"""dnerf in the port against the JAX reference: D-NeRF's temporal
distortion at its shipped widths, the cameras' times through ray
generation, one training step and the eval forward of the NeRF with the
distortion, the distortion inert without times, converted JAX checkpoints
with and without the distortion's subtree, the D-NeRF parser, and the
method config.

Small sizes: the NeRF fields at 6 layers x 32 (``TINY_FIELD`` of
test_torch_vanilla_mipnerf), the distortion at its shipped 4 x 256, 32
rays of 8 + 8 samples. Inputs are drawn with numpy from a seed; JAX's
parameters reach the port through ``params_from_jax`` and JAX's jitter
draws are handed in. The step and eval comparisons hold every MLP in
float32 on both sides (``_f32``, ``_port_f32``), as the vanilla-nerf tests do."""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, to_torch
import nerfstudio_tpu.field_components.temporal_distortions as jtd
import nerfstudio_tpu.fields.vanilla_nerf_field as jnerf_field
import nerfstudio_tpu.models.vanilla_nerf as jvanilla
from nerfstudio_tpu.configs.method_configs import get_method as jget_method
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.field_components import field_heads as jheads
from nerfstudio_tpu.field_components import mlp as jmlp
import nerfstudio_torch.models.vanilla_nerf as tvanilla
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.field_components.field_heads import FieldHead
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.field_components.temporal_distortions import DNeRFDistortion
from nerfstudio_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
from nerfstudio_torch.utils.convert import params_from_jax

REPO = Path(__file__).resolve().parent.parent
RAYS = 32
TINY_FIELD = dict(base_mlp_num_layers=6, base_mlp_layer_width=32, head_mlp_layer_width=16)
TINY_SAMPLES = dict(num_coarse_samples=8, num_importance_samples=8)
LOSS_RTOL, GRAD_REL = 2e-3, 5e-2  # the step's limits: every loss term, every gradient of its peak


def _f32(monkeypatch):
    """JAX's MLPs and heads (the distortion's too) in float32."""
    f32 = dict(dtype=jnp.float32)
    monkeypatch.setattr(jnerf_field, "MLP", functools.partial(jmlp.MLP, **f32))
    monkeypatch.setattr(jnerf_field, "DensityFieldHead", functools.partial(jheads.DensityFieldHead, **f32))
    monkeypatch.setattr(jnerf_field, "RGBFieldHead", functools.partial(jheads.RGBFieldHead, **f32))
    monkeypatch.setattr(jtd, "MLP", functools.partial(jmlp.MLP, **f32))


def _port_f32(model):
    for m in model.modules():
        if isinstance(m, (MLP, FieldHead)):
            m.dtype = torch.float32
    return model


# --------------------------------------------------------------------------
# the distortion


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distortion_matches_jax(dtype, monkeypatch):
    """``DNeRFDistortion`` at its shipped widths (84 features, 4 x 256, out
    3) on 1000 positions and times: the same parameter names and shapes as
    JAX's (``temporal_distortion/MLP_0/layers_0..3``); in float32 the
    distorted positions within 1e-5, the positions', times' and weights'
    gradients within 1e-4 of their peak; as shipped, in bfloat16, within
    2e-2 of the offsets' peak (values and gradients: bfloat16 products
    rounded in another order)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1.5, 1.5, (1000, 3)).astype(np.float32)
    times = rng.uniform(0, 1, (1000, 1)).astype(np.float32)
    if dtype == "float32":
        monkeypatch.setattr(jtd, "MLP", functools.partial(jmlp.MLP, dtype=jnp.float32))
    jd = jtd.DNeRFDistortion()
    params = jax.device_get(jd.init(jax.random.PRNGKey(3), jnp.asarray(pos), jnp.asarray(times)))
    holder = torch.nn.Module()
    holder.temporal_distortion = DNeRFDistortion(device=CPU)
    holder.temporal_distortion.mlp.dtype = getattr(torch, dtype)
    holder.load_state_dict(params_from_jax({"temporal_distortion": params["params"]}, holder))
    assert [tuple(l.weight.shape) for l in holder.temporal_distortion.mlp.layers] == [(256, 84), (256, 256),
                                                                                       (256, 256), (3, 256)]
    want, pull = jax.vjp(lambda p, x, t: jd.apply(p, x, t), params, jnp.asarray(pos), jnp.asarray(times))
    want = np.asarray(want)
    tp, tt = to_torch(pos).requires_grad_(True), to_torch(times).requires_grad_(True)
    got = holder.temporal_distortion(tp, tt)
    offsets = want - pos
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    else:
        assert np.abs(got.detach().numpy() - want).max() <= 2e-2 * np.abs(offsets).max()
    cot = rng.normal(size=want.shape).astype(np.float32)
    got.backward(to_torch(cot))
    jp, jx, jt = pull(jnp.asarray(cot))
    rel = 1e-4 if dtype == "float32" else 2e-2
    for g, ref in ((tp.grad, jx), (tt.grad, jt)):
        ref = np.asarray(ref)
        assert np.abs(g.numpy() - ref).max() <= rel * np.abs(ref).max()
    jg = params_from_jax({"temporal_distortion": jax.device_get(jp)["params"]}, holder)
    for n, p in holder.named_parameters():
        if n.endswith(".bias") and dtype == "bfloat16":
            continue  # sums of bfloat16 cotangents in another order (the vanilla-nerf tests' note)
        ref = jg[n].numpy()
        assert np.abs(p.grad.numpy() - ref).max() <= rel * np.abs(ref).max(), n
    assert holder.temporal_distortion(tp, None) is tp


# --------------------------------------------------------------------------
# the cameras' times


def _cams(n=5, hw=6):
    rng = np.random.default_rng(1)
    c2w = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    c2w[:, :, 3] = rng.normal(size=(n, 3))
    return c2w, rng.uniform(0, 1, n).astype(np.float32), hw


@pytest.mark.parametrize("shape", ["flat", "column"])
def test_rays_carry_the_cameras_times(shape):
    """Cameras built with one time per camera ((N,) or (N, 1), as JAX
    takes them): rays at mixed camera indices through
    ``generate_rays_from_coords``, ``ray_generators`` and a whole image
    through ``generate_rays`` carry JAX's times exactly; the times survive
    ``to``, ``rescale_output_resolution`` and ``dataclasses.replace``;
    samples broadcast them; cameras without times give rays without."""
    from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
    from nerfstudio_torch.cameras.cameras import Cameras
    from nerfstudio_torch.model_components.ray_generators import generate_rays_from_indices

    c2w, times, hw = _cams()
    t_in = times if shape == "flat" else times[:, None]
    jc = JCameras(c2w, 5.0, 5.0, hw / 2, hw / 2, hw, hw, times=t_in)
    tc = Cameras.create(c2w, 5.0, 5.0, hw / 2, hw / 2, hw, hw, device=CPU, times=t_in)
    assert tc.times.shape == (5, 1) and tc.times.dtype == torch.float32
    rng = np.random.default_rng(2)
    cam = rng.integers(0, 5, (64, 1)).astype(np.int32)
    coords = rng.uniform(0, hw, (64, 2)).astype(np.float32)
    want = np.asarray(jc.generate_rays(camera_indices=jnp.asarray(cam), coords=jnp.asarray(coords)).times)
    got = tc.generate_rays_from_coords(to_torch(cam), to_torch(coords)).times
    np.testing.assert_array_equal(got.numpy(), want)
    idx = torch.from_numpy(np.concatenate([cam, rng.integers(0, hw, (64, 2))], axis=-1).astype(np.int64))
    np.testing.assert_array_equal(generate_rays_from_indices(tc, idx).times.numpy(), times[cam[:, 0], None])
    full = tc.rescale_output_resolution(0.5).to(CPU).generate_rays(camera_indices=3)
    assert full.shape == (hw // 2, hw // 2) and bool((full.times == float(times[3])).all())
    assert torch.equal(dataclasses.replace(tc, fx=tc.fx * 2).times, tc.times)
    samples = full.flatten().get_ray_samples(torch.zeros(9, 4, 1), torch.ones(9, 4, 1))
    assert samples.times.shape == (9, 4, 1) and bool((samples.times == float(times[3])).all())
    plain = Cameras.create(c2w, 5.0, 5.0, hw / 2, hw / 2, hw, hw, device=CPU)
    assert plain.generate_rays_from_coords(to_torch(cam), to_torch(coords)).times is None


# --------------------------------------------------------------------------
# the model: a step, the eval forward, the distortion on and off


def _rays(seed, n=RAYS):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.3, size=(n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full((n, 1), 1e-4, np.float32), rng.uniform(0, 1, (n, 1)).astype(np.float32)


def _jax_model(train, monkeypatch):
    _f32(monkeypatch)
    monkeypatch.setattr(jvanilla, "NeRFField", functools.partial(jnerf_field.NeRFField, **TINY_FIELD))
    cfg = dataclasses.replace(jget_method("dnerf").model, **TINY_SAMPLES)
    return jvanilla.NeRFModel(config=cfg, num_train_data=4, train=train)


def _torch_model(params, train, monkeypatch, method="dnerf"):
    monkeypatch.setattr(tvanilla, "NeRFField", functools.partial(NeRFField, **TINY_FIELD))
    cfg = dataclasses.replace(get_method(method).model, **TINY_SAMPLES)
    model = cfg.setup(num_train_data=4, device=CPU).train(train)
    if params is not None:
        model.load_state_dict(params_from_jax(params, model))
    return _port_f32(model)


def _gentle(params, scale=1e-3):
    """JAX's init with the distortion's output layer scaled by ``scale``
    (1e-3: offsets of ~1e-3).

    At the init itself the step is ill-conditioned across two float32
    implementations: the distortion's last-bit differences (its 4 x 256
    products summed in another order, ~2e-7 on a position) pass through the
    coarse field's top encoding frequency (2^8 x 2 pi) into the coarse
    weights (~7e-6 apart), the inverse CDF moves the fine bins by up to
    ~3e-5, and the distortion at the fine samples amplifies that ~100x, so
    single fine positions land ~2e-3 apart (the PDF sampling itself is
    equal to ~2e-6 on the same weights). Smaller offsets keep every
    difference at the last bits, as in the vanilla-nerf step, while every
    parameter keeps its gradient (and the offsets stay nonzero)."""
    params = jax.tree_util.tree_map(np.copy, params)
    out = params["params"]["temporal_distortion"]["MLP_0"]["layers_3"]
    out["kernel"] = out["kernel"] * np.float32(scale)
    return params


def test_training_step_matches_jax(monkeypatch):
    """One dnerf step from JAX's init (the distortion's output layer scaled
    by 1e-3, ``_gentle``) on rays with times, an RGBA ground truth and
    JAX's jitter draws, the MLPs in float32: both passes' rgb losses within
    2e-3 relative and every gradient within 5e-2 of its peak, the temporal
    distortion's included (measured: losses ~1e-6, gradients 1.8e-2 at
    worst, the distortion's third layer; 4.1e-2 at a 1e-2 scale)."""
    jmodel = _jax_model(True, monkeypatch)
    o, d, a, t = _rays(1)
    gt = np.random.default_rng(2).uniform(size=(RAYS, 4)).astype(np.float32)
    gt[:8, 3], gt[8:16, 3] = 0.0, 1.0
    key = jax.random.PRNGKey(5)
    jrb = JRayBundle(origins=o, directions=d, pixel_area=a, times=t)
    params = _gentle(jax.device_get(jax.jit(lambda k: jmodel.init(k, jrb, key=k))(jax.random.PRNGKey(0))))
    assert set(params["params"]) == {"field_coarse", "field_fine", "temporal_distortion"}

    def loss_fn(p):
        terms = jmodel.get_loss_dict(jmodel.apply(p, jrb, key=key), {"image": jnp.asarray(gt)}, None, p)
        return sum(terms.values()), terms

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    k1, k2, _ = jax.random.split(key, 3)
    draws = SamplerUniforms(None, (to_torch(jax.random.uniform(k1, (RAYS, TINY_SAMPLES["num_coarse_samples"] + 1))),
                                   to_torch(jax.random.uniform(k2, (RAYS,
                                                                    TINY_SAMPLES["num_importance_samples"] + 1)))))
    model = _torch_model(params, True, monkeypatch)
    out = model(RayBundle(to_torch(o), to_torch(d), to_torch(a), times=to_torch(t)), uniforms=draws)
    terms = model.get_loss_dict(out, {"image": to_torch(gt)})
    assert set(terms) == set(jterms) == {"rgb_loss_coarse", "rgb_loss_fine"}
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    sum(terms.values()).backward()
    jg = params_from_jax(jax.device_get(jgrads), model)
    assert set(jg) == {n for n, _ in model.named_parameters()}
    assert any(n.startswith("temporal_distortion.") for n in jg)
    for n, p in model.named_parameters():
        ref = jg[n].numpy()
        assert np.abs(ref).max() > 0, n
        assert np.abs(p.grad.numpy() - ref).max() <= GRAD_REL * np.abs(ref).max(), n


def test_eval_forward_matches_jax(monkeypatch):
    """The eval forward (midpoint samples) of rays with times in float32,
    from JAX's init with the gentle distortion (``_gentle``): every output
    within 1e-4 of JAX's (depths 1e-4 relative)."""
    jmodel = _jax_model(False, monkeypatch)
    o, d, a, t = _rays(3)
    jrb = JRayBundle(origins=o, directions=d, pixel_area=a, times=t)
    params = _gentle(jax.device_get(jax.jit(lambda k: jmodel.init(k, jrb))(jax.random.PRNGKey(1))))
    want = jax.jit(lambda p: jmodel.apply(p, jrb))(params)
    model = _torch_model(params, False, monkeypatch)
    with torch.no_grad():
        got = model(RayBundle(to_torch(o), to_torch(d), to_torch(a), times=to_torch(t)))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_the_distortion_moves_samples_by_time(monkeypatch):
    """With times the distortion fires: each pass's samples carry offsets,
    nonzero, and the same rays at times 0.2 and 0.8 are moved differently
    and render differently."""
    model = _torch_model(None, False, monkeypatch).eval()
    o, d, a, _ = _rays(4)
    seen = []
    real = model._distort
    monkeypatch.setattr(model, "_distort", lambda rs: seen.append(real(rs)) or seen[-1])
    outs = []
    for time in (0.2, 0.8):
        with torch.no_grad():
            outs.append(model(RayBundle(to_torch(o), to_torch(d), to_torch(a), times=torch.full((RAYS, 1), time))))
    assert len(seen) == 4 and all(s.frustums.offsets is not None for s in seen)
    early, late = seen[0].frustums.offsets, seen[2].frustums.offsets
    assert float(early.abs().min()) > 0 and float(early.abs().max()) > 1e-3
    assert float((early - late).abs().max()) > 1e-4
    assert not torch.equal(outs[0]["rgb"], outs[1]["rgb"])


def test_without_times_dnerf_is_vanilla_nerf(monkeypatch):
    """Rays without times: dnerf's outputs equal vanilla-nerf's bit for bit
    at the same fields, its samples carry no offsets, and after a step's
    backward the distortion's gradients are None (its RAdam group then
    steps its parameters on zeros: they stay as they were)."""
    from nerfstudio_torch.engine.optimizers import PerGroupAdam

    dnerf = _torch_model(None, True, monkeypatch)
    vanilla = _torch_model(None, True, monkeypatch, method="vanilla-nerf")
    vanilla.load_state_dict({k: v for k, v in dnerf.state_dict().items() if not k.startswith("temporal_")})
    o, d, a, _ = _rays(5)
    gen = np.random.default_rng(6)
    draws = SamplerUniforms(None, tuple(torch.from_numpy(gen.uniform(size=(RAYS, 9)).astype(np.float32))
                                        for _ in range(2)))
    rb = RayBundle(to_torch(o), to_torch(d), to_torch(a))
    got, want = dnerf(rb, uniforms=draws), vanilla(rb, uniforms=draws)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    gt = {"image": torch.rand(RAYS, 3, generator=torch.Generator().manual_seed(0))}
    sum(dnerf.get_loss_dict(got, gt).values()).backward()
    dist = dict(dnerf.temporal_distortion.named_parameters())
    assert dist and all(p.grad is None for p in dist.values())
    before = {k: v.detach().clone() for k, v in dist.items()}
    opt = PerGroupAdam(get_method("dnerf").optimizers, dnerf)
    assert set(opt.optimizers) == {"field", "temporal_distortion"}
    opt.step()
    assert all(torch.equal(dist[k], before[k]) for k in dist)


# --------------------------------------------------------------------------
# the D-NeRF parser, the config, converted checkpoints


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The tool's ``dnerf`` and ``blender`` scenes at 16^2: 4 train views,
    2 val and 2 test."""
    root = tmp_path_factory.mktemp("scenes")
    for scene in ("dnerf", "blender"):
        subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"), str(root / scene),
                        "--scene", scene, "--hw", "16", "--n-train", "4", "--n-test", "2", "--n-points", "100"],
                       check=True, capture_output=True, timeout=300)
    return root


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dnerf_parser_matches_jax(scenes, split):
    """The D-NeRF parser against JAX's (which reads the image size with
    Pillow; the port reads the PNG header): cameras, times (exact), image
    filenames, white alpha, the scene box and scale; then
    ``dataparser_outputs_from_jax`` carries the times."""
    from nerfstudio_tpu.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig as JDNeRF
    from test_torch_dataparsers import assert_outputs_match
    from nerfstudio_torch.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig
    from nerfstudio_torch.utils.convert import dataparser_outputs_from_jax

    kw = dict(data=scenes / "dnerf", scale_factor=0.8)
    j = JDNeRF(**kw).setup().get_dataparser_outputs(split)
    t = DNeRFDataParserConfig(**kw).setup().get_dataparser_outputs(split)
    assert_outputs_match(j, t)
    want = np.asarray(j.cameras.times).reshape(-1, 1)
    np.testing.assert_array_equal(t.cameras.times.numpy(), want)
    meta = json.loads((scenes / "dnerf" / f"transforms_{split}.json").read_text())
    assert want[:, 0].tolist() == pytest.approx([fr["time"] for fr in meta["frames"]])
    assert len(set(want[:, 0].tolist())) == len(want)
    np.testing.assert_array_equal(dataparser_outputs_from_jax(j).cameras.times.numpy(), want)


def test_dnerf_config_matches_jax():
    """``get_method("dnerf")``: JAX's config field for field (the model's
    ``enable_temporal_distortion``), its parser's fields, and both RAdam
    groups."""
    from test_torch_vanilla_mipnerf import test_method_config_matches_jax as same_config

    same_config("dnerf")
    cfg = get_method("dnerf")
    assert cfg.model.enable_temporal_distortion and type(cfg.dataparser).__name__ == "DNeRFDataParserConfig"
    assert set(cfg.optimizers) == {"field", "temporal_distortion"}


def _jax_pipeline(scene, parser, monkeypatch):
    """JAX's factory-built dnerf at TINY_FIELD, TINY_SAMPLES and 32 rays,
    its MLPs in float32, on ``scene`` through ``parser`` ("dnerf" or
    "blender"). Returns (pipeline, state, config)."""
    from nerfstudio_tpu.data.dataparsers.blender_dataparser import BlenderDataParserConfig as JBlender
    from nerfstudio_tpu.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig as JDNeRF
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline

    _f32(monkeypatch)
    monkeypatch.setattr(jvanilla, "NeRFField", functools.partial(jnerf_field.NeRFField, **TINY_FIELD))
    jconfig = jget_method("dnerf")
    jconfig.model = dataclasses.replace(jconfig.model, **TINY_SAMPLES)
    jconfig.data = scene
    jconfig.dataparser = JDNeRF(data=scene) if parser == "dnerf" else JBlender(data=scene)
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    return jbuild_pipeline(jconfig, use_mesh=False)


@pytest.mark.parametrize("scene", ["dnerf", "blender"])
def test_converted_checkpoint_renders_as_jax(scenes, scene, tmp_path, monkeypatch):
    """A JAX dnerf train state after one train step (from its init with the
    gentle distortion, ``_gentle``) becomes the port's checkpoint and
    renders a held-out view as JAX does (rgb, accumulation and depth within
    1e-4, the MLPs in float32). On the ``dnerf`` scene the
    samples carry times, so JAX's tree has the distortion's subtree and its
    RAdam moments; on ``blender`` (no times) it has neither: the port keeps
    its own distortion parameters, with zero moments at the group's count."""
    from nerfstudio_torch.engine import trainer as ttrainer
    from nerfstudio_torch.pipelines.factory import build_pipeline
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    jpipe, jstate, _ = _jax_pipeline(scenes / scene, scene, monkeypatch)
    if scene == "dnerf":
        jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, _gentle(jax.device_get(jstate.params))))
    jstate, _ = jpipe.train_step(jstate, jpipe.datamanager.train_images, jax.random.PRNGKey(2))
    host = jax.device_get(jstate)
    assert ("temporal_distortion" in host.params["params"]) == (scene == "dnerf")
    monkeypatch.setattr(tvanilla, "NeRFField", functools.partial(NeRFField, **TINY_FIELD))
    config = get_method("dnerf")
    config.model = dataclasses.replace(config.model, **TINY_SAMPLES)
    config.data, config.machine.device_type = scenes / scene, "cpu"
    if scene == "blender":
        from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig

        config.dataparser = BlenderDataParserConfig(data=scenes / scene)
    pipe, state, _ = build_pipeline(config)
    _port_f32(pipe.model)
    own = {k: v.clone() for k, v in pipe.model.state_dict().items() if k.startswith("temporal_distortion.")}
    payload = trainer_checkpoint_from_jax(host, pipe.model, state.optimizer)
    assert payload["optimizer"]["count"] == 1 and set(payload["optimizer"]["optimizers"]) == {"field",
                                                                                             "temporal_distortion"}
    ttrainer.write_checkpoint(tmp_path / "ckpt", 1, payload)
    ttrainer.restore_train_state(pipe, state, ttrainer.read_checkpoint(tmp_path / "ckpt")[1])
    moments = state.optimizer.state_dict()["optimizers"]["temporal_distortion"]["state"]
    assert len(moments) == 8 and all(float(v["step"]) == 1.0 for v in moments.values())
    if scene == "dnerf":
        assert all(float(v["exp_avg"].abs().max()) > 0 for v in moments.values())
    else:
        assert all(float(v["exp_avg"].abs().max()) == 0 for v in moments.values())
        assert all(torch.equal(pipe.model.state_dict()[k], v) for k, v in own.items())
    cam_idx = pipe.datamanager.eval_image(0)[0]
    want = jpipe.render_camera(jstate.params, jpipe.datamanager.eval_cameras, cam_idx, 128)
    got = pipe.render_eval_camera(state, cam_idx, 128)
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)
