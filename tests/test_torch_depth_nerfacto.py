"""depth-nerfacto in the port against the JAX reference, at tiny widths:
16-bit grey PNGs decoded as Pillow reads them (every row filter), the
nerfstudio parser's depth files and seed points, ``DepthDataset``'s maps
from files (PNG and .npy) and from the SfM points (collisions included),
the datamanager's ``depth_image`` batches (the full stack, a resident
subset, resolution buckets), the DS-NeRF and URF losses and their
gradients, the sigma schedule, and one factory-built training step at
steps 304 and 6000 with JAX's draws handed in.

The step follows test_torch_trainer's: flat hash tables, the loss and its
terms (``depth_loss`` included) to 2e-3, each non-table gradient within
5e-2 of its largest entry, each table's gradient summed per level and
feature within 1e-3 of the largest such sum (the proposal table's 1e-2).
The helpers here (``step_pair``, ``check_step``) also serve
test_torch_semantic_nerfw.py."""

import dataclasses
import functools
import json
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import CPU, NUM_IMAGES, TINY_MODEL, jax_occupancy_draws, jax_step_draws
from fixtures import make_mixed_res_fixture, make_nerfstudio_fixture
from test_torch_train_step import _flat_tables
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.data.image_io import decode_png
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.utils.convert import params_from_jax, trainer_checkpoint_from_jax

HW = 16
RAYS = 64


# -- 16-bit grey PNGs --------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png16(values: np.ndarray, filters) -> bytes:
    """A 16-bit grey PNG of the (H, W) uint16 ``values``, row y filtered
    with ``filters[y % len(filters)]`` (0-4: None, Sub, Up, Average, Paeth;
    PNG spec section 9, on bytes, 2 bytes per pixel)."""
    h, w = values.shape
    rows = values.astype(">u2").view(np.uint8).reshape(h, 2 * w).astype(np.int64)
    raw = b""
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(2, np.int64), x[:-2]])
        b = rows[y - 1] if y else np.zeros_like(x)
        c = np.concatenate([np.zeros(2, np.int64), b[:-2]])
        kind = filters[y % len(filters)]
        pred = [np.zeros_like(x), a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        raw += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decode_png_16bit_grey_equals_pillow(tmp_path, filters):
    """Every row filter, on values spanning 0..65535 (both bytes of a
    sample live): ``decode_png`` returns Pillow's uint16 array, exactly."""
    from PIL import Image

    values = np.random.default_rng(3).integers(0, 65536, (9, 13)).astype(np.uint16)
    values[0, 0], values[-1, -1] = 0, 65535
    path = tmp_path / "d.png"
    path.write_bytes(png16(values, filters))
    ref = np.asarray(Image.open(path))
    got = decode_png(path.read_bytes())
    assert ref.dtype == np.uint16 and got.dtype == np.uint16 and got.shape == (9, 13, 1)
    np.testing.assert_array_equal(got[..., 0], ref)
    np.testing.assert_array_equal(got[..., 0], values)


# -- scenes --------------------------------------------------------------------


def _sphere_points(n: int, seed: int) -> np.ndarray:
    """Points on the fixture's sphere (radius 0.5 at the origin)."""
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return (0.5 * p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)


def add_points(root: Path, n: int = 3000) -> Path:
    """points3D.ply on the sphere, named in transforms.json: thousands of
    points on a 16^2 image, so several land on one pixel."""
    from nerfstudio_tpu.exporter.ply_io import write_ply

    pts = _sphere_points(n, 5)
    write_ply(root / "points3D.ply", n, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                                         "red": np.full(n, 200, np.uint8), "green": np.full(n, 50, np.uint8),
                                         "blue": np.full(n, 50, np.uint8)})
    meta = json.loads((root / "transforms.json").read_text())
    meta["ply_file_path"] = "points3D.ply"
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def add_depth_files(root: Path, kind: str) -> Path:
    """A depth file per frame: a 16-bit grey PNG (millimetres, filters
    cycling) or a float32 .npy of the same values."""
    meta = json.loads((root / "transforms.json").read_text())
    (root / "depths").mkdir()
    rng = np.random.default_rng(9)
    for i, fr in enumerate(meta["frames"]):
        values = rng.integers(0, 65536, (meta["h"], meta["w"])).astype(np.uint16)
        values[rng.uniform(size=values.shape) < 0.3] = 0  # pixels without depth
        if kind == "png":
            name = f"depths/d_{i}.png"
            (root / name).write_bytes(png16(values, [i % 5, (i + 2) % 5]))
        else:
            name = f"depths/d_{i}.npy"
            np.save(root / name, values.astype(np.float32))
        fr["depth_file_path"] = name
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_scenes")
    out = {"sfm": add_points(make_nerfstudio_fixture(root / "sfm", n=NUM_IMAGES + 1, hw=HW))}
    for kind in ("png", "npy"):
        out[kind] = add_depth_files(make_nerfstudio_fixture(root / kind, n=NUM_IMAGES + 1, hw=HW), kind)
    out["mixed"] = add_points(make_mixed_res_fixture(root / "mixed", n=6, hws=(16, 12, 16)))
    return out


def _parse(scene, split="train", jax_side=False, **kw):
    cfg = (JNerfstudio if jax_side else NerfstudioDataParserConfig)(data=scene, load_3D_points=True, **kw)
    return cfg.setup().get_dataparser_outputs(split)


@pytest.mark.parametrize("kind", ["png", "npy", "sfm"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_parser_depth_metadata_equals_jax(scenes, kind, split):
    """The depth files of the split, the unit scale and the seed points
    equal the JAX parser's, exactly (the points with their transform and
    scale applied)."""
    j, t = _parse(scenes[kind], split, True), _parse(scenes[kind], split)
    jf, tf = j.metadata["depth_filenames"], t.metadata["depth_filenames"]
    assert (tf is None) == (jf is None) == (kind == "sfm")
    if jf is not None:
        assert [str(p) for p in tf] == [str(p) for p in jf]
    assert t.metadata["depth_unit_scale_factor"] == j.metadata["depth_unit_scale_factor"] == 1e-3
    if kind == "sfm":
        np.testing.assert_array_equal(t.metadata["points3D_xyz"].numpy(), np.asarray(j.metadata["points3D_xyz"]))
    else:
        assert "points3D_xyz" not in t.metadata and "points3D_xyz" not in j.metadata
    np.testing.assert_array_equal(t.cameras.camera_to_worlds.numpy(),
                                  np.asarray(j.cameras.camera_to_worlds).reshape(-1, 3, 4))


@pytest.mark.parametrize("kind", ["png", "npy", "sfm"])
def test_depth_dataset_equals_jax(scenes, kind):
    """Every train image's ``depth_image`` equals JAX's ``DepthDataset``'s
    bit for bit: the files times ``depth_unit_scale_factor``, or the SfM
    projection, whose collisions (asserted) keep the nearest point."""
    from nerfstudio_tpu.data.datasets import DepthDataset as JDepthDataset
    from nerfstudio_torch.data.datasets import DepthDataset

    jds, tds = JDepthDataset(_parse(scenes[kind], jax_side=True)), DepthDataset(_parse(scenes[kind]))
    assert tds.provides_depth and jds.provides_depth
    for i in range(len(tds)):
        ref, got = jds.get_metadata(i)["depth_image"], tds.get_metadata(i)["depth_image"]
        assert got.dtype == np.float32 and got.shape == ref.shape == (HW, HW, 1)
        np.testing.assert_array_equal(got, ref)
        assert 0 < (got > 0).mean() < 1
    if kind == "sfm":  # more points in front of the camera than pixels they hit
        assert (tds.get_metadata(0)["depth_image"] > 0).sum() < len(tds._sfm_points) // 2


def test_depth_dataset_without_depth_supervises_nothing(scenes):
    """No depth files and no seed points: no depth map, as in JAX."""
    from nerfstudio_torch.data.datasets import DepthDataset

    out = NerfstudioDataParserConfig(data=scenes["sfm"]).setup().get_dataparser_outputs("train")
    ds = DepthDataset(out)
    assert not ds.provides_depth and ds.get_metadata(0) == {}


def _jax_dm(scene, max_images=None):
    from nerfstudio_tpu.data.datamanagers import DataManagerConfig as JDMConfig
    from nerfstudio_tpu.data.datamanagers import DeviceCacheDataManager as JDM
    from nerfstudio_tpu.data.datasets import DepthDataset as JDepthDataset

    return JDM(JDMConfig(train_num_rays_per_batch=RAYS, max_images_in_memory=max_images),
               JDepthDataset(_parse(scene, jax_side=True)))


def _port_dm(scene, max_images=None):
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.data.datasets import DepthDataset

    return DeviceCacheDataManager.from_datasets(
        DataManagerConfig(train_num_rays_per_batch=RAYS, max_images_in_memory=max_images),
        DepthDataset(_parse(scene)), device=CPU)


def jax_batches_and_slots(jdm, key):
    """JAX's batch from ``key`` and the slot indices its sampler drew (one
    array per bucket for a bucketed split), to hand to the port."""
    from nerfstudio_tpu.data.pixel_samplers import sample_pixel_indices

    imgs = jdm.train_images
    _, batch = jdm.sample_train_batch(key, imgs, resident_map=jdm.resident_map)
    if isinstance(imgs, tuple):
        alloc = jdm._bucket_ray_alloc(RAYS)
        keys = jax.random.split(key, len(imgs))
        slots = [torch.from_numpy(np.asarray(sample_pixel_indices(k, r, *im.shape[:3])).astype(np.int64))
                 for k, r, im in zip(keys, alloc, imgs)]
    else:
        slots = torch.from_numpy(np.asarray(sample_pixel_indices(key, RAYS, *imgs.shape[:3])).astype(np.int64))
    return batch, slots


@pytest.mark.parametrize("layout", ["full", "resident", "buckets"])
def test_datamanager_depth_batch_equals_jax(scenes, layout):
    """The same draws on both sides: ``depth_image`` (R, 1) float32, the
    image and the original-camera indices equal JAX's exactly; the depth
    gathered at the resident slots before the remap; a bucketed split
    gathers each bucket's own depths."""
    scene = scenes["mixed" if layout == "buckets" else "sfm"]
    m = 2 if layout == "resident" else None
    jdm, tdm = _jax_dm(scene, m), _port_dm(scene, m)
    if layout == "resident":
        np.testing.assert_array_equal(tdm._resident, jdm._resident)
        assert tdm.train_depths.shape[0] == 2
    if layout == "buckets":
        assert tdm.bucket_depths is not None and len(tdm.bucket_depths) == 2
    for seed in (0, 1):
        ref, slots = jax_batches_and_slots(jdm, jax.random.PRNGKey(seed))
        _, got = tdm.sample_train_batch(indices=slots)
        assert got["depth_image"].dtype == torch.float32 and got["depth_image"].shape == (RAYS, 1)
        for k in ("depth_image", "image", "indices"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        assert (got["depth_image"] > 0).any()


# -- losses --------------------------------------------------------------------


def _loss_inputs(seed=0, rays=24, samples=12):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.05, 4.0, (rays, samples + 1)), axis=-1).astype(np.float32)
    return dict(
        weights=rng.dirichlet(np.ones(samples), rays).astype(np.float32)[..., None],
        starts=edges[:, :-1, None], ends=edges[:, 1:, None],
        termination=np.where(rng.uniform(size=(rays, 1)) < 0.25, 0.0,
                             rng.uniform(0.3, 3.5, (rays, 1))).astype(np.float32),
        predicted=rng.uniform(0.3, 3.5, (rays, 1)).astype(np.float32),
        norms=rng.uniform(1.0, 1.3, (rays, 1)).astype(np.float32),
        directions=rng.normal(size=(rays, 3)).astype(np.float32),
    )


def _jax_samples(x):
    from nerfstudio_tpu.core.rays import Frustums, RaySamples

    s = x["starts"].shape
    zeros = np.zeros(s[:2] + (3,), np.float32)
    dirs = np.broadcast_to(x["directions"][:, None], zeros.shape)
    return RaySamples(frustums=Frustums(origins=zeros, directions=dirs, starts=x["starts"], ends=x["ends"],
                                        pixel_area=np.ones(s, np.float32)))


def _port_samples(x):
    from nerfstudio_torch.core.rays import Frustums, RaySamples

    s = x["starts"].shape
    zeros = torch.zeros(s[:2] + (3,))
    dirs = torch.from_numpy(x["directions"])[:, None].expand(zeros.shape)
    return RaySamples(frustums=Frustums(origins=zeros, directions=dirs, starts=torch.from_numpy(x["starts"]),
                                        ends=torch.from_numpy(x["ends"]), pixel_area=torch.ones(s)))


@pytest.mark.parametrize("loss_type", ["ds_nerf", "urf"])
@pytest.mark.parametrize("is_euclidean", [False, True])
@pytest.mark.parametrize("sigma", [0.2, 0.01])
def test_depth_losses_and_gradients_equal_jax(loss_type, is_euclidean, sigma):
    """``depth_loss`` (DS-NeRF's likelihood or URF's line of sight, through
    ``directions_norm`` for a z-depth) and its gradients with respect to
    the weights and the predicted depth: within 1e-6 of JAX's, relative to
    each one's peak; a quarter of the rays have no depth (0)."""
    from nerfstudio_tpu.model_components.losses import depth_loss as jdepth_loss
    from nerfstudio_torch.model_components.losses import depth_loss

    x = _loss_inputs()
    jsamples = _jax_samples(x)

    def jloss(w, pred):
        return jdepth_loss(w, jsamples, x["termination"], pred, jax.numpy.asarray(sigma, jax.numpy.float32),
                           x["norms"], is_euclidean, loss_type)

    ref, (gw_ref, gp_ref) = jax.value_and_grad(jloss, argnums=(0, 1))(x["weights"], x["predicted"])
    w = torch.from_numpy(x["weights"]).requires_grad_()
    pred = torch.from_numpy(x["predicted"]).requires_grad_()
    got = depth_loss(w, _port_samples(x), torch.from_numpy(x["termination"]), pred,
                     torch.tensor(sigma, dtype=torch.float32), torch.from_numpy(x["norms"]), is_euclidean, loss_type)
    got.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    if loss_type == "ds_nerf":  # DS-NeRF reads no predicted depth
        assert pred.grad is None and np.abs(gp_ref).max() == 0
        pred.grad = torch.zeros_like(pred)
    for g, r in ((w.grad, gw_ref), (pred.grad, gp_ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6 * np.abs(r).max())


def test_sigma_schedule_equals_jax():
    """``step_kwargs`` at the shipped config (the decaying ``depth_sigma``
    with nerfacto's schedule) equals JAX's at steps 0, 1000, 20,000 and
    30,000, and without the decay the floor sigma."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.models.depth_nerfacto import DepthNerfactoModel as JDepth
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.models.depth_nerfacto import DepthNerfactoModel

    jcfg, cfg = jget_method("depth-nerfacto").model, get_method("depth-nerfacto").model
    for decay in (True, False):
        jcfg.should_decay_sigma = cfg.should_decay_sigma = decay
        for step in (0, 1000, 20000, 30000):
            got, want = DepthNerfactoModel.step_kwargs(step, cfg), JDepth.step_kwargs(step, jcfg)
            assert got == want, (step, got, want)
    assert DepthNerfactoModel.step_kwargs(1000, cfg)["depth_sigma"] == 0.01
    cfg.should_decay_sigma = True
    assert DepthNerfactoModel.step_kwargs(1000, cfg)["depth_sigma"] == pytest.approx(0.2 * 0.99985**1000)


# -- one training step ---------------------------------------------------------


def step_pair(method, scene, load_points=False):
    """JAX's and the port's factory-built ``method`` at TINY_MODEL on the
    scene through the nerfstudio parser (frame 0 held out), JAX's params
    with flat tables. Returns (JAX pipeline, its host state, its config,
    the port's pipeline, its state, its config)."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.pipelines.factory import build_pipeline

    parser = dict(data=scene, eval_mode="interval", eval_interval=NUM_IMAGES + 1, load_3D_points=load_points)
    jconfig = jget_method(method)
    jconfig.model = dataclasses.replace(jconfig.model, **TINY_MODEL)
    jconfig.data, jconfig.dataparser = scene, JNerfstudio(**parser)
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    m = jconfig.model
    params = _flat_tables(jax.device_get(jstate.params),
                          (m.log2_hashmap_size, m.proposal_net_args_list[-1]["log2_hashmap_size"]))
    host_state = jax.device_get(jstate.replace(params=params))
    config = get_method(method)
    config.data, config.dataparser = scene, NerfstudioDataParserConfig(**parser)
    config.machine.device_type = "cpu"
    config.datamanager.train_num_rays_per_batch = RAYS
    for k, v in TINY_MODEL.items():
        setattr(config.model, k, v)
    pipe, state, config = build_pipeline(config)
    return jpipe, host_state, jconfig, pipe, state, config


def jax_step(jpipe, params, aux, key, kwargs, float32=False):
    """(gradients, {"loss", its terms, the metrics}) of JAX's train step at
    ``params``: its ``loss_fn`` with the step's kwargs (``depth_sigma``
    into the losses, as its train step hands it) and its draws from
    ``key``; with ``float32`` every MLP and the semantic head of the JAX
    model compute in float32."""
    import nerfstudio_tpu.field_components.mlp as jmlp
    import nerfstudio_tpu.fields.nerfacto_field as jfield
    from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices

    dm, jmodel = jpipe.datamanager, jpipe.model_train
    k_pix, k_model = jax.random.split(key)
    idx, batch = dm.sample_train_batch(k_pix, dm.train_images)
    model_kw = {k: v for k, v in kwargs.items() if k != "depth_sigma"}
    loss_kw = {"depth_sigma": kwargs["depth_sigma"]} if "depth_sigma" in kwargs else {}

    def loss_fn(p):
        outputs = jmodel.apply(p, generate_rays_from_indices(dm.train_cameras, idx), key=k_model, model_aux=aux,
                               **model_kw)
        metrics = jmodel.get_metrics_dict(outputs, batch, p)
        loss_dict = jmodel.get_loss_dict(outputs, batch, metrics, p, config=jmodel.config, **loss_kw)
        return sum(loss_dict.values()), {**loss_dict, **metrics}

    saved = jfield.MLP, jmlp.MLP, jfield.SemanticFieldHead
    if float32:
        jfield.MLP, jmlp.MLP, jfield.SemanticFieldHead = (functools.partial(c, dtype=jax.numpy.float32)
                                                          for c in saved)
    try:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        return jax.device_get(grads), {"loss": loss, **jax.device_get(metrics)}
    finally:
        jfield.MLP, jmlp.MLP, jfield.SemanticFieldHead = saved


def check_step(pair, step, terms, float32_biases=()):
    """The occupancy hook and one step at ``step`` on both sides with
    JAX's draws: the grid's densities to 1e-4 and its cells on >= 99.9%;
    the port's ``step_kwargs`` equal JAX's; the loss and ``terms`` to 2e-3;
    gradients as the module docstring says. Parameters whose name starts
    with one of ``float32_biases`` and ends in ``bias`` are held to JAX's
    gradient with every MLP in float32, and the port's bfloat16 gradients
    of those lie nearer to it than JAX's do (asserted). Returns the port's
    metrics."""
    jpipe, host_state, jconfig, pipe, state, config = pair
    model = pipe.model
    ttrainer.restore_train_state(pipe, state, trainer_checkpoint_from_jax(host_state, model, state.optimizer))
    jstate = jax.tree_util.tree_map(jax.numpy.asarray, host_state)
    jstate = jstate.replace(step=jax.numpy.asarray(step, jax.numpy.int32))
    state.step = step
    k_aux, k_step = jax.random.split(jax.random.PRNGKey(7))
    jstate = jpipe.aux_update_fn(jstate, step, k_aux)
    cells, jitter = jax_occupancy_draws(k_aux, jconfig.model.occ_grid_resolution, jconfig.model.occ_cells_per_update)
    pipe.aux_update_fn(state, step, cells=cells, jitter=jitter)
    np.testing.assert_allclose(state.aux.densities.numpy(), np.asarray(jstate.aux.densities), rtol=1e-4, atol=1e-6)
    assert (state.aux.binary.numpy() == np.asarray(jstate.aux.binary)).mean() >= 0.999
    kwargs = type(jpipe.model_train).step_kwargs(step, jconfig.model)
    assert type(model).step_kwargs(step, config.model) == kwargs
    jgrads, jmetrics = jax_step(jpipe, jstate.params, jstate.aux, k_step, kwargs)
    jgrads = params_from_jax(jgrads, model)
    jgrads32 = (params_from_jax(jax_step(jpipe, jstate.params, jstate.aux, k_step, kwargs, float32=True)[0], model)
                if float32_biases else None)
    n_img, h, w = pipe.datamanager.train_images.shape[:3]
    tmetrics = pipe.train_step(state, draws=jax_step_draws(k_step, RAYS, n_img, h, w), **kwargs)
    for k in ("loss", "rgb_loss", "distortion_loss", "interlevel_loss", "psnr", *terms):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=2e-3, atol=1e-7, err_msg=k)
    off_float32 = {"port": 0.0, "jax": 0.0}
    for n, p in model.named_parameters():
        held32 = bool(float32_biases) and n.startswith(tuple(float32_biases)) and n.endswith("bias")
        ref = (jgrads32 if held32 else jgrads)[n].numpy().astype(np.float64)
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy().astype(np.float64)
        if held32:
            for side, g in (("port", got), ("jax", jgrads[n].numpy())):
                off_float32[side] = max(off_float32[side], np.abs(g - ref).max() / np.abs(ref).max())
        if n.endswith("hash_table"):
            log2_t = config.model.log2_hashmap_size if n.startswith("field") else \
                config.model.proposal_net_args_list[-1]["log2_hashmap_size"]
            F = 128 * got.shape[1] // 2**log2_t
            got, ref = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, ref))
            rel = 1e-2 if n.startswith("proposal_networks") else 1e-3
            np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=n)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * np.abs(ref).max() + 1e-10, err_msg=n)
    assert off_float32["port"] <= off_float32["jax"], off_float32
    assert torch.isfinite(torch.stack([v for v in tmetrics.values()])).all()
    return tmetrics


@pytest.fixture(scope="module")
def depth_pair(scenes):
    return step_pair("depth-nerfacto", scenes["sfm"], load_points=True)


@pytest.mark.parametrize("step", [304, 6000], ids=["early", "steady"])
def test_depth_nerfacto_step_matches_jax(depth_pair, step):
    """depth-nerfacto with the SfM depth of the scene's points: at 304 the
    sigma is 0.19 with live proposals and the full field backward, at 6000
    0.081 with frozen proposals and half the field levels. The colour
    head's biases are held with every MLP in float32, as
    test_torch_trainer's step (a bias gradient sums every sample's
    bfloat16-rounded cotangent)."""
    batch = depth_pair[3].datamanager.sample_train_batch(torch.Generator().manual_seed(0))[1]
    assert (batch["depth_image"] > 0).float().mean() > 0.05
    metrics = check_step(depth_pair, step, ("depth_loss",), float32_biases=("field.mlp_head",))
    assert float(metrics["depth_loss"]) > 0
