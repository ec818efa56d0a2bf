"""semantic-nerfw and phototourism in the port against the JAX reference,
at tiny widths: the nerfstudio parser's semantic labels (classes and
colours), ``SemanticDataset``'s labels, the datamanager's ``semantics``
batches (the full stack, a resident subset; a bucketed split carries
none), the field's semantic head through ``params_from_jax``, one
factory-built training step of each method at steps 304 and 6000 with
JAX's draws handed in (test_torch_depth_nerfacto's ``check_step``), a
phototourism eval render with the mean appearance embedding, and the two
method configs against JAX's."""

import dataclasses
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import CPU, NUM_IMAGES
from fixtures import make_mixed_res_fixture, make_nerfstudio_fixture
from test_torch_depth_nerfacto import RAYS, check_step, jax_batches_and_slots, step_pair
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.utils.convert import params_from_jax

HW = 16
CLASSES = ["background", "sphere", "upper"]


def add_labels(root: Path, classes=CLASSES) -> Path:
    """A label image per frame (RGB, the class in channel 0, the other
    channels noise the reader must drop): 0 off the sphere, 1 on it, 2 on
    its upper half of the image; the class names in transforms.json."""
    from PIL import Image

    meta = json.loads((root / "transforms.json").read_text())
    (root / "labels").mkdir()
    rng = np.random.default_rng(4)
    for i, fr in enumerate(meta["frames"]):
        img = np.asarray(Image.open(root / fr["file_path"]))
        label = (img[..., 1] < 200).astype(np.uint8)  # the red sphere on white
        label[: img.shape[0] // 2] *= 2
        rgb = np.stack([label, rng.integers(0, 255, label.shape), rng.integers(0, 255, label.shape)], -1)
        Image.fromarray(rgb.astype(np.uint8)).save(root / f"labels/s_{i}.png")
        fr["semantic_path"] = f"labels/s_{i}.png"
    if classes:
        meta["semantic_classes"] = classes
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("semantic_scenes")
    return {
        "classes": add_labels(make_nerfstudio_fixture(root / "classes", n=NUM_IMAGES + 1, hw=HW)),
        "default": add_labels(make_nerfstudio_fixture(root / "default", n=NUM_IMAGES + 1, hw=HW), classes=None),
        "mixed": add_labels(make_mixed_res_fixture(root / "mixed", n=6, hws=(16, 12, 16))),
        "plain": make_nerfstudio_fixture(root / "plain", n=NUM_IMAGES + 1, hw=HW),
    }


def _parse(scene, split="train", jax_side=False):
    return (JNerfstudio if jax_side else NerfstudioDataParserConfig)(data=scene).setup().get_dataparser_outputs(split)


@pytest.mark.parametrize("scene", ["classes", "default"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_parser_semantics_equal_jax(scenes, scene, split):
    """The split's label files, the class names (the capture's, else 256
    numbered ones) and their ``default_rng(0)`` colours equal JAX's
    exactly."""
    j, t = _parse(scenes[scene], split, True).metadata["semantics"], _parse(scenes[scene], split).metadata["semantics"]
    assert [str(p) for p in t.filenames] == [str(p) for p in j.filenames]
    assert t.classes == j.classes == (CLASSES if scene == "classes" else [f"class_{i}" for i in range(256)])
    assert t.colors.dtype == np.float32
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.mask_classes == j.mask_classes == []


def test_parser_without_labels_has_no_semantics(scenes):
    assert "semantics" not in _parse(scenes["plain"]).metadata


def test_semantic_dataset_labels_equal_jax(scenes):
    """Every train image's labels: channel 0 of the label PNG, int32 (H, W,
    1), equal to JAX's ``SemanticDataset``'s."""
    from nerfstudio_tpu.data.datasets import SemanticDataset as JSemanticDataset
    from nerfstudio_torch.data.datasets import SemanticDataset

    jds, tds = JSemanticDataset(_parse(scenes["classes"], jax_side=True)), SemanticDataset(_parse(scenes["classes"]))
    for i in range(len(tds)):
        ref, got = jds.get_metadata(i)["semantics"], tds.get_metadata(i)["semantics"]
        assert got.dtype == np.int32 and got.shape == ref.shape == (HW, HW, 1)
        np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got)) == {0, 1, 2}
    assert SemanticDataset(_parse(scenes["plain"])).get_metadata(0) == {}


@pytest.mark.parametrize("layout", ["full", "resident", "buckets"])
def test_datamanager_semantics_batch_equals_jax(scenes, layout):
    """The same draws on both sides: ``semantics`` (R, 1) int32, the image
    and the original-camera indices equal JAX's exactly (gathered at the
    resident slots); a bucketed split's batches carry no labels, as JAX's."""
    from nerfstudio_tpu.data.datamanagers import DataManagerConfig as JDMConfig
    from nerfstudio_tpu.data.datamanagers import DeviceCacheDataManager as JDM
    from nerfstudio_tpu.data.datasets import SemanticDataset as JSemanticDataset
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.data.datasets import SemanticDataset

    scene = scenes["mixed" if layout == "buckets" else "classes"]
    m = 2 if layout == "resident" else None
    jdm = JDM(JDMConfig(train_num_rays_per_batch=RAYS, max_images_in_memory=m),
              JSemanticDataset(_parse(scene, jax_side=True)))
    tdm = DeviceCacheDataManager.from_datasets(DataManagerConfig(train_num_rays_per_batch=RAYS,
                                                                 max_images_in_memory=m),
                                               SemanticDataset(_parse(scene)), device=CPU)
    for seed in (0, 1):
        ref, slots = jax_batches_and_slots(jdm, jax.random.PRNGKey(seed))
        _, got = tdm.sample_train_batch(indices=slots)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        if layout != "buckets":
            assert got["semantics"].dtype == torch.int32 and got["semantics"].shape == (RAYS, 1)
            assert len(np.unique(got["semantics"].numpy())) > 1


# -- the semantic head -----------------------------------------------------------

FIELD = dict(num_images=NUM_IMAGES, num_levels=4, base_res=4, max_res=64, log2_hashmap_size=12, features_per_level=4,
             hidden_dim=16, hidden_dim_color=16, appearance_embedding_dim=8, use_semantics=True,
             num_semantic_classes=5)


def _float32(self, x):
    """The port's MLP and head forward with every product in float32."""
    layers = self.layers if hasattr(self, "layers") else [self.layer]
    h = x.float()
    for i, layer in enumerate(layers):
        h = torch.nn.functional.linear(h, layer.weight) + layer.bias
        if i < len(layers) - 1:
            h = self.act(h)
    return self.out_act(h) if hasattr(self, "out_act") else h


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_semantic_field_outputs_match_jax(dtype, monkeypatch):
    """The field's heads in eval mode (the mean appearance embedding) on
    the same samples and geometry features, the JAX init's parameters
    converted by ``params_from_jax`` (the head's ``Dense_0`` included):
    with float32 products on both sides the semantic logits and rgb agree
    within 1e-5; as shipped (bfloat16 products, float32 accumulation on
    both sides) within 2e-2 of the logits' peak, a few bfloat16 roundings.
    The semantic head reads the features with their gradient stopped."""
    import functools

    import nerfstudio_tpu.field_components.field_heads as jheads
    import nerfstudio_tpu.field_components.mlp as jmlp
    import nerfstudio_tpu.fields.nerfacto_field as jfield_mod
    from nerfstudio_tpu.core.rays import Frustums as JFrustums
    from nerfstudio_tpu.core.rays import RaySamples as JRaySamples
    from nerfstudio_torch.core.rays import Frustums, RaySamples
    from nerfstudio_torch.field_components.field_heads import FieldHeadNames
    from nerfstudio_torch.fields.nerfacto_field import NerfactoField

    rng = np.random.default_rng(1)
    shape = (8, 6)
    dirs = rng.normal(size=shape + (3,)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = rng.uniform(-0.3, 0.3, shape + (3,)).astype(np.float32)
    starts = rng.uniform(0.1, 0.5, shape + (1,)).astype(np.float32)
    emb = rng.normal(size=shape + (15,)).astype(np.float32)
    if dtype == "float32":
        monkeypatch.setattr(jfield_mod, "MLP", functools.partial(jmlp.MLP, dtype=jax.numpy.float32))
        monkeypatch.setattr(jfield_mod, "SemanticFieldHead",
                            functools.partial(jheads.SemanticFieldHead, dtype=jax.numpy.float32))
    jf = jfield_mod.NerfactoField(**FIELD, hash_block=True, train=False)
    jrs = JRaySamples(frustums=JFrustums(origins=origins, directions=dirs, starts=starts, ends=starts + 0.05,
                                         pixel_area=np.ones(shape + (1,), np.float32)))
    params = jax.device_get(jax.jit(jf.init)(jax.random.PRNGKey(0), jrs))
    ref = jf.apply(params, jrs, emb, method=jfield_mod.NerfactoField.get_outputs)
    field = NerfactoField(**FIELD, device=CPU).eval()
    field.load_state_dict(params_from_jax(params, field))
    if dtype == "float32":
        for m in (field.mlp_head, field.mlp_semantics, field.field_head_semantics):
            monkeypatch.setattr(m, "forward", types.MethodType(_float32, m))
    rs = RaySamples(frustums=Frustums(origins=torch.from_numpy(origins), directions=torch.from_numpy(dirs),
                                      starts=torch.from_numpy(starts), ends=torch.from_numpy(starts + 0.05),
                                      pixel_area=torch.ones(shape + (1,))))
    emb_t = torch.from_numpy(emb).requires_grad_()
    got = field.get_outputs(rs, density_embedding=emb_t)
    sem, jsem = got[FieldHeadNames.SEMANTICS], np.asarray(ref[jheads.FieldHeadNames.SEMANTICS])
    assert sem.dtype == torch.float32 and sem.shape == shape + (5,)
    peak = np.abs(jsem).max()
    tol = 1e-5 if dtype == "float32" else 2e-2 * peak
    np.testing.assert_allclose(sem.detach().numpy(), jsem, rtol=0, atol=tol)
    np.testing.assert_allclose(got[FieldHeadNames.RGB].detach().numpy(),
                               np.asarray(ref[jheads.FieldHeadNames.RGB]), rtol=0, atol=1e-5 if dtype == "float32"
                               else 2e-2)
    sem.sum().backward()
    assert emb_t.grad is None or emb_t.grad.abs().max() == 0  # stopped


def test_semantic_nerfw_refuses_the_transient_embedding():
    from nerfstudio_torch.models.semantic_nerfw import SemanticNerfWModelConfig

    with pytest.raises(ValueError, match="Transient embedding"):
        SemanticNerfWModelConfig(use_transient_embedding=True).setup(device=CPU)


# -- steps and the eval render --------------------------------------------------


@pytest.fixture(scope="module")
def semantic_pair(scenes):
    return step_pair("semantic-nerfw", scenes["classes"])


@pytest.fixture(scope="module")
def photo_pair(scenes):
    return step_pair("phototourism", scenes["plain"])


@pytest.mark.parametrize("step", [304, 6000], ids=["early", "steady"])
def test_semantic_nerfw_step_matches_jax(semantic_pair, step):
    """semantic-nerfw (no speed knobs: live proposals and every field level
    at both steps), ``semantics_loss`` and ``semantics_accuracy`` with the
    loss terms; the classes from the dataset on both sides. The colour
    head's and the semantic MLP's biases are held with every MLP in
    float32 (test_torch_depth_nerfacto's ``check_step``)."""
    jconfig, pipe = semantic_pair[2], semantic_pair[3]
    assert pipe.model.config.num_semantic_classes == jconfig.model.num_semantic_classes == len(CLASSES)
    metrics = check_step(semantic_pair, step, ("semantics_loss", "semantics_accuracy"),
                         float32_biases=("field.mlp_head", "field.mlp_semantics", "field.field_head_semantics"))
    assert float(metrics["semantics_loss"]) > 0


@pytest.mark.parametrize("step", [304, 6000], ids=["early", "steady"])
def test_phototourism_step_matches_jax(photo_pair, step):
    """phototourism (nerfacto with the appearance embedding and no speed
    knobs) at both steps."""
    check_step(photo_pair, step, (), float32_biases=("field.mlp_head",))


def test_phototourism_eval_render_matches_jax(photo_pair):
    """One held-out view through each package's chunked eval render from
    the same state (flat tables, so K1's rounding picks no different value):
    the field reads the mean of the per-image appearance codes (drawn apart
    here), rgb within 5e-3 mean and 5e-2 on >= 99% of pixels as
    test_torch_nerfacto_render's, accumulation and expected depth within
    1e-3 mean; the codes' mean moves the render (asserted)."""
    from nerfstudio_tpu.models.base_model import render_camera as jrender_camera
    from nerfstudio_torch.engine import trainer as ttrainer
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    jpipe, host_state, _, pipe, state, _ = photo_pair
    host_state = jax.tree_util.tree_map(np.copy, host_state)
    codes = host_state.params["params"]["field"]["embedding_appearance"]["embedding"]
    codes["embedding"] = np.random.default_rng(2).normal(0, 1, codes["embedding"].shape).astype(np.float32)
    ttrainer.restore_train_state(pipe, state, trainer_checkpoint_from_jax(host_state, pipe.model, state.optimizer))
    cam_idx = 0
    apply = jax.jit(lambda p, rb, aux: jpipe.model_eval.apply(p, rb, key=None, model_aux=aux))
    ref = jrender_camera(lambda rb: apply(host_state.params, rb, host_state.aux), jpipe.datamanager.eval_cameras,
                         cam_idx, 128)
    got = {k: v.numpy() for k, v in pipe.render_eval_camera(state, cam_idx, 128).items()}
    err = np.abs(got["rgb"] - np.asarray(ref["rgb"]))
    assert err.mean() <= 5e-3 and (err.max(axis=-1) <= 5e-2).mean() >= 0.99, err.mean()
    for k in ("accumulation", "expected_depth"):
        assert np.abs(got[k] - np.asarray(ref[k])).mean() <= 1e-3, k
    with torch.no_grad():
        pipe.model.field.embedding_appearance.embedding.weight.zero_()
    zeroed = pipe.render_eval_camera(state, cam_idx, 128)["rgb"].numpy()
    assert np.abs(zeroed - got["rgb"]).mean() > 10 * err.mean()


# -- configs --------------------------------------------------------------------


def _leaves(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        if f.name.startswith("_") or f.name == "optimizers":
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


@pytest.mark.parametrize("method", ["depth-nerfacto", "semantic-nerfw", "phototourism"])
def test_method_config_equals_jax(method):
    """``get_method`` at JAX's shipped values: every trainer, datamanager and
    model field the two share, the dataset kind, the optimizer groups; the
    parser JAX ships, field for field (sitcoms3d's for semantic-nerfw,
    phototourism's for phototourism), which sets up into its parser."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_torch.configs.method_configs import get_method

    jcfg, tcfg = jget_method(method), get_method(method)
    j, t = _leaves(jcfg), _leaves(tcfg)
    for part in ("trainer.", "datamanager.", "model."):
        shared = {k for k in set(j) & set(t) if k.startswith(part)}
        assert {k: t[k] for k in shared} == {k: j[k] for k in shared}, part
        if part != "model.":
            assert shared == {k for k in j if k.startswith(part)}, part
    assert len({k for k in set(j) & set(t) if k.startswith("model.")}) >= 50
    assert tcfg.dataset == jcfg.dataset and type(tcfg.model).__name__ == type(jcfg.model).__name__
    assert set(tcfg.optimizers) == set(jcfg.optimizers)
    for g, jo in jcfg.optimizers.items():
        to = tcfg.optimizers[g]
        assert (to["optimizer"].lr, to["optimizer"].eps) == (jo["optimizer"].lr, jo["optimizer"].eps), g
        for f in dataclasses.fields(to["scheduler"]):
            assert getattr(to["scheduler"], f.name) == getattr(jo["scheduler"], f.name), (g, f.name)
    if method == "depth-nerfacto":
        assert t["dataparser.load_3D_points"] and {k: t[k] for k in t if k.startswith("dataparser.")} == \
            {k: j[k] for k in j if k.startswith("dataparser.")}
    else:
        name = {"semantic-nerfw": "Sitcoms3D", "phototourism": "Phototourism"}[method]
        assert type(tcfg.dataparser).__name__ == type(jcfg.dataparser).__name__ == f"{name}DataParserConfig"
        assert {k: t[k] for k in t if k.startswith("dataparser.")} == \
            {k: j[k] for k in j if k.startswith("dataparser.")}
        assert type(tcfg.dataparser.setup()).__name__.startswith(name)
