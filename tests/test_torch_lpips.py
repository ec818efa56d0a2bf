"""The port's LPIPS against the JAX package's on the same images (numpy,
from a seed): the random-VGG filters bit-identical, the metric in both
modes within 1e-5 relative (a random-weight ``.npz`` in place of real
weights; odd image sizes check the pools' floors), the mode's name, and
the eval's rule for reporting it (``lpips`` with real weights,
``lpips_rand_vgg`` only with ``NST_LPIPS_FALLBACK_METRIC=1``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)
import torch

from nerfstudio_tpu.utils import lpips as jlp
from nerfstudio_torch.utils import lpips as tlp
from nerfstudio_torch.utils import metrics as tmetrics

SIZES = [(24, 32), (35, 29)]  # the second: odd sides, so every pool floors


def _pair(hw, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=hw + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


def test_random_vgg_filters_are_bit_identical():
    ref = jlp._rand_vgg_params()
    got = tlp.rand_vgg_arrays()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(torch.as_tensor(got[k], dtype=torch.float32).numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("hw", SIZES)
def test_random_vgg_lpips_matches(hw, monkeypatch):
    monkeypatch.delenv("NST_LPIPS_WEIGHTS", raising=False)
    a, b = _pair(hw, 0)
    fn, name = tlp.lpips_fn()
    assert name == "lpips_rand_vgg"
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    ref = jlp._lpips_rand(jnp.asarray(a), jnp.asarray(b))
    assert _rel(got, ref) <= 1e-5, (float(got), float(ref))
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) == 0.0
    assert _rel(tmetrics.lpips(torch.from_numpy(a), torch.from_numpy(b)), ref) <= 1e-5


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """Random weights in the converted file's layout: every conv's filter
    and bias, positive linear heads."""
    rng = np.random.default_rng(7)
    arrays = {}
    for k, v in tlp.rand_vgg_arrays().items():
        if k.startswith("lin"):
            arrays[k] = rng.uniform(0, 2.0 / v.shape[1], v.shape).astype(np.float32)
        else:
            arrays[k] = (rng.normal(size=v.shape) * (np.std(v) if k.endswith("_w") else 0.05)).astype(np.float32)
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"
    np.savez(path, **arrays)
    return path, arrays


@pytest.mark.parametrize("hw", SIZES)
def test_real_weights_lpips_matches(hw, weights_file, monkeypatch):
    path, arrays = weights_file
    monkeypatch.setenv("NST_LPIPS_WEIGHTS", str(path))
    a, b = _pair(hw, 1)
    fn, name = tlp.lpips_fn()
    assert name == "lpips"
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    ref = jlp._lpips_real(jnp.asarray(a), jnp.asarray(b), {k: jnp.asarray(v) for k, v in arrays.items()})
    assert _rel(got, ref) <= 1e-5, (float(got), float(ref))


def test_eval_reports_lpips_under_the_reference_rule(weights_file, monkeypatch):
    a, b = (torch.from_numpy(x) for x in _pair((24, 32), 2))
    monkeypatch.delenv("NST_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("NST_LPIPS_FALLBACK_METRIC", raising=False)
    assert tlp.eval_lpips(a, b) == {}
    monkeypatch.setenv("NST_LPIPS_FALLBACK_METRIC", "1")
    assert set(tlp.eval_lpips(a, b)) == {"lpips_rand_vgg"}
    monkeypatch.setenv("NST_LPIPS_WEIGHTS", str(weights_file[0]))
    assert set(tlp.eval_lpips(a, b)) == {"lpips"}
    monkeypatch.delenv("NST_LPIPS_FALLBACK_METRIC")
    assert set(tlp.eval_lpips(a, b)) == {"lpips"}
    monkeypatch.setenv("NST_LPIPS_WEIGHTS", str(weights_file[0].parent / "missing.npz"))
    assert tlp.eval_lpips(a, b) == {}


def test_tf32_setting_is_restored():
    a, b = (torch.from_numpy(x) for x in _pair((24, 32), 3))
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        tlp.lpips_with(a, b, {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in tlp.rand_vgg_arrays().items()})
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
