"""The bilateral grid (``model_components/bilateral_grid.py``) against the
JAX package's functions (those of tests/model_components/test_bilateral_grid.py),
on the CPU, from numpy inputs made from a seed.

Tolerances: the identity init exactly; the slice within 1e-6 absolute and
its VJP into the grid and into rgb (through the affine product and the luma
guidance's sample weights) within 1e-5 of each gradient's peak (K8's gather
cotangents add in another order); TV within 1e-6 relative of its float64
value and 2e-5 of JAX's (whose float32 mean of ~10^5 terms is itself
1.2e-5 off float64 at these inputs); ``color_correct`` within 1e-4 absolute: a 10x10 ridge solve
in float32 whose normal equations sum 40,000 pixels in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_tpu.model_components import bilateral_grid as jbg
from nerfstudio_torch.model_components import bilateral_grid as tbg

GRAD_REL = 1e-5


def _grids(seed, n=3, noise=0.1):
    rng = np.random.default_rng(seed)
    g = np.asarray(jbg.init_bilateral_grid(n))
    return (g + rng.normal(0, noise, g.shape)).astype(np.float32)


def test_init_is_the_identity_as_jax():
    for n, x, y, w in ((2, 16, 16, 8), (1, 4, 5, 3)):
        want = np.asarray(jbg.init_bilateral_grid(n, x, y, w))
        got = tbg.init_bilateral_grid(n, x, y, w, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    rgb = np.random.default_rng(0).uniform(size=(16, 16, 3)).astype(np.float32)
    out = tbg.slice_bilateral_grid(tbg.init_bilateral_grid(1, device="cpu")[0], torch.from_numpy(rgb))
    np.testing.assert_allclose(out.numpy(), rgb, atol=1e-6)


@pytest.mark.parametrize("hw", [(40, 30), (48, 64)])
def test_slice_and_its_vjp_match_jax(hw):
    """One image's grid over a render, values and the VJP into the grid
    and into rgb; pixels at 0 and 1 (the luma clip's bounds) included."""
    rng = np.random.default_rng(hw[0])
    grids = _grids(hw[1])
    rgb = rng.uniform(size=hw + (3,)).astype(np.float32)
    rgb[0, :4] = 0.0
    rgb[1, :4] = 1.0
    jout, pull = jax.vjp(lambda g, r: jbg.slice_bilateral_grid(g[1], r), jnp.asarray(grids), jnp.asarray(rgb))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jg, jr = pull(jnp.asarray(cot))
    g, r = torch.from_numpy(grids).requires_grad_(True), torch.from_numpy(rgb).requires_grad_(True)
    out = tbg.slice_bilateral_grid(g[1], r)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-6)
    for name, a, b in (("grids", g.grad, jg), ("rgb", r.grad, jr)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= GRAD_REL * np.abs(b).max(), name
    assert not g.grad[0].any() and not g.grad[2].any()


def test_slice_takes_given_pixel_coordinates():
    rng = np.random.default_rng(5)
    grids, rgb = _grids(5), rng.uniform(size=(6, 7, 3)).astype(np.float32)
    xy = rng.uniform(size=(6, 7, 2)).astype(np.float32)
    want = jbg.slice_bilateral_grid(jnp.asarray(grids[0]), jnp.asarray(rgb), jnp.asarray(xy))
    got = tbg.slice_bilateral_grid(torch.from_numpy(grids[0]), torch.from_numpy(rgb), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_tv_loss_and_its_gradient_match_jax():
    grids = _grids(7, n=4)
    assert float(tbg.bilateral_grid_tv_loss(tbg.init_bilateral_grid(2, device="cpu"))) == 0.0
    jv, jg = jax.value_and_grad(jbg.bilateral_grid_tv_loss)(jnp.asarray(grids))
    g = torch.from_numpy(grids).requires_grad_(True)
    v = tbg.bilateral_grid_tv_loss(g)
    v.backward()
    exact = sum(np.mean(np.diff(grids.astype(np.float64), axis=a) ** 2) for a in (-3, -2, -1))
    assert abs(float(v.detach()) - exact) <= 1e-6 * exact
    assert abs(float(v.detach()) - float(jv)) <= 2e-5 * float(jv)
    jg = np.asarray(jg)
    assert np.abs(g.grad.numpy() - jg).max() <= GRAD_REL * np.abs(jg).max()


@pytest.mark.parametrize("case", ["affine", "quadratic", "noisy"])
def test_color_correct_matches_jax(case):
    """The post-hoc fit of a render to its ground truth at 200^2, the
    gate scenes' size."""
    rng = np.random.default_rng(len(case))
    ref = rng.uniform(size=(200, 200, 3)).astype(np.float32)
    if case == "affine":
        img = np.clip(ref * 0.8 + 0.07, 0, 1)
    elif case == "quadratic":
        img = np.clip(ref ** 2 * 0.9 + 0.05 * ref[..., ::-1], 0, 1)
    else:
        img = np.clip(ref * 1.2 - 0.1 + rng.normal(0, 0.05, ref.shape), 0, 1)
    img = img.astype(np.float32)
    want = np.asarray(jbg.color_correct(jnp.asarray(img), jnp.asarray(ref)))
    got = tbg.color_correct(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    assert got.shape == img.shape
    assert np.abs(got - want).max() <= 1e-4
    assert np.mean((got - ref) ** 2) < np.mean((img - ref) ** 2)
