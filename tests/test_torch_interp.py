"""K8 (``ops/interp.py``): the port's grid sampling and linear resize
against the JAX package's, values and gradients, on the CPU.

The reference's functions are plain ``jnp``; the port's are their plain
PyTorch twins with autograd. Tolerances: values within 1e-6 absolute (the
same float32 products, summed in the same order); gradients within 1e-5 of
their peak (the scatter of the gathers' cotangents adds in another order);
``resize_linear`` within 1e-6 (one weight matrix per axis, contracted in
another order). The lower edge is the reference's own, not
``F.grid_sample``'s border padding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_tpu.ops import interp as jinterp
from nerfstudio_torch.ops import interp as tinterp

GRAD_REL = 1e-5


def _coords(rng, shape, dims):
    """Coordinates over [-1.3, 1.3] (both edges crossed), with exact -1, 1
    and the lower edge's half-cell on every axis."""
    c = rng.uniform(-1.3, 1.3, shape + (dims,)).astype(np.float32) if dims else rng.uniform(
        -1.3, 1.3, shape).astype(np.float32)
    flat = c.reshape(-1, dims) if dims else c.reshape(-1, 1)
    flat[:3] = np.array([-1.0, 1.0, -1.05], np.float32)[:, None]
    return c


@pytest.mark.parametrize("which,grid_shape,dims", [
    ("1d", (5, 9), 0), ("2d", (4, 7, 6), 2), ("3d", (12, 8, 16, 16), 3), ("3d", (3, 5, 4, 7), 3),
])
def test_grid_sample_matches_jax(which, grid_shape, dims):
    """Values and the VJP into the grid and the coordinates."""
    rng = np.random.default_rng(len(grid_shape) + grid_shape[-1])
    grid = rng.normal(size=grid_shape).astype(np.float32)
    coords = _coords(rng, (30, 11), dims)
    jfn, tfn = getattr(jinterp, f"grid_sample_{which}"), getattr(tinterp, f"grid_sample_{which}")
    jout, pull = jax.vjp(jfn, jnp.asarray(grid), jnp.asarray(coords))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jg, jc = pull(jnp.asarray(cot))
    g, c = torch.from_numpy(grid).requires_grad_(True), torch.from_numpy(coords).requires_grad_(True)
    out = tfn(g, c)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-6)
    for name, a, b in (("grid", g.grad, jg), ("coords", c.grad, jc)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= GRAD_REL * np.abs(b).max(), name


def test_lower_edge_is_the_references_not_border_padding():
    """On a 1..8 ramp: 1.5 at x = -1 (the reference), where
    ``F.grid_sample(padding_mode="border")`` gives 1.0; the weight keeps its
    gradient there."""
    ramp = np.arange(1, 9, dtype=np.float32)[None]
    xs = np.array([-1.0, -1.2, -0.75, 1.0, 1.3], np.float32)
    want = np.asarray(jinterp.grid_sample_1d(jnp.asarray(ramp), jnp.asarray(xs)))[:, 0]
    c = torch.from_numpy(xs).requires_grad_(True)
    got = tinterp.grid_sample_1d(torch.from_numpy(ramp), c)[:, 0]
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert float(got[0].detach()) == 1.5
    border = torch.nn.functional.grid_sample(
        torch.from_numpy(ramp)[None, :, None, :], torch.tensor([[[[-1.0, 0.0]]]]), mode="bilinear",
        padding_mode="border", align_corners=False)
    assert float(border) == 1.0
    got.sum().backward()
    jgrad = jax.grad(lambda x: jnp.sum(jinterp.grid_sample_1d(jnp.asarray(ramp), x)))(jnp.asarray(xs))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    assert float(c.grad[0]) == 4.0  # d/dx of w * (2 - 1), x unnormalised by 8 / 2


@pytest.mark.parametrize("shape,new", [
    ((3, 8), (16,)), ((3, 8), (4,)), ((3, 8), (3,)), ((2, 5, 7), (11, 3)), ((2, 4, 6, 5), (8, 3, 5)),
    ((4, 300), (64,)), ((1, 64, 64, 64), (128, 32, 64)),
])
def test_resize_linear_matches_jax_image_resize(shape, new):
    """Up- and down-sizing, one axis or several, against the reference's
    ``jax.image.resize`` "linear" (antialiased when shrinking; not
    ``F.interpolate``'s edges), and its VJP."""
    rng = np.random.default_rng(sum(shape))
    grid = rng.normal(size=shape).astype(np.float32)
    jout, pull = jax.vjp(lambda g: jinterp.resize_linear(g, new), jnp.asarray(grid))
    g = torch.from_numpy(grid).requires_grad_(True)
    out = tinterp.resize_linear(g, new)
    assert tuple(out.shape) == (shape[0],) + new
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-6)
    cot = rng.normal(size=jout.shape).astype(np.float32)
    out.backward(torch.from_numpy(cot))
    jg = np.asarray(pull(jnp.asarray(cot))[0])
    assert np.abs(g.grad.numpy() - jg).max() <= GRAD_REL * np.abs(jg).max()


def test_resize_linear_refuses_a_wrong_rank():
    with pytest.raises(ValueError, match="spatial axes"):
        tinterp.resize_linear(torch.zeros(2, 4, 4), (8,))
