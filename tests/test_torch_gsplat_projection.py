"""K4 (EWA projection): the port's plain PyTorch twin against the JAX
package's ``project_gaussians``, values and VJP, classic and antialiased, on
the CPU.

Tolerances: means2d, depths, conics and compensations within 1e-5 of each
output's peak (the two sides run the same float32 operations; the
quaternion norm and the viewmat product may sum in another order). radii and valid are equal except
where ceil's argument lies within 1e-5 of an integer. The VJP within 1e-5 of
each gradient's peak. The CUDA kernels are held against this twin on the
card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_tpu.ops.gsplat import projection as jproj
from nerfstudio_torch.ops.gsplat import projection as tproj

REL = 1e-5
W, H = 64, 48
FX = FY = np.float32(1.2 * W)
CX, CY = np.float32(W / 2), np.float32(H / 2)


def _c2w():
    pos = np.array([2.5, 0.4, 1.2])
    fwd = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, pos], -1).astype(np.float32)


def _gaussians(n=2000, seed=0):
    """Random gaussians around the origin, plus one behind the camera, one
    off screen, one near z = 0 and one with a zero-norm-ish quaternion."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.5, -1.0, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    c2w = _c2w()
    cam, fwd = c2w[:, 3], c2w[:, 2]  # OpenGL: the camera looks along -z
    means[0] = cam + 3.0 * fwd  # behind the camera
    means[1] = cam - 2.0 * fwd + 5.0 * c2w[:, 0]  # in front, far off screen
    means[2] = cam - 1e-7 * fwd  # at z ~ 0
    quats[3] = [1e-9, 0.0, 0.0, 0.0]
    return means, scales, quats


def _both(means, scales, quats, antialiased=False):
    c2w = _c2w()
    jv = jproj.get_viewmat(jnp.asarray(c2w))
    tv = tproj.get_viewmat(torch.from_numpy(c2w))
    j = jproj.project_gaussians(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), jv,
                                FX, FY, CX, CY, W, H, antialiased=antialiased)
    t = tproj.project_gaussians(torch.from_numpy(means), torch.from_numpy(scales), torch.from_numpy(quats), tv,
                                FX, FY, CX, CY, W, H, antialiased=antialiased)
    return jv, tv, j, t


def test_rotmat_cov3d_viewmat_match_jax():
    means, scales, quats = _gaussians(64)
    np.testing.assert_allclose(tproj.quat_to_rotmat(torch.from_numpy(quats)).numpy(),
                               np.asarray(jproj.quat_to_rotmat(jnp.asarray(quats))), atol=1e-6)
    np.testing.assert_allclose(
        tproj.compute_cov3d(torch.from_numpy(scales), torch.from_numpy(quats)).numpy(),
        np.asarray(jproj.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))), rtol=1e-5, atol=1e-9)
    jv, tv, _, _ = _both(means, scales, quats)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_values_match_jax(antialiased):
    """Values of every gaussian in front of the camera. Behind it (z <=
    1e-6) the projection divides by 1e-6, so an ulp of a camera-frame
    coordinate becomes pixels; those gaussians are invalid on both sides and
    emit no tile key."""
    means, scales, quats = _gaussians()
    _, _, j, t = _both(means, scales, quats, antialiased)
    front = np.asarray(j[1]) > 1e-3
    assert (np.asarray(j[5]) < 1).any() == antialiased
    for name, a, b in zip(("means2d", "depths", "conics", "compensations"), j[:3] + j[5:], t[:3] + t[5:]):
        a, b = np.asarray(a)[front], b.numpy()
        assert np.isfinite(b).all(), name
        b = b[front]
        assert np.abs(a - b).max() <= REL * np.abs(a).max(), name
    # radii (ceil of 3 sqrt(v1)) and valid may flip only where ceil's
    # argument is within 1e-5 of an integer
    jr, tr = np.asarray(j[3]), t[3].numpy()
    jvalid, tvalid = np.asarray(j[4]), t[4].numpy()
    cov = np.asarray(j[2])
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    a, b_, c = cov[:, 2] / det, -cov[:, 1] / det, cov[:, 0] / det  # cov2d from the conic
    half = 0.5 * (a + c)
    arg = 3.0 * np.sqrt(half + np.sqrt(np.maximum(half * half - (a * c - b_ * b_), 0.01)))
    near_int = np.abs(arg - np.round(arg)) < 1e-5
    differ = (jr != tr) | (jvalid != tvalid)
    assert not (differ & ~near_int).any(), np.nonzero(differ & ~near_int)
    assert not tvalid[0] and not tvalid[1] and not tvalid[2]
    assert tvalid.sum() > 500


@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_vjp_matches_jax(antialiased):
    """The VJP into means, scales and quats from cotangents on means2d,
    depths, conics and, antialiased, the compensations."""
    means, scales, quats = _gaussians(seed=1)
    rng = np.random.default_rng(2)
    _, _, j, _ = _both(means, scales, quats, antialiased)
    valid = np.asarray(j[4])
    # cotangents as the blend gives them: only visible gaussians get one
    outs = (0, 1, 2, 5) if antialiased else (0, 1, 2)
    cots = [rng.normal(size=np.shape(j[i])).astype(np.float32) * valid.reshape((-1,) + (1,) * (np.ndim(j[i]) - 1))
            for i in outs]
    c2w = _c2w()
    jv = jproj.get_viewmat(jnp.asarray(c2w))
    _, pull = jax.vjp(lambda m, s, q: tuple(jproj.project_gaussians(
        m, s, q, jv, FX, FY, CX, CY, W, H, antialiased=antialiased)[i] for i in outs),
                      jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats))
    jgrads = pull(tuple(jnp.asarray(c) for c in cots))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (means, scales, quats)]
    out = tproj.project_gaussians(*leaves, tproj.get_viewmat(torch.from_numpy(c2w)), FX, FY, CX, CY, W, H,
                                  antialiased=antialiased)
    tgrads = torch.autograd.grad([out[i] for i in outs], leaves, [torch.from_numpy(c) for c in cots])
    for name, a, b in zip(("means", "scales", "quats"), jgrads, tgrads):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), name
        assert np.abs(a - b).max() <= REL * np.abs(a).max(), (name, np.abs(a - b).max(), np.abs(a).max())
        assert np.abs(b[~valid]).max() == 0.0, name


def test_projection_checks_inputs():
    means, scales, quats = (torch.from_numpy(x) for x in _gaussians(8))
    vm = torch.eye(4)
    with pytest.raises(ValueError, match="quats"):
        tproj.project_gaussians(means, scales, quats[:, :3], vm, 10.0, 10.0, 8.0, 8.0, 16, 16)
    with pytest.raises(ValueError, match="float32"):
        tproj.project_gaussians(means.double(), scales, quats, vm, 10.0, 10.0, 8.0, 8.0, 16, 16)


def _vjp_both(means, scales, quats, c2w, cots, outs, antialiased, fx=FX, fy=FY):
    """JAX's and the port's VJP into (means, scales, quats, c2w) through
    get_viewmat, as the camera-opt step differentiates the corrected pose."""
    _, pull = jax.vjp(lambda m, s, q, c: tuple(jproj.project_gaussians(
        m, s, q, jproj.get_viewmat(c), fx, fy, CX, CY, W, H, antialiased=antialiased)[i] for i in outs),
                      *(jnp.asarray(x) for x in (means, scales, quats, c2w)))
    jgrads = pull(tuple(jnp.asarray(c) for c in cots))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (means, scales, quats, c2w)]
    out = tproj.project_gaussians(*leaves[:3], tproj.get_viewmat(leaves[3]), fx, fy, CX, CY, W, H,
                                  antialiased=antialiased)
    tgrads = torch.autograd.grad([out[i] for i in outs], leaves, [torch.from_numpy(c) for c in cots])
    return jgrads, tgrads


@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_viewmat_vjp_matches_jax(antialiased):
    """The VJP into the camera (c2w through get_viewmat) beside means,
    scales and quats, against ``jax.vjp`` of the reference, every
    gradient within 1e-5 of its peak (the viewmat's sums over the 2000
    gaussians in another order)."""
    means, scales, quats = _gaussians(seed=3)
    rng = np.random.default_rng(4)
    _, _, j, _ = _both(means, scales, quats, antialiased)
    valid = np.asarray(j[4])
    outs = (0, 1, 2, 5) if antialiased else (0, 1, 2)
    cots = [rng.normal(size=np.shape(j[i])).astype(np.float32) * valid.reshape((-1,) + (1,) * (np.ndim(j[i]) - 1))
            for i in outs]
    jgrads, tgrads = _vjp_both(means, scales, quats, _c2w(), cots, outs, antialiased)
    for name, a, b in zip(("means", "scales", "quats", "c2w"), jgrads, tgrads):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all() and np.abs(a).max() > 0, name
        assert np.abs(a - b).max() <= REL * np.abs(a).max(), (name, np.abs(a - b).max(), np.abs(a).max())


def test_projection_viewmat_vjp_at_the_clip_limits():
    """Gaussians whose screen coordinate sits exactly on the EWA clip limit
    (an axis-aligned camera at the origin, z = 1 exactly): JAX's clip passes
    half the gradient there, and so does the port, into the means and into
    the camera."""
    c2w = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)  # looks along -z
    lim_x = np.float32(1.3) * (np.float32(W) / (np.float32(2.0) * FX))
    lim_y = np.float32(1.3) * (np.float32(H) / (np.float32(2.0) * FY))
    means = np.array([[lim_x, 0.0, -1.0], [-lim_x, 0.1, -1.0], [0.05, lim_y, -1.0], [0.2, -lim_y, -1.0],
                      [0.1, 0.1, -2.0]], np.float32)
    rng = np.random.default_rng(6)
    scales = np.full((5, 3), 0.05, np.float32) * rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32)
    quats = rng.normal(size=(5, 4)).astype(np.float32)
    cots = [rng.normal(size=(5, 2)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32),
            rng.normal(size=(5, 3)).astype(np.float32)]
    jgrads, tgrads = _vjp_both(means, scales, quats, c2w, cots, (0, 1, 2), False)
    for name, a, b in zip(("means", "scales", "quats", "c2w"), jgrads, tgrads):
        a, b = np.asarray(a), b.numpy()
        assert np.abs(a - b).max() <= REL * np.abs(a).max(), (name, np.abs(a - b).max(), np.abs(a).max())


def test_twin_takes_one_viewmat_per_gaussian():
    """A viewmat per gaussian (N, 4, 4), as chip_smoke.py uses it for the
    viewmat gradient's rounding bound: the same outputs, and its gradient
    summed over the gaussians is the shared viewmat's."""
    means, scales, quats = (torch.from_numpy(x) for x in _gaussians(300, seed=5))
    vm = tproj.get_viewmat(torch.from_numpy(_c2w()))
    cam = (vm, FX, FY, CX, CY, W, H, 0.01, 0.3, False)
    out = tproj._project_twin(means, scales, quats, *cam)
    per = tproj._project_twin(means, scales, quats, vm.expand(300, 4, 4), *cam[1:])
    for a, b in zip(out, per):
        assert torch.equal(a, b)
    rng = np.random.default_rng(7)
    cots = [torch.from_numpy(rng.normal(size=tuple(out[i].shape)).astype(np.float32)) * out[4].view(
        (-1,) + (1,) * (out[i].ndim - 1)) for i in (0, 1, 2, 5)]
    g = tproj._project_twin_bwd(means.double(), scales.double(), quats.double(), cam,
                                *(c.double() for c in cots), need_viewmat=True)
    g_per = tproj._project_twin_bwd(means.double(), scales.double(), quats.double(), (vm.expand(300, 4, 4),) + cam[1:],
                                    *(c.double() for c in cots), need_viewmat=True)
    assert g[3].shape == (4, 4) and g_per[3].shape == (300, 4, 4)
    torch.testing.assert_close(g_per[3].sum(0), g[3], rtol=1e-12, atol=1e-12)
    assert not g[3][3].any()
