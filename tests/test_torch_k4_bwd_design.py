"""K4's backward (``ops/gsplat/projection._project_bwd_kernel``) in its one
design for the card: one launch per call on both routes, the viewmat
gradient written by the kernel as a (4, 4) tensor. Pure Python on the CPU:
the wrapper's refusals raise before anything is launched (the C entry is
replaced by a recorder where a launch is reached), CPU tensors launch
nothing, and the twin's viewmat gradient has the kernel's shape. The
kernel itself is held against the float64 twin on the card by
``chip_smoke.py`` phase 47 and by the card test below, which skips here."""

import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (cuda_device: a fixture)
from nerfstudio_torch.ops.gsplat import _cuda
from nerfstudio_torch.ops.gsplat import projection as pj

W = H = 64
FOCAL = 1.2 * W
# the viewmat gradient's limit against float64: float32 roundings of the
# sum of each entry's |terms| (chip_smoke.K4_VIEW_ROUNDINGS)
VIEW_ROUNDINGS, U32 = 32, 2.0**-24


def _inputs(n, seed, device="cpu"):
    """Gaussians in front of a camera at (0.3, -0.2, 3) looking at the
    origin, anisotropic scales, random quaternions, and cotangents on the
    visible ones: (means, scales, quats, cam_args, cots)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.5, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    c2w = np.array([[1, 0, 0, 0.3], [0, 1, 0, -0.2], [0, 0, 1, 3.0]], np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    viewmat = pj.get_viewmat(t(c2w))
    cam = (viewmat, FOCAL, FOCAL, W / 2, H / 2, W, H, 0.01, 0.3, False)
    with torch.no_grad():
        out = pj._project_twin(t(means), t(scales), t(quats), *cam)
    valid = out[4].cpu().numpy()
    cots = [t(rng.normal(size=tuple(o.shape)).astype(np.float32) * valid.reshape((-1,) + (1,) * (o.ndim - 1)))
            for o in out[:3] + out[5:]]
    return t(means), t(scales), t(quats), cam, cots


@pytest.fixture
def recorded(monkeypatch):
    """Replace the C entry by a recorder: [(launch count name, C function,
    arguments)], counted as a launch is; the viewmat gradient's scratch is a
    CPU tensor."""
    calls = []

    def launch(name, fn, device, *args):
        calls.append((name, fn, args))
        if name is not None:
            _cuda.launch_counts[name] += 1

    monkeypatch.setattr(_cuda, "launch", launch)
    monkeypatch.setattr(pj, "_bwd_scratch", lambda device: torch.zeros(64))
    _cuda.reset_launch_counts()
    return calls


def _misaligned(t):
    """A copy of ``t`` 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 4)[1 : t.numel() + 1].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("need_viewmat", [False, True])
def test_bwd_refuses_misaligned_quats_before_launching(recorded, need_viewmat):
    """The kernel reads each quaternion and writes its gradient as one
    16-byte access: quats off a 16-byte boundary raise ValueError in the
    wrapper, which launches nothing and counts nothing."""
    m, s, q, cam, cots = _inputs(64, 0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pj._project_bwd_kernel(m, s, _misaligned(q), cam, *cots, need_viewmat=need_viewmat)
    assert not recorded and not any(_cuda.launch_counts.values())


@pytest.mark.parametrize("shape", [(3, 4), (1, 4, 4)])
def test_bwd_refuses_a_viewmat_not_4x4(recorded, shape):
    """The kernel reads rows 0-2 of a row-major (4, 4) viewmat where it lies
    and writes d(viewmat) as (4, 4): another shape raises, with no launch."""
    m, s, q, cam, cots = _inputs(64, 1)
    bad = (cam[0].reshape(-1)[: int(np.prod(shape))].reshape(shape),) + cam[1:]
    with pytest.raises(ValueError, match="viewmat must be \\(4, 4\\)"):
        pj._project_bwd_kernel(m, s, q, bad, *cots, need_viewmat=True)
    assert not recorded and not any(_cuda.launch_counts.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bwd_launch_writes_the_viewmat_gradient(recorded, dtype):
    """With the viewmat gradient asked for, one launch of the C entry gets
    the scratch and a (4, 4) float32 d_viewmat, which the wrapper returns as
    it is (converted only for a viewmat of another dtype), and the launch is
    counted under both names; without it, neither pointer and one count."""
    m, s, q, cam, cots = _inputs(64, 2)
    cam = (cam[0].to(dtype),) + cam[1:]
    grads = pj._project_bwd_kernel(m, s, q, cam, *cots, need_viewmat=True)
    (name, fn, args), = recorded
    assert (name, fn) == ("project_gaussians_bwd", "nst_gsplat_project_bwd")
    assert args[-2] is not None and args[-1] is not None
    assert grads[3].shape == (4, 4) and grads[3].dtype == dtype
    if dtype == torch.float32:
        assert args[-1] == grads[3].data_ptr()
    assert _cuda.launch_counts["project_gaussians_bwd"] == 1
    assert _cuda.launch_counts["project_gaussians_bwd_viewmat"] == 1
    assert all(g.data_ptr() % 16 == 0 for g in grads[:3])
    assert pj._project_bwd_kernel(m, s, q, cam, *cots)[3] is None
    assert recorded[1][2][-2:] == (None, None)
    assert _cuda.launch_counts["project_gaussians_bwd"] == 2
    assert _cuda.launch_counts["project_gaussians_bwd_viewmat"] == 1


def test_cpu_tensors_launch_nothing():
    """On CPU tensors K4's forward and backward, with the viewmat gradient,
    run the twins: no launch is counted under any name."""
    m, s, q, cam, cots = _inputs(200, 3)
    _cuda.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for x in (m, s, q, cam[0])]
    out = pj.project_gaussians(*leaves, *cam[1:])
    torch.autograd.backward([out[0], out[1], out[2]], cots[:3])
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    assert not any(_cuda.launch_counts.values())


def test_twin_viewmat_gradient_is_4x4_with_a_zero_last_row():
    """The twin's d(viewmat), which the kernel's is held against, has the
    kernel's layout: (4, 4), its last row zero, rows 0-2 not."""
    m, s, q, cam, cots = _inputs(300, 4)
    d_view = pj._project_twin_bwd(m, s, q, cam, *cots, need_viewmat=True)[3]
    assert d_view.shape == (4, 4) and d_view.dtype == torch.float32
    assert not d_view[3].any() and d_view[:3].abs().min() > 0


@pytest.mark.parametrize("antialiased", [False, True])
def test_k4_bwd_routes_match_the_float64_twin_on_the_card(cuda_device, antialiased):
    """Both routes on the card against the float64 twin, with
    chip_smoke.py's limits: d_means, d_scales and d_quats within twice the
    float32 twin's error plus 1e-6 of the peak, d(viewmat) within twice the
    twin's error plus 32 float32 roundings of each entry's sum of |terms|,
    its last row zero; both routes give the same three gradients, and two
    runs the same bits. A last block with fewer than 256 gaussians."""
    m, s, q, cam, cots = _inputs(20_011, 5, cuda_device)
    cam = cam[:-1] + (antialiased,)
    cots = cots if antialiased else cots[:3] + [torch.zeros_like(cots[3])]
    got = pj._project_bwd_kernel(m, s, q, cam, *cots, need_viewmat=True)
    again = pj._project_bwd_kernel(m, s, q, cam, *cots, need_viewmat=True)
    default = pj._project_bwd_kernel(m, s, q, (cam[0].cpu(),) + cam[1:], *cots)
    twin = pj._project_twin_bwd(m, s, q, cam, *cots, need_viewmat=True)
    d64 = (m.double(), s.double(), q.double())
    c64 = [c.double() for c in cots]
    ref = pj._project_twin_bwd(*d64, cam, *c64, need_viewmat=True)
    per = pj._project_twin_bwd(*d64, (cam[0].double().expand(m.shape[0], 4, 4),) + cam[1:], *c64,
                               need_viewmat=True)[3]
    torch.cuda.synchronize()
    for k, a, b, r in zip(("means", "scales", "quats"), got, twin, ref):
        e_k, e_t = float((a.double() - r).abs().max()), float((b.double() - r).abs().max())
        assert e_k <= 2 * e_t + 1e-6 * float(r.abs().max()), k
    e_k, e_t = (got[3].double() - ref[3]).abs(), (twin[3].double() - ref[3]).abs()
    assert (e_k[:3] <= 2 * e_t[:3] + VIEW_ROUNDINGS * U32 * per.abs().sum(0)[:3]).all()
    assert not got[3][3].any()
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, c in zip(got[:3], default[:3]):
        assert torch.equal(a, c)
