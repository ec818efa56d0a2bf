"""The hand-written kernels' backwards under a double backward. K7's
(``_FlatEncode``), K4's (``_ProjectGaussians``) and K6's
(``_BlendSaturating``) are once differentiable: their CUDA kernels return
gradients with no graph, so a ``create_graph=True`` backward must give
gradients whose own backward raises, on the CPU twins as on the card,
instead of treating the kernels' gradients as constants. K1's is
differentiable twice (its backward is a Function whose backward is K1bb,
which the density-gradient normals need) in the positions; a gradient
through its table gradient raises. The first-order gradients stay what the
twins' backward functions compute, bit for bit."""

import math

import pytest
import torch

from nerfstudio_torch.ops import hash_grid
from nerfstudio_torch.ops.gsplat import projection, rasterize

GEOM = dict(num_levels=4, min_res=4, max_res=64, hash_table_size=2**12)


def _hash_inputs(block: bool):
    gen = torch.Generator().manual_seed(0)
    pos = torch.rand((300, 3), generator=gen).requires_grad_(True)
    rows = GEOM["hash_table_size"] * 2 // 128  # F = 2
    table = (torch.rand((GEOM["num_levels"], rows, 128), generator=gen) * 2 - 1).requires_grad_(True)
    return pos, table


@pytest.mark.parametrize("block", [True, False], ids=["K1", "K7"])
def test_hash_encode_double_backward_raises(block):
    """K1 (block layout) and K7 (flat): the gradients of half the encoding's
    squared norm, taken with ``create_graph=True`` (the cotangent, the
    encoding itself, then carries a graph), equal the ones of a plain
    backward bit for bit and the twin's own backward. K7: backpropagating
    through them raises ``RuntimeError``. K1: backpropagating through the
    position gradient runs and equals autograd through the twice
    differentiable twin (``create_graph=True``) within float32 summation
    order (1e-5 of the peak); through the table gradient it raises
    ``NotImplementedError``."""
    pos, table = _hash_inputs(block)
    out = hash_grid.hash_encode(pos, table, block=block, **GEOM)
    g_pos, g_table = torch.autograd.grad(0.5 * out.square().sum(), (pos, table), create_graph=True)
    plain = torch.autograd.grad(0.5 * hash_grid.hash_encode(pos, table, block=block, **GEOM).square().sum(),
                                (pos, table))
    assert torch.equal(g_pos, plain[0]) and torch.equal(g_table, plain[1])
    cot = out.detach()
    geom = {k: v for k, v in GEOM.items() if k != "num_levels"}
    if block:
        twin = hash_grid._block_stochastic_twin_bwd(pos.detach(), table.detach(), cot, [1.0] * 4,
                                                    need_positions=True, **geom)
    else:
        twin = hash_grid._flat_twin_bwd(pos.detach(), table.detach(), cot, need_positions=True, need_table=True,
                                        **geom)
    assert torch.equal(g_table, twin[0]) and torch.equal(g_pos, twin[1])
    assert g_pos.requires_grad and g_table.requires_grad
    if block:
        got = torch.autograd.grad(g_pos.square().sum(), (pos, table), retain_graph=True)
        again = hash_grid.hash_encode(pos, table, block=True, **GEOM)
        _, twin_pos = hash_grid._block_stochastic_twin_bwd(pos, table, again, [1.0] * 4, create_graph=True, **geom)
        ref = torch.autograd.grad(twin_pos.square().sum(), (pos, table))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
        assert float(got[1].abs().max()) > 0
        with pytest.raises(NotImplementedError, match="table gradient"):
            g_table.square().sum().backward()
        return
    with pytest.raises(RuntimeError, match="once_differentiable"):
        (g_pos.square().sum() + g_table.square().sum()).backward()


def _splat_inputs(n=24):
    gen = torch.Generator().manual_seed(2)
    means = (torch.rand((n, 3), generator=gen) - 0.5) * torch.tensor([1.0, 1.0, 0.5]) + torch.tensor([0, 0, 3.0])
    scales = torch.full((n, 3), 0.08) * (1 + torch.rand((n, 3), generator=gen))
    quats = torch.nn.functional.normalize(torch.randn((n, 4), generator=gen), dim=-1)
    return [x.requires_grad_(True) for x in (means, scales, quats)]


def test_project_gaussians_double_backward_raises():
    """K4: gradients taken with ``create_graph=True`` equal a plain
    backward's bit for bit; their own backward raises."""
    means, scales, quats = _splat_inputs()
    cam = (32.0, 32.0, 16.0, 16.0, 32, 32)
    outs = projection.project_gaussians(means, scales, quats, torch.eye(4), *cam)
    loss = outs[0].square().sum() + outs[1].sum() + outs[2].sum()
    grads = torch.autograd.grad(loss, (means, scales, quats), create_graph=True)
    outs = projection.project_gaussians(means, scales, quats, torch.eye(4), *cam)
    plain = torch.autograd.grad(outs[0].square().sum() + outs[1].sum() + outs[2].sum(), (means, scales, quats))
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    with pytest.raises(RuntimeError, match="once_differentiable"):
        sum(g.square().sum() for g in grads).backward()


def test_blend_double_backward_raises():
    """K6 through ``rasterize``: the colours' and opacities' gradients with
    ``create_graph=True`` equal a plain backward's; their own backward
    raises."""
    means, scales, quats = _splat_inputs()
    with torch.no_grad():
        m2, depths, conics, radii, valid, _ = projection.project_gaussians(
            means, scales, quats, torch.eye(4), 32.0, 32.0, 16.0, 16.0, 32, 32)
    assert bool(valid.any())
    gen = torch.Generator().manual_seed(3)
    colors = torch.rand((m2.shape[0], 3), generator=gen).requires_grad_(True)
    opac = torch.full((m2.shape[0],), 0.6).requires_grad_(True)

    def loss():
        rgb, alpha, _ = rasterize.rasterize(m2, conics, colors, opac, depths, radii, valid, width=32, height=32)
        return (rgb * rgb).sum() + alpha.sum() * math.pi

    grads = torch.autograd.grad(loss(), (colors, opac), create_graph=True)
    plain = torch.autograd.grad(loss(), (colors, opac))
    assert all(torch.equal(a, b) for a, b in zip(grads, plain)) and float(grads[0].detach().abs().sum()) > 0
    with pytest.raises(RuntimeError, match="once_differentiable"):
        sum(g.square().sum() for g in grads).backward()
