"""``chip_smoke.replay_sampler_weights``, which phase 67's step card vs CPU
uses to feed the CPU's PDF samplers the card's weights: it records each
call's weights, replays them in order (the samples then follow the
replayed weights bit for bit, whatever weights the caller passes), reports
each call's gap, refuses weights of another shape, and its undo restores
the sampler."""

import sys
from pathlib import Path

import pytest
import torch

import _torch_port  # noqa: F401  (the per-worker thread cap)
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.model_components.ray_samplers import PDFSampler, UniformSampler

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RAYS, COARSE, FINE = 8, 24, 16


def _inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    bundle = RayBundle(origins=torch.rand((RAYS, 3), generator=gen),
                       directions=torch.nn.functional.normalize(torch.randn((RAYS, 3), generator=gen), dim=-1),
                       pixel_area=torch.ones((RAYS, 1)), nears=torch.full((RAYS, 1), 0.05),
                       fars=torch.full((RAYS, 1), 4.0))
    coarse = UniformSampler(COARSE, single_jitter=True)(bundle, uniforms=torch.rand((RAYS, 1), generator=gen))
    weights = torch.rand((RAYS, COARSE, 1), generator=gen) ** 4
    return bundle, coarse, weights, torch.rand((RAYS, 1), generator=gen)


def _bins(bundle, coarse, weights, jitter):
    out = PDFSampler(num_samples=FINE, single_jitter=True)(bundle, coarse, weights, uniforms=jitter)
    return torch.cat([out.spacing_starts, out.spacing_ends[..., -1:, :]], dim=-2)


def test_records_then_replays_the_weights_bit_for_bit():
    call = PDFSampler.__call__
    bundle, coarse, weights, jitter = _inputs(0)
    other = weights * (1.0 + 1e-3 * torch.rand(weights.shape, generator=torch.Generator().manual_seed(1)))
    recorded, undo = chip_smoke.replay_sampler_weights()
    try:
        want = _bins(bundle, coarse, weights, jitter)
    finally:
        undo()
    assert PDFSampler.__call__ is call
    assert len(recorded) == 1 and torch.equal(recorded[0], weights)
    gaps, undo = chip_smoke.replay_sampler_weights(replay=recorded)
    try:
        got = _bins(bundle, coarse, other, jitter)
    finally:
        undo()
    assert PDFSampler.__call__ is call
    assert torch.equal(got, want)
    assert not torch.equal(_bins(bundle, coarse, other, jitter), want)
    assert gaps == [pytest.approx(float((other - weights).abs().max()), rel=0, abs=0)]


def test_refuses_weights_of_another_shape():
    bundle, coarse, weights, jitter = _inputs(2)
    gaps, undo = chip_smoke.replay_sampler_weights(replay=[weights[:, :-1]])
    try:
        with pytest.raises(AssertionError, match="PDF sampler call 0"):
            _bins(bundle, coarse, weights, jitter)
    finally:
        undo()
    assert gaps == []
