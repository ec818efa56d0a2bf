"""Score-distillation guidance facade for text-to-3D (counterpart of
``nerfstudio_tpu/generative/sds.py``).

Backends: ``generative/stable_diffusion.py`` (latent SDS) and
``generative/deepfloyd.py`` (pixel SDS), both gated on diffusers and local
weights; the noise and guidance math lives in ``generative/schedules.py``
and the view-dependent prompting in ``generative/positional_text_embeddings.py``.
Without diffusers or local weights ``load_guidance`` falls back to a
weights-free stub, with a warning on stderr, so the generfacto pipeline
stays runnable end to end. Random draws come from an explicit
``torch.Generator`` or are handed in (``noise``, ``t``)."""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from nerfstudio_torch.generative.positional_text_embeddings import PositionalTextEmbeddings


class DiffusionGuidance:
    """The SDS guidance interface."""

    def text_embedding(self, prompt: str, negative_prompt: str = ""):
        raise NotImplementedError

    def sds_grad(self, rgb: torch.Tensor, text_embedding, guidance_scale: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                 t: Optional[int] = None) -> torch.Tensor:
        """d(SDS loss)/d(rgb image) for an (H, W, 3) render."""
        raise NotImplementedError


class StubGuidance(DiffusionGuidance):
    """Weights-free fallback: pulls renders toward a prompt-seeded colour.
    Keeps the SDS plumbing testable without model downloads."""

    def text_embedding(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        """The prompt's colour, (3,) float32 in [0.2, 0.8). The seed is
        ``abs(hash(prompt)) % 2**31`` as the reference takes it: Python salts
        ``hash`` of a string per process (``PYTHONHASHSEED``), so the colour
        is fixed within one process and changes between processes."""
        seed = abs(hash(prompt)) % (2**31)
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.uniform(0.2, 0.8, (3,)).astype(np.float32))

    def sds_grad(self, rgb, text_embedding, guidance_scale=None, generator=None, noise=None, t=None):
        """(rgb - colour + 0.1 eps) / rgb.numel(), eps standard normal of
        rgb's shape: ``noise`` where handed in, else drawn from
        ``generator``."""
        if noise is None:
            noise = torch.randn(rgb.shape, generator=generator, device=rgb.device)
        noise = noise.to(rgb.device) * 0.1
        return (rgb - text_embedding.to(rgb.device) + noise) / rgb.numel()


def load_guidance(backend: str = "stable-diffusion", device=None) -> DiffusionGuidance:
    """The backend the config names, its networks on ``device`` (None: the
    GPU); the stub, with a warning on stderr, when diffusers or its local
    weights are missing."""
    try:
        if backend == "deepfloyd":
            from nerfstudio_torch.generative.deepfloyd import DeepFloyd

            return DeepFloyd(device=device)
        from nerfstudio_torch.generative.stable_diffusion import StableDiffusion

        return StableDiffusion(device=device)
    except Exception:
        print(
            "[generfacto] WARNING: no diffusion weights found (diffusers/HF cache "
            "unavailable) — falling back to STUB guidance. The run will only pull "
            "renders toward a prompt-seeded color; it will NOT produce a real "
            "text-to-3D object. Install diffusers + download StableDiffusion or "
            "DeepFloyd weights for real SDS guidance.",
            file=sys.stderr,
            flush=True,
        )
        return StubGuidance()


__all__ = ["DiffusionGuidance", "StubGuidance", "load_guidance", "PositionalTextEmbeddings"]
