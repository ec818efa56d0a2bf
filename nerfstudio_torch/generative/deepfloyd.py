"""DeepFloyd IF SDS wrapper (counterpart of
``nerfstudio_tpu/generative/deepfloyd.py``). Pixel-space diffusion (no
VAE): the SDS gradient applies directly to the rendered 64x64 image; T5
text embeddings. Gated on diffusers and local weights as the Stable
Diffusion wrapper is; the timestep and noise are handed in or drawn from a
``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch

from nerfstudio_torch.generative.schedules import (
    DDPMSchedule,
    classifier_free_guidance,
    sample_timestep,
    sds_gradient,
)
from nerfstudio_torch.utils.device import resolve_device

IMG_DIM = 64


def available() -> bool:
    try:
        import diffusers  # noqa: F401

        return True
    except ImportError:
        return False


class DeepFloyd:
    """Pixel-space SDS guidance. ``pipe`` holds ``encode_prompt``, the
    text encoder and ``unet``; its UNet's device is the wrapper's."""

    def __init__(self, guidance_scale: float = 100.0, device=None):
        if not available():
            raise RuntimeError("diffusers/torch weights unavailable; use generative.sds.load_guidance()")
        from diffusers import DiffusionPipeline

        device = resolve_device(device)
        self.pipe = DiffusionPipeline.from_pretrained("DeepFloyd/IF-I-XL-v1.0", local_files_only=True).to(device)
        self.guidance_scale = guidance_scale
        self.schedule = DDPMSchedule(kind="linear", beta_start=0.0001, beta_end=0.02)

    def get_text_embeds(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        emb, neg = self.pipe.encode_prompt(prompt, negative_prompt=negative_prompt)
        return torch.cat([neg, emb])

    def delete_text_encoder(self) -> None:
        """Free the T5 once the embeddings are cached."""
        self.pipe.text_encoder = None

    def sds_grad(self, rgb: torch.Tensor, text_embedding, guidance_scale: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                 t: Optional[int] = None) -> torch.Tensor:
        """Pixel-space SDS, w(t)(eps_pred - eps) on the (H, W, 3) image;
        ``t`` and ``noise`` (H, W, 3) drawn from ``generator`` where not
        handed in."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        if t is None:
            t = sample_timestep(self.schedule, generator)
        device = next(self.pipe.unet.parameters()).device
        img = rgb.detach().to(device).float() * 2.0 - 1.0  # (H, W, 3) in [-1, 1]
        if noise is None:
            noise = torch.randn(img.shape, generator=generator, device=device)
        noise = noise.to(device, torch.float32)
        noisy = self.schedule.add_noise(img, noise, t)
        x = noisy.permute(2, 0, 1)[None]
        emb = torch.as_tensor(text_embedding, device=device).float()
        with torch.no_grad():
            eps = self.pipe.unet(torch.cat([x, x]), t, encoder_hidden_states=emb).sample[:, :3]
        eps_uncond, eps_text = eps.float().chunk(2)
        eps_cfg = classifier_free_guidance(eps_uncond[0].permute(1, 2, 0), eps_text[0].permute(1, 2, 0), gs)
        grad = sds_gradient(self.schedule, eps_cfg, noise, t)
        return (grad * 2.0).to(rgb.device)  # d(img_pm1)/d(rgb01) = 2
