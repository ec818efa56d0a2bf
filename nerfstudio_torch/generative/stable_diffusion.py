"""Stable Diffusion SDS wrapper (counterpart of
``nerfstudio_tpu/generative/stable_diffusion.py``).

The SDS math (noise schedule, timestep band, classifier-free guidance,
w(t)(eps_pred - eps)) is ``generative/schedules.py``. The UNet, VAE and
text encoder load from a local HuggingFace cache (``local_files_only``) onto
the port's device; without diffusers ``available()`` is False and
``generative.sds.load_guidance`` falls back to the stub. The timestep and
the latent noise are handed in or drawn from a ``torch.Generator``."""

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

IMG_DIM = 512
LATENT_DIM = IMG_DIM // 8
CONST_SCALE = 0.18215  # the SD VAE's latent scale
SD_IDENTIFIERS = {
    "1-5": "runwayml/stable-diffusion-v1-5",
    "2-0": "stabilityai/stable-diffusion-2-base",
    "2-1": "stabilityai/stable-diffusion-2-1-base",
}


def available() -> bool:
    try:
        import diffusers  # noqa: F401

        return True
    except ImportError:
        return False


class StableDiffusion:
    """Latent-space SDS guidance. ``pipe`` holds ``tokenizer``,
    ``text_encoder``, ``vae`` and ``unet``; its networks' device is the
    wrapper's."""

    def __init__(self, version: str = "1-5", guidance_scale: float = 100.0, device=None):
        if not available():
            raise RuntimeError("diffusers/torch weights unavailable; use generative.sds.load_guidance()")
        from diffusers import StableDiffusionPipeline

        device = resolve_device(device)
        self.pipe = StableDiffusionPipeline.from_pretrained(SD_IDENTIFIERS[version], local_files_only=True).to(device)
        self.guidance_scale = guidance_scale
        self.schedule = DDPMSchedule(kind="scaled_linear")

    def _device(self) -> torch.device:
        return next(self.pipe.unet.parameters()).device

    # -- text ---------------------------------------------------------------
    def get_text_embeds(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        """(2, 77, D): [uncond, text], stacked for classifier-free guidance."""
        embeds = []
        for p in (negative_prompt, prompt):
            tok = self.pipe.tokenizer(
                p, padding="max_length", max_length=self.pipe.tokenizer.model_max_length,
                return_tensors="pt", truncation=True,
            )
            with torch.no_grad():
                embeds.append(self.pipe.text_encoder(tok.input_ids.to(self._device()))[0])
        return torch.cat(embeds)

    # -- latents ------------------------------------------------------------
    def imgs_to_latent(self, rgb01: torch.Tensor):
        """(H, W, 3) in [0, 1] -> (the image in [-1, 1] as a leaf that takes
        a gradient, its latents)."""
        img = rgb01.detach().to(self._device()).permute(2, 0, 1)[None].float() * 2 - 1
        img.requires_grad_(True)
        latents = self.pipe.vae.encode(img).latent_dist.mean * CONST_SCALE
        return img, latents

    # -- SDS ----------------------------------------------------------------
    def sds_grad(self, rgb: torch.Tensor, text_embedding, guidance_scale: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                 t: Optional[int] = None) -> torch.Tensor:
        """d(SDS)/d(rgb) for an (H, W, 3) render: the latent score
        w(t)(eps_pred - eps) chained through the VAE encoder by a VJP. ``t``
        and the latents' ``noise`` are drawn from ``generator`` where not
        handed in."""
        gs = self.guidance_scale if guidance_scale is None else guidance_scale
        if t is None:
            t = sample_timestep(self.schedule, generator)
        img, latents = self.imgs_to_latent(rgb)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=latents.device)
        noise = noise.to(latents.device, torch.float32)
        noisy = self.schedule.add_noise(latents.detach().float(), noise, t)
        emb = torch.as_tensor(text_embedding, device=latents.device).float()
        with torch.no_grad():
            eps = self.pipe.unet(torch.cat([noisy, noisy]), t, encoder_hidden_states=emb).sample
        eps_uncond, eps_text = eps.float().chunk(2)
        eps_cfg = classifier_free_guidance(eps_uncond, eps_text, gs)
        grad_lat = sds_gradient(self.schedule, eps_cfg, noise, t)
        # chain to pixels: latents.backward(grad) gives (dlat/dimg)^T grad
        latents.backward(gradient=grad_lat.to(latents.dtype))
        return (img.grad[0].permute(1, 2, 0) * 2.0).float().to(rgb.device)  # d(img_pm1)/d(rgb01) = 2
