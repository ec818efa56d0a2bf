"""View-dependent prompting for text-to-3D (counterpart of
``nerfstudio_tpu/generative/positional_text_embeddings.py``).

DreamFusion's trick: condition the guidance on "front/side/back/top view"
prompt variants, chosen (or interpolated) from the sampled camera's
spherical angles."""

from __future__ import annotations

from typing import Literal

import torch


class PositionalTextEmbeddings:
    """The five prompts' embeddings and the rule that picks or blends them."""

    def __init__(
        self,
        base_prompt: str,
        top_prompt: str,
        side_prompt: str,
        back_prompt: str,
        front_prompt: str,
        diffusion_model,
        positional_prompting: Literal["discrete", "interpolated", "off"] = "discrete",
    ):
        self.positional_prompting = positional_prompting
        self.diffusion = diffusion_model
        self.update_prompt(base_prompt, top_prompt, side_prompt, back_prompt, front_prompt)

    def update_prompt(self, base_prompt, top_prompt, side_prompt, back_prompt, front_prompt):
        get = self.diffusion.get_text_embeds
        self.base_embed = torch.as_tensor(get(base_prompt, ""))
        self.top_embed = torch.as_tensor(get(top_prompt, ""))
        self.side_embed = torch.as_tensor(get(side_prompt, ""))
        self.back_embed = torch.as_tensor(get(back_prompt, ""))
        self.front_embed = torch.as_tensor(get(front_prompt, ""))

    def get_text_embedding(self, vertical_angle: float, horizontal_angle: float) -> torch.Tensor:
        """Angles in degrees; vertical 0 is overhead (vertical < 40 is the
        top view)."""
        h = float(horizontal_angle) % 360.0
        if h < 0:
            h += 360.0
        v = float(vertical_angle)

        if self.positional_prompting == "discrete":
            if v < 40:
                return self.top_embed
            if h > 315 or h <= 45:
                return self.front_embed
            if 45 < h <= 135:
                return self.side_embed
            if 135 < h <= 225:
                return self.back_embed
            return self.side_embed
        if self.positional_prompting == "interpolated":
            v = max(v, 0.0)
            if 0 < h <= 90:
                emb = h * self.side_embed + (90 - h) * self.front_embed
            elif 90 < h <= 180:
                emb = (h - 90) * self.back_embed + (180 - h) * self.side_embed
            elif 180 < h <= 270:
                emb = (h - 180) * self.side_embed + (270 - h) * self.back_embed
            else:
                emb = (h - 270) * self.front_embed + (360 - h) * self.side_embed
            emb = emb / 90.0
            v = min(v, 90.0)
            return (v * emb + (90 - v) * self.top_embed) / 90.0
        return self.base_embed
