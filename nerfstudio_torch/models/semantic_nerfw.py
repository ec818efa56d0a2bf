"""Semantic NeRF-W (counterpart of ``nerfstudio_tpu/models/semantic_nerfw.py``).

nerfacto with the field's semantic head (``use_semantics``: per-class
logits from the geometry feature, its gradient stopped, composited with
the weights, which are detached unless ``pass_semantic_gradients``) and a
per-pixel cross-entropy against the batch's class labels, with the
labels' accuracy as a metric. The transient embedding is refused, as the
reference refuses it."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from nerfstudio_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig


@dataclasses.dataclass
class SemanticNerfWModelConfig(NerfactoModelConfig):
    """(reference semantic_nerfw.py:24-39): the same fields and defaults;
    the pipeline sets ``num_semantic_classes`` from the dataset's classes."""

    use_transient_embedding: bool = False
    use_semantics: bool = True
    num_semantic_classes: int = 16
    semantic_loss_weight: float = 1.0
    pass_semantic_gradients: bool = False

    def __post_init__(self):
        if self._target is None:
            self._target = SemanticNerfWModel
        super().__post_init__()


class SemanticNerfWModel(NerfactoModel):
    """(reference semantic_nerfw.py:42-75)"""

    def __init__(self, config: SemanticNerfWModelConfig, *args, **kwargs):
        if config.use_transient_embedding:
            raise ValueError("Transient embedding is not fully working for semantic nerf-w.")
        super().__init__(config, *args, **kwargs)

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """nerfacto's losses and the semantic cross-entropy on the labels'
        first channel (reference :53-66)."""
        loss_dict = super().get_loss_dict(outputs, batch, metrics_dict)
        if "semantics" in outputs and "semantics" in batch:
            labels = batch["semantics"][..., 0].long()
            log_probs = torch.log_softmax(outputs["semantics"], dim=-1)
            ce = -torch.gather(log_probs, -1, labels[..., None])
            loss_dict["semantics_loss"] = self.config.semantic_loss_weight * torch.mean(ce)
        return loss_dict

    def get_metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """nerfacto's metrics and the labels' accuracy (reference :68-75)."""
        metrics = super().get_metrics_dict(outputs, batch)
        if "semantics" in outputs and "semantics" in batch:
            labels = batch["semantics"][..., 0].long()
            pred = torch.argmax(outputs["semantics"].detach(), dim=-1)
            metrics["semantics_accuracy"] = torch.mean((pred == labels).to(torch.float32))
        return metrics
