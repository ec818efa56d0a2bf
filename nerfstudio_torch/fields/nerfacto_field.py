"""Nerfacto field (counterpart of ``nerfstudio_tpu/fields/nerfacto_field.py``).

Block hash grid + base MLP -> (density, 15 geo features); SH(4) direction
encoding; the per-camera appearance embedding in training, its mean at
eval; colour MLP (3 x 64, sigmoid). The mode picks the hash path on every
call: training (and the occupancy update) runs the stochastic trilerp K1,
with its level-subsampled backward; eval runs the exact 8-corner trilerp
K3, or K1 with ``exact_eval=False``. With ``hash_block=False`` (the
reference field's default, generfacto's) every call runs the flat layout's
exact trilerp K7. With ``use_semantics``, a semantic
head (MLP 2 x 64 and a linear layer to ``num_semantic_classes`` logits)
reads the geometry feature with its gradient stopped. With
``use_pred_normals``, a predicted-normal head (MLP 3 x 64 over the
geometry feature and the raw sample positions, a linear layer to three
outputs, tanh and normalised). The transient heads are not ported (the
JAX package's semantic-nerfw refuses them)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nerfstudio_torch.core.rays import RaySamples
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.field_components.activations import trunc_exp
from nerfstudio_torch.field_components.embedding import Embedding
from nerfstudio_torch.field_components.encodings import SHEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames, PredNormalsFieldHead, SemanticFieldHead
from nerfstudio_torch.field_components.mlp import MLP, MLPWithHashEncoding
from nerfstudio_torch.field_components.spatial_distortions import SceneContraction
from nerfstudio_torch.fields.base_field import Field, get_normalized_directions
from nerfstudio_torch.utils.device import resolve_device


class NerfactoField(Field):
    """(reference nerfacto_field.py:36-199)"""

    def __init__(
        self,
        aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
            (-1.0, -1.0, -1.0),
            (1.0, 1.0, 1.0),
        ),
        num_images: int = 1,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_levels: int = 16,
        base_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        appearance_embedding_dim: int = 32,
        use_average_appearance_embedding: bool = True,
        use_semantics: bool = False,
        num_semantic_classes: int = 100,
        use_pred_normals: bool = False,
        use_appearance_embedding: bool = True,
        disable_scene_contraction: bool = False,
        average_init_density: float = 1.0,
        hash_block: bool = True,
        exact_eval: bool = True,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.aabb = aabb
        self.geo_feat_dim = geo_feat_dim
        self.appearance_embedding_dim = appearance_embedding_dim
        self.use_average_appearance_embedding = use_average_appearance_embedding
        self.use_appearance_embedding = use_appearance_embedding and appearance_embedding_dim > 0
        self.disable_scene_contraction = disable_scene_contraction
        self.average_init_density = average_init_density
        self.direction_encoding = SHEncoding(levels=4)
        self.mlp_base = MLPWithHashEncoding(
            num_levels=num_levels,
            min_res=base_res,
            max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level,
            num_layers=num_layers,
            layer_width=hidden_dim,
            out_dim=1 + geo_feat_dim,
            block=hash_block,
            block_exact=hash_block and exact_eval,
            device=device,
        )
        self.use_semantics = use_semantics
        if use_semantics:  # (reference :105-107)
            self.mlp_semantics = MLP(in_dim=geo_feat_dim, num_layers=2, layer_width=64, out_dim=64, device=device)
            self.field_head_semantics = SemanticFieldHead(64, num_semantic_classes, device=device)
        self.use_pred_normals = use_pred_normals
        if use_pred_normals:  # (reference :108-110)
            self.mlp_pred_normals = MLP(in_dim=geo_feat_dim + 3, num_layers=3, layer_width=64, out_dim=64,
                                        device=device)
            self.field_head_pred_normals = PredNormalsFieldHead(64, device=device)
        color_in = self.direction_encoding.get_out_dim() + geo_feat_dim
        if self.use_appearance_embedding:
            self.embedding_appearance = Embedding(num_images, appearance_embedding_dim, device=device)
            color_in += appearance_embedding_dim
        self.mlp_head = MLP(
            in_dim=color_in,
            num_layers=num_layers_color,
            layer_width=hidden_dim_color,
            out_dim=3,
            out_activation="sigmoid",
            device=device,
        )

    def density_from_normalized(self, positions01: torch.Tensor) -> torch.Tensor:
        """Density at contracted, normalised coordinates in [0,1]^3, the
        occupancy update's hook (reference nerfacto_field.py:123-132)."""
        selector = torch.all((positions01 > 0.0) & (positions01 < 1.0), dim=-1, keepdim=True)
        h = self.mlp_base(positions01 * selector)
        return self.average_init_density * trunc_exp(h[..., :1]) * selector

    def get_density(self, ray_samples: RaySamples, bwd_levels=None, bwd_scale: float = 1.0):
        """(reference nerfacto_field.py:134-151). ``bwd_levels``/``bwd_scale``:
        the level-subsampled table backward (``ops.hash_grid.hash_encode``)."""
        positions = ray_samples.frustums.get_positions()
        if not self.disable_scene_contraction:
            positions = (SceneContraction(order="inf")(positions) + 2.0) / 4.0
        else:
            aabb = torch.tensor(self.aabb, dtype=torch.float32, device=positions.device)
            positions = SceneBox.get_normalized_positions(positions, aabb)
        selector = torch.all((positions > 0.0) & (positions < 1.0), dim=-1, keepdim=True)
        positions = positions * selector
        h = self.mlp_base(positions, bwd_levels=bwd_levels, bwd_scale=bwd_scale)
        density_before, geo_feat = h[..., :1], h[..., 1:]
        density = self.average_init_density * trunc_exp(density_before)
        return density * selector, geo_feat

    def get_outputs(
        self, ray_samples: RaySamples, density_embedding: Optional[torch.Tensor] = None
    ) -> Dict[FieldHeadNames, torch.Tensor]:
        """(reference nerfacto_field.py:153-199)"""
        assert density_embedding is not None
        outputs = {}
        if self.use_semantics:
            outputs[FieldHeadNames.SEMANTICS] = self.field_head_semantics(
                self.mlp_semantics(density_embedding.detach()))
        directions = get_normalized_directions(ray_samples.frustums.directions)
        head_inputs = [self.direction_encoding(directions), density_embedding]
        if self.use_appearance_embedding:
            if self.training and ray_samples.camera_indices is not None:
                emb = self.embedding_appearance(ray_samples.camera_indices[..., 0])
            else:
                if self.use_average_appearance_embedding:
                    mean_emb = self.embedding_appearance.mean()
                else:
                    mean_emb = density_embedding.new_zeros((self.appearance_embedding_dim,))
                emb = mean_emb.expand(density_embedding.shape[:-1] + (self.appearance_embedding_dim,))
            head_inputs.append(emb)
        if self.use_pred_normals:  # (reference :190-195)
            pn_in = torch.cat([density_embedding, ray_samples.frustums.get_positions()], dim=-1)
            outputs[FieldHeadNames.PRED_NORMALS] = self.field_head_pred_normals(self.mlp_pred_normals(pn_in))
        outputs[FieldHeadNames.RGB] = self.mlp_head(torch.cat(head_inputs, dim=-1))
        return outputs
