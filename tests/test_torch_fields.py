"""Parity of the port's field components and fields with the JAX reference:
SH encoding, trunc_exp, the bf16 MLP, HashMLPDensityField (K1) and
NerfactoField (K3), with parameters from the JAX ``init`` converted by
``params_from_jax``.

Tolerances: SH and trunc_exp run the same float32 ops (rtol 1e-5, atol
1e-6). The MLPs compute in bf16 as the reference does, but a bf16 product
rounded once differently flips a last bf16 bit (~0.4% relative), so outputs
are held to rgb 1e-2 absolute and density 5e-2 relative where it exceeds
1e-3 (density is exp of an MLP output, so a bf16 ulp there is a relative
error)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, init_params, to_torch
from nerfstudio_tpu.core.rays import Frustums as JFrustums
from nerfstudio_tpu.core.rays import RaySamples as JRaySamples
from nerfstudio_tpu.field_components.activations import trunc_exp as j_trunc_exp
from nerfstudio_tpu.field_components.field_heads import FieldHeadNames as JNames
from nerfstudio_tpu.field_components.mlp import MLP as JMLP
from nerfstudio_tpu.fields.density_fields import HashMLPDensityField as JDensityField
from nerfstudio_tpu.fields.nerfacto_field import NerfactoField as JNerfactoField
from nerfstudio_tpu.utils.spherical_harmonics import components_from_spherical_harmonics as j_sh
from nerfstudio_torch.core.rays import Frustums, RaySamples
from nerfstudio_torch.field_components.activations import trunc_exp
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.utils.convert import params_from_jax
from nerfstudio_torch.utils.spherical_harmonics import components_from_spherical_harmonics

TOL = dict(rtol=1e-5, atol=1e-6)


def _samples(n, seed, scale=1.5):
    """(JAX, torch) point samples: positions spread inside and outside the
    unit ball, some far away, random unit directions."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, scale, (n, 3)).astype(np.float32)
    pos[:6] = [[0, 0, 0], [0.999, 0, 0], [1.0, 1.0, 1.0], [5, -3, 2], [1e8, 0, 1], [-2.5, 2.5, -2.5]]
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.zeros((n, 1), np.float32)
    one = np.ones((n, 1), np.float32)
    jrs = JRaySamples(frustums=JFrustums(origins=pos, directions=d, starts=z, ends=z, pixel_area=one))
    trs = RaySamples(frustums=Frustums(to_torch(pos), to_torch(d), to_torch(z), to_torch(z), to_torch(one)))
    return jrs, trs, pos


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_components(levels):
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        components_from_spherical_harmonics(levels, to_torch(d)).numpy(),
        np.asarray(j_sh(levels, jnp.asarray(d))), **TOL,
    )


def test_trunc_exp_clamps_forward_exponent():
    x = np.array([-50, -1, 0, 1, 10, 29.9, 30, 31, 1e4], np.float32)
    np.testing.assert_allclose(trunc_exp(to_torch(x)).numpy(), np.asarray(j_trunc_exp(jnp.asarray(x))), **TOL)


def test_mlp_bf16_matches_flax():
    """bf16 products and biases, float32 params, float32 output."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (512, 24)).astype(np.float32)
    jm = JMLP(in_dim=24, num_layers=3, layer_width=32, out_dim=5, out_activation="sigmoid")
    params = init_params(lambda k: jm.init(k, jnp.asarray(x)), 0)
    tm = MLP(in_dim=24, num_layers=3, layer_width=32, out_dim=5, out_activation="sigmoid", device=CPU)
    tm.load_state_dict(params_from_jax(params, tm))
    with torch.no_grad():
        got = tm(to_torch(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, jnp.asarray(x))), rtol=0, atol=1e-2)


def _density_close(got, ref):
    got, ref = got.numpy()[..., 0], np.asarray(ref)[..., 0]
    np.testing.assert_array_equal(got == 0, ref == 0)  # the selector zeroes the same samples
    big = ref > 1e-3
    assert big.sum() > 20
    np.testing.assert_allclose(got[big], ref[big], rtol=5e-2)


@pytest.mark.parametrize("contraction", [True, False], ids=["contracted", "aabb"])
def test_hash_mlp_density_field_k1(contraction):
    """Proposal field through K1, positions outside the unit cube zeroed by
    the selector (a far point contracts to the cube's face, outside (0,1))."""
    kw = dict(num_levels=4, base_res=4, max_res=64, log2_hashmap_size=11, hidden_dim=16,
              use_spatial_distortion=contraction, average_init_density=1.0)
    jrs, trs, _ = _samples(3000, 2)
    jf = JDensityField(block=True, **kw)
    params = init_params(lambda k: jf.init(k, jrs, method=JDensityField.get_density), 3)
    tf = HashMLPDensityField(block=True, device=CPU, **kw)
    tf.load_state_dict(params_from_jax(params, tf))
    ref, _ = jf.apply(params, jrs, method=JDensityField.get_density)
    with torch.no_grad():
        got, _ = tf.get_density(trs)
    _density_close(got, ref)
    if not contraction:
        assert (got[[3, 4, 5], 0] == 0).all()


@pytest.mark.parametrize("exact_eval", [True, False], ids=["K3_exact", "K1_preview"])
def test_nerfacto_field_eval(exact_eval):
    kw = dict(num_images=4, num_levels=4, base_res=4, max_res=64, log2_hashmap_size=12,
              features_per_level=4, hidden_dim=16, hidden_dim_color=16, appearance_embedding_dim=8,
              average_init_density=1.0, hash_block=True, exact_eval=exact_eval)
    jrs, trs, _ = _samples(3000, 4)
    jf = JNerfactoField(train=False, **kw)
    params = init_params(lambda k: jf.init(k, jrs), 5)
    tf = NerfactoField(device=CPU, **kw).eval()
    tf.load_state_dict(params_from_jax(params, tf))
    ref = jf.apply(params, jrs)
    with torch.no_grad():
        got = tf(trs)
    assert got[FieldHeadNames.RGB].shape == (3000, 3)
    np.testing.assert_allclose(got[FieldHeadNames.RGB].numpy(), np.asarray(ref[JNames.RGB]), rtol=0, atol=1e-2)
    _density_close(got[FieldHeadNames.DENSITY], ref[JNames.DENSITY])
    assert got[FieldHeadNames.DENSITY][4, 0] == 0  # 1e8 away: on the contracted cube's face


def test_nerfacto_field_training_forward_is_not_ported():
    """The training forward runs (K1, with gradients), and so do the
    density-gradient normals, which were the part not ported before: unit
    normals where the density gradient lives, and a loss on them reaches the
    hash table through K1's second derivative (held against JAX in
    test_torch_normals.py)."""
    tf = NerfactoField(num_levels=2, base_res=4, max_res=8, log2_hashmap_size=10, features_per_level=4, device=CPU)
    _, trs, _ = _samples(8, 6)
    out = tf(trs)
    out[FieldHeadNames.RGB].sum().backward()
    assert tf.mlp_base.encoding.hash_table.grad is not None
    tf.zero_grad(set_to_none=True)
    normals = tf(trs, compute_normals=True)[FieldHeadNames.NORMALS]
    assert normals.shape == (8, 3) and torch.isfinite(normals).all()
    norms = torch.linalg.norm(normals.detach(), dim=-1)
    assert ((norms - 1).abs() < 1e-5).sum() >= 4 and ((norms == 0) | ((norms - 1).abs() < 1e-5)).all()
    normals.sum().backward()
    assert float(tf.mlp_base.encoding.hash_table.grad.abs().sum()) > 0
