"""The port's score-distillation pieces (``nerfstudio_torch/generative``)
against the JAX package's: the DDPM schedules, classifier-free guidance and
the SDS gradient, the timestep band, the view-dependent prompts in all
three modes, the stub guidance, ``load_guidance``'s fallback, and the
Stable Diffusion and DeepFloyd wrappers' ``sds_grad`` on one tiny fake
diffusers pipeline (torch modules for the tokenizer, text encoder, VAE and
UNet), both wrappers built with ``object.__new__`` on both sides, the
timestep and noise JAX draws from its key handed to the port.

Tolerances: the schedules within 1e-6 relative (JAX's float32 ``cumprod``
may run as an associative scan; the port rounds the float64 product once;
the weight 1 - alpha within 1e-6 of 1),
CFG and the SDS gradient at equal weights exact, the stub 1e-7 absolute,
the wrappers 1e-5."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from _torch_port import to_torch
import nerfstudio_tpu.generative.deepfloyd as jdf
import nerfstudio_tpu.generative.schedules as jsched
import nerfstudio_tpu.generative.sds as jsds
import nerfstudio_tpu.generative.stable_diffusion as jsd
from nerfstudio_tpu.generative.positional_text_embeddings import PositionalTextEmbeddings as JPositional
import nerfstudio_torch.generative.deepfloyd as tdf
import nerfstudio_torch.generative.schedules as tsched
import nerfstudio_torch.generative.sds as tsds
import nerfstudio_torch.generative.stable_diffusion as tsd
from nerfstudio_torch.generative.positional_text_embeddings import PositionalTextEmbeddings

KINDS = {"scaled_linear": dict(kind="scaled_linear"), "linear": dict(kind="linear", beta_start=0.0001, beta_end=0.02)}
TIMESTEPS = (0, 20, 500, 979, 999)
SCHEDULE_RTOL = 1e-6
WRAPPER_TOL = 1e-5


@pytest.mark.parametrize("kind", list(KINDS))
def test_schedule_matches_jax(kind):
    """Betas and alphas_cumprod at every t, add_noise at t in TIMESTEPS,
    within 1e-6 relative; the SDS weight 1 - alpha there within 1e-6 of 1."""
    js, ts = jsched.DDPMSchedule(**KINDS[kind]), tsched.DDPMSchedule(**KINDS[kind])
    np.testing.assert_allclose(ts.betas().numpy(), np.asarray(js.betas()), rtol=SCHEDULE_RTOL, atol=0)
    np.testing.assert_allclose(ts.alphas_cumprod().numpy(), np.asarray(js.alphas_cumprod()), rtol=SCHEDULE_RTOL,
                               atol=0)
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(4, 5, 3)).astype(np.float32)
    eps = rng.normal(size=(4, 5, 3)).astype(np.float32)
    for t in TIMESTEPS:
        got = ts.add_noise(to_torch(x0), to_torch(eps), t).numpy()
        np.testing.assert_allclose(got, np.asarray(js.add_noise(x0, eps, jnp.asarray(t))), rtol=SCHEDULE_RTOL,
                                   atol=SCHEDULE_RTOL, err_msg=f"add_noise t={t}")
        # w = 1 - alpha (exact in float32) inherits alpha's last-bit gap: held
        # at alpha's scale, 1
        np.testing.assert_allclose(float(ts.sds_weight(t)), float(js.sds_weight(jnp.asarray(t))),
                                   rtol=0, atol=SCHEDULE_RTOL, err_msg=f"sds_weight t={t}")


def test_guidance_math_is_exact():
    """CFG bit for bit; the SDS gradient bit for bit at t where both
    schedules give the same weight, and w(t) (eps_pred - eps) at the
    port's weight everywhere."""
    rng = np.random.default_rng(1)
    u, c, pred, noise = (rng.normal(size=(8, 8, 3)).astype(np.float32) for _ in range(4))
    got = tsched.classifier_free_guidance(to_torch(u), to_torch(c), 7.5).numpy()
    assert np.array_equal(got, np.asarray(jsched.classifier_free_guidance(u, c, 7.5)))
    js, ts = jsched.DDPMSchedule(), tsched.DDPMSchedule()
    same = 0
    for t in TIMESTEPS:
        g = tsched.sds_gradient(ts, to_torch(pred), to_torch(noise), t)
        assert torch.equal(g, ts.sds_weight(t) * (to_torch(pred) - to_torch(noise)))
        if float(ts.sds_weight(t)) == float(js.sds_weight(jnp.asarray(t))):
            same += 1
            assert np.array_equal(g.numpy(), np.asarray(jsched.sds_gradient(js, pred, noise, jnp.asarray(t))))
    assert same >= 3


def test_timestep_band():
    """sample_timestep stays in [20, 980) and reaches both ends of it."""
    gen = torch.Generator().manual_seed(0)
    ts = [tsched.sample_timestep(tsched.DDPMSchedule(), gen) for _ in range(20000)]
    assert min(ts) == 20 and max(ts) == 979


class _FakeDiffusion:
    """A distinct constant embedding per direction keyword (JAX's test's)."""

    def get_text_embeds(self, prompt, negative_prompt=""):
        for i, k in enumerate(("base", "top", "side", "back", "front")):
            if k in prompt:
                return np.full((2, 4), float(i + 1), np.float32) * np.arange(1, 5, dtype=np.float32)
        return np.zeros((2, 4), np.float32)


@pytest.mark.parametrize("mode", ["discrete", "interpolated", "off"])
def test_positional_prompts_match_jax(mode):
    """The embedding over a grid of vertical and horizontal angles (both
    sides of every boundary, negative and wrapped angles): equal in the
    discrete and off modes, within 1e-6 relative interpolated."""
    args = ("base", "top", "side", "back", "front", _FakeDiffusion(), mode)
    jp, tp = JPositional(*args), PositionalTextEmbeddings(*args)
    for v in (-30.0, 0.0, 20.0, 39.9, 40.0, 60.0, 90.0, 120.0):
        for h in (-10.0, 0.0, 30.0, 45.0, 45.5, 90.0, 100.0, 135.0, 180.0, 200.0, 225.0, 250.0, 270.0, 300.0,
                  315.0, 315.5, 359.0, 360.0, 725.0):
            got, want = tp.get_text_embedding(v, h).numpy(), np.asarray(jp.get_text_embedding(v, h))
            if mode == "interpolated":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"v={v} h={h}")
            else:
                assert np.array_equal(got, want), (v, h)


def test_stub_colour_and_gradient_match_jax():
    """StubGuidance's prompt colour equals JAX's in this process (both seed
    numpy with abs(hash(prompt)) % 2**31, which Python salts per
    process); sds_grad with JAX's draw handed in within 1e-7."""
    jstub, tstub = jsds.StubGuidance(), tsds.StubGuidance()
    for prompt in ("a high quality photo of a pineapple", "a red chair", ""):
        assert np.array_equal(tstub.text_embedding(prompt).numpy(), np.asarray(jstub.text_embedding(prompt)))
    emb = tstub.text_embedding("a red chair")
    rgb = np.random.default_rng(2).uniform(size=(16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jstub.sds_grad(key, jnp.asarray(rgb), jnp.asarray(emb.numpy())))
    got = tstub.sds_grad(to_torch(rgb), emb, noise=to_torch(jax.random.normal(key, rgb.shape)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    drawn = tstub.sds_grad(to_torch(rgb), emb, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (16, 16, 3) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("backend", ["stable-diffusion", "deepfloyd"])
def test_load_guidance_falls_back_to_the_stub(backend, capsys):
    """Without diffusers both packages take the stub and print the same
    warning on stderr."""
    assert not tsd.available() and not tdf.available()
    assert isinstance(tsds.load_guidance(backend, device="cpu"), tsds.StubGuidance)
    port_err = capsys.readouterr().err
    assert isinstance(jsds.load_guidance(backend), jsds.StubGuidance)
    assert port_err == capsys.readouterr().err and "falling back to STUB guidance" in port_err


# --------------------------------------------------------------------------
# the wrappers on one tiny fake diffusers pipeline


class _Tokenizer:
    model_max_length = 6

    def __call__(self, p, padding, max_length, return_tensors, truncation):
        ids = [(ord(ch) % 50) + 1 for ch in p][:max_length]
        ids += [0] * (max_length - len(ids))
        return types.SimpleNamespace(input_ids=torch.tensor([ids], dtype=torch.long))


class _TextEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(64, 5)

    def forward(self, ids):
        return (self.emb(ids),)


class _VAE(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, stride=2, padding=1)

    def encode(self, img):
        return types.SimpleNamespace(latent_dist=types.SimpleNamespace(mean=torch.tanh(self.conv(img))))


class _UNet(nn.Module):
    """eps from the noisy input, the timestep and the text embedding, so
    the guidance's difference of the two halves is not zero."""

    def __init__(self, channels, out_channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)
        self.text = nn.Linear(5, out_channels)

    def forward(self, x, t, encoder_hidden_states):
        cond = self.text(encoder_hidden_states.mean(dim=1))[:, :, None, None]
        return types.SimpleNamespace(sample=torch.sin(self.conv(x) + cond + t / 1000.0))


class _IFPipe(nn.Module):
    def __init__(self):
        super().__init__()
        self.text_encoder = _TextEncoder()
        self.unet = _UNet(3, 6)

    def encode_prompt(self, prompt, negative_prompt=""):
        tok = _Tokenizer()
        enc = lambda p: self.text_encoder(tok(p, None, 6, None, None).input_ids)[0]  # noqa: E731
        return enc(prompt).detach(), enc(negative_prompt).detach()


def _sd_pipe():
    torch.manual_seed(0)
    pipe = nn.Module()
    pipe.tokenizer, pipe.text_encoder, pipe.vae, pipe.unet = _Tokenizer(), _TextEncoder(), _VAE(), _UNet(4, 4)
    return pipe


def _bare(cls, pipe, schedule, **attrs):
    obj = object.__new__(cls)
    obj.pipe, obj.guidance_scale, obj.schedule = pipe, 100.0, schedule
    for k, v in attrs.items():
        setattr(obj, k, v)
    return obj


@pytest.mark.parametrize("guidance_scale", [None, 7.5])
def test_stable_diffusion_sds_grad_matches_jax(guidance_scale):
    """Both wrappers on one fake pipe: the text embeddings equal, and the
    pixel gradient (the latent score chained through the VAE) within 1e-5,
    the port given JAX's timestep and latent noise."""
    pipe = _sd_pipe()
    jw = _bare(jsd.StableDiffusion, pipe, jsched.DDPMSchedule(kind="scaled_linear"), torch=torch)
    tw = _bare(tsd.StableDiffusion, pipe, tsched.DDPMSchedule(kind="scaled_linear"))
    emb_j, emb_t = jw.get_text_embeds("a red chair", "blurry"), tw.get_text_embeds("a red chair", "blurry")
    assert np.array_equal(emb_t.numpy(), emb_j) and emb_t.shape == (2, 6, 5)
    rgb = np.random.default_rng(4).uniform(size=(16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jw.sds_grad(key, jnp.asarray(rgb), emb_j, guidance_scale))
    t = int(jsched.sample_timestep(key, jw.schedule))
    noise = to_torch(jax.random.normal(jax.random.fold_in(key, 1), (1, 4, 8, 8), jnp.float32))
    got = tw.sds_grad(to_torch(rgb), emb_t, guidance_scale, t=t, noise=noise)
    assert got.shape == (16, 16, 3) and float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=WRAPPER_TOL, atol=WRAPPER_TOL * float(np.abs(want).max()))
    drawn = tw.sds_grad(to_torch(rgb), emb_t, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (16, 16, 3) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("guidance_scale", [None, 7.5])
def test_deepfloyd_sds_grad_matches_jax(guidance_scale):
    """Both wrappers on one fake IF pipe: the embeddings [negative, text]
    equal, and the pixel-space gradient within 1e-5 at JAX's timestep and
    noise."""
    torch.manual_seed(1)
    pipe = _IFPipe()
    jw = _bare(jdf.DeepFloyd, pipe, jsched.DDPMSchedule(kind="linear", beta_start=0.0001, beta_end=0.02),
               torch=torch)
    tw = _bare(tdf.DeepFloyd, pipe, tsched.DDPMSchedule(kind="linear", beta_start=0.0001, beta_end=0.02))
    emb_j, emb_t = jw.get_text_embeds("a red chair", "blurry"), tw.get_text_embeds("a red chair", "blurry")
    assert np.array_equal(emb_t.numpy(), emb_j)
    rgb = np.random.default_rng(6).uniform(size=(16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jw.sds_grad(key, jnp.asarray(rgb), emb_j, guidance_scale))
    t = int(jsched.sample_timestep(key, jw.schedule))
    noise = to_torch(jax.random.normal(jax.random.fold_in(key, 1), rgb.shape, jnp.float32))
    got = tw.sds_grad(to_torch(rgb), emb_t, guidance_scale, t=t, noise=noise)
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=WRAPPER_TOL, atol=WRAPPER_TOL * float(np.abs(want).max()))
    tw.delete_text_encoder()
    assert pipe.text_encoder is None
