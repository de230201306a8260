"""The diffusion autoencoder (`diffusion_autoencoder`) and DAU1d conditioning
in the port against the JAX package on the CPU, f32, the same weights
(io/from_jax.py, seeded numpy values) and the same inputs and draws:

- DAU1d's `cond` (`cond_dim`; resized by `jax.image.resize(..., "linear")`
  where its length differs, up and down) and `cond_noise_aug` (the level and
  the noise replayed, or `cond_aug_scale`); `learned_resample` accepted and
  ignored as in JAX;
- a tiny diffusion AE (Oobleck encoder with the snake, VAE bottleneck) on
  each diffusion type (`DAU1d` with `cond_dim`, `adp_1d`, `dit`): encode,
  `diffusion_forward` (the nearest upsampling), `decode` in a few v-DDIM
  steps, one `DiffusionAutoencoderTrainer` step;
- the trainer's unread `accum_steps` and `use_reconstruction_loss`, the
  encoder in bf16 (`encoder_compute_dtype`) against JAX's f32, an RVQ
  bottleneck's state, the demo callback and the training entry with
  `--recover` and `unwrap_model`.

JAX's draws are replaced by the port's (`vae_sample`, `jax.random.normal` /
`uniform` where sizes tell them apart). Each tolerance is stated where it is
used."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import dance_unet as jdance
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.diffusion import (
    DiffusionAutoencoderTrainer as JaxDiffAETrainer)
from stable_audio_tools_tpu_torch import train, unwrap_model
from stable_audio_tools_tpu_torch.io.from_jax import dance_unet_state_dict, diffusion_ae_state_dict
from stable_audio_tools_tpu_torch.models import dance_unet as tdance
from stable_audio_tools_tpu_torch.models.diffusion_ae import DiffusionAutoencoder
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training import demos as tdemos
from stable_audio_tools_tpu_torch.training.diffusion import DiffusionAutoencoderTrainer
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from stable_audio_tools_tpu_torch.training.trainer import step_checkpoints

from test_torch_ae_training import _jax_grads, _replay_noise, one_torch_thread  # noqa: F401
from test_torch_dac_rvq import _replay_normal
from test_torch_train_entry import write_run_inputs
from test_torch_transformer_options import randomize
from test_torch_uncond_backbones import TINY_UNET

B, T, RATIO, LATENT = 3, 256, 8, 4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- DAU1d conditioning -----------------------------------------------------------


@pytest.mark.parametrize("t_in,t_out", [(5, 12), (12, 5), (16, 64), (64, 16), (48, 33)])
def test_linear_resize_matches_jax_image_resize(t_in, t_out):
    # half-pixel centres, antialiased when shrinking: 1e-6 of the peak
    x = np.random.default_rng(t_in).standard_normal((2, 3, t_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 1)), (2, t_out, 3),
                                       method="linear")).transpose(0, 2, 1)
    got = tdance.linear_resize(_t(x), t_out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    plain = torch.nn.functional.interpolate(_t(x), t_out, mode="linear").numpy()
    assert t_out > t_in or not np.allclose(plain, want, atol=1e-3)  # no antialias there


DAU = dict(io_channels=2, depth=3, n_attn_layers=1, channels=[16, 32, 32], strides=[2, 2],
           cond_dim=LATENT)


def _dau_pair(seed, **changes):
    cfg = dict(DAU, **changes)
    jm = jdance.DiffusionAttnUnet1D(**cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, 2, 32)), jnp.zeros((2,)), cond=jnp.zeros((2, LATENT, 32))))
    params = randomize(shapes["params"], seed)
    port = tdance.DiffusionAttnUnet1D(**cfg)
    port.load_state_dict({k: _t(v) for k, v in dance_unet_state_dict(params).items()},
                         strict=True)
    return jm, params, port


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("cond_len", [32, 8, 80])
def test_dau1d_cond_matches_jax(monkeypatch, aug, cond_len):
    # cond at x's length, shorter (resized up) and longer (down); with
    # cond_noise_aug the level [B] and the noise replayed (aug_embed's 16
    # planes before cond): f32, 1e-5 of the output's peak
    jm, params, port = _dau_pair(3 + aug, cond_noise_aug=aug)
    rng = np.random.default_rng(cond_len)
    x = rng.standard_normal((2, 2, 32)).astype(np.float32)
    t = np.array([0.25, 0.8], np.float32)
    cond = rng.standard_normal((2, LATENT, cond_len)).astype(np.float32)
    level = np.array([0.3, 0.7], np.float32)
    noise = rng.standard_normal((2, LATENT, 32)).astype(np.float32)
    if aug:
        _replay_normal(monkeypatch, [noise.transpose(0, 2, 1)])
        real = jax.random.uniform
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: (
            jnp.asarray(level) if tuple(shape) == (2,) else real(key, shape, *a, **k)))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                               cond=jnp.asarray(cond), rngs={"sample": jax.random.PRNGKey(2)}))
    with torch.no_grad():
        got = port(_t(x), _t(t), cond=_t(cond), aug_level=_t(level), cond_noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_dau1d_cond_aug_scale_sets_the_level(monkeypatch):
    # cond_aug_scale fixes every item's level (the noise still drawn)
    jm, params, port = _dau_pair(5, cond_noise_aug=True)
    rng = np.random.default_rng(6)
    x, cond = (rng.standard_normal((2, c, 32)).astype(np.float32) for c in (2, LATENT))
    noise = rng.standard_normal((2, LATENT, 32)).astype(np.float32)
    _replay_normal(monkeypatch, [noise.transpose(0, 2, 1)])
    t = np.array([0.4, 0.6], np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                               cond=jnp.asarray(cond), cond_aug_scale=0.25,
                               rngs={"sample": jax.random.PRNGKey(2)}))
    with torch.no_grad():
        got = port(_t(x), _t(t), cond=_t(cond), cond_aug_scale=0.25, cond_noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_learned_resample_is_accepted_and_ignored():
    # the JAX module takes the flag and resamples with the cubic filter all
    # the same: the same parameters and the same output as without it
    jm0, params, port0 = _dau_pair(7)
    jm1, _, port1 = _dau_pair(7, learned_resample=True)
    assert sorted(port0.state_dict()) == sorted(port1.state_dict())
    x = np.random.default_rng(8).standard_normal((2, 2, 32)).astype(np.float32)
    cond = np.random.default_rng(9).standard_normal((2, LATENT, 32)).astype(np.float32)
    args = (jnp.asarray(x), jnp.ones((2,)) * 0.5)
    np.testing.assert_array_equal(
        np.asarray(jm0.apply({"params": params}, *args, cond=jnp.asarray(cond))),
        np.asarray(jm1.apply({"params": params}, *args, cond=jnp.asarray(cond))))
    with torch.no_grad():
        a = port0(_t(x), torch.full((2,), 0.5), cond=_t(cond))
        b = port1(_t(x), torch.full((2,), 0.5), cond=_t(cond))
    assert torch.equal(a, b)


# -- the diffusion autoencoder --------------------------------------------------------

# channels 16: torch 2.13's CPU bf16 conv1d gives wrong outputs for 8 input
# channels at stride 4 (66% off f32; 0.3% at 16 channels), which the bf16
# encoder check would read as the port's
ENCODER = {"type": "oobleck", "config": {"in_channels": 2, "channels": 16, "c_mults": [1, 2],
                                         "strides": [2, 4], "latent_dim": 2 * LATENT,
                                         "use_snake": True}}
DIFFUSION = {
    "DAU1d": {"type": "DAU1d", "config": dict(DAU, n_attn_layers=1)},
    "adp_1d": {"type": "adp_1d", "config": dict(TINY_UNET, context_channels=[LATENT])},
    "dit": {"type": "dit", "config": {"io_channels": 2, "embed_dim": 128, "depth": 2,
                                      "num_heads": 2, "input_concat_dim": LATENT,
                                      "use_checkpointing": False}}}
KINDS = list(DIFFUSION)


def diffae_config(kind: str) -> dict:
    return {"model_type": "diffusion_autoencoder", "sample_size": T, "sample_rate": 16000,
            "audio_channels": 2,
            "model": {"encoder": copy.deepcopy(ENCODER), "bottleneck": {"type": "vae"},
                      "diffusion": copy.deepcopy(DIFFUSION[kind]), "io_channels": 2,
                      "latent_dim": LATENT, "downsampling_ratio": RATIO},
            "training": {"learning_rate": 1e-4,
                         # Adam's eps at 1e-3: a first update lr g / (|g| + eps) is
                         # smooth in g, so f32 gradient roundoff stays small in it
                         "optimizer_configs": {"diffusion": {"optimizer": {
                             "type": "Adam", "config": {"lr": 1e-4, "eps": 1e-3}}}},
                         "demo": {"demo_every": 2000, "demo_steps": 2, "num_demos": 2}}}


DIM_HEADS = 64  # the tiny DiT's


@pytest.fixture(scope="module")
def diffae_pairs():
    """{kind: (JAX model, params, the port's model)} with the same seeded
    weights."""
    out = {}
    for seed, kind in enumerate(KINDS):
        cfg = diffae_config(kind)
        jm = jax_create_model(cfg)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
            jnp.zeros((B, 2, T)), jnp.zeros((B,))))
        params = randomize(shapes["params"], 40 + seed)
        port = create_model_from_config(cfg, "cpu")
        port.load_state_dict({k: _t(v) for k, v in diffusion_ae_state_dict(
            params, DIM_HEADS).items()}, strict=True)
        out[kind] = (jm, params, port.eval())
    return out


def _audio(seed, batch=B):
    return (0.3 * np.random.default_rng(seed).standard_normal((batch, 2, T))).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_factory_builds_the_diffae(diffae_pairs, kind):
    jm, _, port = diffae_pairs[kind]
    assert isinstance(port, DiffusionAutoencoder)
    assert port.diffusion_downsampling_ratio == jm.diffusion_downsampling_ratio == {
        "DAU1d": 4, "adp_1d": 4, "dit": 1}[kind]
    assert port.min_length == jm.min_length == RATIO
    assert all(n.startswith(("encoder.", "diffusion.model.")) for n in port.state_dict())


@pytest.mark.parametrize("kind", KINDS)
def test_encode_and_diffusion_forward_match_jax(diffae_pairs, monkeypatch, kind):
    # the Oobleck encoder and the VAE (noise replayed), then the denoiser on
    # the latents upsampled by nearest index: f32, 1e-5 of each peak
    jm, params, port = diffae_pairs[kind]
    audio = _audio(1)
    noise = np.random.default_rng(2).standard_normal((B, LATENT, T // RATIO)).astype(np.float32)
    _replay_noise(monkeypatch, noise)
    v = {"params": params}
    rngs = {"sample": jax.random.PRNGKey(3)}
    jz, jinfo = jm.apply(v, jnp.asarray(audio), return_info=True, method=jm.encode, rngs=rngs)
    with torch.no_grad():
        tz, tinfo = port.encode(_t(audio), return_info=True, noise=_t(noise))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5 * np.abs(jz).max())
    np.testing.assert_allclose(float(tinfo["kl"]), float(jinfo["kl"]), rtol=1e-5)
    x = np.random.default_rng(4).standard_normal((B, 2, T)).astype(np.float32)
    t = np.array([0.1, 0.5, 0.9], np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(t), jz, rngs=rngs,
                               method=jm.diffusion_forward))
    with torch.no_grad():
        got = port.diffusion_forward(_t(x), _t(t), _t(np.asarray(jz))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_jax(diffae_pairs, monkeypatch, kind):
    # 3 v-DDIM steps (eta 0) from the same noise, the model conditioned on
    # the latents at every step: f32, 1e-4 of the audio's peak
    jm, params, port = diffae_pairs[kind]
    latents = np.random.default_rng(5).standard_normal((B, LATENT, T // RATIO)).astype(
        np.float32)
    noise = np.random.default_rng(6).standard_normal((B, 2, T)).astype(np.float32)
    _replay_normal(monkeypatch, [noise])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(latents), 3, method=jm.decode,
                               rngs={"sample": jax.random.PRNGKey(7)}))
    with torch.no_grad():
        got = port.decode(_t(latents), 3, noise=_t(noise)).numpy()
    assert got.shape == want.shape == (B, 2, T)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _jax_step(kind, params, audio, vae_noise, key):
    """One JAX DiffusionAutoencoderTrainer step from `params`: (aux, grads,
    new params, t, noise), its draws (t: fold_in(key, 1); the diffusion
    noise: fold_in(key, 2)) read back for the port."""
    cfg = diffae_config(kind)
    with pytest.MonkeyPatch.context() as mp:
        _replay_noise(mp, vae_noise)
        jt = JaxDiffAETrainer(jax_create_model(cfg),
                              optimizer_configs=cfg["training"]["optimizer_configs"])
        state = jt.init_state({"params": jax.tree_util.tree_map(jnp.asarray, params)})
        state, aux = jax.jit(jt.make_train_step())(state, {"audio": jnp.asarray(audio)}, key)
    t = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (audio.shape[0],)))
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), audio.shape))
    return aux, _jax_grads(state.opt_state, 0.9), state.params, t, noise


STEP_AUDIO, STEP_VAE_NOISE, STEP_KEY = _audio(8), np.random.default_rng(9).standard_normal(
    (B, LATENT, T // RATIO)).astype(np.float32), jax.random.PRNGKey(10)


@pytest.fixture(scope="module")
def jax_steps(diffae_pairs):
    """{kind: `_jax_step` of the module's batch}, computed once a kind."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _jax_step(kind, diffae_pairs[kind][1], STEP_AUDIO, STEP_VAE_NOISE,
                                    STEP_KEY)
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", ["DAU1d", "dit"])  # adp_1d's step: test_torch_uncond_backbones
def test_training_step_matches_jax(diffae_pairs, jax_steps, kind):
    # one step: the v-objective MSE + 1e-6 x the KL, the gradient through
    # the encoder, Adam, the EMA. The loss and its parts 1e-5 relative; every
    # gradient within 1e-3 of its peak + 1e-6 of the largest (f32 sums: a
    # weight-norm gain's gradient sums a whole filter's, whose terms cancel;
    # a bias ahead of a GroupNorm has a zero gradient up to roundoff); the
    # parameters after Adam (eps 1e-3) within lr / eps (0.1) x that bound +
    # 3e-6: the first update lr g / (|g| + eps) moves by at most that much
    # per unit of gradient
    _, _, port = diffae_pairs[kind]
    jaux, jgrads, jparams, t, noise = jax_steps(kind)
    w = create_training_wrapper_from_config(diffae_config(kind), copy.deepcopy(port))
    assert isinstance(w, DiffusionAutoencoderTrainer)
    aux = w.train_step(_t(STEP_AUDIO), None, t=_t(t), noise=_t(noise),
                       encode_noise=_t(STEP_VAE_NOISE))
    assert set(aux) == set(jaux) == {"loss", "mse_loss", "kl_loss"}
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    want = diffusion_ae_state_dict(jgrads, DIM_HEADS)
    assert sorted(want) == sorted(w.params)
    assert any(n.startswith("encoder.") for n in w.params)
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    new = diffusion_ae_state_dict(jax.tree_util.tree_map(np.asarray, jparams), DIM_HEADS)
    for n, g in want.items():
        bound = 1e-3 * np.abs(g).max() + floor
        np.testing.assert_allclose(w.params[n].grad.numpy(), g, atol=bound, err_msg=n)
        np.testing.assert_allclose(w.params[n].detach().numpy(), new[n], rtol=0,
                                   atol=0.1 * bound + 3e-6, err_msg=n)


def test_accum_steps_and_use_reconstruction_loss_are_read_nowhere(diffae_pairs, jax_steps):
    # JAX takes both and reads neither (training/diffusion.py:343-345, :401):
    # the port's train_step(accum_steps=4) with use_reconstruction_loss
    # equals its plain step bit for bit (both at JAX's draws)
    kind = "DAU1d"
    _, params, port = diffae_pairs[kind]
    plain = jax_steps(kind)
    ports = []
    for kw, accum in (({}, 1), ({"use_reconstruction_loss": True}, 4)):
        w = DiffusionAutoencoderTrainer(copy.deepcopy(port), optimizer_configs=diffae_config(
            kind)["training"]["optimizer_configs"], **kw)
        aux = w.train_step(_t(STEP_AUDIO), None, accum_steps=accum, t=_t(plain[3]),
                           noise=_t(plain[4]), encode_noise=_t(STEP_VAE_NOISE))
        ports.append((aux, w))
    assert ports[1][1].use_reconstruction_loss and float(ports[0][0]["loss"]) == float(
        ports[1][0]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(ports[0][1].params.values(),
                                                 ports[1][1].params.values()))


def test_bf16_encoder_lies_as_far_from_f32_as_the_jax_packages_own(diffae_pairs):
    # `encoder_compute_dtype` "bfloat16" (the card's snake kernels take bf16
    # only) against the JAX package's f32 encode of the same clip (the VAE's
    # mean: noise 0). Random weights compound bf16 rounding: the JAX
    # package's own bf16 encode lies 8.7% from its f32 one, the port's 7.9%
    # (torch 2.13 CPU). Pinned: the port's within twice JAX's own, and the
    # port's f32 encode within 1e-5 of JAX's
    jm, params, port = diffae_pairs["DAU1d"]
    audio = _audio(14)
    zero = np.zeros((B, LATENT, T // RATIO), np.float32)
    half = copy.deepcopy(port)
    half.encoder_compute_dtype = torch.bfloat16
    with torch.no_grad():
        f32 = port.encode(_t(audio), noise=_t(zero))
        b16 = half.encode(_t(audio), noise=_t(zero))
    want = _jax_mean_latents(jm, params, audio)
    np.testing.assert_allclose(f32.numpy(), want, atol=1e-5 * np.abs(want).max())
    assert b16.dtype == torch.float32
    dist = lambda a: float(np.linalg.norm(a - want) / np.linalg.norm(want))
    jax_bf16 = _jax_mean_latents(jm, params, audio, jnp.bfloat16)
    assert 0 < dist(b16.numpy()) <= 2 * dist(jax_bf16), (dist(b16.numpy()), dist(jax_bf16))


def _jax_mean_latents(jm, params, audio, dtype=jnp.float32):
    """The JAX encoder's VAE mean (the latents with zero noise) of audio cast
    to `dtype` (its parameters stay f32, cast at use), f32 out."""
    enc = jm.apply({"params": params}, jnp.asarray(audio).transpose(0, 2, 1).astype(dtype),
                   method=lambda m, x: m.encoder(x))
    return np.asarray(enc.astype(jnp.float32))[..., :LATENT].transpose(0, 2, 1)


def test_rvq_bottleneck_state_moves_in_training():
    # an RVQ-VAE bottleneck: a training step runs its k-means init and EMA
    # (the JAX step cannot: its variables lack the quantizer_state
    # collection); the codebooks move, the step's loss is finite
    cfg = diffae_config("DAU1d")
    cfg["model"]["bottleneck"] = {"type": "rvq_vae", "config": {
        "dim": LATENT, "codebook_size": 8, "num_quantizers": 2, "kmeans_iters": 2}}
    model = create_model_from_config(cfg, "cpu")
    w = create_training_wrapper_from_config(cfg, model)
    q = model.bottleneck.quantizer
    before = q.codebooks.clone()
    aux = w.train_step(_t(_audio(15)))
    assert bool(q.initted) and not torch.equal(q.codebooks, before)
    assert all(np.isfinite(float(v)) for v in aux.values()) and "kl_loss" in aux


def test_demo_callback_renders_with_the_ema_weights(tmp_path):
    # num_demos reals from the demo loader, encoded and decoded in demo_steps
    # with the EMA weights (the training weights back after), the host's and
    # the card's random states kept by the trainer
    cfg = diffae_config("DAU1d")
    model = create_model_from_config(cfg, "cpu")
    w = create_training_wrapper_from_config(cfg, model)
    w.train_step(_t(_audio(16)))
    w.train_step(_t(_audio(17)))
    before = {n: p.detach().clone() for n, p in w.params.items()}
    reals = _audio(18, batch=4)
    cb = tdemos.create_demo_callback_from_config(cfg, str(tmp_path), demo_dl=[(reals, [{}] * 4)])
    assert isinstance(cb, tdemos.DiffusionAutoencoderDemoCallback)
    cb(w, 2)
    out = cb.outputs
    assert out["diffae_reals"].shape == out["diffae_recon"].shape == (2, 2, T)
    np.testing.assert_array_equal(out["diffae_reals"], reals[:2])
    assert np.isfinite(out["diffae_recon"]).all()
    assert all(torch.equal(p, before[n]) for n, p in w.params.items())
    files = sorted(os.listdir(tmp_path))
    assert "diffae_recon_step2_1.wav" in files and "diffae_reals_step2_0.wav" in files
    again = copy.deepcopy(cb)
    again(w, 2)
    np.testing.assert_array_equal(again.outputs["diffae_recon"], out["diffae_recon"])


def test_train_entry_trains_a_diffae_recovers_and_unwraps(tmp_path):
    # the entry with demos and checkpoints, then --recover to one more step,
    # then unwrap_model's EMA weights under the model's names
    cfg = diffae_config("DAU1d")
    argv = write_run_inputs(str(tmp_path), cfg) + [
        "--save-dir", str(tmp_path / "run"), "--checkpoint-every", "2", "--demo-every", "2"]
    trainer = train.main(argv + ["--max-steps", "2"])
    assert isinstance(trainer.wrapper, DiffusionAutoencoderTrainer) and trainer.wrapper.step == 2
    assert [s for s, _ in step_checkpoints(str(tmp_path / "run"))] == [2]
    demos = os.listdir(tmp_path / "run" / "demos")
    assert any(f.startswith("diffae_recon_step2") for f in demos)
    resumed = train.main(argv + ["--recover", "--max-steps", "3"])
    assert resumed.wrapper.step == 3
    log = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert [r["step"] for r in log if "train/loss" in r] == [1, 2, 3]
    ckpt = step_checkpoints(str(tmp_path / "run"))[-1][1]
    out = str(tmp_path / "unwrapped")
    unwrap_model.main(["--ckpt-path", ckpt, "--name", out])
    state = torch.load(out + ".ckpt", map_location="cpu", weights_only=True)
    sd = state.get("state_dict", state)
    assert set(resumed.wrapper.ema) <= set(sd)
    fresh = create_model_from_config(cfg, "cpu")
    fresh.load_state_dict(sd, strict=True)
