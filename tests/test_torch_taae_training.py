"""VAE-GAN training of the transformer autoencoder in the port against the
JAX package's AutoencoderTrainer on the CPU, f32: a tiny TAAE twin of
`chip_smoke.taae_config()` (channels 8 at strides [4, 4], one block a level
under the window (7, 8), latent 4; the EnCodec discriminator of 8 filters
over two STFT scales, two MRSTFT resolutions; AdamW with eps 1e-3 as in
tests/test_torch_ae_training.py) with the same weights on both sides
(io/from_jax.py), the same batch and the same draws:

- a generator and a discriminator step, then the trainer's options in one
  run: `latent_mask_ratio` 0.5 (the same mask on both sides, in both steps),
  a teacher TAAE (its five distillation losses), and
  `encoder_freeze_on_warmup` after a one-step warm-up (the third step's
  encoder, which moves by AdamW's moments and weight decay alone);
- a generator step with the dithered FSQ bottleneck (its dropout and dither
  replayed).

JAX draws inside its jitted steps; the tests replace its `vae_sample`, and
its `jax.random.uniform` / `bernoulli`, by the numpy draws the port is
handed, and clear the trainer's jit cache so each step traces the draws
anew. Each tolerance is stated where it is used.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.autoencoders import AutoencoderTrainer as JaxTrainer
from stable_audio_tools_tpu_torch.io.from_jax import (autoencoder_state_dict,
                                                      encodec_discriminator_state_dict)
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training.autoencoders import AutoencoderTrainer

from test_torch_ae_training import _jax_grads, _replay_noise, _tree_np, one_torch_thread  # noqa: F401
from test_torch_transformer_options import randomize

B, T, LATENT, RATIO = 2, 1024, 4, 16


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tiny_config(fsq: bool = False) -> dict:
    cfg = chip_smoke.tiny_taae_config("float32", fsq=fsq)
    cfg["sample_size"] = T
    tower = dict(channels=8, c_mults=[1, 2], strides=[4, 4], transformer_depths=[1, 1],
                 sliding_window=[7, 8])
    m = cfg["model"]
    m["encoder"]["config"].update(tower, latent_dim=LATENT if fsq else 2 * LATENT)
    m["decoder"]["config"].update(tower, latent_dim=LATENT)
    m.update(latent_dim=LATENT, downsampling_ratio=RATIO)
    if fsq:
        m["bottleneck"]["config"].update(dim=2, num_codebooks=2)
    tr = cfg["training"]
    tr.pop("compute_dtype")
    adamw = {"optimizer": {"type": "AdamW", "config": {"lr": 1e-4, "betas": [0.8, 0.99],
                                                       "eps": 1e-3}}}
    tr["optimizer_configs"] = {"autoencoder": adamw, "discriminator": copy.deepcopy(adamw)}
    losses = tr["loss_configs"]
    losses["discriminator"]["config"] = dict(filters=8, n_ffts=[64, 32], hop_lengths=[16, 8],
                                             win_lengths=[64, 32])
    losses["spectral"]["config"].update(fft_sizes=[64, 16], hop_sizes=[16, 4],
                                        win_lengths=[64, 16])
    return cfg


def _weights(jm, seed):
    """Seeded numpy weights over the JAX model's parameter shapes."""
    return randomize(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((B, 2, T))))["params"], seed)


def _pair(cfg, **options):
    """(JAX trainer, its state with seeded TAAE weights, the port's trainer
    with the same weights); `options` go to both constructors (a teacher as
    (JAX model, its params, the port's model))."""
    tr = cfg["training"]
    kw = dict(sample_rate=cfg["sample_rate"], loss_config=tr["loss_configs"],
              optimizer_configs=tr["optimizer_configs"], lr=tr.get("learning_rate"),
              warmup_steps=tr.get("warmup_steps", 0), use_ema=True)
    jkw, tkw = dict(kw), dict(kw)
    for key in ("latent_mask_ratio", "encoder_freeze_on_warmup", "warmup_steps"):
        if key in options:
            jkw[key] = tkw[key] = options[key]
    if "teacher" in options:
        jt, tparams, tt = options["teacher"]
        jkw.update(teacher_model=jt, teacher_variables={"params": tparams})
        tkw.update(teacher_model=tt, teacher_variables={
            k: _t(v) for k, v in autoencoder_state_dict(tparams).items()})
    jm = jax_create_model(cfg)
    jtr = JaxTrainer(jm, **jkw)
    state = jtr.init_state(jax.random.PRNGKey(0), jnp.zeros((B, 2, T)))
    state = state.replace(gen_params=_weights(jm, 3))
    state = state.replace(ema_params=jax.tree_util.tree_map(jnp.copy, state.gen_params),
                          gen_opt_state=jtr.gen_optimizer.init(state.gen_params))
    model = create_model_from_config(cfg, "cpu")
    qs = None if state.quantizer_state is None else _tree_np(state.quantizer_state)
    model.load_state_dict({k: _t(v) for k, v in autoencoder_state_dict(
        _tree_np(state.gen_params), quantizer_state=qs).items()}, strict=True)
    ttr = AutoencoderTrainer(model, **tkw)
    ttr.discriminator.load_state_dict({k: _t(v) for k, v in encodec_discriminator_state_dict(
        _tree_np(state.disc_params)).items()})
    return jtr, state, ttr


def _check_step(step, jtr, state, jaux, ttr, taux, gen, grad_tol=(2e-3, 1e-4),
                param_tol=3e-6):
    """Every named loss to 1e-4 relative; every gradient to grad_tol[0] of
    its tensor's peak plus grad_tol[1] of the side's largest (by default the
    bounds of tests/test_torch_ae_training.py: the A-weighted log magnitudes
    amplify the STFTs' f32 differences, sums whose terms cancel keep
    roundoff at the side's scale); the parameters after AdamW to `param_tol`. The
    JAX gradients come from its optimizers' first moments (first steps
    only)."""
    assert set(taux) == set(jaux), (sorted(taux), sorted(jaux))
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-4,
                                   err_msg=f"step {step} {key}")
    to_port = autoencoder_state_dict if gen else encodec_discriminator_state_dict
    params = ttr.params if gen else ttr.disc_params
    if step < 2:
        want = to_port(_jax_grads(state.gen_opt_state if gen else state.disc_opt_state, 0.8))
        floor = grad_tol[1] * max(np.abs(g).max() for g in want.values())
        for n, p in params.items():
            err = np.abs(p.grad.numpy() - want[n]).max()
            assert err <= grad_tol[0] * np.abs(want[n]).max() + floor, (step, n, err)
    want_p = to_port(_tree_np(state.gen_params if gen else state.disc_params))
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n], rtol=0, atol=param_tol,
                                   err_msg=f"step {step} {n}")


def _replay_uniform(monkeypatch, value):
    """JAX's uniform draws of `value`'s size replaced by it (flax traces the
    parameters' own initialisers too, which keep the real draw)."""
    real = jax.random.uniform

    def uniform(key, shape, *args, **kwargs):
        if int(np.prod(shape)) == value.size and not args and not kwargs:
            return jnp.asarray(value).reshape(shape)
        return real(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)


def _audio_and_noise(seed, steps):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, 2, T)) * 0.3).astype(np.float32)
    return audio, [rng.standard_normal((B, LATENT, T // RATIO)).astype(np.float32)
                   for _ in range(steps)]


def test_taae_vae_gan_steps_match_jax(monkeypatch):
    cfg = tiny_config()
    jtr, state, ttr = _pair(cfg)
    audio, noise = _audio_and_noise(0, 2)
    for step in (0, 1):
        _replay_noise(monkeypatch, noise[step])
        state, jaux = jtr.train_step(state, jnp.asarray(audio), jax.random.PRNGKey(2 + step),
                                     step)
        taux = ttr.train_step(_t(audio), noise=_t(noise[step]))
        _check_step(step, jtr, state, jaux, ttr, taux, gen=step == 0)


def test_mask_teacher_and_encoder_freeze_match_jax(monkeypatch):
    # warm-up 1: step 0 trains the generator (masked latents, the teacher's
    # five losses), step 1 the discriminator (masked too: JAX's train=True),
    # step 2 the generator with the encoder frozen. The teacher is another
    # seeded tiny TAAE; it encodes with the same replayed VAE noise.
    cfg = tiny_config()
    jteacher = jax_create_model(cfg)
    tparams = _weights(jteacher, 7)
    tteacher = create_model_from_config(cfg, "cpu")
    jtr, state, ttr = _pair(cfg, latent_mask_ratio=0.5, encoder_freeze_on_warmup=True,
                            warmup_steps=1, teacher=(jteacher, tparams, tteacher))
    assert [m.name for m in ttr.losses_gen.losses] == [m.name for m in jtr.losses_gen.losses]
    audio, noise = _audio_and_noise(1, 3)
    # the JAX mask is drawn in the latents' [B, C, T] (AudioAutoencoder.encode's)
    masks = [np.random.default_rng(10 + s).random((B, LATENT, T // RATIO)).astype(np.float32)
             for s in range(3)]
    encoder = [n for n in ttr.params if n.startswith("encoder.")]
    for step in range(3):
        _replay_noise(monkeypatch, noise[step])
        _replay_uniform(monkeypatch, masks[step])
        jtr._jit_cache.clear()
        before = {n: ttr.params[n].detach().clone() for n in encoder}
        state, jaux = jtr.train_step(state, jnp.asarray(audio), jax.random.PRNGKey(5 + step),
                                     step)
        taux = ttr.train_step(_t(audio), noise=_t(noise[step]), draws={
            "latent_mask": _t(masks[step]),
            "teacher_noise": _t(noise[step])})
        gen = step != 1
        if step == 0:
            assert {"latent_distill_loss", "mrstft_loss_distill",
                    "mrstft_loss_own_latents_teacher",
                    "mrstft_loss_teacher_latents_own"} <= set(taux)
        # the gradients to 2e-2 of a tensor's peak + 1e-3 of the side's
        # largest: the teacher's four STFT terms pile up f32 roundoff in the
        # cancelling sums (a transposed conv's bias): against an f64 run of
        # the port, the port's f32 gradient lay 1.3e-2 and JAX's 2.3e-3 of
        # a tensor's peak away at worst, each package's own f32 error. The
        # parameters to 3e-5, a fifth of a step's largest move (lr 1.5e-4):
        # AdamW's first update lr * g / (|g| + 1e-3) is steep in a gradient
        # near 0, where that roundoff is all there is
        _check_step(step, jtr, state, jaux, ttr, taux, gen, grad_tol=(2e-2, 1e-3),
                    param_tol=3e-5)
        if step == 2:  # frozen: a zero gradient, AdamW's moments still move it
            assert all(float(ttr.params[n].grad.abs().max()) == 0 for n in encoder)
            assert any(not torch.equal(ttr.params[n], before[n]) for n in encoder)


def test_dithered_fsq_generator_step_matches_jax(monkeypatch):
    # 2 codebooks of 2 dims at 5 levels over the 4 latents; the dropout and
    # dither draws replayed, item 0 keeping its unquantized tanh and item 1
    # dithered
    cfg = tiny_config(fsq=True)
    jtr, state, ttr = _pair(cfg)
    audio, _ = _audio_and_noise(2, 0)
    uniform = np.random.default_rng(3).random((B, T // RATIO, 2, 2)).astype(np.float32)
    keep, apply = np.array([True, False]), np.array([False, True])
    bern = iter([keep, apply])
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(next(bern)).reshape(shape))
    _replay_uniform(monkeypatch, uniform)
    state, jaux = jtr.train_step(state, jnp.asarray(audio), jax.random.PRNGKey(4), 0)
    taux = ttr.train_step(_t(audio), noise={
        "keep": torch.from_numpy(keep), "apply": torch.from_numpy(apply),
        "dither": _t(uniform.reshape(B, T // RATIO, LATENT).transpose(0, 2, 1))})
    _check_step(0, jtr, state, jaux, ttr, taux, gen=True)
