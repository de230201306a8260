"""DAC VAE-GAN training of the port against the JAX package on the CPU: tiny
twins of the two shipped DAC VAE configs (autoencoders/stable_audio_1_0_vae.json,
stereo; dac_2048_32_vae.json, mono) with the same weights on both sides
(carried over by io/from_jax.py), the same batch and VAE noise, through one
generator step and one discriminator step of each package's
AutoencoderTrainer in f32; DAC's snake with beta tied to alpha, whose two
gradients autograd sums into the one parameter, against the JAX gradient of
x + sin^2(alpha x) / (alpha + 1e-9), alone and fused into the conv; then the
shipped configs' trainers and the `train` entry point.

JAX's VAE draws its noise inside its jitted step; the tests replace its
`vae_sample` by one that adds the numpy noise the port is handed
(tests/test_torch_ae_training.py does the same). Each tolerance is stated
where it is used.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import dac as jdac
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_create_wrapper)
from stable_audio_tools_tpu_torch.io.from_jax import (autoencoder_state_dict,
                                                      encodec_discriminator_state_dict)
from stable_audio_tools_tpu_torch.models import dac as tdac
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

from test_torch_ae_training import _jax_grads, _replay_noise, _tree_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUTOENCODERS = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                            "autoencoders")
NAMES = ("stable_audio_1_0_vae", "dac_2048_32_vae")


def _shipped(name: str) -> dict:
    with open(os.path.join(AUTOENCODERS, f"{name}.json")) as f:
        return json.load(f)


B, T, LATENT = 2, 1024, 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tiny_dac_config(name: str) -> dict:
    """The shipped config at toy size: the encoder's d_model 8 and strides
    [2, 4] into 2 x 4 channels, the decoder's 32 channels at rates [4, 2]
    from 4 latents (the same blocks: residual units at d = 1 / 3 / 9, the
    strided and transposed convs, the snake + conv_outs, `proj_out`); the
    discriminator's filters 8 over two STFT scales, two MRSTFT resolutions;
    both optimizers AdamW with eps 1e-3 (see
    tests/test_torch_ae_training.py); f32 compute."""
    cfg = _shipped(name)
    cfg["sample_size"] = T
    m = cfg["model"]
    m["encoder"]["config"].update(d_model=8, strides=[2, 4], latent_dim=2 * LATENT)
    m["decoder"]["config"].update(channels=32, rates=[4, 2], latent_dim=LATENT)
    m.update(latent_dim=LATENT, downsampling_ratio=8)
    tr = cfg["training"]
    del tr["compute_dtype"]
    adamw = {"optimizer": {"type": "AdamW", "config": {"lr": 1e-4, "betas": [0.8, 0.99],
                                                       "eps": 1e-3}}}
    tr["optimizer_configs"] = {"autoencoder": adamw, "discriminator": copy.deepcopy(adamw)}
    losses = tr["loss_configs"]
    losses["discriminator"]["config"] = dict(filters=8, n_ffts=[64, 32], hop_lengths=[16, 8],
                                             win_lengths=[64, 32])
    losses["spectral"]["config"].update(fft_sizes=[64, 16], hop_sizes=[16, 4],
                                        win_lengths=[64, 16])
    return cfg


def _pair(cfg):
    """(JAX trainer, its state, the port's trainer with the same weights)."""
    channels = cfg["audio_channels"]
    jtr = jax_create_wrapper(cfg, jax_create_model(cfg))
    state = jtr.init_state(jax.random.PRNGKey(0), jnp.zeros((B, channels, T)))
    model = create_model_from_config(cfg, "cpu")
    model.load_state_dict({k: _t(v) for k, v in
                           autoencoder_state_dict(_tree_np(state.gen_params)).items()},
                          strict=True)
    ttr = create_training_wrapper_from_config(cfg, model)
    ttr.discriminator.load_state_dict({k: _t(v) for k, v in encodec_discriminator_state_dict(
        _tree_np(state.disc_params)).items()})
    return jtr, state, ttr


@pytest.mark.parametrize("name", NAMES)
def test_dac_vae_steps_match_jax(name, monkeypatch):
    # step 0 (generator) and step 1 (discriminator) of both trainers, f32:
    # every named loss within 1e-4 relative; every gradient within 2e-3 of
    # its tensor's peak plus 1e-4 of the side's largest gradient (the bounds
    # of tests/test_torch_ae_training.py: the A-weighted log magnitudes
    # amplify the STFTs' f32 differences, sums whose terms cancel keep
    # roundoff at the side's scale), the snakes' tied alpha included; the
    # parameters after AdamW within 3e-6. The JAX gradients come from its
    # optimizers' first moments.
    cfg = tiny_dac_config(name)
    jtr, state, ttr = _pair(cfg)
    rng = np.random.default_rng(0)
    channels = cfg["audio_channels"]
    audio = (rng.standard_normal((B, channels, T)) * 0.3).astype(np.float32)
    noise = [rng.standard_normal((B, LATENT, T // 8)).astype(np.float32) for _ in range(2)]
    snakes = [n for n in ttr.params if n.endswith(".alpha")]
    assert snakes and all(ttr.params[n].shape[0] == 1 for n in snakes)
    for step in (0, 1):
        _replay_noise(monkeypatch, noise[step])
        gen = step == 0
        state, jaux = jtr.train_step(state, jnp.asarray(audio), jax.random.PRNGKey(2 + step),
                                     step)
        taux = ttr.train_step(_t(audio), noise=_t(noise[step]))
        assert set(taux) == set(jaux), (sorted(taux), sorted(jaux))
        for key in jaux:
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-4,
                                       err_msg=f"{name} step {step} {key}")
        to_port = autoencoder_state_dict if gen else encodec_discriminator_state_dict
        want = to_port(_jax_grads(state.gen_opt_state if gen else state.disc_opt_state, 0.8))
        params = ttr.params if gen else ttr.disc_params
        assert set(want) == set(params)
        floor = 1e-4 * max(np.abs(g).max() for g in want.values())
        for n, p in params.items():
            assert p.grad is not None, n
            err = np.abs(p.grad.numpy() - want[n]).max()
            assert err <= 2e-3 * np.abs(want[n]).max() + floor, (step, n, err)
        if gen:
            assert all(ttr.params[n].grad.abs().max() > 0 for n in snakes)
        want_p = to_port(_tree_np(state.gen_params if gen else state.disc_params))
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_p[n], rtol=0, atol=3e-6,
                                       err_msg=f"{name} step {step} {n}")


def _snake_ref(x, alpha):
    """x + sin^2(alpha x) / (alpha + 1e-9), alpha [1, C, 1] against x [B, C, T]."""
    return x + jnp.sin(alpha * x) ** 2 / (alpha + 1e-9)


@pytest.mark.parametrize("C", [3, 96])
def test_tied_snake_gradient_matches_jax(C):
    # Snake1d passes its alpha as both the kernel's alpha and its beta; the
    # backward returns a dalpha and a dbeta, and autograd sums them into the
    # one parameter. Against the JAX gradient of the closed form (and the
    # JAX module's), f32: dx and dalpha within 1e-5 of their peaks
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((2, C, 50)) * 2).astype(np.float32)
    alpha = np.exp(rng.standard_normal((1, C, 1)) * 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jx, ja = jax.grad(lambda x, a: jnp.sum(_snake_ref(x, a) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(alpha))
    jm = jdac.Snake1d(features=C)
    jvars = {"params": {"alpha": jnp.asarray(alpha.reshape(C))}}
    jx2, jv = jax.grad(lambda x, v: jnp.sum(jm.apply(v, x) * g.transpose(0, 2, 1)),
                       argnums=(0, 1))(jnp.asarray(x.transpose(0, 2, 1)), jvars)
    np.testing.assert_allclose(np.asarray(jx2).transpose(0, 2, 1), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jv["params"]["alpha"]).reshape(-1),
                               np.asarray(ja).reshape(-1), rtol=1e-5, atol=1e-5)
    tm = tdac.Snake1d(C)
    with torch.no_grad():
        tm.alpha.copy_(_t(alpha))
    xt = _t(x).requires_grad_(True)
    (tm(xt) * _t(g)).sum().backward()
    for got, want in ((xt.grad, jx), (tm.alpha.grad, ja)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_tied_snake_gradient_through_the_fused_conv_matches_jax():
    # a residual unit's k = 7 conv runs snake(x; alpha, alpha) inside the
    # snake-conv Function (ops/conv.py `conv1d` with `pre_snake`); its
    # alpha's gradient sums the kernel's dalpha and dbeta: against JAX's
    # gradient of conv1d(x + sin^2(alpha x) / (alpha + 1e-9)) within 1e-5
    # of the peaks
    rng = np.random.default_rng(4)
    C, k, d = 12, 7, 3
    x = (rng.standard_normal((2, C, 80)) * 2).astype(np.float32)
    alpha = np.exp(rng.standard_normal((1, C, 1)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((C, C, k)) / np.sqrt(C * k)).astype(np.float32)
    g = rng.standard_normal((2, C, 80)).astype(np.float32)
    pad = d * (k - 1) // 2

    def jf(x, a, w):
        y = jax.lax.conv_general_dilated(_snake_ref(x, a), w, (1,), [(pad, pad)],
                                         rhs_dilation=(d,),
                                         dimension_numbers=("NCH", "OIH", "NCH"))
        return jnp.sum(y * g)

    jx, ja, jw = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(alpha),
                                                 jnp.asarray(w))
    unit = tdac.DACResidualUnit(C, d)
    act, conv = unit.block[0], unit.block[1]
    with torch.no_grad():
        act.alpha.copy_(_t(alpha))
        conv.weight_v.copy_(_t(w))
        conv.weight_g.copy_(torch.linalg.vector_norm(conv.weight_v, dim=(1, 2), keepdim=True))
        conv.bias.zero_()
    conv.weight_g.requires_grad_(False)
    xt = _t(x).requires_grad_(True)
    y = conv(xt, pre_snake=act.params(xt.dtype))
    (y * _t(g)).sum().backward()
    for got, want in ((xt.grad, jx), (act.alpha.grad, ja)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_shipped_dac_vae_configs_build_their_trainers(name):
    # the shipped configs' training sections through the factory on the
    # CPU: bf16 compute, the EnCodec discriminator of 64 filters over five
    # scales, MRSTFT (+ L/R for stereo) and the KL at 1e-4
    cfg = _shipped(name)
    w = create_training_wrapper_from_config(copy.deepcopy(cfg),
                                            create_model_from_config(copy.deepcopy(cfg), "cpu"))
    assert w.compute_dtype == torch.bfloat16
    assert len(w.discriminator.discriminators.discriminators) == 5
    stereo = cfg["audio_channels"] == 2
    assert [loss.name for loss in w.losses_gen.losses] == [
        "loss_adv", "feature_matching_loss", "mrstft_loss"] + (
        ["stft_loss_left", "stft_loss_right"] if stereo else []) + ["kl_loss"]
    assert w.losses_gen.losses[-1].weight == 1e-4
    assert isinstance(w.model.encoder, tdac.DACEncoderWrapper)


def test_train_entry_trains_the_mono_dac_vae_and_resumes(tmp_path):
    # `python -m stable_audio_tools_tpu_torch.train` on the CPU with the
    # mono tiny twin: four steps (gen, disc, gen, disc) with finite losses
    # and both learning rates logged, a checkpoint, a resumed run to step 6
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav

    rng = np.random.default_rng(1)
    os.makedirs(tmp_path / "wavs")
    for i in range(3):
        save_wav(str(tmp_path / "wavs" / f"c{i}.wav"),
                 (rng.standard_normal((1, 3000)) * 0.2).astype(np.float32), 44100)
    data = tmp_path / "dataset.json"
    data.write_text(json.dumps({"dataset_type": "audio_dir", "random_crop": True, "datasets": [
        {"id": "d", "path": str(tmp_path / "wavs")}]}))
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps(tiny_dac_config("dac_2048_32_vae")))
    argv = ["--model-config", str(cfg_path), "--dataset-config", str(data),
            "--batch-size", "2", "--num-workers", "0", "--max-steps", "4",
            "--checkpoint-every", "4", "--save-dir", str(tmp_path / "run"), "--device", "cpu",
            "--precision", "32"]
    train.main(argv)
    log = [json.loads(line) for line in
           (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    assert "train/kl_loss" in log[0] and "train/discriminator_loss" in log[1]
    assert all("train/lr" in r and "train/lr_disc" in r for r in log)
    assert all(np.isfinite(v) for r in log for v in r.values())
    resumed = train.main(argv[:9] + ["6"] + argv[10:] +
                         ["--ckpt-path", str(tmp_path / "run" / "step=4.ckpt")])
    assert resumed.wrapper.step == 6


def decoder_dtype_gaps(cfg16, reals):
    """The decoders' dtypes under a bf16 `compute_dtype` in both trainers,
    the same weights on both sides: the JAX trainer's `_ae_forward` (eval
    pass) on `reals`, then the JAX decoder alone on its f32 latents, and the
    port's trainer (its encode replaced by those latents) in the bf16
    config and in f32. Returns each decoded output's largest distance from
    the JAX f32 decode, relative to its peak, and the output dtype of each
    of the port decoder's modules."""
    jm = jax_create_model(cfg16)
    jtr = jax_create_wrapper(cfg16, jm)
    x = jnp.asarray(reals)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                                  "sample": jax.random.PRNGKey(1)}, x)
    params, qs = variables["params"], variables.get("quantizer_state")
    decoded, info = jax.jit(lambda p, q, x: jtr._ae_forward(
        p, q, x, jax.random.PRNGKey(2), train=False)[:2])(params, qs, x)
    assert info["latents"].dtype == jnp.float32
    latents = np.asarray(info["latents"])
    want = np.asarray(jm.apply({**variables}, jnp.asarray(latents), method=jm.decode))
    want = want[..., :reals.shape[-1]]
    peak = np.abs(want).max()
    gaps = {"jax": np.abs(np.asarray(decoded) - want).max() / peak}

    model = create_model_from_config(cfg16, "cpu")
    sd = autoencoder_state_dict(_tree_np(params),
                                quantizer_state=None if qs is None else _tree_np(qs))
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    model.encode = lambda *a, **k: (_t(latents), {})
    dtypes = {}

    def hook(name):
        def record(m, i, o):
            if isinstance(o, torch.Tensor):
                dtypes.setdefault(name, o.dtype)
        return record

    for name, m in model.decoder.named_modules():
        if name:
            m.register_forward_hook(hook(name))
    cfg32 = copy.deepcopy(cfg16)
    del cfg32["training"]["compute_dtype"]
    with torch.no_grad():
        for key, cfg in (("port_bf16", cfg16), ("port_f32", cfg32)):
            got = create_training_wrapper_from_config(cfg, model).ae_forward(_t(reals))[0]
            gaps[key] = np.abs(got.numpy() - want).max() / peak
    return gaps, dtypes


@pytest.mark.parametrize("name", NAMES)
def test_bf16_config_decodes_in_bf16_in_the_port_and_f32_in_jax(name):
    # Under the shipped bf16 compute dtype the JAX trainer hands its DAC
    # decoder the f32 latents of the encoder's f32 proj_out (through the
    # VAE), so the JAX decoder computes in f32; the port's trainer casts the
    # latents to bf16 (the snake kernels take bf16), so every conv of its
    # decoder computes in bf16: a deliberate divergence (ROADMAP queue 3).
    # The JAX trainer's output equals its f32 decode (jitted there, eager
    # here) within 1e-5 of the peak, as does the port's f32 run, and the
    # port's bf16 run lies apart by its rounding: within 5% of the peak,
    # farther than 1e-3 (0.88% and 0.78% when written)
    cfg = tiny_dac_config(name)
    cfg["training"]["compute_dtype"] = "bfloat16"
    reals = (np.random.default_rng(9).standard_normal((B, cfg["audio_channels"], T)) * 0.3
             ).astype(np.float32)
    gaps, dtypes = decoder_dtype_gaps(cfg, reals)
    assert set(dtypes.values()) == {torch.bfloat16}, dtypes
    assert gaps["jax"] <= 1e-5 and gaps["port_f32"] <= 1e-5, gaps
    assert 1e-3 < gaps["port_bf16"] <= 0.05, gaps
