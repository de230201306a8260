"""The autoencoder validation of the port against the JAX package's:
`make_eval_metrics` (training/losses/metrics.py: the STFT, SI-SDR and mel
distances) on seeded audio, and `AutoencoderTrainer.val_step` against the JAX
trainer's `make_val_step` on a tiny SA-2.0-VAE-shaped model with the same
weights and VAE noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_create_wrapper)
from stable_audio_tools_tpu.training.losses import metrics as jmetrics
from stable_audio_tools_tpu_torch.io.from_jax import autoencoder_state_dict
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.ops.stft import mel_filterbank
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from stable_audio_tools_tpu_torch.training.losses import metrics as tmetrics
from test_torch_ae_training import LATENT, _replay_noise, _tree_np, tiny_config


def _audio(seed, shape=(2, 2, 8192)):
    rng = np.random.default_rng(seed)
    reals = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    decoded = (reals + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return decoded, reals


@pytest.mark.parametrize("sample_rate", [16000, 44100])
def test_eval_metrics_match_jax(sample_rate):
    # f32 STFTs by FFT (port) against the JAX conv-DFT: 1e-5 relative. At
    # 44.1 kHz the two lowest HTK mel bands of a 1024-point FFT hold no bin:
    # their log magnitude is -inf and the JAX mel metric NaN; the port leaves
    # those bands out, and equals the JAX metric over the other bands.
    decoded, reals = _audio(sample_rate)
    want = jmetrics.make_eval_metrics(sample_rate)
    got = tmetrics.make_eval_metrics(sample_rate)
    assert sorted(got) == sorted(want) == ["mel", "sisdr", "stft"]
    fb = mel_filterbank(sample_rate, 1024, 128)
    empty = ~fb.any(axis=1)
    assert empty.any() == (sample_rate == 44100)
    if empty.any():
        assert np.isnan(float(want["mel"](jnp.asarray(decoded), jnp.asarray(reals))))
        want["mel"]._fb = want["mel"]._fb[jnp.asarray(~empty)]
    for name in want:
        w = float(want[name](jnp.asarray(decoded), jnp.asarray(reals)))
        g = float(got[name](torch.from_numpy(decoded), torch.from_numpy(reals)))
        assert np.isfinite(g) and abs(g - w) <= 1e-5 * abs(w), (name, g, w)


def test_pesq_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="pesq"):
        tmetrics.make_eval_metrics(16000, {"pesq": {}, "stft": {}})


def test_autoencoder_val_step_matches_jax(monkeypatch):
    # the validation of a tiny SA-2.0-VAE-shaped model (f32; the shipped
    # config's 44.1 kHz, whose JAX mel metric is NaN, see above) with the
    # JAX trainer's weights and its replayed VAE noise: the eval-mode forward
    # with the training weights, each metric of the decoded audio against the
    # reals within 1e-4 relative (two Oobleck levels and the metrics' STFTs,
    # f32)
    cfg = tiny_config()
    T = 4096  # the STFT metric's 2048-point frames reflect-pad 1024 a side
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal((2, 2, T))).astype(np.float32)
    noise = rng.standard_normal((2, LATENT, T // 4)).astype(np.float32)
    jtr = jax_create_wrapper(cfg, jax_create_model(cfg))
    state = jtr.init_state(jax.random.PRNGKey(0), jnp.asarray(audio))
    model = create_model_from_config(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           autoencoder_state_dict(_tree_np(state.gen_params)).items()})
    ttr = create_training_wrapper_from_config(cfg, model)
    # the EMA held away from the weights: validation must not read it
    for e in ttr.ema.values():
        e.mul_(0.5)
    _replay_noise(monkeypatch, noise)
    fb = jmetrics.make_eval_metrics(cfg["sample_rate"])["mel"]._fb
    nonempty = mel_filterbank(cfg["sample_rate"], 1024, 128).any(axis=1)
    real_make = jmetrics.make_eval_metrics

    def make(*args, **kwargs):  # the JAX mel over its non-empty bands, as the port's
        metrics = real_make(*args, **kwargs)
        metrics["mel"]._fb = fb[jnp.asarray(nonempty)]
        return metrics

    monkeypatch.setattr(jmetrics, "make_eval_metrics", make)
    want = jtr.make_val_step()(state, jnp.asarray(audio), jax.random.PRNGKey(3))
    before = {n: p.detach().clone() for n, p in ttr.params.items()}
    got = ttr.val_step(torch.from_numpy(audio), None, noise=torch.from_numpy(noise))
    assert sorted(got) == sorted(want) == ["val/mel", "val/sisdr", "val/stft"]
    for k in want:
        w, g = float(want[k]), float(got[k])
        assert np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w), (k, g, w)
    assert ttr.model.training and ttr.step == 0
    assert all(torch.equal(p, before[n]) and p.grad is None for n, p in ttr.params.items())
