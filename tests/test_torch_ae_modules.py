"""The autoencoder-training modules of the port against the JAX package on the
CPU: the STFT forms, the A-weighting FIR, the STFT losses, the EnCodec
MS-STFT discriminator (its weights carried over by io/from_jax.py) and the
VAE bottleneck's KL.

Inputs are f32 and made with numpy from a seed. The JAX package computes its
STFTs as conv-DFT products at Precision.HIGHEST, the port with torch.stft
(an FFT): the two agree to f32 rounding of sums of n_fft terms; each
tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import bottleneck as jbottleneck
from stable_audio_tools_tpu.models.discriminators import EncodecDiscriminator as JaxEncodec
from stable_audio_tools_tpu.ops import stft as jstft
from stable_audio_tools_tpu.training.losses import auraloss as jaura
from stable_audio_tools_tpu.training.losses import losses as jlosses
from stable_audio_tools_tpu_torch.io.from_jax import encodec_discriminator_state_dict
from stable_audio_tools_tpu_torch.models.bottleneck import VAEBottleneck
from stable_audio_tools_tpu_torch.models.discriminators import EncodecDiscriminator
from stable_audio_tools_tpu_torch.ops import stft as tstft
from stable_audio_tools_tpu_torch.training.losses import auraloss as taura
from stable_audio_tools_tpu_torch.training.losses import losses as tlosses


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * max(np.abs(want).max(), 1e-6))


def _audio(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def test_hann_window_and_a_weighting_taps_are_the_jax_package_s():
    # the same numpy / scipy maths: equal to the bit
    for n in (32, 128, 2048):
        np.testing.assert_array_equal(tstft.hann_window(n), jstft.hann_window(n))
    np.testing.assert_array_equal(tstft.a_weighting_fir(101, 44100),
                                  jstft.a_weighting_fir(101, 44100))


@pytest.mark.parametrize("n_fft,hop,win", [(64, 16, 64), (128, 32, 96), (32, 8, 32)])
def test_stft_mag_matches_jax(n_fft, hop, win):
    # reflect-centred |STFT| of the losses: FFT against the conv-DFT, 1e-5
    # of the peak (f32 sums of n_fft products)
    x = _audio(0, (3, 1000))
    want = jstft.stft_mag_conv(jnp.asarray(x), n_fft, hop, win)
    got = tstft.stft_mag(_t(x), n_fft, hop, win)
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (128, 32)])
def test_stft_reim_normalized_matches_jax(n_fft, hop):
    # the discriminator's STFT: no centring, divided by sqrt(sum window^2)
    # (torchaudio's normalisation, not torch.stft's sqrt(n_fft)); real and
    # imaginary parts in [re | im] order: 1e-5 of the peak
    x = _audio(1, (2, 2, 900))
    want = jstft.stft_reim_conv(jnp.asarray(x), n_fft, hop, n_fft, center=False,
                                normalized=True)
    got = tstft.stft_reim(_t(x), n_fft, hop, n_fft, center=False, normalized=True)
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


def test_apply_fir_matches_jax():
    # 101-tap same-length FIR with zero edges: the port's direct conv against
    # the JAX package's 128-sample Toeplitz fold, both f32 HIGHEST: 1e-6
    x = _audio(2, (2, 2, 700))
    taps = jstft.a_weighting_fir(101, 44100)
    _close(tstft.apply_fir(_t(x), taps).numpy(), jstft.apply_fir(jnp.asarray(x), taps), 1e-6)
    _close(tstft.apply_fir(_t(x[:, 0]), taps).numpy(),
           jstft.apply_fir(jnp.asarray(x[:, 0]), taps), 1e-6)


def test_apply_fir_gradient_matches_jax_with_tf32_off(monkeypatch):
    # the FIR's input gradient against jax.vjp of the JAX package's FIR, 1e-6
    # of the peak; the transposed conv of the backward runs with cuDNN's TF32
    # off, as the forward does (the flag is read where the conv is called)
    x = _audio(3, (2, 2, 700))
    g = _audio(4, (2, 2, 700))
    taps = jstft.a_weighting_fir(101, 44100)
    _, vjp = jax.vjp(lambda v: jstft.apply_fir(v, taps), jnp.asarray(x))
    flags = []
    transposed = tstft.F.conv_transpose1d

    def spy(*args, **kwargs):
        flags.append(torch.backends.cudnn.allow_tf32)
        return transposed(*args, **kwargs)

    monkeypatch.setattr(tstft.F, "conv_transpose1d", spy)
    xt = _t(x).requires_grad_()
    (tstft.apply_fir(xt, taps) * _t(g)).sum().backward()
    _close(xt.grad.numpy(), vjp(jnp.asarray(g))[0], 1e-6)
    assert flags == [False] and torch.backends.cudnn.allow_tf32


SCALES =dict(fft_sizes=(64, 32, 16), hop_sizes=(16, 8, 4), win_lengths=(64, 32, 16))


@pytest.mark.parametrize("kind,kwargs", [
    ("stft", dict(fft_size=64, hop_size=16, win_length=64)),
    ("stft", dict(fft_size=64, hop_size=16, win_length=64, w_lin_mag=1.0,
                  perceptual_weighting=True, sample_rate=44100)),
    ("stft", dict(fft_size=32, hop_size=8, win_length=32, scale_invariance=True)),
    ("mrstft", dict(SCALES, perceptual_weighting=True, sample_rate=44100)),
    ("sumdiff", dict(SCALES, perceptual_weighting=True, sample_rate=44100)),
])
def test_stft_losses_match_jax(kind, kwargs):
    # the losses and their input gradients on [2, 2, 800] stereo pairs: the
    # value to 1e-5 relative, the gradient to 1e-4 of its peak, 5e-4 after
    # the A-weighting (the log magnitude's gradient divides by |X|, and the
    # filter leaves the lowest bins ~50 dB down, where the FFT's and the
    # conv-DFT's f32 roundings differ most: 1.4e-4 measured)
    jcls, tcls = {"stft": (jaura.STFTLoss, taura.STFTLoss),
                  "mrstft": (jaura.MultiResolutionSTFTLoss, taura.MultiResolutionSTFTLoss),
                  "sumdiff": (jaura.SumAndDifferenceSTFTLoss,
                              taura.SumAndDifferenceSTFTLoss)}[kind]
    x, y = _audio(3, (2, 2, 800)), _audio(4, (2, 2, 800))
    jloss, tloss = jcls(**kwargs), tcls(**kwargs)
    want, want_g = jax.jit(jax.value_and_grad(lambda a: jloss(a, jnp.asarray(y))))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_()
    got = tloss(tx, _t(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close(tx.grad.numpy(), want_g, 5e-4 if kwargs.get("perceptual_weighting") else 1e-4)


def test_value_l1_and_auraloss_modules_match_jax():
    # the loss modules' plumbing, weights and decay, and AuralossLoss's
    # (target, input) argument order: f32, 1e-6 relative
    rng = np.random.default_rng(5)
    info = {k: rng.standard_normal((2, 2, 300)).astype(np.float32) for k in ("a", "b")}
    info["kl"] = np.float32(0.7)
    mr = dict(fft_sizes=(32,), hop_sizes=(8,), win_lengths=(32,))
    jmods = [jlosses.ValueLoss("kl", "kl_loss", weight=1e-2),
             jlosses.L1Loss("a", "b", "l1", weight=0.5, decay=0.9),
             jlosses.AuralossLoss(jaura.MultiResolutionSTFTLoss(**mr), "a", "b", "aura"),
             jlosses.LossWithTarget(jaura.MultiResolutionSTFTLoss(**mr), "a", "b", "with")]
    tmods = [tlosses.ValueLoss("kl", "kl_loss", weight=1e-2),
             tlosses.L1Loss("a", "b", "l1", weight=0.5, decay=0.9),
             tlosses.AuralossLoss(taura.MultiResolutionSTFTLoss(**mr), "a", "b", "aura"),
             tlosses.LossWithTarget(taura.MultiResolutionSTFTLoss(**mr), "a", "b", "with")]
    jtotal, jvals = jlosses.MultiLoss(jmods)({k: jnp.asarray(v) for k, v in info.items()}, 3)
    ttotal, tvals = tlosses.MultiLoss(tmods)({k: _t(v) for k, v in info.items()}, 3)
    assert set(tvals) == set(jvals)
    for name in jvals:
        np.testing.assert_allclose(float(tvals[name]), float(jvals[name]), rtol=1e-5)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)


DISC = dict(filters=8, n_ffts=(64, 32), hop_lengths=(16, 8), win_lengths=(64, 32))


@pytest.fixture(scope="module")
def disc_pair():
    """The JAX EncodecDiscriminator with seeded random weights and the port's
    with the same weights."""
    jdisc = JaxEncodec(in_channels=2, **DISC)
    x = jnp.asarray(_audio(6, (2, 2, 512)))
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), x)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tdisc = EncodecDiscriminator(in_channels=2, **DISC)
    sd = encodec_discriminator_state_dict(params)
    assert set(sd) == set(tdisc.state_dict())
    tdisc.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return jdisc, params, tdisc


def test_encodec_discriminator_logits_and_feature_maps_match_jax(disc_pair):
    # per scale: logits [B, 1, frames, bins] (JAX [B, frames, bins, 1]) and
    # the five feature maps (JAX NHWC), f32 convs: 1e-5 of each one's peak
    jdisc, params, tdisc = disc_pair
    x = _audio(7, (2, 2, 700))
    jlogits, jfmaps = jax.jit(jdisc.apply)({"params": params}, jnp.asarray(x))
    tlogits, tfmaps = tdisc(_t(x))
    assert len(tlogits) == len(jlogits) == 2
    for tl, jl, tf, jf in zip(tlogits, jlogits, tfmaps, jfmaps):
        _close(tl.detach().numpy(), np.moveaxis(np.asarray(jl), -1, 1), 1e-5)
        assert len(tf) == len(jf) == 5
        for a, b in zip(tf, jf):
            _close(a.detach().numpy(), np.moveaxis(np.asarray(b), -1, 1), 1e-5)


def test_encodec_discriminator_loss_matches_jax(disc_pair):
    # loss(): discriminator hinge loss, adversarial loss and feature-matching
    # distance from one forward over [reals; fakes], and the fakes' gradient
    # of adv + fm: values 1e-5 relative, gradient 1e-4 of its peak
    jdisc, params, tdisc = disc_pair
    reals, fakes = _audio(8, (2, 2, 600)), _audio(9, (2, 2, 600))

    def jloss(f):
        d, a, fm = jdisc.apply({"params": params}, jnp.asarray(reals), f, method=jdisc.loss)
        return a + fm, (d, a, fm)

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(fakes))
    tf = _t(fakes).requires_grad_()
    got = tdisc.loss(_t(reals), tf)
    (got[1] + got[2]).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
    _close(tf.grad.numpy(), want_g, 1e-4)


def test_vae_bottleneck_kl_matches_jax():
    # vae_sample's latents (with JAX's noise replayed) and KL: f32, 1e-6
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)  # JAX NLC: [mean | scale]
    key = jax.random.PRNGKey(3)
    mean, scale = jnp.split(jnp.asarray(x), 2, axis=-1)
    want_z, want_kl = jbottleneck.vae_sample(mean, scale, key)
    noise = np.asarray(jax.random.normal(key, mean.shape, mean.dtype)).transpose(0, 2, 1)
    z, info = VAEBottleneck().encode(_t(x.transpose(0, 2, 1)), noise=_t(noise),
                                     return_info=True)
    _close(z.numpy().transpose(0, 2, 1), want_z, 1e-6)
    np.testing.assert_allclose(float(info["kl"]), float(want_kl), rtol=1e-6)
