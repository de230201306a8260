"""The remaining bottlenecks in the port against the JAX package on the CPU,
f32, the same weights (io/from_jax.py, seeded numpy values) and the same
inputs and draws: the DAC residual VQ (`dac_rvq`, `dac_rvq_vae`: its codes
exactly, both code layouts, `n_quantizers`, `quantize_on_decode` in encode,
decode, decode_quantized and decode_tokens, the unread `quantizer_dropout`),
the RVQ-VAE (`rvq_vae`, its training state), the decoders' noise
augmentation and softnorm's `noise_regularize` under a shared draw; the
port's DAC RVQ state dict taken into JAX by its own importer; the
bottlenecks' loss modules; and a generator step of the autoencoder trainer
with each new bottleneck (the `quantize_on_decode` shortcut included).

The JAX draws are replaced by the port's (`jax.random.normal` for the
augmentation, `vae_sample` for the VAE noise). Each tolerance is stated
where it is used."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.io import checkpoints as jckpt
from stable_audio_tools_tpu.models import bottleneck as jbn
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.autoencoders import (
    create_loss_modules_from_bottleneck as jax_losses)
from stable_audio_tools_tpu_torch.io.from_jax import autoencoder_state_dict, bottleneck_state_dict
from stable_audio_tools_tpu_torch.models import bottleneck as tbn
from stable_audio_tools_tpu_torch.models.factory import _bottleneck, create_model_from_config
from stable_audio_tools_tpu_torch.training.autoencoders import create_loss_modules_from_bottleneck

from test_torch_ae_training import _jax_grads, _replay_noise, one_torch_thread  # noqa: F401
from test_torch_taae_training import _audio_and_noise, _pair
from test_torch_taae_training import tiny_config as taae_tiny_config
from test_torch_transformer_options import randomize

B, T, C = 2, 12, 6  # batch, frames, latent channels of the module tests
N_CB, CB_SIZE, CB_DIM = 3, 16, 4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _x(seed, channels=C, frames=T):
    return np.random.default_rng(seed).standard_normal((B, channels, frames)).astype(np.float32)


def _nlc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 1))


def _nct(a):
    return np.asarray(a).transpose(0, 2, 1)


def _jax_bottleneck(module, channels, seed):
    """(module, its seeded params) for encode on [B, T, channels]."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((B, T, channels)), return_info=True, method=module.encode))
    return module, randomize(shapes.get("params", {}), seed)


def _port(module, params):
    if params:
        sd = {}
        bottleneck_state_dict(sd, "b", params)
        module.load_state_dict({k[2:]: _t(v) for k, v in sd.items()}, strict=True)
    return module


@pytest.fixture(scope="module")
def dac_pairs():
    """{quantize_on_decode: (JAX DACRVQBottleneck, params, the port's)} with
    the same weights."""
    out = {}
    for qod in (False, True):
        kw = dict(input_dim=C, n_codebooks=N_CB, codebook_size=CB_SIZE, codebook_dim=CB_DIM,
                  quantize_on_decode=qod)
        jm, params = _jax_bottleneck(jbn.DACRVQBottleneck(**kw), C, 1)
        out[qod] = (jm, params, _port(tbn.DACRVQBottleneck(**kw), params))
    return out


def _apply(jm, params, method, *args, **kwargs):
    return jm.apply({"params": params}, *args, method=getattr(jm, method),
                    rngs={"sample": jax.random.PRNGKey(3)}, **kwargs)


# -- the DAC residual VQ ---------------------------------------------------------


@pytest.mark.parametrize("qod", [False, True])
def test_dac_rvq_encode_matches_jax(dac_pairs, qod):
    # codes exactly equal; z, z_e latents and the two losses within 1e-5 of
    # their peak (f32 products of width 4-6)
    jm, params, port = dac_pairs[qod]
    x = _x(qod)
    jz, jinfo = _apply(jm, params, "encode", _nlc(x), return_info=True)
    tz, tinfo = port.encode(_t(x), return_info=True)
    np.testing.assert_array_equal(tinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
    assert tinfo["codes"].shape == (B, N_CB, T)
    for key, got, want in (("out", tz, jz), ("z", tinfo["z"], jinfo["z"]),
                           ("latents", tinfo["latents"], jinfo["latents"]),
                           ("pre_quantizer", tinfo["pre_quantizer"], jinfo["pre_quantizer"])):
        want = _nct(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=key)
    for key in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]), rtol=1e-5)
    # without info: quantize_on_decode passes the input through untouched
    plain = port.encode(_t(x))
    np.testing.assert_array_equal(plain.detach().numpy(), x) if qod else \
        np.testing.assert_allclose(plain.detach().numpy(), tz.detach().numpy(), atol=0)


@pytest.mark.parametrize("qod", [False, True])
def test_dac_rvq_decode_paths_match_jax(dac_pairs, qod):
    # decode (quantizes first with quantize_on_decode), decode_quantized
    # (never), decode_tokens from both code layouts ([B, Q, T] wins when Q
    # == T is ambiguous) and never re-quantizing: 1e-5 of the peak
    jm, params, port = dac_pairs[qod]
    x = _x(10 + qod)
    for method in ("decode", "decode_quantized"):
        want = _nct(_apply(jm, params, method, _nlc(x)))
        got = getattr(port, method)(_t(x)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), err_msg=method)
    codes = np.random.default_rng(4).integers(0, CB_SIZE, (B, N_CB, T))
    want = _nct(_apply(jm, params, "decode_tokens", jnp.asarray(codes)))
    for layout in (codes, codes.transpose(0, 2, 1)):
        got = port.decode_tokens(torch.from_numpy(layout)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    square = np.random.default_rng(5).integers(0, CB_SIZE, (B, N_CB, N_CB))
    want = _nct(_apply(jm, params, "decode_tokens", jnp.asarray(square)))
    got = port.decode_tokens(torch.from_numpy(square)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2])
def test_dac_rvq_n_quantizers_masks_the_later_stages(dac_pairs, n):
    # the stages from n on add nothing to z (their codes and losses still
    # count): z within 1e-5 of the peak, codes equal, losses 1e-5 relative
    jm, params, port = dac_pairs[False]
    x = _x(20 + n)
    jz, jinfo = _apply(jm, params, "encode", _nlc(x), return_info=True, n_quantizers=n)
    tz, tinfo = port.encode(_t(x), return_info=True, n_quantizers=n)
    np.testing.assert_array_equal(tinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
    np.testing.assert_allclose(tz.detach().numpy(), _nct(jz), atol=1e-5 * np.abs(jz).max())
    partial = sum(q.from_codes(tinfo["codes"].transpose(1, 2)[..., i])
                  for i, q in enumerate(port.quantizer.quantizers) if i < n)
    np.testing.assert_allclose(tz.detach().numpy(), partial.transpose(1, 2).detach().numpy(),
                               atol=1e-5 * np.abs(jz).max())
    np.testing.assert_allclose(float(tinfo["vq/codebook_loss"]), float(jinfo["vq/codebook_loss"]),
                               rtol=1e-5)


def test_dac_rvq_gradients_match_jax(dac_pairs):
    # straight-through z_e + sg(z_q - z_e) and the two losses: the gradient
    # of sum(z * w) + commitment + codebook w.r.t. every parameter and the
    # input, 1e-5 of each tensor's peak
    jm, params, port = dac_pairs[False]
    x = _x(30)
    w = np.random.default_rng(31).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xin):
        z, info = jm.apply({"params": p}, xin, return_info=True, method=jm.encode)
        return (jnp.sum(z * _nlc(w)) + info["vq/commitment_loss"]
                + info["vq/codebook_loss"])

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, _nlc(x))
    xt = _t(x).requires_grad_(True)
    port.zero_grad()
    z, info = port.encode(xt, return_info=True)
    ((z * _t(w)).sum() + info["vq/commitment_loss"] + info["vq/codebook_loss"]).backward()
    np.testing.assert_allclose(xt.grad.numpy(), _nct(jgx), atol=1e-5 * np.abs(jgx).max())
    # the Dense kernel's gradient, against the weight-norm product's: read
    # the effective weight's gradient through autograd of the port's w
    for i, q in enumerate(port.quantizer.quantizers):
        jq = jgp["quantizer"][f"quantizers_{i}"]
        want = np.asarray(jq["codebook"])
        np.testing.assert_allclose(q.codebook.weight.grad.numpy(), want,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12))
        want = np.asarray(jq["out_proj"]["bias"])
        np.testing.assert_allclose(q.out_proj.bias.grad.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


def test_dac_rvq_vae_matches_jax(monkeypatch):
    # the VAE's sample (the same noise) then the DAC RVQ: codes equal, z and
    # the KL within 1e-5; with quantize_on_decode the sample itself comes
    # back (no codes) and decode quantizes
    noise = _x(41)
    _replay_noise(monkeypatch, noise)
    kw = dict(input_dim=C, n_codebooks=N_CB, codebook_size=CB_SIZE, codebook_dim=CB_DIM)
    # the quantize_on_decode module's encode makes no parameters: both take these
    _, params = _jax_bottleneck(jbn.DACRVQVAEBottleneck(**kw), 2 * C, 2)
    for qod in (False, True):
        kw["quantize_on_decode"] = qod
        jm = jbn.DACRVQVAEBottleneck(**kw)
        port = _port(tbn.DACRVQVAEBottleneck(**kw), params)
        x = _x(40, 2 * C)
        jz, jinfo = _apply(jm, params, "encode", _nlc(x), return_info=True)
        tz, tinfo = port.encode(_t(x), return_info=True, noise=_t(noise))
        assert ("codes" in tinfo) == ("codes" in jinfo) == (not qod)
        if not qod:
            np.testing.assert_array_equal(tinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
        np.testing.assert_allclose(tz.detach().numpy(), _nct(jz), atol=1e-5 * np.abs(jz).max())
        np.testing.assert_allclose(float(tinfo["kl"]), float(jinfo["kl"]), rtol=1e-5)
        want = _nct(_apply(jm, params, "decode", jz))
        got = port.decode(tz).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_quantizer_dropout_is_read_nowhere():
    # the JAX DACResidualVQ has the field and nothing reads it; its
    # bottlenecks do not take it (the factory's filter drops the key): the
    # port's outputs with quantizer_dropout 0.9 equal those with 0, as JAX's
    x = _nlc(_x(50))
    outs = []
    for p in (0.0, 0.9):
        jm = jbn.DACResidualVQ(input_dim=C, n_codebooks=N_CB, codebook_size=CB_SIZE,
                               codebook_dim=CB_DIM, quantizer_dropout=p)
        params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 3)
        outs.append(np.asarray(jm.apply({"params": params}, x)[0]))
        port = tbn.DACResidualVQ(C, N_CB, CB_SIZE, CB_DIM, quantizer_dropout=p)
        sd = {}
        bottleneck_state_dict(sd, "b", {"quantizer": params})
        port.load_state_dict({k[len("b.quantizer."):]: _t(v) for k, v in sd.items()})
        port.train()
        outs.append(port(torch.from_numpy(np.asarray(x)))[0].detach().numpy())
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5 * np.abs(outs[0]).max())
    b = _bottleneck({"type": "dac_rvq", "config": {"input_dim": C, "quantizer_dropout": 0.5}})
    assert b.quantizer.quantizer_dropout == 0.0


def test_port_dac_rvq_state_dict_loads_into_jax_by_its_importer():
    # the port's names are the reference's: JAX's import_dac_rvq folds the
    # port's weight-norm projections into its Dense kernels and both give
    # the same codes and latents (1e-5 of the peak) from the port's own
    # seeded init
    from stable_audio_tools_tpu_torch.models.factory import init_random_

    port = init_random_(tbn.DACRVQBottleneck(C, N_CB, CB_SIZE, CB_DIM),
                        torch.Generator().manual_seed(6))
    sd = {f"bottleneck.{k}": v.numpy() for k, v in port.state_dict().items()}
    assert sorted(k for k in sd if k.startswith("bottleneck.quantizer.quantizers.0.")) == [
        f"bottleneck.quantizer.quantizers.0.{n}" for n in (
            "codebook.weight", "in_proj.bias", "in_proj.weight_g", "in_proj.weight_v",
            "out_proj.bias", "out_proj.weight_g", "out_proj.weight_v")]
    params = {"quantizer": jckpt.import_dac_rvq(sd, "bottleneck.quantizer.", N_CB)}
    jm = jbn.DACRVQBottleneck(input_dim=C, n_codebooks=N_CB, codebook_size=CB_SIZE,
                              codebook_dim=CB_DIM)
    x = _x(60)
    jz, jinfo = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, _nlc(x),
                         return_info=True, method=jm.encode)
    tz, tinfo = port.encode(_t(x), return_info=True)
    np.testing.assert_array_equal(tinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
    np.testing.assert_allclose(tz.detach().numpy(), _nct(jz), atol=1e-5 * np.abs(jz).max())


def test_port_dac_codec_loads_into_jax_by_import_autoencoder_state_dict():
    # a tiny DAC codec (DAC towers + dac_rvq) from the port's seeded init:
    # its whole state dict through JAX's import_autoencoder_state_dict and
    # import_dac_rvq (import_codec_variables), the same codes and the same
    # decode of them (1e-4 of the peak: the towers' f32 convs)
    from stable_audio_tools_tpu_torch.models.factory import init_random_

    cfg = _dac_codec_config()
    port = init_random_(create_model_from_config(cfg, "cpu"), torch.Generator().manual_seed(8))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jm = jax_create_model(cfg)
    variables = jckpt.import_codec_variables(jm, sd)
    audio = (0.3 * np.random.default_rng(9).standard_normal((B, 1, 256))).astype(np.float32)
    _, jinfo = jm.apply(variables, jnp.asarray(audio), return_info=True, method=jm.encode)
    _, tinfo = port.encode(_t(audio), return_info=True)
    np.testing.assert_array_equal(tinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
    want = np.asarray(jm.apply(variables, jinfo["codes"], method=jm.decode_tokens))
    got = port.decode_tokens(tinfo["codes"]).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _dac_codec_config():
    return {"model_type": "autoencoder", "sample_size": 256, "sample_rate": 16000,
            "audio_channels": 1,
            "model": {"encoder": {"type": "dac", "config": {"d_model": 4, "strides": [2, 4],
                                                            "latent_dim": C}},
                      "decoder": {"type": "dac", "config": {"latent_dim": C, "channels": 16,
                                                            "rates": [4, 2]}},
                      "bottleneck": {"type": "dac_rvq", "config": {
                          "input_dim": C, "n_codebooks": N_CB, "codebook_size": CB_SIZE,
                          "codebook_dim": CB_DIM}},
                      "latent_dim": C, "downsampling_ratio": 8, "io_channels": 1}}


# -- the RVQ-VAE ------------------------------------------------------------------


def test_rvq_vae_matches_jax_with_its_training_state(monkeypatch):
    # the VAE's sample then the RVQ: a training pass (k-means init, EMA) then
    # an eval pass; codes equal, z and the KL / commitment loss within 1e-5,
    # the state after the training pass within 1e-5 of its peak
    noise = _x(71)
    _replay_noise(monkeypatch, noise)
    kw = dict(dim=C, codebook_size=8, num_quantizers=2, kmeans_iters=5)
    jm = jbn.RVQVAEBottleneck(**kw)
    x = _x(70, 2 * C)
    variables = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                        _nlc(x), method=jm.encode)
    port = tbn.RVQVAEBottleneck(**kw)
    port.quantizer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                                    variables["quantizer_state"]["quantizer"].items()})
    (jz, jinfo), upd = jm.apply(variables, _nlc(x), return_info=True, train=True,
                                method=jm.encode, mutable=["quantizer_state"],
                                rngs={"sample": jax.random.PRNGKey(2)})
    tz, tinfo = port.encode(_t(x), return_info=True, train=True, noise=_t(noise))
    np.testing.assert_array_equal(tinfo["quantizer_indices"].numpy(),
                                  np.asarray(jinfo["quantizer_indices"]))
    np.testing.assert_allclose(tz.detach().numpy(), _nct(jz), atol=1e-5 * np.abs(jz).max())
    for key in ("kl", "quantizer_loss"):
        np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]), rtol=1e-5)
    for name, want in upd["quantizer_state"]["quantizer"].items():
        want = np.asarray(want, np.float32)
        got = getattr(port.quantizer, name).float().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)
    variables = {**variables, **upd}
    jz, jinfo = jm.apply(variables, _nlc(x), return_info=True, method=jm.encode,
                         rngs={"sample": jax.random.PRNGKey(2)})
    tz, tinfo = port.encode(_t(x), return_info=True, noise=_t(noise))
    np.testing.assert_array_equal(tinfo["quantizer_indices"].numpy(),
                                  np.asarray(jinfo["quantizer_indices"]))
    codes = tinfo["quantizer_indices"]
    want = _nct(jm.apply(variables, jnp.asarray(codes.numpy()), method=jm.decode_tokens))
    for layout in (codes, codes.transpose(1, 2)):
        np.testing.assert_allclose(port.decode_tokens(layout).numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


# -- the decoders' noise augmentation ------------------------------------------------


def _replay_normal(monkeypatch, values):
    """JAX's normal draws of each value's size replaced by it, in turn
    (flax traces parameter initialisers too: other sizes pass through)."""
    real = jax.random.normal
    queue = list(values)

    def normal(key, shape, dtype=jnp.float32):
        for i, v in enumerate(queue):
            if int(np.prod(shape)) == v.size:
                return jnp.asarray(queue.pop(i)).reshape(shape).astype(dtype)
        return real(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


AUG = 3


def _decode_params(jm, seed):
    """Seeded params of encode's and decode's (softnorm makes its
    noise_scaling_factor in decode, the DAC RVQ its stages in encode)."""
    params = dict(_jax_bottleneck(jm, C, seed)[1])
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((B, T, C)), method=jm.decode))
    params.update(randomize(shapes.get("params", {}), seed + 1))
    return params


@pytest.mark.parametrize("kind", ["softnorm", "wasserstein", "fsq", "dac_rvq"])
def test_noise_augmentation_matches_jax(monkeypatch, kind):
    # decode joins AUG standard-normal channels after the latents (softnorm's
    # times its noise_scaling_factor, randomized here): the same draw on both
    # sides, 1e-6 of the peak; through decode_tokens too for the FSQ and the
    # DAC RVQ
    cfg = {"softnorm": {"dim": C}, "wasserstein": {}, "fsq": {"levels": [3, 3, 3],
                                                             "num_codebooks": 2},
           "dac_rvq": {"input_dim": C, "n_codebooks": N_CB, "codebook_size": CB_SIZE,
                       "codebook_dim": CB_DIM}}[kind]
    cfg = dict(cfg, noise_augment_dim=AUG)
    jcls = {"softnorm": jbn.SoftNormBottleneck, "wasserstein": jbn.WassersteinBottleneck,
            "fsq": jbn.FSQBottleneck, "dac_rvq": jbn.DACRVQBottleneck}[kind]
    jm = jcls(**cfg)
    params = _decode_params(jm, 11)
    port = _port(_bottleneck({"type": kind, "config": cfg}), params)
    x = _x(80)
    noise = np.random.default_rng(81).standard_normal((B, AUG, T)).astype(np.float32)
    _replay_normal(monkeypatch, [noise.transpose(0, 2, 1)])
    want = _nct(_apply(jm, params, "decode", _nlc(x)))
    feed = {"augment": _t(noise)} if kind == "softnorm" else _t(noise)
    got = port.decode(_t(x), noise=feed).detach().numpy()
    assert got.shape == (B, C + AUG, T)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    if kind in ("fsq", "dac_rvq"):
        q = 2 if kind == "fsq" else N_CB
        codes = np.random.default_rng(82).integers(0, 9 if kind == "fsq" else CB_SIZE,
                                                   (B, q, T))
        _replay_normal(monkeypatch, [noise.transpose(0, 2, 1)])
        want = _nct(_apply(jm, params, "decode_tokens", jnp.asarray(codes)))
        got = port.decode_tokens(torch.from_numpy(codes), noise=_t(noise)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_softnorm_noise_regularize_matches_jax(monkeypatch):
    # in training: x + normal x std over time x 1e-2, then the augmentation;
    # out of training the regularisation is off: 1e-6 of the peak
    jm = jbn.SoftNormBottleneck(dim=C, noise_augment_dim=AUG, noise_regularize=True)
    params = _decode_params(jm, 13)
    port = _port(tbn.SoftNormBottleneck(C, AUG, True), params)
    x = _x(90)
    rng = np.random.default_rng(91)
    reg = rng.standard_normal((B, C, T)).astype(np.float32)
    aug = rng.standard_normal((B, AUG, T)).astype(np.float32)
    for train in (True, False):
        _replay_normal(monkeypatch, [reg.transpose(0, 2, 1), aug.transpose(0, 2, 1)])
        want = _nct(_apply(jm, params, "decode", _nlc(x), train=train))
        got = port.decode(_t(x), train=train, noise={"regularize": _t(reg),
                                                     "augment": _t(aug)}).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    assert not np.allclose(got[:, :C], port.decode(_t(x), train=True, noise={
        "regularize": _t(reg), "augment": _t(aug)}).detach().numpy()[:, :C])


def test_decode_draws_from_the_generator_and_the_factory_counts_the_channels():
    # without `noise` the augmentation draws from the generator: the same seed,
    # the same channels; the decoder's latent_dim counts them, as in JAX
    b = _bottleneck({"type": "wasserstein", "config": {"noise_augment_dim": AUG}})
    x = _t(_x(95))
    a1 = b.decode(x, generator=torch.Generator().manual_seed(1))
    a2 = b.decode(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a1, a2) and a1.shape == (B, C + AUG, T)
    cfg = copy.deepcopy(_dac_codec_config())
    cfg["model"]["bottleneck"]["config"]["noise_augment_dim"] = AUG
    cfg["model"]["decoder"]["config"]["latent_dim"] = C + AUG
    model = create_model_from_config(cfg, "cpu")
    audio = _t(0.3 * np.random.default_rng(96).standard_normal((1, 1, 256)))
    z = model.encode(audio)
    y1 = model.decode(z, generator=torch.Generator().manual_seed(3))
    y2 = model.decode(z, generator=torch.Generator().manual_seed(3))
    assert torch.equal(y1, y2) and y1.shape == (1, 1, 256)


# -- losses and the AE trainer ---------------------------------------------------------


def test_loss_modules_of_the_new_bottlenecks_match_jax():
    cfg = {"bottleneck": {"weights": {"kl": 1e-4, "codebook": 0.5, "commitment": 0.3}}}
    kw = dict(input_dim=C, n_codebooks=N_CB, codebook_size=CB_SIZE, codebook_dim=CB_DIM)
    for jmod, tmod in ((jbn.RVQVAEBottleneck(), tbn.RVQVAEBottleneck()),
                       (jbn.DACRVQBottleneck(**kw), tbn.DACRVQBottleneck(**kw)),
                       (jbn.DACRVQVAEBottleneck(**kw), tbn.DACRVQVAEBottleneck(**kw))):
        for c in (cfg, {}):
            want = [(m.name, m.key, m.weight) for m in jax_losses(jmod, c)]
            got = [(m.name, m.key, m.weight) for m in create_loss_modules_from_bottleneck(tmod, c)]
            assert got == want, type(tmod).__name__


def _ae_config(kind: str, qod: bool = False) -> dict:
    """The tiny TAAE trainer config of tests/test_torch_taae_training.py with
    the bottleneck `kind`."""
    cfg = taae_tiny_config()
    m = cfg["model"]
    latent = m["latent_dim"]
    vae = kind.endswith("_vae")
    m["encoder"]["config"]["latent_dim"] = 2 * latent if vae else latent
    if kind == "rvq_vae":
        m["bottleneck"] = {"type": kind, "config": {"dim": latent, "codebook_size": 8,
                                                    "num_quantizers": 2, "kmeans_iters": 3}}
    else:
        m["bottleneck"] = {"type": kind, "config": {
            "input_dim": latent, "n_codebooks": 2, "codebook_size": 8, "codebook_dim": 2,
            "quantize_on_decode": qod}}
    cfg["training"]["loss_configs"]["bottleneck"] = {"type": "kl", "weights": {
        "kl": 1e-4, "codebook": 1.0, "commitment": 0.25}}
    return cfg


def _wn_grads(dW, v, g):
    """The gradient of w = g v / ||v|| (rows) by v and g, from dL/dw
    [out, in]: g / ||v|| (dw - (dw . v^) v^) and dw . v^; and the peak of
    g / ||v|| dw, the scale before the projection cancels its part along v."""
    v, g = v[:, :, 0].astype(np.float64), g.reshape(-1).astype(np.float64)
    norm = np.linalg.norm(v, axis=1, keepdims=True)
    vh = v / norm
    along = (dW * vh).sum(1, keepdims=True)
    scaled = g[:, None] / norm * dW
    return ((scaled - g[:, None] / norm * along * vh)[:, :, None], along.reshape(-1, 1, 1),
            np.abs(scaled).max())


@pytest.mark.parametrize("kind,qod", [("dac_rvq", True), ("dac_rvq_vae", False),
                                      ("rvq_vae", False)])
def test_generator_step_with_the_new_bottlenecks_matches_jax(monkeypatch, kind, qod):
    # one generator step of each package's AE trainer: the DAC RVQ's
    # codebook and commitment losses, with quantize_on_decode the decode of
    # encode's quantized z (JAX :384-395; the DAC RVQ-VAE quantizes in
    # encode and decodes z as a plain DAC RVQ does), the RVQ-VAE's KL and commitment
    # loss (its k-means init in the step), the VAE noise replayed.
    # - every named loss to 1e-4 relative;
    # - every gradient to 5e-3 of its tensor's peak + 1e-4 of the side's
    #   largest: against an f64 run of the port, the port's f32 gradient lay
    #   1.4e-3 and JAX's 1.7e-3 of a tensor's peak away at worst (dac_rvq,
    #   the encoder's weight-norm gains), each package's own f32 error;
    # - the DAC projections: JAX trains plain Dense kernels, the port the
    #   reference's weight-norm v and g, so their gradients are compared
    #   through the chain rule of w = g v / ||v|| (v's bound taken at the
    #   peak of g / ||v|| dw: the projection off v cancels most of a row,
    #   and JAX's f32 error in dw with it), and their values after the step
    #   not at all (ROADMAP queue 3);
    # - every other parameter after AdamW to lr / eps (0.1) x its gradient
    #   bound + 3e-6: the first update lr g / (|g| + eps) moves by at most
    #   that much per unit of gradient.
    cfg = _ae_config(kind, qod)
    jtr, state, ttr = _pair(cfg)  # an RVQ's state carried over too
    before = {n: p.detach().numpy().copy() for n, p in ttr.params.items()}
    audio, noise = _audio_and_noise(3, 1)
    if kind.endswith("_vae"):
        _replay_noise(monkeypatch, noise[0])
    state, jaux = jtr.train_step(state, jnp.asarray(audio), jax.random.PRNGKey(6), 0)
    taux = ttr.train_step(_t(audio), noise=_t(noise[0]) if kind.endswith("_vae") else None)
    assert set(taux) == set(jaux), (sorted(taux), sorted(jaux))
    assert ({"codebook_loss", "commitment_loss"} <= set(taux)) == kind.startswith("dac")
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-4, err_msg=key)
    jgrads = _jax_grads(state.gen_opt_state, 0.8)
    want = autoencoder_state_dict({k: v for k, v in jgrads.items() if k != "bottleneck"})
    scale = {}
    for i, q in enumerate(jgrads.get("bottleneck", {}).get("quantizer", {}).values()):
        pre = f"bottleneck.quantizer.quantizers.{i}"
        want[f"{pre}.codebook.weight"] = q["codebook"]
        for proj in ("in_proj", "out_proj"):
            name = f"{pre}.{proj}"
            want[f"{name}.bias"] = q[proj]["bias"]
            want[f"{name}.weight_v"], want[f"{name}.weight_g"], scale[f"{name}.weight_v"] = (
                _wn_grads(q[proj]["kernel"].T, before[f"{name}.weight_v"],
                          before[f"{name}.weight_g"]))
    assert sorted(want) == sorted(ttr.params)
    floor = 1e-4 * max(np.abs(g).max() for g in want.values())
    new = autoencoder_state_dict(jax.tree_util.tree_map(np.asarray, state.gen_params))
    for n, p in ttr.params.items():
        bound = 5e-3 * max(np.abs(want[n]).max(), scale.get(n, 0.0)) + floor
        err = np.abs(p.grad.numpy() - want[n]).max()
        assert err <= bound, (n, err, bound)
        if "quantizers" not in n or "codebook" in n:
            np.testing.assert_allclose(p.detach().numpy(), new[n], rtol=0,
                                       atol=0.1 * bound + 3e-6, err_msg=n)
    if kind == "rvq_vae":
        for name, value in state.quantizer_state["bottleneck"]["quantizer"].items():
            got = getattr(ttr.model.bottleneck.quantizer, name).float().numpy()
            np.testing.assert_allclose(got, np.asarray(value, np.float32), atol=1e-5)
