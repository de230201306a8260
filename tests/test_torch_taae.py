"""The transformer autoencoder (TAAE) and the ELU Oobleck of the port
(models/autoencoders.py) against the JAX package on the CPU: the encoder and
decoder towers (channels 8 at strides [4, 4] under the window (7, 8), and a
head of 128 under the TAAE's own window (31, 32), with the snake), the whole
AudioAutoencoder round trip with the VAE's noise replayed, the Oobleck
towers with `use_snake=False`; the factory's two TAAE configurations
(`chip_smoke.taae_config`) at full width on `meta`; and the JAX package's
own bf16-vs-f32 distance of an Oobleck decode, the number `chip_smoke.py`
holds the card's to.

Weights are seeded numpy values over the JAX parameter tree, carried to the
port by io/from_jax.py; inputs are f32 from numpy. Tower outputs are held
within 1e-5 of their peak (f32 through a few transformer blocks and convs).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stable_audio_tools_tpu.models import autoencoders as jae
from stable_audio_tools_tpu.models import bottleneck as jbn
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu_torch.io.from_jax import (autoencoder_state_dict,
                                                      oobleck_decoder_state_dict,
                                                      taae_state_dict)
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

from test_torch_transformer_options import randomize

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _nlc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 1))


def _nct(y):
    return np.asarray(y).transpose(0, 2, 1)


def _params(jmod, x, seed=1):
    return randomize(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), _nlc(x)))[
        "params"], seed)


def _apply(jmod, params, x):
    return jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, _nlc(x))


TOWERS = {
    # tests/test_taae_integration.py's tiny TAAE: channels 8, c_mults [1, 2],
    # strides [4, 4]
    "narrow": dict(channels=8, c_mults=[1, 2], strides=[4, 4], transformer_depths=[1, 1],
                   sliding_window=(7, 8)),
    # a head of 128 at the TAAE's own window, with the snake before conv_out
    "head_128": dict(channels=64, c_mults=[2], strides=[2], transformer_depths=[2],
                     sliding_window=(31, 32), use_snake=True),
}


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_taae_towers_match_jax(tower):
    kw = TOWERS[tower]
    ratio = int(np.prod(kw["strides"]))
    audio = _x((2, 2, 160 * ratio), scale=0.5)
    jenc = jae.TAAEEncoder(in_channels=2, latent_dim=8, **kw)
    pe = _params(jenc, audio)
    tenc = create_model_from_config({"model_type": "autoencoder", "sample_rate": 44100, "model": {
        "encoder": {"type": "taae", "config": dict(kw, in_channels=2, latent_dim=8)},
        "decoder": {"type": "taae", "config": dict(kw, out_channels=2, latent_dim=4)},
        "latent_dim": 4, "downsampling_ratio": ratio, "io_channels": 2}}, "cpu")
    tenc.encoder.load_state_dict({k: _t(v) for k, v in taae_state_dict(pe).items()}, strict=True)
    _close(tenc.encoder(_t(audio)), _nct(_apply(jenc, pe, audio)))

    latents = _x((2, 4, 160), seed=2)
    jdec = jae.TAAEDecoder(out_channels=2, latent_dim=4, **kw)
    pd = _params(jdec, latents, seed=3)
    tenc.decoder.load_state_dict({k: _t(v) for k, v in taae_state_dict(pd, decoder=True).items()},
                                 strict=True)
    want = _nct(_apply(jdec, pd, latents))
    assert want.shape == (2, 2, 160 * ratio)  # the transposed convs give s x L exactly
    _close(tenc.decoder(_t(latents)), want)


def _tiny_taae_config():
    cfg = chip_smoke.tiny_taae_config("float32")
    tower = dict(TOWERS["narrow"])
    cfg["model"]["encoder"]["config"].update(tower, latent_dim=8)
    cfg["model"]["decoder"]["config"].update(tower, latent_dim=4)
    cfg["model"].update(latent_dim=4, downsampling_ratio=16)
    return cfg


def test_taae_autoencoder_round_trip_matches_jax(monkeypatch):
    # encode (VAE with the JAX noise replayed) and decode of the whole model
    # built by both factories from one config
    cfg = _tiny_taae_config()
    audio = _x((2, 2, 2048), scale=0.5)
    noise = _x((2, 4, 128), seed=5)
    jm = jax_create(cfg)
    params = randomize(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(audio)))["params"], 4)
    real = jbn.vae_sample
    monkeypatch.setattr(jbn, "vae_sample", lambda mean, scale, rng: (
        jnp.asarray(noise.transpose(0, 2, 1)) * (jax.nn.softplus(scale) + 1e-4) + mean,
        real(mean, scale, rng)[1]))
    want, info = jax.jit(lambda p, a: jm.apply({"params": p}, a, rngs={
        "sample": jax.random.PRNGKey(2)}))(params, jnp.asarray(audio))
    tm = create_model_from_config(cfg, "cpu")
    tm.load_state_dict({k: _t(v) for k, v in autoencoder_state_dict(params).items()}, strict=True)
    latents, tinfo = tm.encode(_t(audio), noise=_t(noise), return_info=True)
    _close(tm.decode(latents), want)
    _close(tinfo["kl"], info["kl"])


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_elu_oobleck_matches_jax(part):
    # use_snake=False: an ELU at every snake's place, no activation parameters
    kw = dict(channels=8, c_mults=[1, 2], strides=[2, 4], use_snake=False)
    if part == "encoder":
        x, jmod = _x((2, 2, 512), scale=0.5), jae.OobleckEncoder(in_channels=2, latent_dim=8,
                                                                  **kw)
    else:
        x, jmod = _x((2, 4, 64)), jae.OobleckDecoder(out_channels=2, latent_dim=4, **kw)
    p = _params(jmod, x)
    section = {"type": "oobleck", "config": dict(kw, latent_dim=8 if part == "encoder" else 4)}
    tm = create_model_from_config({"model_type": "autoencoder", "sample_rate": 44100, "model": {
        "encoder": section, "decoder": copy.deepcopy(section), "latent_dim": 4,
        "downsampling_ratio": 8, "io_channels": 2}}, "cpu")
    sd = autoencoder_state_dict({part: p})
    getattr(tm, part).load_state_dict({k[len(part) + 1:]: _t(v) for k, v in sd.items()},
                                      strict=True)
    assert not any("alpha" in k for k in sd)
    _close(getattr(tm, part)(_t(x)), _nct(_apply(jmod, p, x)))


def test_factory_builds_both_taae_configurations():
    # full width on `meta`: JAX's count at the class defaults (156,347,266 by
    # jax.eval_shape of the JAX model), the FSQ encoder's conv_out to 64
    # channels instead of 128 (1024 x 64 x 3 + 64 fewer)
    for fsq, count, bottleneck in ((False, 156_347_266, "VAEBottleneck"),
                                   (True, 156_150_530, "DitheredFSQBottleneck")):
        model = create_model_from_config(chip_smoke.taae_config(fsq), "meta")
        assert sum(p.numel() for p in model.parameters()) == count
        assert type(model.bottleneck).__name__ == bottleneck
        assert model.downsampling_ratio == 512 and len(model.encoder.blocks) == 4
        block = model.encoder.blocks[0].transformers[0]
        assert block.self_attn.dim_heads == 128 and block.self_attn.sliding_window == (31, 32)
    assert model.bottleneck.codebook_size == 625 and model.bottleneck.num_quantizers == 16


def _to_jax(port_sd, shapes, to_port):
    """The inverse of `to_port` (an io/from_jax.py map whose transforms only
    move values): each JAX leaf is marked with its flat positions, mapped,
    and the port's values scattered back."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(s.shape)) for s in leaves]
    starts = np.cumsum([0] + sizes)
    assert starts[-1] < 2 ** 24  # positions exact in f32
    marked = [np.arange(a, a + n, dtype=np.float32).reshape(s.shape)
              for a, n, s in zip(starts, sizes, leaves)]
    flat = np.full(starts[-1], np.nan, np.float32)
    for name, pos in to_port(jax.tree_util.tree_unflatten(treedef, marked)).items():
        flat[pos.astype(np.int64).ravel()] = port_sd[name].numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(
        treedef, [flat[a:a + n].reshape(s.shape) for a, n, s in zip(starts, sizes, leaves)])


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float32) - b) / np.linalg.norm(b))


def test_oobleck_bf16_decode_distance_of_the_jax_package():
    # chip_smoke.oobleck_bf16_case(): the SA-2.0 VAE decoder's five levels at
    # channels 32, the port's seeded init (the same weights on the card),
    # carried to the JAX decoder; the JAX package's bf16 decode against its
    # f32 one, ||bf16 - f32|| / ||f32||, is the number the card's distance is
    # held to (2x) in phase 16: recorded in chip_smoke.OOBLECK_BF16_JAX, equal
    # here to 1% (XLA's CPU reductions may reorder across versions)
    cfg, z = chip_smoke.oobleck_bf16_case()
    port = chip_smoke.oobleck_bf16_decoder(cfg)
    dec = cfg["model"]["decoder"]["config"]
    jdec = jae.OobleckDecoder(**dec)
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, z.shape[2], z.shape[1]))))["params"]
    params = _to_jax({k: v for k, v in port.state_dict().items()}, shapes,
                     oobleck_decoder_state_dict)
    decode = jax.jit(lambda p, x: jdec.apply({"params": p}, x))
    f32 = _nct(decode(params, _nlc(z)))
    bf16 = _nct(decode(params, _nlc(z).astype(jnp.bfloat16)))
    jax_dist = _rel(bf16, f32)
    assert abs(jax_dist / chip_smoke.OOBLECK_BF16_JAX - 1) < 1e-2, jax_dist
    # the port, f32 and bf16 on the CPU (the plain versions): the same f32
    # decode, and a bf16 distance within the 2x the card is held to
    with torch.no_grad():
        port_f32 = port(_t(z)).numpy()
        port_bf16 = port(_t(z).bfloat16()).float().numpy()
    _close(port_f32, f32, 1e-4)
    assert _rel(port_bf16, port_f32) <= 2 * jax_dist
