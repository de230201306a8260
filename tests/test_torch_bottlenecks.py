"""The bottlenecks the port gained for the TAAE slice (models/bottleneck.py)
against the JAX package's on the CPU: tanh, softnorm (its parameters
carried by io/from_jax.py, its training loss), Wasserstein (the MMD with the
JAX draw replayed), L2, FSQ and dithered FSQ (encode in eval and in
training with the JAX draws replayed, the codes, `decode_tokens`), and
their loss modules; the factory's bottleneck types.

Inputs are f32 from a seeded numpy generator, in the port's [B, C, T]
layout (the JAX package's is [B, T, C]). Values are held within 1e-5 of
their peak and the FSQ codes exactly (the grid rounding is the same round
half to even on both sides, and the inputs stay clear of the half-way
points by more than f32 error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import bottleneck as jbn
from stable_audio_tools_tpu.training.autoencoders import (
    create_loss_modules_from_bottleneck as jax_losses)
from stable_audio_tools_tpu_torch.io.from_jax import autoencoder_state_dict
from stable_audio_tools_tpu_torch.models import bottleneck as tbn
from stable_audio_tools_tpu_torch.models.factory import _bottleneck
from stable_audio_tools_tpu_torch.training.autoencoders import create_loss_modules_from_bottleneck

B, C, T = 2, 16, 24


def _t(a):
    return torch.from_numpy(np.array(a))


def _nlc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 1))


def _nct(y):
    return np.asarray(y).transpose(0, 2, 1)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


X = (np.random.default_rng(0).standard_normal((B, C, T)) * 1.3).astype(np.float32)


def _apply(module, method, x, params=None, rngs=None, **kw):
    variables = {"params": params or {}}
    return module.apply(variables, _nlc(x), rngs=rngs or {}, method=method, **kw)


@pytest.mark.parametrize("name,jmod,tmod", [
    ("tanh", jbn.TanhBottleneck(scale=2.0), tbn.TanhBottleneck(scale=2.0)),
    ("l2_norm", jbn.L2Bottleneck(), tbn.L2Bottleneck()),
    ("wasserstein_tanh", jbn.WassersteinBottleneck(use_tanh=True, tanh_scale=1.5),
     tbn.WassersteinBottleneck(use_tanh=True, tanh_scale=1.5)),
])
def test_stateless_bottlenecks_match_jax(name, jmod, tmod):
    want, info = _apply(jmod, jmod.encode, X, return_info=True)
    got, tinfo = tmod.encode(_t(X), return_info=True)
    _close(got, _nct(want))
    assert info == {} and tinfo == {}
    _close(tmod.decode(got), _nct(_apply(jmod, jmod.decode, _nct(want))))


def test_softnorm_matches_jax_with_its_loss():
    jmod = jbn.SoftNormBottleneck(dim=C)
    params = jmod.init(jax.random.PRNGKey(0), _nlc(X), method=jmod.encode)["params"]
    rng = np.random.default_rng(1)
    params = {"scaling_factor": (1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.3 * rng.standard_normal(C)).astype(np.float32)}
    want, info = _apply(jmod, jmod.encode, X, params, return_info=True, train=True)
    tmod = tbn.SoftNormBottleneck(dim=C)
    tmod.load_state_dict({k[len("bottleneck."):]: _t(v) for k, v in autoencoder_state_dict(
        {"bottleneck": params}).items()})
    got, tinfo = tmod.encode(_t(X), return_info=True, train=True)
    _close(got, _nct(want))
    _close(tinfo["softnorm_loss"], info["softnorm_loss"])
    assert tmod.encode(_t(X), return_info=True)[1] == {}  # eval: no loss


def test_wasserstein_mmd_matches_jax_with_its_draw(monkeypatch):
    noise = np.random.default_rng(2).standard_normal((B, C, T)).astype(np.float32)
    jmod = jbn.WassersteinBottleneck()
    rng = jax.random.PRNGKey(3)
    # the JAX draw replayed: compute_mmd's normal of z's shape [B * T, C]
    z = _nlc(X).reshape(-1, C)
    want = jbn.compute_mmd(_nlc(X), rng)
    drawn = np.asarray(jax.random.normal(rng, z.shape, z.dtype)).reshape(B, T, C)
    got = tbn.compute_mmd(_t(X), _t(_nct(drawn)))
    # the MMD is a difference of three kernel means of size ~1 (here ~5e-3
    # after the cancellation; the port expands the square distances): held
    # within 1e-6 absolute, 1e-6 of the means it is taken from
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    # through the bottleneck, the same draw replayed into JAX's
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(drawn, dtype).reshape(shape))
    jx, info = jmod.apply({}, _nlc(X), return_info=True, train=True, method=jmod.encode,
                          rngs={"sample": rng})
    out, tinfo = tbn.WassersteinBottleneck().encode(_t(X), return_info=True, train=True,
                                                    noise=_t(_nct(drawn)))
    _close(out, _nct(jx))
    np.testing.assert_allclose(float(tinfo["mmd"]), float(info["mmd"]), rtol=0, atol=1e-6)
    assert abs(float(tbn.compute_mmd(_t(X), _t(noise))) - float(got)) > 0  # the draw matters
    bypass = tbn.WassersteinBottleneck(bypass_mmd=True).encode(_t(X), return_info=True,
                                                               train=True)[1]
    assert float(bypass["mmd"]) == 0.0


def test_wasserstein_mmd_of_bf16_latents_is_taken_in_f32(monkeypatch):
    # bf16 latents and draw (the trainer's compute dtype): the port's MMD
    # is taken in f32, so it agrees with JAX's direct square differences in
    # f32 on the same bf16 values within 1e-6 absolute, as the f32 case does
    # (the |a|^2 + |b|^2 - 2ab expansion in bf16 misses by far more)
    zb = _t(X).to(torch.bfloat16)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((B, C, T)).astype(
        np.float32)).to(torch.bfloat16)
    drawn = _nlc(noise.float().numpy())
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(drawn, dtype).reshape(shape))
    want = jbn.compute_mmd(_nlc(zb.float().numpy()), jax.random.PRNGKey(5))
    got = tbn.compute_mmd(zb, noise)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_fsq_matches_jax_codes_and_tokens():
    levels, Q = (8, 5, 5, 5), 4  # C = 4 x 4
    jmod = jbn.FSQBottleneck(levels=levels, num_codebooks=Q)
    tmod = tbn.FSQBottleneck(levels=levels, num_codebooks=Q)
    want, info = _apply(jmod, jmod.encode, X, return_info=True)
    got, tinfo = tmod.encode(_t(X), return_info=True)
    _close(got, _nct(want))
    assert tinfo["quantizer_indices"].shape == (B, Q, T)
    np.testing.assert_array_equal(tinfo["quantizer_indices"].numpy(), info["quantizer_indices"])
    assert tmod.codebook_size == 1000 and tmod.num_quantizers == Q
    codes = tinfo["quantizer_indices"]
    want_dec = jmod.apply({}, jnp.asarray(codes.numpy()), method=jmod.decode_tokens)
    _close(tmod.decode_tokens(codes), _nct(want_dec))
    _close(tmod.decode_tokens(codes.transpose(1, 2)), _nct(want_dec))  # [B, T, Q] too
    _close(tmod.decode_tokens(codes), got)  # the tokens decode to the codes
    # straight through: the gradient of the codes is the tanh's
    x = _t(X).requires_grad_()
    tmod.encode(x).sum().backward()
    _close(x.grad, 1 - np.tanh(X) ** 2)


def _replay_dither(monkeypatch, keep, uniform, apply):
    """JAX's three draws of the dithered FSQ (bernoulli, uniform, bernoulli)
    replaced by the given numpy values."""
    bern = iter([keep, apply])
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(next(bern)).reshape(shape))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(uniform))


@pytest.mark.parametrize("keep,apply", [([True, False], [False, False]),
                                        ([False, True], [False, True]),
                                        ([False, False], [False, False])])
def test_dithered_fsq_matches_jax_in_training_and_eval(monkeypatch, keep, apply):
    # dim 4 at 5 levels in 4 codebooks over 16 channels: the taae_dithered_fsq
    # layout at a quarter of its codebooks
    jmod = jbn.DitheredFSQBottleneck(dim=4, levels=5, num_codebooks=4)
    tmod = tbn.DitheredFSQBottleneck(dim=4, levels=5, num_codebooks=4)
    uniform = np.random.default_rng(4).random((B, T, 4, 4)).astype(np.float32)
    _replay_dither(monkeypatch, np.asarray(keep), uniform, np.asarray(apply))
    want, info = _apply(jmod, jmod.encode, X, return_info=True, train=True,
                        rngs={"sample": jax.random.PRNGKey(0)})
    noise = {"keep": torch.tensor(keep), "apply": torch.tensor(apply),
             "dither": _t(_nct(uniform.reshape(B, T, C)))}
    got, tinfo = tmod.encode(_t(X), return_info=True, train=True, noise=noise)
    _close(got, _nct(want))
    assert tinfo["quantizer_indices"].shape == (B, T, 4)  # JAX's [B, T, Q]
    np.testing.assert_array_equal(tinfo["quantizer_indices"].numpy(), info["quantizer_indices"])
    ev, _ = tmod.encode(_t(X), return_info=True)
    _close(tmod.decode_tokens(tinfo["quantizer_indices"]), ev)
    assert tmod.codebook_size == 625
    # with no draws given, the generator's: the same draws from the same seed
    a = tmod.encode(_t(X), train=True, generator=torch.Generator().manual_seed(1))
    b = tmod.encode(_t(X), train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_loss_modules_match_jax():
    cfg = {"bottleneck": {"weights": {"mmd": 50.0}}}
    for jmod, tmod in ((jbn.WassersteinBottleneck(), tbn.WassersteinBottleneck()),
                       (jbn.TanhBottleneck(), tbn.TanhBottleneck()),
                       (jbn.L2Bottleneck(), tbn.L2Bottleneck()),
                       (jbn.SoftNormBottleneck(), tbn.SoftNormBottleneck()),
                       (jbn.FSQBottleneck(), tbn.FSQBottleneck()),
                       (jbn.DitheredFSQBottleneck(), tbn.DitheredFSQBottleneck())):
        want = [(m.name, m.key, m.weight) for m in jax_losses(jmod, cfg)]
        got = [(m.name, m.key, m.weight) for m in create_loss_modules_from_bottleneck(tmod, cfg)]
        assert got == want, type(tmod).__name__
    assert [m.weight for m in create_loss_modules_from_bottleneck(
        tbn.WassersteinBottleneck(), {})] == [100]


def test_factory_builds_the_bottleneck_types_and_refuses_the_rest():
    assert isinstance(_bottleneck({"type": "dithered_fsq", "config": {
        "dim": 4, "levels": 5, "num_codebooks": 16}}), tbn.DitheredFSQBottleneck)
    for kind, cls in (("tanh", tbn.TanhBottleneck), ("l2_norm", tbn.L2Bottleneck),
                      ("softnorm", tbn.SoftNormBottleneck), ("fsq", tbn.FSQBottleneck),
                      ("wasserstein", tbn.WassersteinBottleneck)):
        assert isinstance(_bottleneck({"type": kind}), cls)
    # the RVQ-VAE and the DAC RVQs (tests/test_torch_dac_rvq.py), and the
    # noise augmentation, are built; an unknown type is refused
    for kind, cls in (("rvq_vae", tbn.RVQVAEBottleneck), ("dac_rvq", tbn.DACRVQBottleneck),
                      ("dac_rvq_vae", tbn.DACRVQVAEBottleneck)):
        assert type(_bottleneck({"type": kind, "config": {}})) is cls
    assert _bottleneck({"type": "fsq", "config": {"noise_augment_dim": 2}}).noise_augment_dim == 2
    with pytest.raises(NotImplementedError, match="lookup_free"):
        _bottleneck({"type": "lookup_free", "config": {}})
