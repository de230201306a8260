"""The port's snake-conv forward without the residual, which the card runs
by row 12 (the carry), against the JAX package's carry kernel,
`_fwd_kernel_carry`, on the CPU.

The JAX side runs `snake_conv1d` with the module attribute `_CARRY` set (the
in-process form of SAT_SNAKE_CARRY=1), so `_run_fwd` takes `_run_fwd_carry`:
the Pallas kernel in interpret mode, as the JAX package's tests run its
kernels on the CPU (a spy counts that it did). The port's `snake_conv1d` on
CPU tensors is the plain version, the same function row 12 computes on the
card; it is also held against the JAX package's default kernel, which
computes that function on the other schedule. Inputs are f32 and made with
numpy from a seed; the JAX package keeps [B, L, C] activations and
[k, Ci, Co] kernels, the port [B, C, L] and [Co, Ci, k]. The Pallas kernel's
snake is a polynomial sin^2 (its max error 4e-10, f32 phase error < 1e-5,
scaled by 1/beta and summed over k*Ci taps), the plain version's exact sin:
1e-4 of the output's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import autoencoders as jae
from stable_audio_tools_tpu.ops.kernels import conv1d_snake as jcs
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import autoencoders as tae
from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as tcs

REL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nlc(t):
    return t.detach().numpy().transpose(0, 2, 1)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=REL_TOL * np.abs(want).max())


@pytest.fixture
def carry(monkeypatch):
    """The JAX package's carry route on for the test (restored after it);
    returns the list of its carry-kernel calls."""
    calls = []
    run = jcs._run_fwd_carry

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return run(*args, **kwargs)

    monkeypatch.setattr(jcs, "_CARRY", True)
    monkeypatch.setattr(jcs, "_run_fwd_carry", spy)
    return calls


def _case(rng, B, L, Ci, Co, k):
    x = (rng.standard_normal((B, L, Ci)) * 2).astype(np.float32)
    w = (rng.standard_normal((k, Ci, Co)) * (Ci * k) ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    alpha = np.exp(rng.standard_normal(Ci) * 0.5).astype(np.float32)
    beta = np.exp(rng.standard_normal(Ci) * 0.5).astype(np.float32)
    return x, w, bias, alpha, beta


def _port(x, w, bias, a, b, pad, d):
    return _nlc(tcs.snake_conv1d(_t(x.transpose(0, 2, 1)), _t(w.transpose(2, 1, 0)),
                   None if bias is None else _t(bias), _t(a), _t(b), pad, pad, d))


# [B, L, Ci, Co, k, d, bias]: the residual unit's k = 7 conv at d 1, 3, 9; the
# encoder's k = 3 conv_out; batch 2 at a ragged L (1000 rows: 3 blocks of
# 256 and a partial one); Ci != Co; the decoder's conv_out (Co = 2, no bias);
# the Co-swept case (k*Ci*Co*2 > 4 MiB: `_fwd_cob` gives 512 of 1024, the
# carry saved at the last Co block only)
CASES = [(1, 300, 16, 16, 7, 1, True), (1, 300, 16, 16, 7, 3, True),
         (1, 300, 16, 16, 7, 9, True), (1, 100, 64, 8, 3, 1, True),
         (2, 1000, 16, 16, 7, 9, True), (1, 700, 16, 32, 7, 1, True),
         (1, 300, 16, 2, 7, 1, False), (1, 300, 512, 1024, 7, 1, True)]


def _jax(x, w, bias, a, b, pad, d):
    jb = bias if bias is not None else np.zeros(w.shape[-1], np.float32)
    return jcs.snake_conv1d(*(jnp.asarray(v) for v in (x, w, jb, a, b)), pad, pad, d)


@pytest.mark.parametrize("B,L,Ci,Co,k,d,bias", CASES)
def test_snake_conv1d_carry_route_matches_the_jax_carry_kernel(carry, B, L, Ci, Co, k, d,
                                                               bias):
    rng = np.random.default_rng(B * L + Ci + Co + k * d)
    x, w, b_, a, b = _case(rng, B, L, Ci, Co, k)
    pad = d * (k - 1) // 2
    b_ = b_ if bias else None
    want = _jax(x, w, b_, a, b, pad, d)
    assert len(carry) == 1
    if Co == 1024:
        assert jcs._fwd_cob(k, Ci, Co) == 512  # two Co blocks
    _close(_port(x, w, b_, a, b, pad, d), want)


@pytest.mark.parametrize("B,L,Ci,Co,k,d,bias", CASES)
def test_snake_conv1d_matches_the_jax_default_kernel(monkeypatch, B, L, Ci, Co, k, d, bias):
    # the JAX package's default route (`_fwd_kernel`, the x block and its
    # halo read twice) computes the same function as its carry kernel: the
    # port's one forward matches both
    monkeypatch.setattr(jcs, "_CARRY", False)
    monkeypatch.setattr(jcs, "_run_fwd_carry", None)  # any call would raise
    rng = np.random.default_rng(B * L + Ci + Co + k * d)
    x, w, b_, a, b = _case(rng, B, L, Ci, Co, k)
    pad = d * (k - 1) // 2
    b_ = b_ if bias else None
    _close(_port(x, w, b_, a, b, pad, d), _jax(x, w, b_, a, b, pad, d))


def test_snake_conv1d_res_stays_off_the_carry_route(carry):
    # with the carry route on, the residual entry keeps the first kernel in
    # the JAX package (no carry call), as in the port (row 3 on the card);
    # on the CPU both give the function
    rng = np.random.default_rng(3)
    x, w, bias, a, b = _case(rng, 2, 300, 16, 16, 1)
    res = rng.standard_normal((2, 300, 16)).astype(np.float32)
    want = jcs.snake_conv1d_res(*(jnp.asarray(v) for v in (x, w, bias, a, b, res)), 0, 0, 1)
    assert carry == []
    got = tcs.snake_conv1d_res(_t(x.transpose(0, 2, 1)), _t(w.transpose(2, 1, 0)), _t(bias),
                               _t(a), _t(b), _t(res.transpose(0, 2, 1)), 0, 0, 1)
    _close(_nlc(got), want)


OOBLECK = dict(channels=16, c_mults=(1, 2), strides=(2, 4), use_snake=True)


def _init(module, *args, seed=0):
    """Seeded numpy parameters at `module`'s shapes: kernels ~ N(0, 1/fan_in),
    weight-norm g ~ 1 + N(0, 0.1), biases and log-scale snake parameters
    ~ N(0, 0.1)."""
    shapes = jax.eval_shape(lambda a: module.init(jax.random.PRNGKey(seed), *a), args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if len(a.shape) >= 2:
            return (rng.standard_normal(a.shape) * np.prod(a.shape[:-1]) ** -0.5).astype(
                np.float32)
        if path[-1].key == "g":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_tiny_oobleck_on_the_carry_route_matches_jax(carry, monkeypatch, part):
    # the JAX model is made to dispatch every stride-1 snake conv to the fused
    # Pallas kernels, as it does on the TPU (its gate refuses the CPU), so its
    # non-residual ones run the carry kernel; against the port's Oobleck. A
    # chain of ~15 convs: 1e-4 of the output's peak
    monkeypatch.setattr(jcs, "snake_conv1d_supported",
                        lambda x, kernel, stride, dilation, groups=1: stride == 1 and groups == 1)
    rng = np.random.default_rng(11)
    if part == "encoder":
        inp = (rng.standard_normal((1, 256, 2)) * 0.5).astype(np.float32)
        jm = jae.OobleckEncoder(in_channels=2, latent_dim=8, **OOBLECK)
        tm = tae.OobleckEncoder(in_channels=2, latent_dim=8, **OOBLECK)
        to_sd = from_jax.oobleck_encoder_state_dict
    else:
        inp = rng.standard_normal((1, 32, 8)).astype(np.float32)
        jm = jae.OobleckDecoder(out_channels=2, latent_dim=8, final_tanh=False, **OOBLECK)
        tm = tae.OobleckDecoder(out_channels=2, latent_dim=8, final_tanh=False, **OOBLECK)
        to_sd = from_jax.oobleck_decoder_state_dict
    p = _init(jm, jnp.asarray(inp))
    carry.clear()
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, jnp.asarray(inp)))
    # the snake convs without a residual: 2 x 3 residual units' k = 7 convs,
    # the conv_out and, through the JAX package's s2d / d2s rewrites (which
    # the port does not port), the 2 strided or transposed convs
    assert len(carry) == 9
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in to_sd(p).items()},
                       strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(inp.transpose(0, 2, 1)))
    _close(_nlc(got), want)
