"""Each Hopper kernel's plain PyTorch version against the JAX function that
reaches the TPU (Pallas) kernel, run on the CPU as the JAX package's own
tests run it: Pallas kernels in interpret mode.

All inputs are f32 and made with numpy from a seed. Layouts: the JAX package
keeps activations [B, L, C] and conv kernels [k, Ci, Co]; the port's conv and
snake take [B, C, L] and [Co, Ci, k], so the tests transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.activations import snake_beta as jax_snake_beta
from stable_audio_tools_tpu.ops.conv import conv1d as jax_conv1d
from stable_audio_tools_tpu.ops.kernels import conv1d_snake as jcs
from stable_audio_tools_tpu.ops.kernels import flash_attention as jfa
from stable_audio_tools_tpu.ops.kernels import layer_norm as jln
from stable_audio_tools_tpu.ops.kernels import snake as jsn
from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as tcs
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa
from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as tln
from stable_audio_tools_tpu_torch.ops.kernels import snake as tsn


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("P", [1, 3])
def test_flash_attention_prefix_plain_matches_pallas(P):
    # f32 on both sides; the Pallas kernel's online softmax over 256-key
    # blocks and the plain version's one-shot softmax differ only by f32
    # reassociation (~1e-6 relative): 2e-5 abs on O(1) outputs.
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, P + 256, 64)).astype(np.float32) for _ in range(3))
    want, want_lse = jfa._prefix_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), P)
    got, got_lse = tfa.flash_attention_prefix(_t(q), _t(k), _t(v), P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,N,P", [(False, 256, 0), (True, 256, 0), (False, 300, 0),
                                        (False, 256, 9)])
def test_flash_attention_nhd_plain_matches_pallas(causal, N, P):
    # f32 on both sides; the Pallas head-pair kernel (interpret mode) folds
    # 256- to 1024-key blocks with an online softmax, the plain version takes
    # one softmax: f32 reassociation only, 2e-5 abs on O(1) outputs
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, N, 4, 64)).astype(np.float32) for _ in range(3))
    want = jfa.flash_attention_nhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, P)
    got = tfa.flash_attention_nhd(_t(q), _t(k), _t(v), causal=causal, prefix_len=P)
    assert got.shape == (2, N, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,P", [(False, 0), (True, 0), (False, 9)])
def test_flash_attention_nhd_gradients_match_pallas(causal, P):
    # the port's autograd Function on the CPU (plain backward from the saved
    # logsumexp, on transposed views) against jax.grad through the Pallas
    # forward and backward kernels in interpret mode, f32: 1e-4 of the
    # gradients' peak (sums over 256 keys reassociate)
    rng = np.random.default_rng(1)
    q, k, v, w = (rng.standard_normal((1, 256, 2, 64)).astype(np.float32) for _ in range(4))

    def jax_loss(q, k, v):
        return jnp.sum(jnp.asarray(w) * jfa.flash_attention_nhd(q, k, v, causal, P) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention_nhd(tq, tk, tv, causal=causal, prefix_len=P)
    got = torch.autograd.grad((_t(w) * out ** 2).sum(), (tq, tk, tv))
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("with_beta", [False, True])
def test_fused_layer_norm_plain_matches_pallas(with_beta):
    # two-pass f32 statistics on both sides: agreement to f32 rounding
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((300, 256)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(256).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32) if with_beta else None
    want = jln._ln_forward(jnp.asarray(x), jnp.asarray(g),
                           None if b is None else jnp.asarray(b), 1e-5)
    got = tln.fused_layer_norm(_t(x), _t(g), None if b is None else _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gamma_dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("with_beta", [False, True])
@pytest.mark.parametrize("C", [64, 768, 1000, 1024, 1536, 2048])
def test_fused_layer_norm_edges_match_pallas(C, with_beta, gamma_dtype):
    # the CUDA kernel's edges: row lengths that are and are not multiples of
    # its 16-byte vectors and 256-element warp rows, row counts that do not
    # fill a 4-row block, gamma / beta in f32 and bf16 (read in their own
    # dtype). The Pallas kernel (interpret mode) and the port's plain version
    # take the same f32 x and the same bf16-representable parameters; two-pass
    # f32 statistics on both sides: agreement to f32 rounding
    rng = np.random.default_rng(C)
    for rows in (1, 5, 301):
        x = (rng.standard_normal((rows, C)) * 3 + 1).astype(np.float32)
        g = rng.standard_normal(C).astype(np.float32)
        b = rng.standard_normal(C).astype(np.float32) if with_beta else None
        jdt = jnp.bfloat16 if gamma_dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if gamma_dtype == "bfloat16" else torch.float32
        jg = jnp.asarray(g).astype(jdt)
        jb = None if b is None else jnp.asarray(b).astype(jdt)
        want = jln._ln_forward(jnp.asarray(x), jg, jb, 1e-5)
        tg = torch.from_numpy(g).to(tdt)
        tb = None if b is None else torch.from_numpy(b).to(tdt)
        got = tln.fused_layer_norm(_t(x), tg, tb, 1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        # the JAX entry (its plain XLA formula off the TPU) computes the same
        np.testing.assert_allclose(got.numpy(), np.asarray(jln.fused_layer_norm(
            jnp.asarray(x), jg, jb, 1e-5)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_beta", [False, True])
@pytest.mark.parametrize("C", [768, 1000, 1536])
def test_fused_layer_norm_gradient_matches_custom_vjp(C, with_beta):
    # the JAX package's custom_vjp (`_fused_ln_nobeta` / `_fused_ln_beta`:
    # the Pallas forward in interpret mode, `_ln_backward` in XLA) against
    # the port's plain forward and `fused_layer_norm_bwd_plain`, the backward
    # of its autograd Function; f32 on both sides, the parameter gradients
    # sum over rows in another order: 1e-5 of each gradient's peak
    rng = np.random.default_rng(C + 1)
    x = (rng.standard_normal((3, 37, C)) * 2 - 0.5).astype(np.float32)
    g = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    w = rng.standard_normal((3, 37, C)).astype(np.float32)
    if with_beta:
        loss = lambda x, g, b: jnp.sum(jnp.asarray(w) * jln._fused_ln_beta(x, g, b, 1e-5))
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    else:
        loss = lambda x, g: jnp.sum(jnp.asarray(w) * jln._fused_ln_nobeta(x, g, 1e-5))
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    y = tln.fused_layer_norm(_t(x), _t(g), _t(b) if with_beta else None, 1e-5)
    want_y = jln._ln_forward(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b) if with_beta else None,
                             1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    got = tln.fused_layer_norm_bwd_plain(_t(x), _t(g), _t(w), 1e-5)
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, want):
        r = np.asarray(r)
        err = np.abs(a.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-5, (name, err)


def _snake_inputs(rng, C, L):
    x = (rng.standard_normal((2, L, C)) * 2).astype(np.float32)
    alpha = np.exp(rng.standard_normal(C) * 0.5).astype(np.float32)
    beta = np.exp(rng.standard_normal(C) * 0.5).astype(np.float32)
    return x, alpha, beta


def test_snake_fused_plain_matches_jax_exact_sin():
    # the JAX CPU path (jnp.sin) is the same f32 maths: f32 rounding only
    rng = np.random.default_rng(2)
    x, a, b = _snake_inputs(rng, 128, 600)
    want = jax_snake_beta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    got = tsn.snake_fused(_t(x.transpose(0, 2, 1)), _t(a), _t(b))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                               atol=2e-6, rtol=1e-6)


def test_snake_fused_plain_matches_pallas_polynomial():
    # the Pallas kernel evaluates sin^2 with a range-reduced polynomial
    # (max error 4e-10, f32 phase error < 1e-5 for |alpha x| < 1e3), scaled
    # by 1/beta up to ~e^1.5: a 1e-4 bound
    rng = np.random.default_rng(3)
    x, a, b = _snake_inputs(rng, 128, 600)
    want = jsn._fwd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    got = tsn.snake_fused(_t(x.transpose(0, 2, 1)), _t(a), _t(b))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want), atol=1e-4)


CONV_CASES = [(7, 1), (7, 3), (7, 9), (1, 1)]


def _conv_inputs(rng, k, L=600, C=128):
    x, a, b = _snake_inputs(rng, C, L)
    w = (rng.standard_normal((k, C, C)) * (C * k) ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    res = rng.standard_normal((2, L, C)).astype(np.float32)
    return x, w, bias, a, b, res


def _port_conv(x, w, bias, a, b, pad, d, res=None):
    args = (_t(x.transpose(0, 2, 1)), _t(w.transpose(2, 1, 0)), _t(bias), _t(a), _t(b))
    if res is None:
        out = tcs.snake_conv1d(*args, pad, pad, d)
    else:
        out = tcs.snake_conv1d_res(*args, _t(res.transpose(0, 2, 1)), pad, pad, d)
    return out.numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("k,d", CONV_CASES)
@pytest.mark.parametrize("residual", [False, True])
def test_snake_conv1d_plain_matches_jax_exact_sin(k, d, residual):
    # the JAX module path on the CPU: snake_beta with jnp.sin, then an XLA
    # conv. Same maths in f32; sums of 7*128 products reassociate: 1e-5.
    rng = np.random.default_rng(10 * k + d)
    x, w, bias, a, b, res = _conv_inputs(rng, k)
    pad = d * (k - 1) // 2
    want = jax_conv1d(jax_snake_beta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)),
                      jnp.asarray(w), jnp.asarray(bias), padding=pad, dilation=d)
    want = np.asarray(want) + (res if residual else 0.0)
    got = _port_conv(x, w, bias, a, b, pad, d, res if residual else None)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,d", CONV_CASES)
@pytest.mark.parametrize("residual", [False, True])
def test_snake_conv1d_plain_matches_pallas_polynomial(k, d, residual):
    # the Pallas kernel (interpret mode) uses the polynomial sin^2: each
    # snake value differs by <~1e-5 * 1/beta, summed over k*Ci = 896 taps
    # with weights ~1/30: a 2e-4 bound
    rng = np.random.default_rng(100 + 10 * k + d)
    x, w, bias, a, b, res = _conv_inputs(rng, k)
    pad = d * (k - 1) // 2
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(a), jnp.asarray(b))
    if residual:
        want = jcs.snake_conv1d_res(*jargs, jnp.asarray(res), pad, pad, d)
    else:
        want = jcs.snake_conv1d(*jargs, pad, pad, d)
    got = _port_conv(x, w, bias, a, b, pad, d, res if residual else None)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)

