"""The backward kernels' plain versions and the autograd Functions around
them (the snake, the snake-conv and the plain stride-1 conv of the Oobleck
autoencoder) against the JAX package's gradients on the CPU.

The JAX oracle is the CPU path (`jnp.sin` snake, `_conv1d_s1` custom VJP),
and, where noted, the Pallas kernels in interpret mode, whose fast-sin^2
polynomial sets a looser tolerance. Inputs are f32 and made with numpy from a
seed; the JAX package keeps [B, L, C] activations and [k, Ci, Co] kernels,
the port [B, C, L] and [Co, Ci, k], so the tests transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.activations import snake_beta as jax_snake_beta
from stable_audio_tools_tpu.ops.conv import conv1d as jax_conv1d
from stable_audio_tools_tpu.ops.kernels import conv1d_snake as jcs
from stable_audio_tools_tpu.ops.kernels import snake as jsn
from stable_audio_tools_tpu_torch.ops import conv as tconv
from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as tcs
from stable_audio_tools_tpu_torch.ops.kernels import snake as tsn


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nlc(t):
    return t.detach().numpy().transpose(0, 2, 1)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-6))


def _snake_inputs(rng, C, L, B=2):
    x = (rng.standard_normal((B, L, C)) * 2).astype(np.float32)
    alpha = np.exp(rng.standard_normal(C) * 0.5).astype(np.float32)
    beta = np.exp(rng.standard_normal(C) * 0.5).astype(np.float32)
    return x, alpha, beta


def test_snake_fused_bwd_plain_matches_jax_vjp():
    # jax.vjp of the JAX snake_beta (CPU: jnp.sin, autodiff) against the
    # plain backward: the same f32 maths summed in another order, 1e-5 of
    # each gradient's peak
    rng = np.random.default_rng(0)
    x, a, b = _snake_inputs(rng, 48, 300)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, pull = jax.vjp(jax_snake_beta, jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    want = pull(jnp.asarray(g))
    dx, da, db = tsn.snake_fused_bwd_plain(_t(x.transpose(0, 2, 1)), _t(a), _t(b),
                                           _t(g.transpose(0, 2, 1)))
    _close(_nlc(dx), want[0], 1e-5)
    _close(da.numpy(), want[1], 1e-5)
    _close(db.numpy(), want[2], 1e-5)


def test_snake_fused_autograd_matches_pallas_bwd():
    # the port's autograd Function (plain backward on the CPU) against the
    # Pallas backward kernel in interpret mode: its polynomial sin^2 and
    # derivative (max error 4e-10, f32 phase error < 1e-5) scaled by 1/beta
    # and summed over 2 x 300 rows: 1e-4 of each gradient's peak
    rng = np.random.default_rng(1)
    x, a, b = _snake_inputs(rng, 128, 300)
    g = rng.standard_normal(x.shape).astype(np.float32)
    want = jsn._bwd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    tx, ta, tb = (_t(v).requires_grad_() for v in (x.transpose(0, 2, 1), a, b))
    y = tsn.snake_fused(tx, ta, tb)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * _t(g.transpose(0, 2, 1))).sum(), (tx, ta, tb))
    _close(_nlc(got[0]), want[0], 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    _close(got[2].numpy(), want[2], 1e-4)


def _conv_case(rng, Ci, Co, L, k):
    x, a, b = _snake_inputs(rng, Ci, L)
    w = (rng.standard_normal((k, Ci, Co)) * (Ci * k) ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    return x, w, bias, a, b


# (Ci, Co, L, k, d): the residual unit's k = 7 convs at the three dilations,
# its k = 1 conv (with the residual), the encoder's conv_out (k = 3, many
# channels in, Lout = L), the decoder's conv_out (Co = 2)
SNAKE_CONV_CASES = [(16, 16, 200, 7, 1), (16, 16, 200, 7, 3), (16, 16, 200, 7, 9),
                    (16, 16, 200, 1, 1), (64, 8, 40, 3, 1), (16, 2, 200, 7, 1)]


@pytest.mark.parametrize("Ci,Co,L,k,d", SNAKE_CONV_CASES)
def test_snake_conv1d_gradients_match_jax(Ci, Co, L, k, d):
    # jax.grad through the JAX ops/conv.py conv1d with pre_snake (and the
    # residual for k = 1), which on the CPU is snake_beta + the _conv1d_s1
    # custom VJP, against the port's autograd Function on the CPU (the
    # plain dx / dW versions): f32, sums of up to 2 x 200 x 16 x 7 products
    # reassociate: 1e-5 of each gradient's peak
    rng = np.random.default_rng(10 * k + d + Co)
    x, w, bias, a, b = _conv_case(rng, Ci, Co, L, k)
    pad = d * (k - 1) // 2
    res = rng.standard_normal((2, L, Co)).astype(np.float32) if k == 1 else None
    g = rng.standard_normal((2, L, Co)).astype(np.float32)

    def jax_loss(x, w, bias, a, b, *r):
        y = jax_conv1d(x, w, bias, padding=pad, dilation=d, pre_snake=(a, b),
                       residual=r[0] if r else None)
        return jnp.sum(y * jnp.asarray(g))

    jargs = [jnp.asarray(v) for v in (x, w, bias, a, b)] + ([jnp.asarray(res)] if k == 1 else [])
    want = jax.grad(jax_loss, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [_t(x.transpose(0, 2, 1)), _t(w.transpose(2, 1, 0)), _t(bias), _t(a), _t(b)]
    if k == 1:
        targs.append(_t(res.transpose(0, 2, 1)))
    targs = [v.requires_grad_() for v in targs]
    y = tconv.conv1d(targs[0], targs[1], targs[2], padding=pad, dilation=d,
                     pre_snake=(targs[3], targs[4]), residual=targs[5] if k == 1 else None)
    got = torch.autograd.grad((y * _t(g.transpose(0, 2, 1))).sum(), targs)
    _close(_nlc(got[0]), want[0], 1e-5)
    _close(got[1].numpy().transpose(2, 1, 0), want[1], 1e-5)
    for p, q in zip(got[2:5], want[2:5]):
        _close(p.numpy(), q, 1e-5)
    if k == 1:
        _close(_nlc(got[5]), want[5], 0.0)  # the residual's gradient is dy itself


@pytest.mark.parametrize("pre_snake", [False, True])
def test_conv1d_wgrad_plain_matches_pallas(pre_snake):
    # conv1d_wgrad_plain against the Pallas weight-gradient kernels in
    # interpret mode at 128 channels: plain, f32 reassociation (2e-5 of the
    # peak); with the snake, the polynomial sin^2 in the recompute: 1e-4
    rng = np.random.default_rng(4)
    B, L, Ci, Co, k, d = 1, 60, 128, 128, 7, 1
    x, a, b = _snake_inputs(rng, Ci, L, B)
    dy = rng.standard_normal((B, L, Co)).astype(np.float32)
    jx, jdy = jnp.asarray(x), jnp.asarray(dy)
    snake = (jnp.asarray(a), jnp.asarray(b)) if pre_snake else None
    want_w, want_b = jcs._run_bwd_dw(jdy, jx, (k, Ci, Co), snake, 3, 3, d, True)
    got_w, got_b = tcs.conv1d_wgrad_plain(_t(dy.transpose(0, 2, 1)), _t(x.transpose(0, 2, 1)),
                                          k, 3, 3, d, (_t(a), _t(b)) if pre_snake else None)
    tol = 1e-4 if pre_snake else 2e-5
    _close(got_w.numpy().transpose(2, 1, 0), want_w, tol)
    _close(got_b.numpy(), want_b, 2e-5)
    if not pre_snake:  # the public entry the JAX plain conv's backward calls
        _close(got_w.numpy().transpose(2, 1, 0),
               jcs.conv1d_wgrad(jdy, jx, (k, Ci, Co), 3, 3, d, interpret=True), tol)


def test_snake_conv1d_dx_plain_matches_pallas():
    # snake_conv1d_dx_plain against the Pallas dgrad kernel in interpret
    # mode (polynomial snake derivative): 1e-4 of each gradient's peak
    rng = np.random.default_rng(5)
    x, w, _, a, b = _conv_case(rng, 128, 128, 60, 7)
    dy = rng.standard_normal((2, 60, 128)).astype(np.float32)
    want = jcs._run_bwd_dx(jnp.asarray(dy), jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                           jnp.asarray(b), 9, 9, 3, True)
    got = tcs.snake_conv1d_dx_plain(_t(dy.transpose(0, 2, 1)), _t(x.transpose(0, 2, 1)),
                                    _t(w.transpose(2, 1, 0)), _t(a), _t(b), 9, 9, 3)
    _close(_nlc(got[0]), want[0], 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    _close(got[2].numpy(), want[2], 1e-4)


@pytest.mark.parametrize("Ci,Co,k,pad", [(2, 16, 7, 3), (8, 32, 7, 3), (16, 16, 3, 1)])
def test_conv1d_s1_gradients_match_jax(Ci, Co, k, pad):
    # the plain stride-1 conv (the encoder's and decoder's conv_in) through
    # Conv1dS1 against jax.grad through the JAX conv1d (its _conv1d_s1
    # custom VJP on the CPU): f32, 1e-5 of each gradient's peak
    rng = np.random.default_rng(Ci + Co)
    x = rng.standard_normal((2, 150, Ci)).astype(np.float32)
    w = (rng.standard_normal((k, Ci, Co)) * (Ci * k) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(Co).astype(np.float32)
    g = rng.standard_normal((2, 150, Co)).astype(np.float32)
    want = jax.grad(lambda x, w, b: jnp.sum(jax_conv1d(x, w, b, padding=pad) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    tx, tw, tb = (v.requires_grad_() for v in (_t(x.transpose(0, 2, 1)),
                                               _t(w.transpose(2, 1, 0)), _t(bias)))
    y = tconv.conv1d(tx, tw, tb, padding=pad)
    assert isinstance(y.grad_fn, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad((y * _t(g.transpose(0, 2, 1))).sum(), (tx, tw, tb))
    _close(_nlc(got[0]), want[0], 1e-5)
    _close(got[1].numpy().transpose(2, 1, 0), want[1], 1e-5)
    _close(got[2].numpy(), want[2], 1e-5)
