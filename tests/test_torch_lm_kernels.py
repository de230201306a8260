"""The causal / sliding-window flash attention of the port (`flash_attention`
and its banded backward) against the JAX `flash_attention`, whose Pallas
forward and backward kernels run in interpret mode on the CPU, as
tests/test_flash_attention.py runs them.

On the CPU the port's wrapper takes its plain versions (`flash_attention_plain`,
`flash_attention_prefix_bwd_plain` under the band), so these tests hold the
function the CUDA kernels compute (tests/test_torch_cuda_kernels.py and
chip_smoke.py hold the kernels to these plain versions on the card).
Inputs are f32 and made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.kernels import flash_attention as jfa
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa

# (causal, window, D, N): causal at D 64 and 128, the TAAE windows (31, 32)
# and (63, 64), one-sided windows, a causal window, the unmasked function,
# ragged N (no multiple of the 64-row tile) up to 256
CASES = [
    (True, None, 64, 200),
    (True, None, 128, 256),
    (False, (31, 32), 128, 256),
    (False, (63, 64), 64, 200),
    (False, (16, -1), 64, 160),
    (False, (-1, 16), 128, 130),
    (True, (31, 32), 64, 230),
    (False, None, 64, 100),
]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _inputs(D, N, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, N, D)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal,window,D,N", CASES)
def test_flash_attention_plain_matches_pallas(causal, window, D, N):
    # f32 on both sides; the Pallas kernel folds 128- to 256-key blocks with
    # an online softmax, the plain version takes one masked softmax: f32
    # reassociation only, 2e-5 abs on O(1) outputs
    q, k, v = _inputs(D, N, 0)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window)
    got, lse = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.shape == (1, 2, N, D) and lse.shape == (1, 2, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    _, want_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal, window)
    np.testing.assert_allclose(lse.numpy().reshape(-1),
                               np.asarray(want_lse)[:, :N, 0].reshape(-1), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window,D,N", CASES)
def test_flash_attention_gradients_match_pallas(causal, window, D, N):
    # the port's autograd Function on the CPU (plain backward from the saved
    # logsumexp under the band) against jax.grad through the Pallas forward
    # and backward kernels in interpret mode, f32: 1e-4 of each gradient's
    # peak (sums over up to 256 keys reassociate)
    q, k, v, w = _inputs(D, N, 1, 4)

    def jax_loss(q, k, v):
        return jnp.sum(jnp.asarray(w) * jfa.flash_attention(q, k, v, causal, window) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out, _ = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad((_t(w) * out ** 2).sum(), (tq, tk, tv))
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("causal,window", [(True, None), (False, (31, 32)), (True, (5, 9)),
                                           (False, (-1, 0)), (False, None)])
def test_band_mask_is_the_pallas_position_mask(causal, window):
    # the plain versions' mask against JAX `_pos_mask` on one 96 x 96 block
    # (the kernels take the same (left, right) from `band`)
    w_left, w_right = (-1, -1) if window is None else window
    want = np.asarray(jfa._pos_mask(0, 0, 96, 96, 96, causal, w_left, w_right))
    got = tfa.band_mask(96, causal, window)
    got = np.ones((96, 96), bool) if got is None else got.numpy()
    np.testing.assert_array_equal(got, want)


def test_causal_nhd_backward_is_the_banded_backward():
    # the NHD entry's causal backward (no longer refused) is the [B, H, N, D]
    # backward under the causal band: the same gradients as `flash_attention`
    q, k, v, w = (_t(a) for a in _inputs(64, 90, 2, 4))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    out_a, _ = tfa.flash_attention(*a, causal=True)
    out_b = tfa.flash_attention_nhd(*b, causal=True)
    ga = torch.autograd.grad((w * out_a ** 2).sum(), a)
    gb = torch.autograd.grad((w.transpose(1, 2) * out_b ** 2).sum(), b)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y.transpose(1, 2), atol=1e-5, rtol=1e-5)


def test_flash_attention_refuses_what_the_kernel_cannot_take():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
