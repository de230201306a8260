"""The flash-attention forward at the edges of the Hopper kernels' tiles
(`csrc/flash_fwd.cu`: 128-row query blocks of two 64-row warpgroups, 64- or
128-key tiles, TMA boxes over 4-D maps of the caller's strides), the port
against the JAX package on the CPU.

The JAX entries `flash_attention`, `flash_attention_prefix`,
`flash_attention_nhd` and `flash_attention_fused_qkv` run their Pallas
kernels in interpret mode (as tests/test_flash_attention.py runs them); the
port's four entries take their plain versions on CPU tensors. Both get the
same f32 inputs from a numpy seed: lengths on either side of 64, 128 and
192, D 64 and 128, unmasked, causal and windows whose edges straddle the
block edges, B*H > 1 with a ragged N, a 1-token prefix at N = 1 + 1024
(SA-Open) and N = 1 + 6144 (SA-2.0) at a narrow width, and the NHD and
fused-QKV layouts with rot_dim 32 and rot_dim = D. Tolerance: 2e-5 of the
peak for the output and the logsumexp, as
tests/test_torch_flash_bwd_tiles.py holds the backward (f32 on both sides;
the softmax runs over blocks in one and whole rows in the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.kernels import flash_attention as jfa
from stable_audio_tools_tpu_torch.io.from_jax import deinterleave_fused
from stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs, rotary_tables
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 2e-5


def _close(name, got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, (name, err)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, H, N, D, causal, window)
BAND_CASES = [
    (1, 1, 63, 64, False, None),
    (2, 3, 65, 64, False, None),
    (1, 2, 127, 128, True, None),
    (2, 2, 129, 64, True, None),
    (1, 2, 191, 64, False, (63, 64)),
    (2, 1, 193, 128, False, (127, 128)),
    (3, 1, 193, 64, True, (64, -1)),
    (1, 2, 257, 64, False, (-1, 65)),
    (2, 1, 255, 128, False, (16, -1)),
    (1, 1, 300, 64, False, (128, 0)),
]


@pytest.mark.parametrize("B,H,N,D,causal,window", BAND_CASES)
def test_flash_attention_tile_edges_match_jax(B, H, N, D, causal, window):
    q, k, v = _rand(N + 7 * D, *[(B, H, N, D)] * 3)
    want, want_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                        window)
    got, got_lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal, window)
    _close("out", got, want)
    _close("lse", got_lse, np.asarray(want_lse)[:, :N, 0].reshape(B, H, N))


# (B, H, N, prefix_len): SA-Open's 1 + 1024 and SA-2.0's 1 + 6144 at a
# narrow width, ragged lengths with B*H > 1
PREFIX_CASES = [(1, 2, 1025, 1), (1, 1, 6145, 1), (2, 3, 129, 1), (1, 2, 193, 3), (2, 1, 65, 1)]


@pytest.mark.parametrize("B,H,N,P", PREFIX_CASES)
def test_flash_attention_prefix_tile_edges_match_jax(B, H, N, P):
    q, k, v = _rand(N + P, *[(B, H, N, 64)] * 3)
    want, want_lse = jfa._prefix_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), P)
    got, got_lse = tfa.flash_attention_prefix(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), P)
    _close("out", got, want)
    _close("lse", got_lse, np.asarray(want_lse)[..., 0])


# (B, N, H, causal, prefix_len): the JAX entry pairs heads (H even), D 64
NHD_CASES = [(2, 65, 2, False, 0), (1, 129, 4, True, 0), (2, 193, 2, False, 3),
             (1, 1025, 2, False, 1), (1, 6145, 2, False, 1), (2, 127, 2, True, 0)]


@pytest.mark.parametrize("B,N,H,causal,P", NHD_CASES)
def test_flash_attention_nhd_tile_edges_match_jax(B, N, H, causal, P):
    q, k, v = _rand(N + H, *[(B, N, H, 64)] * 3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, (lse_pair, lse_pref) = jfa._nhd_forward(jq, jk, jv, causal, P)
    want_lse = jfa._nhd_lse_to_bhn(lse_pair, lse_pref, B, H, N, P)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention_nhd(tq, tk, tv, causal=causal, prefix_len=P)
    _close("out", got, want)
    # the entry returns the output only; the logsumexp of the same call on
    # CPU tensors is its plain version's
    _, got_lse = tfa.flash_attention_nhd_plain(tq, tk, tv, causal, P)
    _close("lse", got_lse, np.asarray(want_lse)[:, :N, 0].reshape(B, H, N))


# (B, N, H, D, rot_dim, causal, window)
FUSED_CASES = [(1, 129, 2, 64, 32, False, None), (2, 65, 2, 64, 64, True, None),
               (1, 193, 2, 128, 128, False, (63, 64)), (1, 127, 2, 128, 32, True, None),
               (2, 191, 1, 64, 32, False, (-1, 65)), (1, 6145, 1, 64, 32, False, None)]


@pytest.mark.parametrize("B,N,H,D,rot,causal,window", FUSED_CASES)
def test_flash_attention_fused_qkv_tile_edges_match_jax(B, N, H, D, rot, causal, window):
    (qkv,) = _rand(N + rot, (B, N, H, 3, D))
    cos, sin = rotary_tables(rotary_freqs(N, rot))
    want, want_lse = jfa._fused_forward(jnp.asarray(qkv), jnp.asarray(cos.numpy()),
                                        jnp.asarray(sin.numpy()), causal, window)
    # the JAX entry reads the interleaved [B, N, H, 3, D]; the port the
    # concat [B, N, 3*H*D]
    concat = torch.from_numpy(deinterleave_fused(qkv.reshape(B * N, H * 3 * D), 3, D)
                              .reshape(B, N, 3 * H * D))
    got = tfa.flash_attention_fused_qkv(concat, cos, sin, H, causal=causal, window=window)
    _close("out", got, np.asarray(want).transpose(0, 2, 1, 3))
    _, got_lse = tfa.flash_attention_fused_qkv_plain(concat, cos, sin, H, causal, window)
    _close("lse", got_lse, np.asarray(want_lse)[..., 0].reshape(B, H, N))
