"""The flash-attention backward at the edges of the Hopper kernels' tiles
(`csrc/flash_bwd.cu`: 64-row tiles, 128-byte TMA boxes over [B*H, N, D]),
the port against the JAX package on the CPU.

The JAX package's `_flash_backward` runs both its kernels, the single-pass
`_bwd_fused_kernel` and the two-pass `_bwd_dkv_kernel` + `_bwd_dq_kernel`,
in interpret mode (as tests/test_flash_attention.py runs them), with 64- or
128-row blocks; the port's `flash_attention_prefix_bwd` takes its plain
version on CPU tensors. Both get the same f32 inputs from a numpy seed and
the same saved output and logsumexp: lengths on either side of 64 and 128,
D 64 and 128, unmasked, causal and windows whose edges straddle the tile
boundaries, B*H > 1 with a ragged N (where a 2-D map over [B*H*N, D] would
read the next head's rows). Tolerance: 2e-5 of each gradient's peak, as
tests/test_torch_training.py holds the same backward (f32 on both sides; the
sums run over blocks in one and whole rows in the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.kernels import flash_attention as jfa
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 2e-5

# (B, H, N, D, causal, window, block rows of the JAX kernels)
CASES = [
    (1, 1, 63, 64, False, None, 64),
    (2, 3, 65, 64, False, None, 64),
    (1, 2, 64, 128, True, None, 64),
    (2, 2, 127, 64, True, None, 64),
    (1, 2, 128, 64, False, (63, 64), 128),
    (2, 1, 129, 128, False, (63, 64), 128),
    (1, 2, 257, 64, False, (127, 128), 128),
    (2, 1, 257, 128, True, (64, -1), 128),
    (3, 1, 129, 64, False, (16, -1), 128),
    (1, 2, 257, 64, False, (-1, 65), 128),
    (2, 2, 65, 128, False, (500, 500), 128),
]


def _inputs(B, H, N, D, causal, window, seed):
    """q, k, v, dO and the forward's output and logsumexp (f32, numpy)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(4))
    keep = tfa.band_mask(N, causal, window)
    logits = np.einsum("bhnd,bhmd->bhnm", q, k) / np.sqrt(D)
    if keep is not None:
        logits = np.where(keep.numpy(), logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    out = np.einsum("bhnm,bhmd->bhnd", np.exp(logits - lse[..., None]), v)
    return q, k, v, g, out.astype(np.float32), lse.astype(np.float32)


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("B,H,N,D,causal,window,block", CASES)
def test_flash_bwd_tile_edges_match_jax(route, B, H, N, D, causal, window, block):
    q, k, v, g, out, lse = _inputs(B, H, N, D, causal, window, seed=N + 7 * D)
    lse_flat = jfa._pad_lse(jnp.asarray(lse.reshape(B * H, N, 1)), N, causal, window, block,
                            block)
    want = jfa._flash_backward(*(jnp.asarray(a) for a in (q, k, v, out)), lse_flat,
                               jnp.asarray(g), causal, window, block_q=block, block_k=block,
                               fused=route == "fused")
    got = tfa.flash_attention_prefix_bwd(*(torch.from_numpy(a) for a in (q, k, v, out, lse, g)),
                                         route=route, causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float64)
        assert a.shape == (B, H, N, D), name
        err = np.abs(a.double().numpy() - b).max() / np.abs(b).max()
        assert err <= TOL, (name, err)
