"""Attention; counterpart of stable_audio_tools_tpu/ops/attention.py.

The port keeps the reference's concatenated projections (`to_qkv` =
[q | k | v], `to_kv` = [k | v]); the JAX package stores them head-major
interleaved for tensor parallelism, and io/from_jax.py de-interleaves.

Dispatch of `Attention`:
- unmasked self-attention with head dim 64, a prefix of at most 128 tokens and
  a main sequence of at least `nhd_min_seq` tokens takes the strided-layout
  entry `flash_attention_nhd`: q, k, v stay [B, N, H, 64] views of the
  `to_qkv` output (no head transposes in or out), the rotary runs in that
  layout, and `to_out` reads the kernel's output as it lies. SA-2.0's DiT
  self-attention is this case (N = 1 + 6144). It is the counterpart of the
  JAX package's NHD branch (ops/attention.py:507-570); that branch's gate
  (`_should_use_nhd`) is the TPU's and is not carried over.
- otherwise `attention_core` ([B, H, N, D] in and out): non-causal, unmasked
  self-attention with a prefix of at most 64 tokens and head dim 64 goes to
  `flash_attention_prefix` (ops/kernels/flash_attention.py: the CUDA kernel on
  the card, its plain version on the CPU). SA-Open's DiT self-attention is
  this case (N = 1 + 1024).
- everything else (the cross-attention to the conditioning tokens, with or
  without a key mask) is plain matmul + f32 softmax, as the JAX package
  leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .embeddings import apply_rotary_pos_emb, apply_rotary_pos_emb_nhd
from .kernels.flash_attention import (HEAD_DIM, MAX_PREFIX, MAX_PREFIX_NHD,
                                      flash_attention_nhd, flash_attention_prefix)

# Main-sequence length from which self-attention takes `flash_attention_nhd`:
# between SA-Open's 1024 and SA-2.0's 6144. On an H100 (chip_smoke.py phase 2,
# q,k,v [2,N,24,64]) the strided-layout entry takes 2.54 ms at N = 6145 and
# 0.100 ms at N = 1025, the [B, H, N, 64] entry with its four transposed
# copies 7.96 ms and 0.357 ms: it is the faster one at both lengths. The
# threshold keeps SA-Open's paths on the entry their records were taken with;
# lowering it is queued in ROADMAP.md.
NHD_MIN_SEQ = 2048


class Linear(nn.Linear):
    """nn.Linear whose f32 parameters are cast to the input's dtype at use
    (f32 master weights, bf16 compute, as the JAX package's Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), bias)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, H, N, D]; mask [B, Nk] True = attend. Softmax in f32, the
    weights cast to q's dtype before PV (as the JAX package)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits + torch.where(mask[:, None, None, :], 0.0, neg)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   prefix_len: Optional[int] = None) -> torch.Tensor:
    """Non-causal attention over [B, H, N, D]. `prefix_len` is the count of
    prepended tokens of a self-attention sequence (None for cross-attention)."""
    if (prefix_len is not None and mask is None and q.shape == k.shape
            and prefix_len <= MAX_PREFIX and q.shape[-1] == HEAD_DIM):
        return flash_attention_prefix(q, k, v, prefix_len)[0]
    return dot_product_attention(q, k, v, mask)


class Attention(nn.Module):
    """Multi-head attention: self-attention (fused `to_qkv`) or
    cross-attention (`to_q` + fused `to_kv`) when `dim_context` is set.

    As in the reference, cross-attention keys and values keep the context's
    width: dim_context // dim_heads key/value heads, each shared by
    consecutive query heads (SA-Open: 24 query heads over 12 kv heads)."""

    def __init__(self, dim: int, dim_heads: int = 64,
                 dim_context: Optional[int] = None,
                 nhd_min_seq: Optional[int] = None):
        """`nhd_min_seq`: the main-sequence length from which self-attention
        takes the strided-layout kernel (default NHD_MIN_SEQ)."""
        super().__init__()
        self.dim = dim
        self.dim_heads = dim_heads
        self.nhd_min_seq = NHD_MIN_SEQ if nhd_min_seq is None else nhd_min_seq
        self.cross = dim_context is not None
        if self.cross:
            self.to_q = Linear(dim, dim, bias=False)
            self.to_kv = Linear(dim_context, 2 * dim_context, bias=False)
        else:
            self.to_qkv = Linear(dim, 3 * dim, bias=False)
        self.to_out = Linear(dim, dim, bias=False)

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, _ = t.shape
        return t.view(b, n, -1, self.dim_heads).transpose(1, 2)

    def _forward_nhd(self, q, k, v, rotary_pos_emb, prefix_len) -> torch.Tensor:
        """q, k, v: [B, N, dim] views of the fused projection. Nothing is
        transposed or made contiguous: the rotary writes new q and k, v stays
        a view, and the kernel reads each through its own strides."""
        b, n, _ = q.shape
        q, k, v = (t.view(b, n, -1, self.dim_heads) for t in (q, k, v))
        if rotary_pos_emb is not None:
            q = apply_rotary_pos_emb_nhd(q, rotary_pos_emb)
            k = apply_rotary_pos_emb_nhd(k, rotary_pos_emb)
        out = flash_attention_nhd(q, k, v, causal=False, prefix_len=prefix_len)
        return self.to_out(out.view(b, n, self.dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                rotary_pos_emb: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                prefix_len: int = 0) -> torch.Tensor:
        if self.cross:
            q = self.to_q(x)
            k, v = self.to_kv(context).chunk(2, dim=-1)
        else:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
            if (mask is None and self.dim_heads == HEAD_DIM and prefix_len <= MAX_PREFIX_NHD
                    and x.shape[1] - prefix_len >= self.nhd_min_seq):
                return self._forward_nhd(q, k, v, rotary_pos_emb, prefix_len)
        q, k, v = self._split_heads(q), self._split_heads(k), self._split_heads(v)
        if k.shape[1] != q.shape[1]:
            rep = q.shape[1] // k.shape[1]
            k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        if rotary_pos_emb is not None:
            q = apply_rotary_pos_emb(q, rotary_pos_emb)
            k = apply_rotary_pos_emb(k, rotary_pos_emb)
        out = attention_core(q, k, v, mask=mask,
                             prefix_len=None if self.cross else prefix_len)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.dim))
