"""Attention; counterpart of stable_audio_tools_tpu/ops/attention.py.

The port keeps the reference's concatenated projections (`to_qkv` =
[q | k | v], `to_kv` = [k | v]); the JAX package stores them head-major
interleaved for tensor parallelism, and io/from_jax.py de-interleaves.

Dispatch in `attention_core` ([B, H, N, D] in and out):
- non-causal, unmasked self-attention with a prefix of at most 64 tokens and
  head dim 64 goes to `flash_attention_prefix` (ops/kernels/flash_attention.py:
  the CUDA kernel on the card, its plain version on the CPU). SA-Open's DiT
  self-attention is this case (N = 1 + 1024).
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

from .embeddings import apply_rotary_pos_emb
from .kernels.flash_attention import HEAD_DIM, MAX_PREFIX, flash_attention_prefix


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
                 dim_context: Optional[int] = None):
        super().__init__()
        self.dim = dim
        self.dim_heads = dim_heads
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

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                rotary_pos_emb: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                prefix_len: int = 0) -> torch.Tensor:
        if self.cross:
            q = self.to_q(x)
            k, v = self.to_kv(context).chunk(2, dim=-1)
        else:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
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
