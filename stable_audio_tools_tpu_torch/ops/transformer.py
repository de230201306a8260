"""The transformer stack of the DiT and the LM backbone; counterpart of
stable_audio_tools_tpu/ops/transformer.py (TransformerBlock :150,
ContinuousTransformer :329, the GLU feed-forward).

This covers the configurations SA-Open's and SA-2.0's DiTs and the
MusicGen-style LM run: pre-norm blocks with bias-less LayerNorms,
self-attention with partial rotary embeddings (causal and / or under a
sliding window: `causal`, `sliding_window` reach every block), cross-attention
to the conditioning tokens (causal too when the stack is, as the JAX package
builds it: ops/attention.py says what that does), a GLU (SiLU) feed-forward
of width `ff_mult` x dim, and prepended tokens ahead of the sequence.
Parameter names are the reference torch names
(`layers.{i}.self_attn.to_qkv.weight`, `ff.ff.0.proj.weight`, ...). adaLN
global conditioning, layer scale, conformer blocks, memory tokens and
qk-norm are later slices.

KV-cached decode (JAX :449, `caches=`): one token at a time, every layer
writes its step into its own cache (`init_kv_cache`) in place, the rotary
runs at `cache_index`, and the cross-attention reads K/V projected once per
request (`compute_cross_kv`, JAX :372-392). Remat stays off there.

`use_checkpointing` rematerialises each block in training: under autograd in
`train()` mode every block runs inside `torch.utils.checkpoint` (non-
reentrant), so only the block inputs are kept and the block's forward runs
again in the backward, as the JAX package's `nn.remat` (ops/transformer.py:449).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, Linear
from .embeddings import RotaryEmbedding, rotary_tables
from .norms import LayerNorm


class GLU(nn.Module):
    """x -> a * silu(gate) with [a | gate] = proj(x) (reference concat layout)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.silu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: float = 4):
        super().__init__()
        inner = int(dim * mult)
        # reference layout: ff.0 = GLU, ff.1 = (dropout), ff.2 = linear_out
        self.ff = nn.Sequential(GLU(dim, inner), nn.Identity(), Linear(inner, dim, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, dim_heads: int = 64, cross_attend: bool = False,
                 dim_context: Optional[int] = None, causal: bool = False,
                 sliding_window: Optional[Tuple[int, int]] = None, ff_mult: float = 4):
        super().__init__()
        dim_heads = min(dim_heads, dim)
        self.pre_norm = LayerNorm(dim)
        self.self_attn = Attention(dim, dim_heads, causal=causal, sliding_window=sliding_window)
        self.cross_attend = cross_attend
        if cross_attend:
            self.cross_attend_norm = LayerNorm(dim)
            self.cross_attn = Attention(dim, dim_heads, dim_context=dim_context, causal=causal)
        self.ff_norm = LayerNorm(dim)
        self.ff = FeedForward(dim, ff_mult)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                rotary_pos_emb: Optional[torch.Tensor] = None,
                prefix_len: int = 0, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        x = x + self.self_attn(self.pre_norm(x), rotary_pos_emb=rotary_pos_emb,
                               prefix_len=prefix_len, cache=cache, cache_index=cache_index,
                               rope_tables=rope_tables)
        if (context is not None or cross_kv is not None) and self.cross_attend:
            x = x + self.cross_attn(self.cross_attend_norm(x), context=context,
                                    mask=context_mask, precomputed_kv=cross_kv)
        return x + self.ff(self.ff_norm(x))


class ContinuousTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, dim_in: Optional[int] = None,
                 dim_out: Optional[int] = None, dim_heads: int = 64,
                 cross_attend: bool = False, cond_token_dim: Optional[int] = None,
                 use_checkpointing: bool = False, causal: bool = False,
                 sliding_window: Optional[Tuple[int, int]] = None, ff_mult: float = 4):
        super().__init__()
        self.use_checkpointing = use_checkpointing
        self.project_in = Linear(dim_in, dim, bias=False) if dim_in is not None else None
        self.project_out = Linear(dim, dim_out, bias=False) if dim_out is not None else None
        self.rotary_pos_emb = RotaryEmbedding(min(max(dim_heads // 2, 32), dim_heads))
        self.layers = nn.ModuleList([
            TransformerBlock(dim, dim_heads, cross_attend=cross_attend,
                             dim_context=cond_token_dim, causal=causal,
                             sliding_window=sliding_window, ff_mult=ff_mult)
            for _ in range(depth)
        ])

    def compute_cross_kv(self, context: torch.Tensor) -> List[Optional[Tuple[torch.Tensor,
                                                                              torch.Tensor]]]:
        """Per-layer split-head cross-attention K/V of a constant context
        (None for a layer without cross-attention), for `cross_kvs=`."""
        return [layer.cross_attn.compute_kv(context) if layer.cross_attend else None
                for layer in self.layers]

    def forward(self, x: torch.Tensor, prepend_embeds: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                caches: Optional[List[Dict[str, torch.Tensor]]] = None,
                cache_index: Optional[int] = None,
                cross_kvs: Optional[List] = None) -> torch.Tensor:
        """x [B, N, dim_in]; prepend_embeds [B, P, dim] go ahead of the
        sequence and stay in the output (the caller strips them). With
        `caches` (one per layer), x is the token at `cache_index` ([B, 1,
        dim_in]) and the caches are updated in place."""
        if self.project_in is not None:
            x = self.project_in(x)
        prefix_len = 0
        if prepend_embeds is not None:
            x = torch.cat([prepend_embeds.to(x.dtype), x], dim=1)
            prefix_len = prepend_embeds.shape[1]
        rope_len = caches[0]["k"].shape[2] if caches is not None else x.shape[1]
        rope = self.rotary_pos_emb(rope_len, device=x.device)
        remat = (self.use_checkpointing and self.training and torch.is_grad_enabled()
                 and caches is None)
        # the rotary's cos / sin tables, once per forward for every block
        tables = rotary_tables(rope) if caches is None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x = layer(x, context, context_mask, rope, cache=caches[i],
                          cache_index=cache_index,
                          cross_kv=cross_kvs[i] if cross_kvs is not None else None)
                continue
            args = (x, context, context_mask, rope, prefix_len)
            x = (checkpoint(layer, *args, use_reentrant=False, rope_tables=tables) if remat
                 else layer(*args, rope_tables=tables))
        if self.project_out is not None:
            x = self.project_out(x)
        return x
