"""The transformer stack of the DiT; counterpart of
stable_audio_tools_tpu/ops/transformer.py (TransformerBlock :150,
ContinuousTransformer :329, the GLU feed-forward).

This covers the configuration SA-Open's and SA-2.0's DiTs run: pre-norm blocks with
bias-less LayerNorms, self-attention with partial rotary embeddings,
cross-attention to the conditioning tokens, a GLU (SiLU) feed-forward, and
prepended tokens ahead of the sequence. Parameter names are the reference
torch names (`layers.{i}.self_attn.to_qkv.weight`, `ff.ff.0.proj.weight`,
...). adaLN global conditioning, layer scale, conformer blocks, memory
tokens, qk-norm and sliding windows are later slices.

`use_checkpointing` rematerialises each block in training: under autograd in
`train()` mode every block runs inside `torch.utils.checkpoint` (non-
reentrant), so only the block inputs are kept and the block's forward runs
again in the backward, as the JAX package's `nn.remat` (ops/transformer.py:449).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, Linear
from .embeddings import RotaryEmbedding
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
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # reference layout: ff.0 = GLU, ff.1 = (dropout), ff.2 = linear_out
        self.ff = nn.Sequential(GLU(dim, dim * mult), nn.Identity(),
                                Linear(dim * mult, dim, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, dim_heads: int = 64, cross_attend: bool = False,
                 dim_context: Optional[int] = None):
        super().__init__()
        dim_heads = min(dim_heads, dim)
        self.pre_norm = LayerNorm(dim)
        self.self_attn = Attention(dim, dim_heads)
        self.cross_attend = cross_attend
        if cross_attend:
            self.cross_attend_norm = LayerNorm(dim)
            self.cross_attn = Attention(dim, dim_heads, dim_context=dim_context)
        self.ff_norm = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                rotary_pos_emb: Optional[torch.Tensor] = None,
                prefix_len: int = 0) -> torch.Tensor:
        x = x + self.self_attn(self.pre_norm(x), rotary_pos_emb=rotary_pos_emb,
                               prefix_len=prefix_len)
        if context is not None and self.cross_attend:
            x = x + self.cross_attn(self.cross_attend_norm(x), context=context,
                                    mask=context_mask)
        return x + self.ff(self.ff_norm(x))


class ContinuousTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, dim_in: Optional[int] = None,
                 dim_out: Optional[int] = None, dim_heads: int = 64,
                 cross_attend: bool = False, cond_token_dim: Optional[int] = None,
                 use_checkpointing: bool = False):
        super().__init__()
        self.use_checkpointing = use_checkpointing
        self.project_in = Linear(dim_in, dim, bias=False) if dim_in is not None else None
        self.project_out = Linear(dim, dim_out, bias=False) if dim_out is not None else None
        self.rotary_pos_emb = RotaryEmbedding(min(max(dim_heads // 2, 32), dim_heads))
        self.layers = nn.ModuleList([
            TransformerBlock(dim, dim_heads, cross_attend=cross_attend,
                             dim_context=cond_token_dim)
            for _ in range(depth)
        ])

    def forward(self, x: torch.Tensor, prepend_embeds: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, N, dim_in]; prepend_embeds [B, P, dim] go ahead of the
        sequence and stay in the output (the caller strips them)."""
        if self.project_in is not None:
            x = self.project_in(x)
        prefix_len = 0
        if prepend_embeds is not None:
            x = torch.cat([prepend_embeds.to(x.dtype), x], dim=1)
            prefix_len = prepend_embeds.shape[1]
        rope = self.rotary_pos_emb(x.shape[1], device=x.device)
        remat = self.use_checkpointing and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            args = (x, context, context_mask, rope, prefix_len)
            x = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        if self.project_out is not None:
            x = self.project_out(x)
        return x
