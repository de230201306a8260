"""The transformer stack of the DiT, the LM backbone and the TAAE; counterpart
of stable_audio_tools_tpu/ops/transformer.py (TransformerBlock :150,
ContinuousTransformer :329, the GLU feed-forward, ConformerModule :120).

Pre-norm blocks with bias-less LayerNorms, self-attention with partial rotary
embeddings (causal and / or under a sliding window: `causal`,
`sliding_window` reach every block), cross-attention to the conditioning
tokens (causal too when the stack is, as the JAX package builds it:
ops/attention.py says what that does), a GLU (SiLU) feed-forward of width
`ff_mult` x dim, and prepended tokens ahead of the sequence. Parameter names
are the reference torch names (`layers.{i}.self_attn.to_qkv.weight`,
`ff.ff.0.proj.weight`, ...).

The block's options (JAX :150-326): `norm_eps`; `remove_norms` (a
`DynamicTanh` for every norm); `layer_scale` (a `LayerScale` on each
branch's output); `conformer` (the `ConformerModule` after the attention);
`add_rope` (the block's own rotary over dim_heads // 2 when the stack gives
none, as the TAAE's blocks have); `ff_no_bias=False` (the feed-forward's
output bias); `qk_norm`, `differential`, `feat_scale` (ops/attention.py);
`global_cond_dim` (adaLN: a learnt [6 * dim] scale / shift / gate added to
the global conditioning, which modulates the normed inputs of the
self-attention and the feed-forward and gates their outputs by sigmoid(1 -
gate)). The stack adds memory tokens ahead of the sequence (stripped from
its output) and the global conditioning's projection (Linear, SiLU, Linear
to 6 * dim).

KV-cached decode (JAX :449, `caches=`): one token at a time, every layer
writes its step into its own cache (`init_kv_cache`) in place, the rotary
runs at `cache_index`, and the cross-attention reads K/V projected once per
request (`compute_cross_kv`, JAX :372-392). Remat stays off there.

`return_info` (JAX :505) also returns {"hidden_states": [each block's
output, prepended tokens kept]}; `exit_layer_ix` = i returns block i's output
and skips the rest and `project_out` (an index no block has, such as -1, runs
them all, as in JAX :507-516).

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
from .embeddings import RotaryEmbedding, rotary_freqs, rotary_tables
from .norms import DynamicTanh, LayerNorm, LayerScale


class GLU(nn.Module):
    """x -> a * silu(gate) with [a | gate] = proj(x) (reference concat layout)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.silu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: float = 4, no_bias: bool = True):
        super().__init__()
        inner = int(dim * mult)
        # reference layout: ff.0 = GLU, ff.1 = (dropout), ff.2 = linear_out
        self.ff = nn.Sequential(GLU(dim, inner), nn.Identity(),
                                Linear(inner, dim, bias=not no_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


class ConformerModule(nn.Module):
    """JAX :120: LayerNorm, a pointwise product, GLU, a depthwise conv over
    time (k 17, padding 8), LayerNorm, SiLU, a pointwise product; x [B, N,
    dim], the conv in x's dtype."""

    def __init__(self, dim: int, norm_eps: float = 1e-5):
        super().__init__()
        self.in_norm = LayerNorm(dim, eps=norm_eps)
        self.pointwise_conv = Linear(dim, dim, bias=False)
        self.glu = GLU(dim, dim)
        self.depthwise_conv = nn.Conv1d(dim, dim, 17, padding=8, groups=dim, bias=False)
        self.mid_norm = LayerNorm(dim, eps=norm_eps)
        self.pointwise_conv_2 = Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.glu(self.pointwise_conv(self.in_norm(x)))
        w = self.depthwise_conv.weight.to(x.dtype)
        x = F.conv1d(x.transpose(1, 2), w, padding=8, groups=x.shape[-1]).transpose(1, 2)
        return self.pointwise_conv_2(F.silu(self.mid_norm(x)))


def _scale(dim: int, on: bool) -> nn.Module:
    return LayerScale(dim) if on else nn.Identity()


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, dim_heads: int = 64, cross_attend: bool = False,
                 dim_context: Optional[int] = None, causal: bool = False,
                 sliding_window: Optional[Tuple[int, int]] = None, ff_mult: float = 4,
                 global_cond_dim: Optional[int] = None, conformer: bool = False,
                 remove_norms: bool = False, add_rope: bool = False,
                 layer_scale: bool = False, qk_norm: str = "none",
                 differential: bool = False, feat_scale: bool = False,
                 ff_no_bias: bool = True, norm_eps: float = 1e-5):
        super().__init__()
        dim_heads = min(dim_heads, dim)
        self.add_rope_dim = dim_heads // 2 if add_rope else 0
        norm = (lambda: DynamicTanh(dim)) if remove_norms else (lambda: LayerNorm(dim, norm_eps))
        self.pre_norm = norm()
        self.self_attn = Attention(dim, dim_heads, causal=causal, sliding_window=sliding_window,
                                   qk_norm=qk_norm, differential=differential,
                                   feat_scale=feat_scale)
        self.self_attn_scale = _scale(dim, layer_scale)
        self.cross_attend = cross_attend
        if cross_attend:
            self.cross_attend_norm = norm()
            self.cross_attn = Attention(dim, dim_heads, dim_context=dim_context, causal=causal,
                                        qk_norm=qk_norm)
            self.cross_attn_scale = _scale(dim, layer_scale)
        self.conformer = ConformerModule(dim, norm_eps) if conformer else None
        if conformer:
            self.conformer_scale = _scale(dim, layer_scale)
        self.ff_norm = norm()
        self.ff = FeedForward(dim, ff_mult, no_bias=ff_no_bias)
        self.ff_scale = _scale(dim, layer_scale)
        self.to_scale_shift_gate = (nn.Parameter(torch.randn(6 * dim) * dim ** -0.5)
                                    if global_cond_dim else None)

    def block_rope(self, n: int, device=None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The `add_rope` rotary's tables over n rows (None without it)."""
        if not self.add_rope_dim:
            return None
        return rotary_tables(rotary_freqs(n, self.add_rope_dim, device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                rotary_pos_emb: Optional[torch.Tensor] = None,
                prefix_len: int = 0, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                global_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`global_cond` [B, 6 * dim] drives adaLN where the block has it.
        Without a stack rotary, an `add_rope` block rotates by its own
        (`rope_tables` may carry them, made once by `block_rope`)."""
        if rotary_pos_emb is None and cache is None and rope_tables is None:
            rope_tables = self.block_rope(x.shape[1], x.device)
        attn = lambda h: self.self_attn(h, rotary_pos_emb=rotary_pos_emb, prefix_len=prefix_len,
                                        cache=cache, cache_index=cache_index,
                                        rope_tables=rope_tables)
        adaln = self.to_scale_shift_gate is not None and global_cond is not None
        if adaln:
            ssg = (self.to_scale_shift_gate.to(x.dtype) + global_cond)[:, None, :]
            scale_self, shift_self, gate_self, scale_ff, shift_ff, gate_ff = ssg.chunk(6, dim=-1)
            h = attn(self.pre_norm(x) * (1 + scale_self) + shift_self)
            x = x + self.self_attn_scale(h * torch.sigmoid(1 - gate_self))
        else:
            x = x + self.self_attn_scale(attn(self.pre_norm(x)))
        if (context is not None or cross_kv is not None) and self.cross_attend:
            x = x + self.cross_attn_scale(self.cross_attn(
                self.cross_attend_norm(x), context=context, mask=context_mask,
                precomputed_kv=cross_kv))
        if self.conformer is not None and cache is None:
            x = x + self.conformer_scale(self.conformer(x))
        if adaln:
            h = self.ff(self.ff_norm(x) * (1 + scale_ff) + shift_ff)
            return x + self.ff_scale(h * torch.sigmoid(1 - gate_ff))
        return x + self.ff_scale(self.ff(self.ff_norm(x)))


class ContinuousTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, dim_in: Optional[int] = None,
                 dim_out: Optional[int] = None, dim_heads: int = 64,
                 cross_attend: bool = False, cond_token_dim: Optional[int] = None,
                 use_checkpointing: bool = False, causal: bool = False,
                 sliding_window: Optional[Tuple[int, int]] = None, ff_mult: float = 4,
                 global_cond_dim: Optional[int] = None, conformer: bool = False,
                 num_memory_tokens: int = 0, layer_scale: bool = False,
                 qk_norm: str = "none"):
        super().__init__()
        self.use_checkpointing = use_checkpointing
        self.num_memory_tokens = num_memory_tokens
        self.project_in = Linear(dim_in, dim, bias=False) if dim_in is not None else None
        self.project_out = Linear(dim, dim_out, bias=False) if dim_out is not None else None
        self.rotary_pos_emb = RotaryEmbedding(min(max(dim_heads // 2, 32), dim_heads))
        if num_memory_tokens:
            self.memory_tokens = nn.Parameter(torch.randn(num_memory_tokens, dim))
        # JAX global_embed_0 / _1: the global conditioning to adaLN's 6 * dim
        self.global_embed = (nn.Sequential(Linear(global_cond_dim, dim), nn.SiLU(),
                                           Linear(dim, dim * 6))
                             if global_cond_dim is not None else None)
        self.layers = nn.ModuleList([
            TransformerBlock(dim, dim_heads, cross_attend=cross_attend,
                             dim_context=cond_token_dim, causal=causal,
                             sliding_window=sliding_window, ff_mult=ff_mult,
                             global_cond_dim=dim * 6 if global_cond_dim is not None else None,
                             conformer=conformer, layer_scale=layer_scale, qk_norm=qk_norm)
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
                cross_kvs: Optional[List] = None, return_info: bool = False,
                exit_layer_ix: Optional[int] = None,
                global_cond: Optional[torch.Tensor] = None):
        """x [B, N, dim_in]; prepend_embeds [B, P, dim] go ahead of the
        sequence and stay in the output (the caller strips them); the memory
        tokens go ahead of both and are stripped here. With `caches` (one
        per layer), x is the token at `cache_index` ([B, 1, dim_in]) and the
        caches are updated in place. `global_cond` [B, global_cond_dim]
        drives the blocks' adaLN."""
        if self.project_in is not None:
            x = self.project_in(x)
        prefix_len = 0
        if prepend_embeds is not None:
            x = torch.cat([prepend_embeds.to(x.dtype), x], dim=1)
            prefix_len = prepend_embeds.shape[1]
        mem = self.num_memory_tokens
        if mem:
            x = torch.cat([self.memory_tokens.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
            prefix_len += mem
        if global_cond is not None and self.global_embed is not None:
            global_cond = self.global_embed(global_cond.to(x.dtype))
        rope_len = caches[0]["k"].shape[2] if caches is not None else x.shape[1]
        rope = self.rotary_pos_emb(rope_len, device=x.device)
        remat = (self.use_checkpointing and self.training and torch.is_grad_enabled()
                 and caches is None)
        # the rotary's cos / sin tables, once per forward for every block
        tables = rotary_tables(rope) if caches is None else None
        info = {"hidden_states": []}
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x = layer(x, context, context_mask, rope, cache=caches[i],
                          cache_index=cache_index,
                          cross_kv=cross_kvs[i] if cross_kvs is not None else None)
                continue
            args = (x, context, context_mask, rope, prefix_len)
            kwargs = dict(rope_tables=tables, global_cond=global_cond)
            x = (checkpoint(layer, *args, use_reentrant=False, **kwargs) if remat
                 else layer(*args, **kwargs))
            if return_info:
                info["hidden_states"].append(x)
            if i == exit_layer_ix:
                x = x[:, mem:]
                return (x, info) if return_info else x
        x = x[:, mem:]
        if self.project_out is not None:
            x = self.project_out(x)
        return (x, info) if return_info else x
