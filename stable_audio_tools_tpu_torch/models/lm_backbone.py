"""Causal LM backbone; counterpart of
stable_audio_tools_tpu/models/lm_backbone.py (`ContinuousTransformerAudioLMBackbone`).

The causal `ContinuousTransformer` (every block's self-attention causal,
launching `flash_attention` on the card; the cross-attention causal too, as
the JAX package builds it) over the summed codebook embeddings, with
cross-attention to the projected conditioning (`to_cross_attn_embed`) and
prepended conditioning (`to_prepend_embed`). `compute_dtype` (MusicGen-small:
bfloat16) casts the input and the conditioning; the parameters stay f32 and
are cast at use, and the output returns in the input's dtype.

Three ways in: the full forward (training, `lm_generate`), the KV-cached
step (`caches=`, `cache_index=`, `cross_kvs=`; no prepend conditioning) and
`compute_cross_kv` (the per-layer cross-attention K/V of a constant context,
once per request).
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops.attention import Linear
from ..ops.transformer import ContinuousTransformer

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


class ContinuousTransformerAudioLMBackbone(nn.Module):
    def __init__(self, embed_dim: int, depth: int = 12, num_heads: int = 8,
                 cross_attn_cond_dim: int = 0, prepend_cond_dim: int = 0,
                 use_checkpointing: bool = True, ff_mult: float = 4,
                 compute_dtype: tp.Optional[str] = None):
        super().__init__()
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.compute_dtype = _DTYPES[compute_dtype] if compute_dtype is not None else None
        self.to_prepend_embed = (Linear(prepend_cond_dim, embed_dim)
                                 if prepend_cond_dim > 0 else None)
        self.to_cross_attn_embed = (Linear(cross_attn_cond_dim, embed_dim)
                                    if cross_attn_cond_dim > 0 else None)
        self.transformer = ContinuousTransformer(
            dim=embed_dim, depth=depth, dim_heads=embed_dim // num_heads, causal=True,
            cross_attend=cross_attn_cond_dim > 0,
            cond_token_dim=embed_dim if cross_attn_cond_dim > 0 else None,
            use_checkpointing=use_checkpointing, ff_mult=ff_mult)

    def _cast(self, t: tp.Optional[torch.Tensor]) -> tp.Optional[torch.Tensor]:
        return t.to(self.compute_dtype) if t is not None and self.compute_dtype else t

    def _cross(self, cross_attn_cond: tp.Optional[torch.Tensor]) -> tp.Optional[torch.Tensor]:
        cross_attn_cond = self._cast(cross_attn_cond)
        if cross_attn_cond is not None and self.to_cross_attn_embed is not None:
            cross_attn_cond = self.to_cross_attn_embed(cross_attn_cond)
        return cross_attn_cond

    def compute_cross_kv(self, cross_attn_cond: torch.Tensor) -> tp.List:
        """Per-layer cross-attention (k, v) [B, H, N_ctx, D] of the context."""
        return self.transformer.compute_cross_kv(self._cross(cross_attn_cond))

    def forward(self, x: torch.Tensor, cross_attn_cond: tp.Optional[torch.Tensor] = None,
                prepend_cond: tp.Optional[torch.Tensor] = None,
                prepend_cond_mask: tp.Optional[torch.Tensor] = None,
                caches: tp.Optional[tp.List[tp.Dict[str, torch.Tensor]]] = None,
                cache_index: tp.Optional[int] = None,
                cross_kvs: tp.Optional[tp.List] = None) -> torch.Tensor:
        """x [B, S, embed_dim] ([B, 1, embed_dim] with caches) -> [B, S,
        embed_dim] in x's dtype. `prepend_cond_mask` is accepted and not used,
        as in the JAX package (the backbone passes no key mask)."""
        del prepend_cond_mask
        in_dtype = x.dtype
        x = self._cast(x)
        if caches is not None:
            if prepend_cond is not None:
                raise ValueError("prepend conditioning is not supported by the cached decode")
            out = self.transformer(x, context=None if cross_kvs is not None
                                   else self._cross(cross_attn_cond),
                                   caches=caches, cache_index=cache_index, cross_kvs=cross_kvs)
            return out.to(in_dtype)
        prepend = None
        if prepend_cond is not None:
            if self.to_prepend_embed is None:
                raise ValueError("prepend conditioning given to a backbone without "
                                 "prepend_cond_dim")
            prepend = self.to_prepend_embed(self._cast(prepend_cond))
        out = self.transformer(x, prepend_embeds=prepend, context=self._cross(cross_attn_cond))
        return out[:, 0 if prepend is None else prepend.shape[1]:].to(in_dtype)
