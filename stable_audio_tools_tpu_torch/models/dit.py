"""DiffusionTransformer (DiT); counterpart of stable_audio_tools_tpu/models/dit.py.

Covers SA-Open's and SA-2.0's configurations and inpainting: Fourier timestep
features -> MLP, cross-attention tokens through `to_cond_embed`, the global
condition through `to_global_embed` plus the timestep embedding, prepended as
one token ahead of the latent sequence ("prepend" global conditioning),
`prepend_cond` tokens through `to_prepend_embed` ahead of that token,
input-concat conditioning (the inpainting mask and masked latents joined to x
on the channel axis, nearest-resampled to its length), zero-init 1x1 pre/post
convs, batch-doubled classifier-free guidance with negative cross-attention
conditioning, `scale_phi` rescale and `cfg_interval`, and bf16 compute over
f32 parameters. Layout: x [B, C, T]. adaLN conditioning and patching are later
slices.

Training: in `train()` mode with `cfg_dropout_prob` > 0 (and no CFG), whole
samples' cross-attention tokens are replaced with zeros (JAX
models/dit.py:282-297); the drop mask is passed in or drawn from a
`torch.Generator`. `use_checkpointing` (the JAX default, true) rematerialises
every transformer block in training.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import Linear
from ..ops.embeddings import FourierFeatures
from ..ops.transformer import ContinuousTransformer


def _mlp(dim_in: int, dim_out: int, bias: bool) -> nn.Sequential:
    return nn.Sequential(Linear(dim_in, dim_out, bias=bias), nn.SiLU(),
                         Linear(dim_out, dim_out, bias=bias))


class DiffusionTransformer(nn.Module):
    """Keyword arguments are the JSON config's `diffusion.config` keys; a key
    this slice does not port raises TypeError."""

    def __init__(self, io_channels: int = 32, embed_dim: int = 768,
                 cond_token_dim: int = 0, project_cond_tokens: bool = True,
                 global_cond_dim: int = 0, project_global_cond: bool = True,
                 input_concat_dim: int = 0, prepend_cond_dim: int = 0,
                 depth: int = 12, num_heads: int = 8,
                 transformer_type: str = "continuous_transformer",
                 compute_dtype: Optional[str] = None, use_checkpointing: bool = True):
        super().__init__()
        if transformer_type != "continuous_transformer":
            raise NotImplementedError(f"transformer_type {transformer_type} is not ported yet")
        self.io_channels = io_channels
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.timestep_features = FourierFeatures(1, 256)
        self.to_timestep_embed = _mlp(256, embed_dim, bias=True)
        cond_embed_dim = embed_dim if project_cond_tokens else cond_token_dim
        self.to_cond_embed = (_mlp(cond_token_dim, cond_embed_dim, bias=False)
                              if cond_token_dim > 0 else None)
        global_embed_dim = embed_dim if project_global_cond else global_cond_dim
        self.to_global_embed = (_mlp(global_cond_dim, global_embed_dim, bias=False)
                                if global_cond_dim > 0 else None)
        self.to_prepend_embed = (_mlp(prepend_cond_dim, embed_dim, bias=False)
                                 if prepend_cond_dim > 0 else None)
        dim_in = io_channels + input_concat_dim
        self.preprocess_conv = nn.Conv1d(dim_in, dim_in, 1, bias=False)
        self.postprocess_conv = nn.Conv1d(io_channels, io_channels, 1, bias=False)
        nn.init.zeros_(self.preprocess_conv.weight)
        nn.init.zeros_(self.postprocess_conv.weight)
        self.transformer = ContinuousTransformer(
            dim=embed_dim, depth=depth, dim_in=dim_in, dim_out=io_channels,
            dim_heads=embed_dim // num_heads, cross_attend=cond_token_dim > 0,
            cond_token_dim=cond_embed_dim if cond_token_dim > 0 else None,
            use_checkpointing=use_checkpointing)

    def _forward(self, x, t, cross_attn_cond=None, global_embed=None, input_concat_cond=None,
                 prepend_cond=None):
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            cdt = self.compute_dtype
            x, t, cross_attn_cond, global_embed, input_concat_cond, prepend_cond = (
                a.to(cdt) if a is not None else None
                for a in (x, t, cross_attn_cond, global_embed, input_concat_cond, prepend_cond))
        if cross_attn_cond is not None:
            cross_attn_cond = self.to_cond_embed(cross_attn_cond)
        if global_embed is not None:
            global_embed = self.to_global_embed(global_embed)
        if input_concat_cond is not None:
            if input_concat_cond.shape[2] != x.shape[2]:  # nearest, along time
                idx = torch.floor(torch.arange(x.shape[2], device=x.device)
                                  * (input_concat_cond.shape[2] / x.shape[2])).long()
                input_concat_cond = input_concat_cond[:, :, idx]
            x = torch.cat([x, input_concat_cond.to(x.dtype)], dim=1)
        timestep_embed = self.to_timestep_embed(self.timestep_features(t[:, None]))
        global_embed = timestep_embed if global_embed is None else global_embed + timestep_embed
        prepend = global_embed[:, None, :]
        if prepend_cond is not None:
            prepend = torch.cat([self.to_prepend_embed(prepend_cond), prepend], dim=1)

        x = F.conv1d(x, self.preprocess_conv.weight.to(x.dtype)) + x
        h = self.transformer(x.transpose(1, 2), prepend_embeds=prepend,
                             context=cross_attn_cond)
        out = h.transpose(1, 2)[:, :, prepend.shape[1]:]
        out = F.conv1d(out, self.postprocess_conv.weight.to(out.dtype)) + out
        return out.to(in_dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cross_attn_cond: Optional[torch.Tensor] = None,
                global_embed: Optional[torch.Tensor] = None,
                negative_cross_attn_cond: Optional[torch.Tensor] = None,
                negative_cross_attn_mask: Optional[torch.Tensor] = None,
                input_concat_cond: Optional[torch.Tensor] = None,
                prepend_cond: Optional[torch.Tensor] = None,
                prepend_cond_mask: Optional[torch.Tensor] = None,
                cfg_scale: float = 1.0,
                cfg_interval: Tuple[float, float] = (0.0, 1.0),
                scale_phi: float = 0.0, cfg_dropout_prob: float = 0.0,
                cfg_dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, C, T], t [B]. CFG doubles the batch: the second half gets
        `negative_cross_attn_cond` (zeros where `negative_cross_attn_mask` is
        off) or null cross-attention tokens, and zeroed `prepend_cond`. In
        training, each sample's cross-attention tokens (and, by a second
        draw, its prepend tokens) are zeroed with probability
        `cfg_dropout_prob`: `cfg_dropout_mask` [B] (True = drop) for the
        cross-attention tokens when given, else draws from `generator`.
        `prepend_cond_mask` is accepted and unused, as in the JAX package,
        whose transformer reads it only beside a sequence mask the DiT never
        passes."""
        del prepend_cond_mask
        if self.training and cfg_dropout_prob > 0.0 and cfg_scale == 1.0:
            def drop(cond, mask=None):
                if mask is None:
                    mask = torch.rand((cond.shape[0],), generator=generator,
                                      device=cond.device) < cfg_dropout_prob
                return torch.where(mask.to(cond.device)[:, None, None],
                                   torch.zeros_like(cond), cond)

            if cross_attn_cond is not None:
                cross_attn_cond = drop(cross_attn_cond, cfg_dropout_mask)
            if prepend_cond is not None:
                prepend_cond = drop(prepend_cond)
        single = lambda: self._forward(x, t, cross_attn_cond, global_embed, input_concat_cond,
                                       prepend_cond)
        if cfg_scale == 1.0 or (cross_attn_cond is None and prepend_cond is None):
            return single()
        lo, hi = cfg_interval
        if (lo, hi) != (0.0, 1.0):
            sigma = math.sin(float(t[0]) * math.pi / 2)
            if not lo <= sigma <= hi:  # outside the interval: the cond pass only
                return single()
        twice = lambda a: torch.cat([a, a]) if a is not None else None
        batch_cond = None
        if cross_attn_cond is not None:
            neg = torch.zeros_like(cross_attn_cond)
            if negative_cross_attn_cond is not None:
                neg = negative_cross_attn_cond.to(cross_attn_cond.dtype)
                if negative_cross_attn_mask is not None:
                    neg = torch.where(negative_cross_attn_mask.bool()[:, :, None], neg,
                                      torch.zeros_like(neg))
            batch_cond = torch.cat([cross_attn_cond, neg])
        out = self._forward(
            twice(x), twice(t), batch_cond, twice(global_embed), twice(input_concat_cond),
            torch.cat([prepend_cond, torch.zeros_like(prepend_cond)])
            if prepend_cond is not None else None)
        cond, uncond = out.chunk(2)
        cfg = uncond + (cond - uncond) * cfg_scale
        if scale_phi != 0.0:
            cond_std = cond.std(dim=1, keepdim=True, correction=0)
            cfg_std = cfg.std(dim=1, keepdim=True, correction=0)
            cfg = scale_phi * (cfg * (cond_std / (cfg_std + 1e-12))) + (1 - scale_phi) * cfg
        return cfg
