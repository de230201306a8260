"""Normalization layers; counterpart of stable_audio_tools_tpu/ops/norms.py
(`LayerNorm`, last-axis features) and of flax's `nn.LayerNorm` and
`nn.GroupNorm` as the JAX UNets use them (`BiasedLayerNorm`, `GroupNorm`
over the channels of [B, C, T]), with flax's epsilon 1e-6."""

from __future__ import annotations

import torch
from torch import nn

from .kernels.layer_norm import fused_layer_norm


class LayerNorm(nn.Module):
    """Bias-less LayerNorm with f32 statistics, cast back to the input dtype.

    CUDA inputs run the fused CUDA kernel (ops/kernels/layer_norm.py)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.gamma, None, self.eps)


class BiasedLayerNorm(nn.LayerNorm):
    """LayerNorm with a scale and a bias (torch's names `weight`, `bias`) and
    epsilon 1e-6 by default (flax's); f32 statistics, the input's dtype out.
    CUDA inputs run the fused CUDA kernel (ops/kernels/layer_norm.py)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channels of x [B, C, ...] with epsilon 1e-6 by
    default (flax's), its statistics in f32, its output in the input's dtype.

    The statistics are one `torch.var_mean` over each (item, group)'s
    values, a reduction spread over the whole card: `F.group_norm` gives each
    (item, group) one thread block, so with one group at batch 1 a single
    block walks the 8.4 M values of a [1, 128, 65536] activation (PERF.md).
    The affine is one `addcmul` with a per-(item, channel) scale and shift."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__(num_groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, G = x.shape[0], x.shape[1], self.num_groups
        var, mean = torch.var_mean(x.float().reshape(B, G, -1), dim=2, keepdim=True,
                                   correction=0)  # [B, G, 1]
        scale = self.weight.view(G, C // G) * torch.rsqrt(var + self.eps)  # [B, G, C / G]
        shift = self.bias.view(G, C // G) - mean * scale
        tail = (1,) * (x.dim() - 2)
        return torch.addcmul(shift.reshape(B, C, *tail), x,
                             scale.reshape(B, C, *tail)).to(x.dtype)
