"""1-D ConvNeXt blocks and encoder; counterpart of
stable_audio_tools_tpu/models/convnext.py (`ConvNeXtBlock` :18,
`ConvNeXtEncoderBlock` :49, `ConvNeXtEncoder` :66), the trunk of ARC's
ConvNeXt discriminator head (models/arc.py), at the settings that head
gives it: 128 channels x (1, 1, 2, 4, 8), strides (2, 4, 8, 8), 3 blocks a
stage, one output channel.

Layout: [B, C, T]. A block is a depthwise conv (k = 7, no bias), a
weight-normalised 1 x 1 up-projection to 4 x the width, GELU (tanh
approximation: `jax.nn.gelu`'s default), a zero-initialised 1 x 1
down-projection, and the residual. Every conv computes in its input's dtype
with its weights cast to it, as the JAX modules do; bf16 stride-1 convs take
`ops/conv.py::conv1d` (its weight gradient is the hand-written
`conv1d_wgrad` on the card), the rest `torch.nn.functional`. Module names
are the JAX package's (`stages.{i}` for `stage_{i}`, `blocks.{j}` for
`block_{j}`); the reference's torch names are not known to this repo.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import WNConv1d, conv1d, weight_norm

KERNEL_SIZE, MULT, BLOCKS = 7, 4, 3
CHANNELS, C_MULTS, STRIDES, LATENT_DIM = 128, (1, 1, 2, 4, 8), (2, 4, 8, 8), 1


def conv_s1(x: torch.Tensor, w: torch.Tensor, bias: tp.Optional[torch.Tensor],
            padding: int) -> torch.Tensor:
    """A stride-1 conv in x's dtype: the kernel route for bf16."""
    w = w.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if x.dtype == torch.bfloat16:
        return conv1d(x, w, bias, padding=padding)
    return F.conv1d(x, w, bias, padding=padding)


class WNConv(WNConv1d):
    """A weight-normalised conv of any stride, in its input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, padding=padding)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = weight_norm(self.weight_v, self.weight_g)
        if self.stride == 1:
            return conv_s1(x, w, self.bias, self.padding)
        return F.conv1d(x, w.to(x.dtype), self.bias.to(x.dtype), stride=self.stride,
                        padding=self.padding)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # lecun normal, as the JAX package's `dw_kernel` [k, 1, C]
        self.dw_conv = nn.Parameter(torch.randn(dim, 1, KERNEL_SIZE) / math.sqrt(KERNEL_SIZE))
        self.proj_up = WNConv(dim, dim * MULT, 1)
        self.proj_down = nn.Conv1d(dim * MULT, dim, 1)
        nn.init.zeros_(self.proj_down.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.conv1d(x, self.dw_conv.to(x.dtype), padding=KERNEL_SIZE // 2, groups=x.shape[1])
        h = F.gelu(self.proj_up(h), approximate="tanh")
        return conv_s1(h, self.proj_down.weight, self.proj_down.bias, 0) + x


class ConvNeXtEncoderBlock(nn.Module):
    """BLOCKS ConvNeXt blocks at the input's width, then a strided
    weight-normalised conv (k = 2 stride, padding ceil(stride / 2))."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.blocks = nn.ModuleList([ConvNeXtBlock(in_channels) for _ in range(BLOCKS)])
        self.downsample = WNConv(in_channels, out_channels, 2 * stride, stride=stride,
                                 padding=math.ceil(stride / 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.downsample(x)


class ConvNeXtEncoder(nn.Module):
    """x [B, in_channels, T] -> [B, LATENT_DIM, T / prod(STRIDES)]."""

    def __init__(self, in_channels: int):
        super().__init__()
        widths = [m * CHANNELS for m in C_MULTS]
        self.conv_in = WNConv(in_channels, widths[0], 7, padding=3)
        self.stages = nn.ModuleList([ConvNeXtEncoderBlock(widths[i], widths[i + 1], s)
                                     for i, s in enumerate(STRIDES)])
        self.conv_out = WNConv(widths[-1], LATENT_DIM, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for stage in self.stages:
            x = stage(x)
        return self.conv_out(x)
