"""DAC (descript-audio-codec) encoder and decoder; counterpart of
stable_audio_tools_tpu/models/dac.py (Snake1d :21, DACResidualUnit :40,
DACEncoderBlock :55, DACEncoder :71, DACDecoderBlock :94, DACDecoder :111).

Layout: [B, C, T]. Module names follow the reference layout that the JAX
package's importers read (io/checkpoints.py `import_dac_encoder`,
`import_dac_decoder`): the wrappers hold the towers as `encoder` /
`decoder`, the encoder tower's layers are `block.{i}`, the decoder's
`model.{i}`, each block's and residual unit's layers `block.{j}`, and a
Snake1d's `alpha` is [1, C, 1].

DAC's snake is x + sin^2(alpha x) / (alpha + 1e-9): the snake-beta function
with beta := alpha, so it runs on the port's snake kernels. As in the Oobleck
autoencoder (models/autoencoders.py), every snake -> stride-1 conv pair is
one fused snake-conv call (`pre_snake`: row 12, and row 3 with the residual
unit's skip add), and the snake before a strided or transposed conv is the
snake kernel (row 4) followed by cuDNN's conv.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import WNConv1d, WNConvTranspose1d
from ..ops.kernels.snake import snake_fused


class Snake1d(nn.Module):
    """DAC's per-channel snake, alpha not log-scaled (ones at init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def params(self, dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha, beta := alpha) for the snake kernels, f32 [C], rounded
        through `dtype` when given (the JAX module computes in x's dtype)."""
        a = self.alpha.reshape(-1).float()
        if dtype is not None:
            a = a.to(dtype).float()
        return a, a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake_fused(x, *self.params(x.dtype))


class DACResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.Sequential(
            Snake1d(dim), WNConv1d(dim, dim, 7, padding=pad, dilation=dilation),
            Snake1d(dim), WNConv1d(dim, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act1, conv1, act2, conv2 = self.block
        h = conv1(x, pre_snake=act1.params(x.dtype))
        return conv2(h, pre_snake=act2.params(x.dtype), residual=x)


class DACEncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.stride = stride
        self.block = nn.Sequential(
            DACResidualUnit(dim // 2, 1), DACResidualUnit(dim // 2, 3),
            DACResidualUnit(dim // 2, 9), Snake1d(dim // 2),
            WNConv1d(dim // 2, dim, 2 * stride, padding=math.ceil(stride / 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.block[:3]:
            x = unit(x)
        act, down = self.block[3], self.block[4]
        # strided conv: snake then cuDNN (the fused kernel is stride 1)
        return F.conv1d(act(x), down.weight(x.dtype), down.bias.to(x.dtype),
                        stride=self.stride, padding=down.padding)


class DACEncoder(nn.Module):
    """conv_in, a block a stride (channels doubling from d_model), Snake1d
    and a k = 3 conv_out to `d_latent` (default: the last block's width)."""

    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 8, 8),
                 d_latent: Optional[int] = None, in_channels: int = 1):
        super().__init__()
        d = d_model
        layers = [WNConv1d(in_channels, d, 7, padding=3)]
        for stride in strides:
            d *= 2
            layers.append(DACEncoderBlock(d, stride))
        layers += [Snake1d(d), WNConv1d(d, d_latent or d, 3, padding=1)]
        self.block = nn.Sequential(*layers)
        self.enc_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block[:-2]:
            x = layer(x)
        act, conv_out = self.block[-2], self.block[-1]
        return conv_out(x, pre_snake=act.params(x.dtype))


class DACEncoderWrapper(nn.Module):
    """The tower and, with `latent_dim`, a k = 1 `proj_out` to that width
    (the reference's backwards-compatible projection; the JAX package's
    `proj_out` Dense, which promotes to its f32 parameters: the projection
    runs in f32 here too)."""

    def __init__(self, latent_dim: Optional[int] = None, **kwargs):
        super().__init__()
        self.encoder = DACEncoder(**kwargs)
        self.proj_out = (nn.Conv1d(self.encoder.enc_dim, latent_dim, 1)
                         if latent_dim is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder(x)
        if self.proj_out is None:
            return x
        return F.conv1d(x.float(), self.proj_out.weight.float(), self.proj_out.bias.float())


class DACDecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        self.block = nn.Sequential(
            Snake1d(input_dim),
            WNConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                              padding=math.ceil(stride / 2)),
            DACResidualUnit(output_dim, 1), DACResidualUnit(output_dim, 3),
            DACResidualUnit(output_dim, 9))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DACDecoder(nn.Module):
    """conv_in to `channels`, a block a rate (channels halving), Snake1d, a
    k = 7 conv_out to `d_out` and tanh (`final_tanh`)."""

    def __init__(self, input_channel: int = 64, channels: int = 1536,
                 rates: Sequence[int] = (8, 8, 4, 2), d_out: int = 1,
                 final_tanh: bool = True):
        super().__init__()
        self.final_tanh = final_tanh
        layers = [WNConv1d(input_channel, channels, 7, padding=3)]
        ch = channels
        for stride in rates:
            layers.append(DACDecoderBlock(ch, ch // 2, stride))
            ch //= 2
        layers += [Snake1d(ch), WNConv1d(ch, d_out, 7, padding=3)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model[:-2]:
            x = layer(x)
        act, conv_out = self.model[-2], self.model[-1]
        x = conv_out(x, pre_snake=act.params(x.dtype))
        return torch.tanh(x) if self.final_tanh else x


class DACDecoderWrapper(nn.Module):
    def __init__(self, **kwargs):
        super().__init__()
        self.decoder = DACDecoder(**kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)
