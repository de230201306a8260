"""Oobleck audio autoencoder; counterpart of
stable_audio_tools_tpu/models/autoencoders.py.

Layout: [B, C, T] throughout (the public audio/latent layout, and torch's
conv order). Module and parameter names follow the reference torch
Sequential layout (`layers.{i}`), so published checkpoints map by name.

The residual fusion is explicit: every snake -> WNConv1d pair passes the
snake's parameters to the conv (`pre_snake`), which runs the fused
snake-conv kernel; the ResidualUnit's skip add rides conv2's epilogue
(`residual=`). The snake before each transposed upsample runs the fused
snake kernel and then cuDNN's transposed conv. This slice covers the snake
activation (SA-Open's VAE); ELU and anti-aliased activations are later slices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.activations import SnakeBeta
from ..ops.conv import WNConv1d, WNConvTranspose1d
from .bottleneck import VAEBottleneck


def _require_snake(use_snake: bool) -> None:
    if not use_snake:
        raise NotImplementedError("only use_snake=True (SA-Open's VAE) is ported")


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        pad = (dilation * (7 - 1)) // 2
        self.layers = nn.Sequential(
            SnakeBeta(channels),
            WNConv1d(channels, channels, 7, padding=pad, dilation=dilation),
            SnakeBeta(channels),
            WNConv1d(channels, channels, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act1, conv1, act2, conv2 = self.layers
        h = conv1(x, pre_snake=act1.params(x.dtype))
        return conv2(h, pre_snake=act2.params(x.dtype), residual=x)


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.layers = nn.Sequential(
            ResidualUnit(in_channels, 1),
            ResidualUnit(in_channels, 3),
            ResidualUnit(in_channels, 9),
            SnakeBeta(in_channels),
            WNConv1d(in_channels, out_channels, 2 * stride,
                     padding=math.ceil(stride / 2)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.layers[:3]:
            x = unit(x)
        act, down = self.layers[3], self.layers[4]
        # strided conv: snake then cuDNN (the fused kernel is stride 1)
        w = down.weight(x.dtype)
        bias = down.bias.to(x.dtype) if down.bias is not None else None
        return nn.functional.conv1d(act(x), w, bias, stride=self.stride,
                                    padding=down.padding)


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.layers = nn.Sequential(
            SnakeBeta(in_channels),
            WNConvTranspose1d(in_channels, out_channels, 2 * stride, stride=stride,
                              padding=math.ceil(stride / 2)),
            ResidualUnit(out_channels, 1),
            ResidualUnit(out_channels, 3),
            ResidualUnit(out_channels, 9),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class OobleckEncoder(nn.Module):
    def __init__(self, in_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 8, 8),
                 use_snake: bool = False):
        super().__init__()
        _require_snake(use_snake)
        c_mults = [1] + list(c_mults)
        layers = [WNConv1d(in_channels, c_mults[0] * channels, 7, padding=3)]
        for i in range(len(c_mults) - 1):
            layers.append(EncoderBlock(c_mults[i] * channels, c_mults[i + 1] * channels,
                                       strides[i]))
        layers += [SnakeBeta(c_mults[-1] * channels),
                   WNConv1d(c_mults[-1] * channels, latent_dim, 3, padding=1)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-2]:
            x = layer(x)
        act, conv_out = self.layers[-2], self.layers[-1]
        return conv_out(x, pre_snake=act.params(x.dtype))


class OobleckDecoder(nn.Module):
    def __init__(self, out_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 8, 8),
                 use_snake: bool = False, final_tanh: bool = True):
        super().__init__()
        _require_snake(use_snake)
        c_mults = [1] + list(c_mults)
        self.final_tanh = final_tanh
        layers = [WNConv1d(latent_dim, c_mults[-1] * channels, 7, padding=3)]
        for i in range(len(c_mults) - 1, 0, -1):
            layers.append(DecoderBlock(c_mults[i] * channels, c_mults[i - 1] * channels,
                                       strides[i - 1]))
        layers += [SnakeBeta(c_mults[0] * channels),
                   WNConv1d(c_mults[0] * channels, out_channels, 7, padding=3, bias=False)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-2]:
            x = layer(x)
        act, conv_out = self.layers[-2], self.layers[-1]
        x = conv_out(x, pre_snake=act.params(x.dtype))
        return torch.tanh(x) if self.final_tanh else x


class AudioAutoencoder(nn.Module):
    """Encoder + bottleneck + decoder; encode/decode take and return [B, C, T]."""

    def __init__(self, encoder: Optional[nn.Module], decoder: nn.Module, latent_dim: int,
                 downsampling_ratio: int, sample_rate: int, io_channels: int = 2,
                 bottleneck: Optional[VAEBottleneck] = None, soft_clip: bool = False):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.bottleneck = bottleneck
        self.latent_dim = latent_dim
        self.downsampling_ratio = downsampling_ratio
        self.sample_rate = sample_rate
        self.io_channels = io_channels
        self.soft_clip = soft_clip

    def encode(self, audio: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        latents = self.encoder(audio)
        if self.bottleneck is not None:
            latents = self.bottleneck.encode(latents, generator=generator, noise=noise)
        return latents

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        if self.bottleneck is not None:
            latents = self.bottleneck.decode(latents)
        decoded = self.decoder(latents)
        return torch.tanh(decoded) if self.soft_clip else decoded
