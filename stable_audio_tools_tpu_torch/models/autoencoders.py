"""Oobleck audio autoencoder; counterpart of
stable_audio_tools_tpu/models/autoencoders.py.

Layout: [B, C, T] throughout (the public audio/latent layout, and torch's
conv order). Module and parameter names follow the reference torch
Sequential layout (`layers.{i}`), so published checkpoints map by name.

The residual fusion is explicit: every snake -> WNConv1d pair passes the
snake's parameters to the conv (`pre_snake`), which runs the fused
snake-conv kernel; the ResidualUnit's skip add rides conv2's epilogue
(`residual=`). The snake before each strided or transposed conv runs the
fused snake kernel and then cuDNN's conv. Every one of these is
differentiable: the snake and snake-conv kernels are autograd Functions with
backward kernels, and the plain convs without a snake (`conv_in`) take the
hand-written weight gradient (ops/conv.py `Conv1dS1`), so the autoencoder
trains (training/autoencoders.py). Covered: the snake activation (SA-Open's
and SA-2.0's VAEs); ELU and anti-aliased activations are later slices.

`encode_audio` / `decode_audio` are the chunked overlap-paste codec for long
audio (JAX :462-553): windows of `chunk_size` latents every `chunk_size -
overlap`, the last one pinned to the end, run through the model in groups of
`chunk_batch` along the batch axis (the JAX package's `lax.map(batch_size=8)`),
and pasted with half the overlap trimmed from each inner edge. The JAX
package's `chunk_pspec` (sharding chunks over a mesh) is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from ..ops.activations import SnakeBeta
from ..ops.conv import WNConv1d, WNConvTranspose1d


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
    """Encoder + bottleneck + decoder; encode/decode take and return [B, C, T].
    The encoder and decoder are Oobleck's or SEANet's (models/seanet.py), the
    bottleneck a VAE or, for a discrete codec, an RVQ (`is_discrete`:
    `encode(..., return_info=True)` gives its codes, `decode_tokens` decodes
    them)."""

    def __init__(self, encoder: Optional[nn.Module], decoder: nn.Module, latent_dim: int,
                 downsampling_ratio: int, sample_rate: int, io_channels: int = 2,
                 bottleneck: Optional[nn.Module] = None, soft_clip: bool = False):
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
               noise: Optional[torch.Tensor] = None, return_info: bool = False,
               train: bool = False, **bottleneck_kwargs):
        """audio [B, C, T] -> latents; with `return_info`, (latents, info) with
        the bottleneck's losses (the VAE's "kl", the RVQ's "quantizer_loss").
        `train` lets a bottleneck with training state (the RVQ) update it;
        `bottleneck_kwargs` (the RVQ's `revive_indices`) go to the
        bottleneck."""
        latents = self.encoder(audio)
        info = {}
        if self.bottleneck is not None:
            out = self.bottleneck.encode(latents, generator=generator, noise=noise,
                                         return_info=return_info, train=train,
                                         **bottleneck_kwargs)
            latents, info = out if return_info else (out, info)
        return (latents, info) if return_info else latents

    @property
    def is_discrete(self) -> bool:
        return getattr(self.bottleneck, "is_discrete", False)

    def decode(self, latents: torch.Tensor, skip_bottleneck: bool = False) -> torch.Tensor:
        if self.bottleneck is not None and not skip_bottleneck:
            latents = self.bottleneck.decode(latents)
        decoded = self.decoder(latents)
        return torch.tanh(decoded) if self.soft_clip else decoded

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Codes [B, Q, T] of a discrete bottleneck -> audio [B, C, T * ratio]."""
        if not self.is_discrete:
            raise ValueError("decode_tokens needs a discrete (RVQ) bottleneck")
        return self.decode(self.bottleneck.decode_tokens(tokens), skip_bottleneck=True)

    # -- chunked overlap-paste codec ---------------------------------------

    @staticmethod
    def _chunk_starts(total: int, chunk: int, hop: int) -> List[int]:
        starts = list(range(0, total - chunk + 1, hop)) or [0]
        if starts[-1] + chunk != total:
            starts.append(total - chunk)  # the last chunk is pinned to the end
        return starts

    @staticmethod
    def _run_chunks(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                    starts: Sequence[int], chunk: int, chunk_batch: int) -> List[torch.Tensor]:
        """fn over x[..., s:s+chunk] for each start, `chunk_batch` windows at
        a time stacked on the batch axis; returns one [B, C', L'] per start."""
        B = x.shape[0]
        outs: List[torch.Tensor] = []
        for g in range(0, len(starts), chunk_batch):
            group = starts[g:g + chunk_batch]
            y = fn(torch.cat([x[:, :, s:s + chunk] for s in group], dim=0))
            outs.extend(y.split(B, dim=0))
        return outs

    @staticmethod
    def _overlap_paste(chunks: Sequence[torch.Tensor], starts: Sequence[int], chunk_len: int,
                       total_len: int, overlap_half: int) -> torch.Tensor:
        """chunks: [B, C, chunk_len] each -> [B, C, total_len]; every chunk but
        the first drops `overlap_half` on its left, every chunk but the last on
        its right, and later chunks overwrite earlier ones."""
        B, C, _ = chunks[0].shape
        y = chunks[0].new_zeros((B, C, total_len))
        for i, (s, c) in enumerate(zip(starts, chunks)):
            lo = overlap_half if i > 0 else 0
            hi = chunk_len - (overlap_half if i < len(chunks) - 1 else 0)
            y[:, :, s + lo:s + hi] = c[:, :, lo:hi]
        return y

    def encode_audio(self, audio: torch.Tensor, chunked: bool = False, overlap: int = 32,
                     chunk_size: int = 128, chunk_batch: int = 8, **kwargs) -> torch.Tensor:
        """audio [B, C, T] -> latents; `chunk_size` and `overlap` in latents.
        With a VAE bottleneck each chunk group draws its own noise from
        `generator`; an injected `noise` is not supported when chunking."""
        spl = self.downsampling_ratio
        if not chunked or audio.shape[2] <= chunk_size * spl:
            return self.encode(audio, **kwargs)
        if kwargs.get("noise") is not None:
            raise ValueError("encode_audio: pass a generator, not noise, when chunking")
        total, cs = audio.shape[2], chunk_size * spl
        starts = self._chunk_starts(total, cs, cs - overlap * spl)
        chunks = self._run_chunks(lambda c: self.encode(c, **kwargs), audio, starts, cs,
                                  chunk_batch)
        return self._overlap_paste(chunks, [s // spl for s in starts], chunk_size,
                                   total // spl, overlap // 2)

    def decode_audio(self, latents: torch.Tensor, chunked: bool = False, overlap: int = 32,
                     chunk_size: int = 128, chunk_batch: int = 8) -> torch.Tensor:
        """latents [B, latent_dim, S] -> audio; `chunk_size` and `overlap` in
        latents."""
        if not chunked or latents.shape[2] <= chunk_size:
            return self.decode(latents)
        spl = self.downsampling_ratio
        total = latents.shape[2]
        starts = self._chunk_starts(total, chunk_size, chunk_size - overlap)
        chunks = self._run_chunks(self.decode, latents, starts, chunk_size, chunk_batch)
        return self._overlap_paste(chunks, [s * spl for s in starts], chunk_size * spl,
                                   total * spl, (overlap // 2) * spl)
