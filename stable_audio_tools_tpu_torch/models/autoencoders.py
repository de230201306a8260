"""Oobleck and transformer (TAAE) audio autoencoders; counterpart of
stable_audio_tools_tpu/models/autoencoders.py.

Layout: [B, C, T] throughout (the public audio/latent layout, and torch's
conv order). Oobleck's module and parameter names follow the reference torch
Sequential layout (`layers.{i}`), so published checkpoints map by name.

Oobleck with the snake (`use_snake=True`, SA-Open's and SA-2.0's VAEs): the
residual fusion is explicit: every snake -> WNConv1d pair passes the snake's
parameters to the conv (`pre_snake`), which runs the fused snake-conv kernel;
the ResidualUnit's skip add rides conv2's epilogue (`residual=`). The snake
before each strided or transposed conv runs the fused snake kernel and then
cuDNN's conv. Every one of these is differentiable: the snake and snake-conv
kernels are autograd Functions with backward kernels, and the plain convs
without a snake (`conv_in`) take the hand-written weight gradient
(ops/conv.py `Conv1dS1`), so the autoencoder trains
(training/autoencoders.py). With `use_snake=False` every activation is an
ELU (`nn.ELU`, no parameters, at the snake's place in `layers`), and each
stride-1 conv is `Conv1dS1` (row 11 plain for its weight gradient in bf16)
with the residual added after it. The anti-aliased activations are not
ported.

TAAE (JAX `TAAEBlock` :248, `TAAEEncoder` :299, `TAAEDecoder` :332): a
stride stage is a strided WNConv1d (k = 2s, padding ceil(s / 2)) followed by
`transformer_depth` TransformerBlocks at its output width (the encoder), or
the blocks at its input width followed by the transposed conv (the
decoder). Every block is the JAX package's: heads of 128 (min(128, width)),
qk-norm "ln", LayerScale, its own rotary over 64 dims, norms of epsilon
1e-2, the feed-forward's output bias, the sliding window (31, 32) by
default; on the card the window runs row 5 forward and row 6 backward (head
dim 128 or 64) and the norms row 2. The blocks run on [B, T, C]. Parameter
names follow the JAX module tree (`conv_in`, `blocks.{i}.conv`,
`blocks.{i}.transformers.{j}.*`, `act`, `conv_out`): the JAX package has no
TAAE importer and the reference sources are not at hand to check theirs.

`encode_audio` / `decode_audio` are the chunked overlap-paste codec for long
audio (JAX :462-553): windows of `chunk_size` latents every `chunk_size -
overlap`, the last one pinned to the end, run through the model in groups of
`chunk_batch` along the batch axis (the JAX package's `lax.map(batch_size=8)`),
and pasted with half the overlap trimmed from each inner edge. The JAX
package's `chunk_pspec` (sharding chunks over a mesh) is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import SnakeBeta, get_activation
from ..ops.conv import WNConv1d, WNConvTranspose1d
from ..ops.transformer import TransformerBlock


def _act(use_snake: bool, channels: int) -> nn.Module:
    return get_activation("snake" if use_snake else "elu", channels)


def _act_conv(act: nn.Module, conv: WNConv1d, x: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv(act(x)) (+ residual): a snake rides the fused snake-conv kernel."""
    if isinstance(act, SnakeBeta):
        return conv(x, pre_snake=act.params(x.dtype), residual=residual)
    return conv(act(x), residual=residual)


def _strided_conv(conv: WNConv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """A WNConv1d's weights at `stride` (cuDNN; the kernels are stride 1)."""
    bias = conv.bias.to(x.dtype) if conv.bias is not None else None
    return F.conv1d(x, conv.weight(x.dtype), bias, stride=stride, padding=conv.padding)


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int, use_snake: bool = True):
        super().__init__()
        pad = (dilation * (7 - 1)) // 2
        self.layers = nn.Sequential(
            _act(use_snake, channels),
            WNConv1d(channels, channels, 7, padding=pad, dilation=dilation),
            _act(use_snake, channels),
            WNConv1d(channels, channels, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act1, conv1, act2, conv2 = self.layers
        return _act_conv(act2, conv2, _act_conv(act1, conv1, x), residual=x)


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 use_snake: bool = True):
        super().__init__()
        self.stride = stride
        self.layers = nn.Sequential(
            ResidualUnit(in_channels, 1, use_snake),
            ResidualUnit(in_channels, 3, use_snake),
            ResidualUnit(in_channels, 9, use_snake),
            _act(use_snake, in_channels),
            WNConv1d(in_channels, out_channels, 2 * stride,
                     padding=math.ceil(stride / 2)),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.layers[:3]:
            x = unit(x)
        # strided conv: the activation (the snake kernel), then cuDNN
        return _strided_conv(self.layers[4], self.layers[3](x), self.stride)


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 use_snake: bool = True):
        super().__init__()
        self.layers = nn.Sequential(
            _act(use_snake, in_channels),
            WNConvTranspose1d(in_channels, out_channels, 2 * stride, stride=stride,
                              padding=math.ceil(stride / 2)),
            ResidualUnit(out_channels, 1, use_snake),
            ResidualUnit(out_channels, 3, use_snake),
            ResidualUnit(out_channels, 9, use_snake),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class OobleckEncoder(nn.Module):
    def __init__(self, in_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 8, 8),
                 use_snake: bool = False):
        super().__init__()
        c_mults = [1] + list(c_mults)
        layers = [WNConv1d(in_channels, c_mults[0] * channels, 7, padding=3)]
        for i in range(len(c_mults) - 1):
            layers.append(EncoderBlock(c_mults[i] * channels, c_mults[i + 1] * channels,
                                       strides[i], use_snake))
        layers += [_act(use_snake, c_mults[-1] * channels),
                   WNConv1d(c_mults[-1] * channels, latent_dim, 3, padding=1)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-2]:
            x = layer(x)
        return _act_conv(self.layers[-2], self.layers[-1], x)


class OobleckDecoder(nn.Module):
    def __init__(self, out_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 8, 8),
                 use_snake: bool = False, final_tanh: bool = True):
        super().__init__()
        c_mults = [1] + list(c_mults)
        self.final_tanh = final_tanh
        layers = [WNConv1d(latent_dim, c_mults[-1] * channels, 7, padding=3)]
        for i in range(len(c_mults) - 1, 0, -1):
            layers.append(DecoderBlock(c_mults[i] * channels, c_mults[i - 1] * channels,
                                       strides[i - 1], use_snake))
        layers += [_act(use_snake, c_mults[0] * channels),
                   WNConv1d(c_mults[0] * channels, out_channels, 7, padding=3, bias=False)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-2]:
            x = layer(x)
        x = _act_conv(self.layers[-2], self.layers[-1], x)
        return torch.tanh(x) if self.final_tanh else x


class TAAEBlock(nn.Module):
    """A stride stage of the TAAE (JAX :248); x [B, C, T] in and out."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 block_type: str = "encoder", transformer_depth: int = 3,
                 sliding_window: Tuple[int, int] = (31, 32), conformer: bool = False,
                 layer_scale: bool = True):
        super().__init__()
        if block_type not in ("encoder", "decoder"):
            raise ValueError(f"block_type must be 'encoder' or 'decoder', got {block_type!r}")
        self.encoder = block_type == "encoder"
        self.stride = stride
        width = out_channels if self.encoder else in_channels
        self.transformers = nn.ModuleList([
            TransformerBlock(width, 128, conformer=conformer, layer_scale=layer_scale,
                             add_rope=True, qk_norm="ln", ff_mult=4, ff_no_bias=False,
                             norm_eps=1e-2, sliding_window=tuple(sliding_window))
            for _ in range(transformer_depth)])
        conv = WNConv1d if self.encoder else WNConvTranspose1d
        kw = {} if self.encoder else {"stride": stride}
        self.conv = conv(in_channels, out_channels, 2 * stride, padding=math.ceil(stride / 2),
                         **kw)

    def run_transformers(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks over x [B, C, T], on [B, T, C], their rotary tables
        made once."""
        h = x.transpose(1, 2)
        if self.transformers:
            tables = self.transformers[0].block_rope(h.shape[1], h.device)
            for block in self.transformers:
                h = block(h, rope_tables=tables)
        return h.transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.encoder:
            return self.run_transformers(_strided_conv(self.conv, x, self.stride))
        return self.conv(self.run_transformers(x))


class TAAEEncoder(nn.Module):
    def __init__(self, in_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 8, 8),
                 transformer_depths: Optional[Sequence[int]] = None, use_snake: bool = False,
                 sliding_window: Tuple[int, int] = (31, 32)):
        super().__init__()
        c_mults = [1] + list(c_mults)
        depths = transformer_depths or [3] * (len(c_mults) - 1)
        self.conv_in = WNConv1d(in_channels, c_mults[0] * channels, 7, padding=3)
        self.blocks = nn.ModuleList([
            TAAEBlock(c_mults[i] * channels, c_mults[i + 1] * channels, strides[i], "encoder",
                      depths[i], sliding_window) for i in range(len(c_mults) - 1)])
        self.act = _act(use_snake, c_mults[-1] * channels)
        self.conv_out = WNConv1d(c_mults[-1] * channels, latent_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        return _act_conv(self.act, self.conv_out, x)


class TAAEDecoder(nn.Module):
    def __init__(self, out_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: Sequence[int] = (1, 2, 4, 8), strides: Sequence[int] = (2, 4, 8, 8),
                 transformer_depths: Optional[Sequence[int]] = None, use_snake: bool = False,
                 sliding_window: Tuple[int, int] = (31, 32), final_tanh: bool = True):
        super().__init__()
        c_mults = [1] + list(c_mults)
        depth = len(c_mults)
        depths = transformer_depths or [3] * (depth - 1)
        self.final_tanh = final_tanh
        self.conv_in = WNConv1d(latent_dim, c_mults[-1] * channels, 7, padding=3)
        self.blocks = nn.ModuleList([
            TAAEBlock(c_mults[i] * channels, c_mults[i - 1] * channels, strides[i - 1],
                      "decoder", depths[i - 1], sliding_window)
            for i in range(depth - 1, 0, -1)])
        self.act = _act(use_snake, c_mults[0] * channels)
        self.conv_out = WNConv1d(c_mults[0] * channels, out_channels, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        x = _act_conv(self.act, self.conv_out, x)
        return torch.tanh(x) if self.final_tanh else x


class AudioAutoencoder(nn.Module):
    """Encoder + bottleneck + decoder; encode/decode take and return [B, C, T].
    The encoder and decoder are Oobleck's, the TAAE's, DAC's or SEANet's, the
    bottleneck any of models/bottleneck.py's; for a discrete one (an RVQ or
    an FSQ, `is_discrete`) `encode(..., return_info=True)` gives its codes
    and `decode_tokens` decodes them."""

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
        the bottleneck's losses (the VAE's "kl", the RVQ's "quantizer_loss",
        the DAC RVQ's "vq/*" and its quantized "z").
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

    def decode(self, latents: torch.Tensor, skip_bottleneck: bool = False,
               train: bool = False, quantized: bool = False,
               generator: Optional[torch.Generator] = None, noise=None) -> torch.Tensor:
        """latents [B, latent_dim, S] -> audio, through the bottleneck's
        decode (`quantized`: its `decode_quantized`, for a latent its encode
        already quantized, JAX :438) whose noise augmentation draws from
        `generator` or takes `noise` (models/bottleneck.py); `train` is
        JAX's training pass (softnorm's `noise_regularize`)."""
        if self.bottleneck is not None and not skip_bottleneck:
            fn = self.bottleneck.decode_quantized if quantized else self.bottleneck.decode
            latents = fn(latents, train=train, generator=generator, noise=noise)
        decoded = self.decoder(latents)
        return torch.tanh(decoded) if self.soft_clip else decoded

    def decode_tokens(self, tokens: torch.Tensor, dtype: Optional[torch.dtype] = None,
                      generator: Optional[torch.Generator] = None, noise=None
                      ) -> torch.Tensor:
        """Codes of a discrete bottleneck (the layout its `decode_tokens`
        takes) -> audio [B, C, T * ratio]; the latents in `dtype` when given
        (the bottlenecks give f32; the card's kernels take bf16); the noise
        augmentation's draw from `generator` or `noise`."""
        if not self.is_discrete:
            raise ValueError("decode_tokens needs a discrete (RVQ, DAC RVQ or FSQ) bottleneck")
        latents = self.bottleneck.decode_tokens(tokens, generator=generator, noise=noise)
        return self.decode(latents if dtype is None else latents.to(dtype),
                           skip_bottleneck=True)

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
                     chunk_size: int = 128, chunk_batch: int = 8,
                     generator: Optional[torch.Generator] = None,
                     skip_bottleneck: bool = False) -> torch.Tensor:
        """latents [B, latent_dim, S] -> audio; `chunk_size` and `overlap` in
        latents; a noise-augmenting bottleneck draws from `generator`."""
        decode = lambda z: self.decode(z, skip_bottleneck=skip_bottleneck, generator=generator)
        if not chunked or latents.shape[2] <= chunk_size:
            return decode(latents)
        spl = self.downsampling_ratio
        total = latents.shape[2]
        starts = self._chunk_starts(total, chunk_size, chunk_size - overlap)
        chunks = self._run_chunks(decode, latents, starts, chunk_size, chunk_batch)
        return self._overlap_paste(chunks, [s * spl for s in starts], chunk_size * spl,
                                   total * spl, (overlap // 2) * spl)
