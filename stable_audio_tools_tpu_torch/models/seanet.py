"""SEANet encoder / decoder (EnCodec's); counterpart of
stable_audio_tools_tpu/models/seanet.py, with the encodec package's
semantics:

- `EncodecConv1d` (SConv1d): a weight-normalised conv after asymmetric
  padding `(pt - pt // 2, pt // 2 + extra)`, pt = k_eff - stride, `extra`
  aligning the input to whole output frames; causal mode pads left only;
  reflect padding falls back to zero-extending inputs shorter than the pad.
- `EncodecConvTranspose1d` (SConvTranspose1d): the full transposed conv, then
  `(pt - pt // 2, pt // 2)` trimmed (causal: the right trim by
  `trim_right_ratio`).
- `SEANetResnetBlock`: [ELU, conv k dil, ELU, conv 1] with a 1x1-conv
  shortcut unless `true_skip`.
- `SEANetLSTM`: a stacked `nn.LSTM` with an input skip. The JAX package runs
  one flax `OptimizedLSTMCell` per layer under `nn.RNN`; io/from_jax.py
  stacks its i / f / g / o kernels into torch's `weight_ih` / `weight_hh` in
  torch's gate order, the bias on the hidden side. The cells compute in
  their f32 parameters' dtype whatever the input's, and the skip promotes
  to it, as the flax cells promote a bf16 input: under a bf16
  `compute_dtype` each tower computes in bf16 up to its LSTM and in f32
  after it (the autoencoder trainer hands the decoder its latents in the
  compute dtype).

Layout: [B, C, T] (the JAX modules run NLC inside an autoencoder that takes
[B, C, T]). Each conv computes in its input's dtype. The strided and
transposed convs are `torch.nn.functional` (cuDNN on the card), as XLA runs
them for the JAX package; a stride-1 conv in bf16 is ops/conv.py's
`conv1d` (cuDNN's forward and input gradient, the hand-written weight
gradient `conv1d_wgrad`), as the JAX `_conv1d_s1` sends its weight gradient
to the Pallas kernel; in f32 (the frozen codec of the LM path, the layers
after an LSTM) it stays `torch.nn.functional`: `conv1d_wgrad` takes
bf16 only.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import WNConv1d, WNConvTranspose1d, conv1d


def pad1d(x: torch.Tensor, pl: int, pr: int, mode: str) -> torch.Tensor:
    """encodec pad1d over the last axis; reflect zero-extends inputs too short
    to reflect."""
    if mode == "reflect":
        T = x.shape[-1]
        extra = max(max(pl, pr) - T + 1, 0)
        if extra:
            x = F.pad(x, (0, extra))
        y = F.pad(x, (pl, pr), mode="reflect")
        return y[..., : y.shape[-1] - extra] if extra else y
    return F.pad(x, (pl, pr))


class EncodecConv1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, causal: bool = False,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal, self.pad_mode = causal, pad_mode
        self.conv = WNConv1d(in_channels, out_channels, kernel_size, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        pt = k_eff - self.stride
        T = x.shape[-1]
        n_frames = (T - k_eff + pt) / self.stride + 1
        ideal = (math.ceil(n_frames) - 1) * self.stride + (k_eff - pt)
        extra = max(ideal - T, 0)
        if self.causal:
            x = pad1d(x, pt, extra, self.pad_mode)
        else:
            x = pad1d(x, pt - pt // 2, pt // 2 + extra, self.pad_mode)
        bias = self.conv.bias.to(x.dtype) if self.conv.bias is not None else None
        if self.stride == 1 and x.dtype == torch.bfloat16:
            return conv1d(x, self.conv.weight(x.dtype), bias, dilation=self.dilation)
        return F.conv1d(x, self.conv.weight(x.dtype), bias, stride=self.stride,
                        dilation=self.dilation)


class EncodecConvTranspose1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False, trim_right_ratio: float = 1.0):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.causal, self.trim_right_ratio = causal, trim_right_ratio
        self.conv = WNConvTranspose1d(in_channels, out_channels, kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        pt = self.kernel_size - self.stride
        pr = math.ceil(pt * self.trim_right_ratio) if self.causal else pt // 2
        return y[..., pt - pr: y.shape[-1] - pr]


class SEANetResnetBlock(nn.Module):
    def __init__(self, dim: int, compress: int = 2, dilation: int = 1, kernel_size: int = 3,
                 true_skip: bool = False, causal: bool = False, pad_mode: str = "reflect"):
        super().__init__()
        hidden = dim // compress
        self.conv1 = EncodecConv1d(dim, hidden, kernel_size, dilation=dilation,
                                   causal=causal, pad_mode=pad_mode)
        self.conv2 = EncodecConv1d(hidden, dim, 1, causal=causal, pad_mode=pad_mode)
        self.shortcut = (None if true_skip else
                         EncodecConv1d(dim, dim, 1, causal=causal, pad_mode=pad_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.elu(self.conv1(F.elu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + y


class SEANetLSTM(nn.Module):
    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]; the LSTM runs over T from a zero state."""
        seq = x.permute(2, 0, 1).to(self.lstm.weight_ih_l0.dtype)  # [T, B, C]
        y, _ = self.lstm(seq)
        return (seq + y).permute(1, 2, 0)  # encodec skips around the LSTM


class SEANetEncoder(nn.Module):
    """Downsamples by the `ratios` in config order (the reference reverses
    them before the encodec package, which reverses them again)."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (2, 2, 2, 2, 2), n_residual_layers: int = 1,
                 dilation_base: int = 2, norm: str = "weight_norm", lstm: int = 2,
                 kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, causal: bool = False,
                 pad_mode: str = "reflect", true_skip: bool = False, compress: int = 2):
        super().__init__()
        if norm != "weight_norm":
            raise NotImplementedError(f"SEANet norm {norm!r}: only weight_norm is ported")
        common = dict(causal=causal, pad_mode=pad_mode)
        mult = 1
        self.conv_in = EncodecConv1d(channels, n_filters, kernel_size, **common)
        self.blocks = nn.ModuleList()
        for ratio in ratios:
            width = mult * n_filters
            self.blocks.append(nn.ModuleDict({
                "res": nn.ModuleList([SEANetResnetBlock(
                    width, compress=compress, dilation=dilation_base ** j,
                    kernel_size=residual_kernel_size, true_skip=true_skip, **common)
                    for j in range(n_residual_layers)]),
                "down": EncodecConv1d(width, 2 * width, 2 * ratio, stride=ratio, **common)}))
            mult *= 2
        self.lstm = SEANetLSTM(mult * n_filters, lstm) if lstm else None
        self.conv_out = EncodecConv1d(mult * n_filters, dimension, last_kernel_size, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            for res in block["res"]:
                x = res(x)
            x = block["down"](F.elu(x))
        if self.lstm is not None:
            x = self.lstm(x)
        return self.conv_out(F.elu(x))


class SEANetDecoder(nn.Module):
    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 dilation_base: int = 2, norm: str = "weight_norm", lstm: int = 2,
                 kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, causal: bool = False,
                 pad_mode: str = "reflect", true_skip: bool = False, compress: int = 2,
                 trim_right_ratio: float = 1.0, final_tanh: bool = False):
        super().__init__()
        if norm != "weight_norm":
            raise NotImplementedError(f"SEANet norm {norm!r}: only weight_norm is ported")
        common = dict(causal=causal, pad_mode=pad_mode)
        mult = 2 ** len(ratios)
        self.final_tanh = final_tanh
        self.conv_in = EncodecConv1d(dimension, mult * n_filters, kernel_size, **common)
        self.lstm = SEANetLSTM(mult * n_filters, lstm) if lstm else None
        self.blocks = nn.ModuleList()
        for ratio in ratios:
            width = mult * n_filters // 2
            self.blocks.append(nn.ModuleDict({
                "up": EncodecConvTranspose1d(2 * width, width, 2 * ratio, stride=ratio,
                                             causal=causal, trim_right_ratio=trim_right_ratio),
                "res": nn.ModuleList([SEANetResnetBlock(
                    width, compress=compress, dilation=dilation_base ** j,
                    kernel_size=residual_kernel_size, true_skip=true_skip, **common)
                    for j in range(n_residual_layers)])}))
            mult //= 2
        self.conv_out = EncodecConv1d(n_filters, channels, last_kernel_size, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        if self.lstm is not None:
            x = self.lstm(x)
        for block in self.blocks:
            x = block["up"](F.elu(x))
            for res in block["res"]:
                x = res(x)
        x = self.conv_out(F.elu(x))
        return torch.tanh(x) if self.final_tanh else x
