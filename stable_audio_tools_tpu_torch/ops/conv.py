"""Weight-normalised 1-D and 2-D convolutions; counterpart of
stable_audio_tools_tpu/ops/conv.py.

Layout: activations [B, C, T] (channels before time, torch's conv order) and
[B, C, H, W] for the 2-D convs; weights in torch's layouts ([Co, Ci, k],
transposed [Ci, Co, k], [Co, Ci, kh, kw]) with the reference's weight-norm
parameter names `weight_g` / `weight_v`: w = g * v / ||v||, the norm over all
dims but the first, with no epsilon (as `_wn_kernel` at JAX ops/conv.py:45).

`conv1d(..., pre_snake=(alpha, beta), residual=...)` sends every stride-1
conv with a preceding snake to the fused kernels (ops/kernels/conv1d_snake.py),
forward and backward, at any width. A stride-1 conv without a snake is
`Conv1dS1` (JAX `_conv1d_s1` :70): cuDNN's forward and input gradient, as
XLA runs them for the JAX package, and the hand-written weight-gradient
kernel (`conv1d_wgrad`, JAX `_bwd_dw_kernel_plain`). Strided, transposed and
2-D convs stay `torch.nn.functional` (cuDNN on the card) with autograd. The
TPU's s2d/d2s strided rewrites and its W-pair packing of the 2-D convs are
not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .kernels.conv1d_snake import conv1d_wgrad, snake_conv1d, snake_conv1d_res


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, norm over every dim but the first (torch weight_norm dim=0)."""
    norm = torch.sqrt(torch.sum(v.float() ** 2, dim=tuple(range(1, v.dim())), keepdim=True))
    return v * (g / norm)


class Conv1dS1(torch.autograd.Function):
    """Stride-1 conv1d of x [B, Ci, T] with w [Co, Ci, k] and zero padding
    `padding` on both sides: forward and input gradient by
    `torch.nn.functional` (cuDNN on the card; the input gradient only when x
    needs one), weight and bias gradients by `conv1d_wgrad`."""

    @staticmethod
    def forward(ctx, x, w, bias, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conv = (padding, dilation, None if bias is None else bias.dtype)
        return F.conv1d(x, w, bias, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        padding, dilation, bias_dtype = ctx.conv
        dx = dW = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(x.shape, w, dy, padding=padding, dilation=dilation)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dW, db = conv1d_wgrad(dy, x, w.shape[-1], padding, padding, dilation)
            dW = dW.to(w.dtype)
            db = None if bias_dtype is None else db.to(bias_dtype)
        return dx, dW, db, None, None


def conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           padding: int = 0, dilation: int = 1,
           pre_snake: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 conv1d of x [B, Ci, T] with w [Co, Ci, k] and symmetric zero
    padding; `pre_snake` applies snake(x; alpha, beta) first and `residual`
    [B, Co, T_out] is added to the output."""
    if pre_snake is not None:
        alpha, beta = pre_snake
        if residual is not None:
            return snake_conv1d_res(x, w, bias, alpha, beta, residual,
                                    padding, padding, dilation)
        return snake_conv1d(x, w, bias, alpha, beta, padding, padding, dilation)
    out = Conv1dS1.apply(x, w, bias, padding, dilation)
    return out if residual is None else out + residual


class WNConv1d(nn.Module):
    """Weight-normalised Conv1d, stride 1 (the decoder's convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.padding = padding
        self.dilation = dilation
        bound = 1.0 / math.sqrt(in_channels * kernel_size)
        v = torch.empty(out_channels, in_channels, kernel_size).uniform_(-bound, bound)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.sqrt(torch.sum(v ** 2, dim=(1, 2), keepdim=True)))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound)) if bias else None

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        return weight_norm(self.weight_v, self.weight_g).to(dtype)

    def forward(self, x: torch.Tensor,
                pre_snake: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        bias = self.bias
        if pre_snake is None and bias is not None:
            bias = bias.to(x.dtype)  # the fused kernel takes an f32 bias
        return conv1d(x, self.weight(x.dtype), bias, padding=self.padding,
                      dilation=self.dilation, pre_snake=pre_snake, residual=residual)


class WNConvTranspose1d(nn.Module):
    """Weight-normalised ConvTranspose1d (norm per *input* channel, as torch
    weight_norm on the [Ci, Co, k] weight)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        bound = 1.0 / math.sqrt(in_channels * kernel_size)
        v = torch.empty(in_channels, out_channels, kernel_size).uniform_(-bound, bound)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.sqrt(torch.sum(v ** 2, dim=(1, 2), keepdim=True)))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = weight_norm(self.weight_v, self.weight_g).to(x.dtype)
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv_transpose1d(x, w, bias, stride=self.stride, padding=self.padding)


class WNConv2d(nn.Module):
    """Weight-normalised Conv2d over [B, C, H, W] (the discriminators'; JAX
    ops/conv.py:619 `WNConv2d` without the W-pair packing); cuDNN with
    autograd, in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 dilation: Tuple[int, int] = (1, 1), bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = tuple(stride), tuple(padding), tuple(dilation)
        bound = 1.0 / math.sqrt(in_channels * kernel_size[0] * kernel_size[1])
        v = torch.empty(out_channels, in_channels, *kernel_size).uniform_(-bound, bound)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.sqrt(torch.sum(v ** 2, dim=(1, 2, 3), keepdim=True)))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = weight_norm(self.weight_v, self.weight_g).to(x.dtype)
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, w, bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation)
