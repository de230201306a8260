"""Fused snake -> conv1d: the Hopper port of the TPU `snake_conv1d` and
`snake_conv1d_res`.

    snake_conv1d(x, w, b, alpha, beta, pad_lo, pad_hi, d)
        = conv1d(snake(x; alpha, beta), w, stride 1, dilation d) + b
    snake_conv1d_res(..., residual) = the same + residual

x is [B, Ci, L] and w is [Co, Ci, k] (torch conv layouts, the port's decoder
layout); alpha, beta are the post-exp per-channel values. Padding rows
contribute an exact 0 (the snake is applied before padding).

- CUDA bf16 tensors launch `csrc/snake_conv1d.cu` (its source note says what
  it replaces, what bounds it and how it is tiled). It covers every width on
  the Oobleck decoder's path (Ci = Co = 128..1024, and Co = 2 for conv_out);
  none of the TPU's 128-lane or 4 MB weight gates apply.
- CPU tensors take `snake_conv1d_plain`: the snake in f32, rounded to x's
  dtype, then `torch.nn.functional.conv1d` (f32 accumulation).

The kernel has no backward yet (the TPU `_bwd_dx_kernel` / `_bwd_dw_kernel_*`
are the AE-training slice's): a CUDA input that requires grad raises.
SA-Open's frozen encoder runs it under `torch.no_grad()`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

MAX_SPAN = 192  # (k - 1) * d the kernel's shared-memory window admits


def _snake_f32(x, alpha, beta):
    xf = x.float()
    s = torch.sin(xf * alpha.float()[:, None])
    return xf + s * s / (beta.float()[:, None] + 1e-9)


def snake_conv1d_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                       alpha: torch.Tensor, beta: torch.Tensor, pad_lo: int,
                       pad_hi: int, dilation: int,
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    sx = _snake_f32(x, alpha, beta).to(x.dtype)
    sx = F.pad(sx, (pad_lo, pad_hi))
    out = F.conv1d(sx, w.to(x.dtype), dilation=dilation).float()
    if bias is not None:
        out = out + bias.float()[:, None]
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _launch(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation, residual):
    if x.device.type != "cuda":
        raise ValueError(f"snake_conv1d: unsupported device {x.device}")
    _build.require_no_grad("snake_conv1d", x, w, bias, alpha, beta, residual)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be [B, Ci, L] and w [Co, Ci, k]: {x.shape} {w.shape}")
    B, Ci, L = x.shape
    Co, Ci_w, k = w.shape
    if Ci_w != Ci:
        raise ValueError(f"weight takes {Ci_w} input channels, x has {Ci}")
    if (k - 1) * dilation > MAX_SPAN:
        raise ValueError(f"(k-1)*d = {(k - 1) * dilation} exceeds {MAX_SPAN}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"snake_conv1d: x {x.dtype}, w {w.dtype}; kernel takes bfloat16")
    if alpha.shape != (Ci,) or beta.shape != (Ci,):
        raise ValueError(f"alpha/beta must be [{Ci}]")
    Lout = L + pad_lo + pad_hi - (k - 1) * dilation
    if Lout <= 0:
        raise ValueError(f"empty output (L={L}, k={k}, d={dilation})")
    if bias is not None and bias.shape != (Co,):
        raise ValueError(f"bias must be [{Co}]")
    if residual is not None:
        if residual.shape != (B, Co, Lout) or residual.dtype != torch.bfloat16:
            raise ValueError(f"residual must be bf16 [{B}, {Co}, {Lout}], got "
                             f"{residual.dtype} {tuple(residual.shape)}")
        residual = residual.contiguous()
    x = x.contiguous()
    w_kio = w.permute(2, 1, 0).contiguous()  # [k, Ci, Co]
    a = alpha.contiguous().float()
    b = beta.contiguous().float()
    bias_f = bias.contiguous().float() if bias is not None else None
    y = torch.empty((B, Co, Lout), device=x.device, dtype=x.dtype)
    fn = _build.bind("snake_conv1d", "snake_conv1d_fwd",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    code = fn(x.data_ptr(), w_kio.data_ptr(), a.data_ptr(), b.data_ptr(),
              bias_f.data_ptr() if bias_f is not None else None,
              residual.data_ptr() if residual is not None else None,
              y.data_ptr(), B, Ci, Co, L, Lout, k, dilation, pad_lo,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "snake_conv1d_fwd")
    return y


def snake_conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                 alpha: torch.Tensor, beta: torch.Tensor, pad_lo: int, pad_hi: int,
                 dilation: int) -> torch.Tensor:
    """conv1d(snake(x), w) + bias; x [B, Ci, L], w [Co, Ci, k] -> [B, Co, Lout]."""
    if x.device.type == "cpu":
        return snake_conv1d_plain(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation)
    y = _launch(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation, None)
    snake_conv1d.launches += 1
    return y


def snake_conv1d_res(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                     alpha: torch.Tensor, beta: torch.Tensor, residual: torch.Tensor,
                     pad_lo: int, pad_hi: int, dilation: int) -> torch.Tensor:
    """snake_conv1d with the residual [B, Co, Lout] added in the epilogue."""
    if x.device.type == "cpu":
        return snake_conv1d_plain(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation,
                                  residual)
    y = _launch(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation, residual)
    snake_conv1d_res.launches += 1
    return y


snake_conv1d.launches = 0
snake_conv1d_res.launches = 0
