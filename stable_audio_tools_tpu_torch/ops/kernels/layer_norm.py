"""Fused last-axis LayerNorm: the Hopper port of the TPU `fused_layer_norm`.

Replaces stable_audio_tools_tpu/ops/kernels/layer_norm.py `_ln_kernel` /
`_ln_kernel_beta` (reached from `fused_layer_norm` through `_ln_forward`):
y = (x - mean) * rsqrt(var + eps) * gamma (+ beta) with two-pass f32 row
statistics, cast back to x's dtype.

Route: CUDA C++, `csrc/layer_norm.cu` (its note gives the design and the
bound: bytes, 3.8 us at the DiT's [2050, 1536] bf16). A call is launch-sized
(thousands per generation request), so the host side is one ctypes call of
a function bound once: no autograd node when autograd cannot need one (grad
mode off, or no input that requires a gradient), no cast of a bf16 gamma,
no copy of a contiguous x. CPU tensors take `fused_layer_norm_plain`.

Where autograd needs it, `fused_layer_norm` is a `torch.autograd.Function`:
the forward is the kernel, the backward `fused_layer_norm_bwd_plain`, the
analytic gradient in plain PyTorch with the normalised input recomputed from
x, as the JAX package's `custom_vjp` (`_ln_backward` :101, `_ln_residuals`
:93), whose backward is plain XLA too.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_C = 16384  # the longest row taken (the Triton kernel's limit before it)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# csrc/layer_norm.cu `layer_norm_fwd`: x, gamma, beta, y, rows, C, the three
# dtype codes, eps, stream
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p)


def fused_layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                           beta: Optional[torch.Tensor] = None,
                           eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


def fused_layer_norm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                               eps: float = 1e-5
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic LayerNorm gradient in f32 from x (the residuals recomputed):
    returns (dx in x's dtype, dgamma f32 [C], dbeta f32 [C])."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gf = dy.float()
    dxhat = gf * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    rows = tuple(range(x.dim() - 1))
    return dx, (gf * xhat).sum(dim=rows), gf.sum(dim=rows)


def _launch(x, gamma, beta, eps):
    """One launch of `csrc/layer_norm.cu` on CUDA tensors (shapes and
    devices checked by the caller): y in x's shape and dtype."""
    codes = (_DTYPES.get(x.dtype), _DTYPES.get(gamma.dtype),
             -1 if beta is None else _DTYPES.get(beta.dtype))
    if None in codes:
        raise TypeError(f"fused_layer_norm: dtypes {x.dtype}, {gamma.dtype}, "
                        f"{None if beta is None else beta.dtype}; the kernel takes "
                        f"{tuple(_DTYPES)}")
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty_like(x)
    C = x.shape[-1]
    if y.numel():
        code = _build.bind("layer_norm", "layer_norm_fwd", _ARGTYPES)(
            x.data_ptr(), gamma.data_ptr(), None if beta is None else beta.data_ptr(),
            y.data_ptr(), x.numel() // C, C, *codes, eps,
            torch._C._cuda_getCurrentRawStream(x.get_device()))
        if code:
            _build.check(code, "fused_layer_norm (layer_norm_fwd)")
        fused_layer_norm.launches += 1
    return y


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps, ctx.has_beta = eps, beta is not None
        ctx.dtypes = (gamma.dtype, beta.dtype if beta is not None else None)
        return _launch(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = fused_layer_norm_bwd_plain(x, gamma, dy, ctx.eps)
        return (dx, dgamma.to(ctx.dtypes[0]),
                dbeta.to(ctx.dtypes[1]) if ctx.has_beta else None, None)


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x [..., C]; gamma/beta [C]. On CUDA:
    x in f32, bf16 or f16, gamma and beta in any of those, C <= MAX_C."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fused_layer_norm_plain(x, gamma, beta, eps)
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    C = x.shape[-1]
    if gamma.shape != (C,) or (beta is not None and beta.shape != (C,)):
        raise ValueError(f"gamma/beta must be [{C}]")
    card = x.get_device()
    if gamma.get_device() != card or (beta is not None and beta.get_device() != card):
        raise ValueError(f"fused_layer_norm: gamma/beta not on {x.device} with x")
    if C > MAX_C:
        raise ValueError(f"fused_layer_norm: row of {C} exceeds {MAX_C}")
    gamma = gamma.contiguous()
    beta = None if beta is None else beta.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or (beta is not None and beta.requires_grad)):
        return _FusedLayerNorm.apply(x, gamma, beta, eps)
    return _launch(x, gamma, beta, eps)


fused_layer_norm.launches = 0
