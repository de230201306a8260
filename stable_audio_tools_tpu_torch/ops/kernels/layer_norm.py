"""Fused last-axis LayerNorm: the Hopper port of the TPU `fused_layer_norm`.

Replaces stable_audio_tools_tpu/ops/kernels/layer_norm.py `_ln_kernel` /
`_ln_kernel_beta` (reached from `fused_layer_norm` through `_ln_forward`):
y = (x - mean) * rsqrt(var + eps) * gamma (+ beta) with two-pass f32 row
statistics, cast back to x's dtype.

Route: Triton. This is a row normalisation, Triton's home ground: one
program per row, the whole row (C = 1536 in the DiT, padded to the next power
of two) in one block, f32 statistics in registers. Bound on the H100: bytes.
At the DiT shape ([2050, 1536] bf16) it moves ~12.6 MB (read x once, write y
once) against ~5 FLOP per element, far under the ~295 FLOP/byte ridge, so
the design's answer is a single pass: x is read once and y written once,
where an unfused PyTorch LayerNorm in f32 makes several passes and
materialises an f32 copy.

The Triton source is `layer_norm_triton.py`, imported inside the launching
function so this module imports on machines without `triton`. CPU tensors
take `fused_layer_norm_plain`.

On the card `fused_layer_norm` is a `torch.autograd.Function`: the forward is
the Triton kernel, the backward `fused_layer_norm_bwd_plain`, the analytic
gradient in plain PyTorch with the normalised input recomputed from x, as the
JAX package's `custom_vjp` (`_ln_backward` :101, `_ln_residuals` :93), whose
backward is plain XLA too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
    C = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"fused_layer_norm: unsupported dtype {x.dtype}")
    if C > 16384:
        raise ValueError(f"fused_layer_norm: row of {C} exceeds one block")
    import triton

    from .layer_norm_triton import ln_fwd

    x2 = x.contiguous().view(-1, C)
    g = gamma.contiguous().float()
    b = beta.contiguous().float() if beta is not None else g
    y = torch.empty_like(x2)
    block = triton.next_power_of_2(C)
    ln_fwd[(x2.shape[0],)](x2, g, b, y, C, eps, HAS_BETA=beta is not None,
                           BLOCK=block, num_warps=8 if block >= 2048 else 4)
    fused_layer_norm.launches += 1
    return y.view(x.shape)


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
    """LayerNorm over the last axis of x [..., C]; gamma/beta [C]."""
    if x.device.type == "cpu":
        return fused_layer_norm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    C = x.shape[-1]
    if gamma.shape != (C,) or (beta is not None and beta.shape != (C,)):
        raise ValueError(f"gamma/beta must be [{C}]")
    return _FusedLayerNorm.apply(x, gamma, beta, eps)


fused_layer_norm.launches = 0
