"""Fused snake-beta activation: the Hopper port of the TPU `snake_fused`.

Replaces stable_audio_tools_tpu/ops/kernels/snake.py `_fwd_kernel` (reached
from `snake_fused` through `_fwd`): y = x + sin^2(alpha x) / (beta + 1e-9)
with per-channel alpha, beta (post-exp values). The TPU kernel evaluates
sin^2 with a range-reduced polynomial (`_COS_POLY`) because the TPU has no
transcendental unit; this port uses exact `sin` in f32 (Triton's `tl.sin`,
libdevice `sinf`), the math of the JAX package's CPU path.

Layout: x is [B, C, L], channels before time (the port's decoder layout, the
public [B, C, T] audio layout); the TPU kernel took [B, L, C].

Route: Triton. It is a one-pass elementwise op with a per-channel scalar:
one program per (row b*C + c, 4096-sample block), alpha and beta loaded once
per program. Bound on the H100: bytes. At the decoder's shapes (up to
[1, 128, 1048576] bf16, 256 MB in and out) it does ~20 FLOP per 4 bytes, far
under the ridge; the design reads x once and writes y once, where the plain
PyTorch version makes several passes with f32 temporaries.

The Triton source is `snake_triton.py`, imported inside the launching function
so this module imports on machines without `triton`. CPU tensors take
`snake_fused_plain`.

The kernel has no backward yet (the TPU `_bwd_kernel` is the AE-training
slice's): a CUDA input that requires grad raises rather than return an output
that autograd cannot differentiate. SA-Open's frozen encoder runs it under
`torch.no_grad()`.
"""

from __future__ import annotations

import torch

from . import _build

BLOCK = 4096


def snake_fused_plain(x: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, L]; alpha, beta [C]. f32 math, result in x's dtype."""
    xf = x.float()
    a = alpha.float()[:, None]
    binv = 1.0 / (beta.float()[:, None] + 1e-9)
    s = torch.sin(xf * a)
    return (xf + binv * (s * s)).to(x.dtype)


def snake_fused(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """snake_beta over x [B, C, L] with per-channel alpha, beta [C]."""
    if x.device.type == "cpu":
        return snake_fused_plain(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"snake_fused: unsupported device {x.device}")
    _build.require_no_grad("snake_fused", x, alpha, beta)
    if x.dim() != 3:
        raise ValueError(f"snake_fused: x must be [B, C, L], got {tuple(x.shape)}")
    B, C, L = x.shape
    if alpha.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"alpha/beta must be [{C}]")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"snake_fused: unsupported dtype {x.dtype}")
    import triton

    from .snake_triton import snake_fwd

    x = x.contiguous()
    y = torch.empty_like(x)
    a = alpha.contiguous().float()
    b = beta.contiguous().float()
    snake_fwd[(B * C, triton.cdiv(L, BLOCK))](x, a, b, y, C, L, BLOCK=BLOCK,
                                             num_warps=8)
    snake_fused.launches += 1
    return y


snake_fused.launches = 0
