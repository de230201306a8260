"""Fused snake-beta activation and its backward: the Hopper port of the TPU
`snake_fused`.

Replaces stable_audio_tools_tpu/ops/kernels/snake.py `_fwd_kernel` (reached
from `snake_fused` through `_fwd`): y = x + sin^2(alpha x) / (beta + 1e-9)
with per-channel alpha, beta (post-exp values); and `_bwd_kernel` (through
`_bwd`): dx = g (1 + alpha binv sin(2 alpha x)) with binv = 1/(beta + 1e-9),
and dalpha = sum g x binv sin(2 alpha x), dbeta = -sum g sin^2(alpha x) binv^2
over batch and time. The TPU kernels evaluate sin^2 and its derivative with a
range-reduced polynomial (`_COS_POLY`, `_DCOS_POLY`) because the TPU has no
transcendental unit; this port uses exact `sin`/`cos` in f32 (Triton's
`tl.sin`, libdevice), the maths of the JAX package's CPU path
(ops/activations.py `_snake_fast_bwd` with `jnp.sin`).

Layout: x is [B, C, L], channels before time (the port's layout); the TPU
kernels took [B, L, C].

Route: Triton, both ways (snake_triton.py), imported inside the launching
functions so this module imports on machines without `triton`.
- Forward: one program per (row b*C + c, 4096-sample block), alpha and beta
  loaded once per program. Bound: bytes (~20 FLOP per 4 bytes at the
  Oobleck widths); it reads x once and writes y once, where the plain
  version makes several passes with f32 temporaries.
- Backward: the same grid; each program reads x and g once, writes dx and
  one f32 partial of dalpha and of dbeta; the wrapper sums the
  [B, C, n_blocks] partials (a tensor ~1/4096 of x's size), as the JAX
  package sums its kernel's partials after the call. Bound: bytes, 6 per
  element (x and g read, dx written, bf16).

`snake_fused` is a `torch.autograd.Function`: CUDA tensors launch the
forward kernel and, in the backward, `snake_fused_bwd`; CPU tensors take the
plain versions through the same Function, so the CPU tests reach its wiring.
"""

from __future__ import annotations

import torch

BLOCK = 4096


def snake_fused_plain(x: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, L]; alpha, beta [C]. f32 math, result in x's dtype."""
    xf = x.float()
    a = alpha.float()[:, None]
    binv = 1.0 / (beta.float()[:, None] + 1e-9)
    s = torch.sin(xf * a)
    return (xf + binv * (s * s)).to(x.dtype)


def snake_fused_bwd_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                          g: torch.Tensor):
    """(dx in x's dtype, dalpha f32 [C], dbeta f32 [C]) of snake_fused for the
    cotangent g [B, C, L]; f32 math."""
    xf, gf = x.float(), g.float()
    a = alpha.float()[:, None]
    binv = 1.0 / (beta.float()[:, None] + 1e-9)
    s, c = torch.sin(xf * a), torch.cos(xf * a)
    ds2 = 2.0 * s * c
    dx = gf * (1.0 + a * binv * ds2)
    dalpha = (gf * xf * binv * ds2).sum(dim=(0, 2))
    dbeta = (-gf * (s * s) * (binv * binv)).sum(dim=(0, 2))
    return dx.to(x.dtype), dalpha, dbeta


def _check(name: str, x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, L], got {tuple(x.shape)}")
    C = x.shape[1]
    if alpha.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"{name}: alpha/beta must be [{C}]")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")


def _forward(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return snake_fused_plain(x, alpha, beta)
    _check("snake_fused", x, alpha, beta)
    import triton

    from .snake_triton import snake_fwd

    B, C, L = x.shape
    x = x.contiguous()
    y = torch.empty_like(x)
    a = alpha.detach().contiguous().float()
    b = beta.detach().contiguous().float()
    snake_fwd[(B * C, triton.cdiv(L, BLOCK))](x, a, b, y, C, L, BLOCK=BLOCK, num_warps=8)
    snake_fused.launches += 1
    return y


def snake_fused_bwd(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                    g: torch.Tensor):
    """(dx, dalpha f32 [C], dbeta f32 [C]) for the cotangent g of
    snake_fused(x, alpha, beta); CUDA tensors launch the Triton backward."""
    if x.device.type == "cpu":
        return snake_fused_bwd_plain(x, alpha, beta, g)
    _check("snake_fused_bwd", x, alpha, beta)
    if g.shape != x.shape:
        raise ValueError(f"snake_fused_bwd: g {tuple(g.shape)} and x {tuple(x.shape)} differ")
    import triton

    from .snake_triton import snake_bwd

    B, C, L = x.shape
    nblk = triton.cdiv(L, BLOCK)
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    pa = torch.empty((B * C, nblk), device=x.device, dtype=torch.float32)
    pb = torch.empty_like(pa)
    snake_bwd[(B * C, nblk)](x, g, alpha.detach().contiguous().float(),
                             beta.detach().contiguous().float(), dx, pa, pb, C, L, nblk,
                             BLOCK=BLOCK, num_warps=8)
    snake_fused_bwd.launches += 1
    return dx, pa.view(B, C, nblk).sum(dim=(0, 2)), pb.view(B, C, nblk).sum(dim=(0, 2))


class _SnakeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        return _forward(x, alpha, beta)

    @staticmethod
    def backward(ctx, g):
        x, alpha, beta = ctx.saved_tensors
        dx, dalpha, dbeta = snake_fused_bwd(x, alpha, beta, g)
        return dx, dalpha.to(alpha.dtype), dbeta.to(beta.dtype)


def snake_fused(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """snake_beta over x [B, C, L] with per-channel alpha, beta [C],
    differentiable in all three."""
    return _SnakeFused.apply(x, alpha, beta)


snake_fused.launches = 0
snake_fused_bwd.launches = 0
