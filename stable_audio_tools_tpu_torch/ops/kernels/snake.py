"""Fused snake-beta activation and its backward: the Hopper port of the TPU
`snake_fused`.

Replaces stable_audio_tools_tpu/ops/kernels/snake.py `_fwd_kernel` (reached
from `snake_fused` through `_fwd`): y = x + sin^2(alpha x) / (beta + 1e-9)
with per-channel alpha, beta (post-exp values); and `_bwd_kernel` (through
`_bwd`): dx = g (1 + alpha binv sin(2 alpha x)) with binv = 1/(beta + 1e-9),
and dalpha = sum g x binv sin(2 alpha x), dbeta = -sum g sin^2(alpha x) binv^2
over batch and time. The TPU kernels evaluate sin^2 and its derivative with a
range-reduced polynomial (`_COS_POLY`, `_DCOS_POLY`) because the TPU has no
transcendental unit; this port uses exact f32 sines (CUDA's sinf / sincosf),
the maths of the JAX package's CPU path (ops/activations.py `_snake_fast_bwd`
with `jnp.sin`).

Layout: x is [B, C, L], channels before time (the port's layout); the TPU
kernels took [B, L, C].

Route: CUDA C++, `csrc/snake.cu` (its note gives the design and the bound:
bytes), one ctypes call a direction: `snake_fwd` (one launch) and
`snake_bwd` (a launch that writes dx and each row's partial sums into a
workspace, and a second that sums each channel's partials in a fixed order:
deterministic, no float atomics). Both walk the plan `snake_plan` gives:
tiles of rows by columns sized by the live elements of the call, 16-byte
vectors where the row length and the pointers allow.

`snake_fused` is a `torch.autograd.Function` where autograd needs one (grad
mode on and an input that requires a gradient): CUDA tensors launch the
forward kernel and, in the backward, `snake_fused_bwd`. Elsewhere (a decode,
a frozen encoder) it is the launch alone, no autograd node, as
`fused_layer_norm`. CPU tensors take the plain versions on both routes, so
the CPU tests reach the wiring.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

THREADS = 256      # a block of either kernel (csrc/snake.cu)
BLOCK_ELEMS = 16384  # the most elements a block takes
# blocks a call aims for before a block takes more than one vector a
# thread: four for each of an H100's 132 SMs, so small sites still spread
MIN_BLOCKS = 4 * 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# csrc/snake.cu `snake_fwd`: x, alpha, beta, y, rows, C, L, dtype, vec, tpr,
# col_steps, row_passes, ncb, stream
_FWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
# `snake_bwd`: x, g, alpha, beta, dx, ws, out, B, C, L, dtype, vec, tpr,
# col_steps, row_passes, ncb, stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)


class SnakePlan(NamedTuple):
    """How the kernels of csrc/snake.cu walk x [B, C, L]: a block of THREADS
    threads puts `tpr` threads along a row, so THREADS // tpr rows a pass;
    each thread takes `col_steps` vectors of `vec` elements along its row,
    `tpr * vec` apart, and the block makes `row_passes` passes. A block's
    tile is `rows` x `cols`; the grid is `ncb` column blocks for each of
    cdiv(B*C, rows) row blocks."""
    vec: int
    tpr: int
    col_steps: int
    row_passes: int
    rows: int
    cols: int
    ncb: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def snake_plan(B: int, C: int, L: int, itemsize: int, vector: bool = True) -> SnakePlan:
    """The plan for x [B, C, L] of `itemsize`-byte elements. `vector`: every
    pointer lies on 16 bytes; then rows whose length is a multiple of the
    16-byte vector are read by vectors, others one element a thread. A block
    takes up to BLOCK_ELEMS elements, fewer where the call has fewer than
    MIN_BLOCKS blocks' worth (never less than one vector a thread); a row
    of fewer vectors than THREADS takes a power of two of threads that
    covers it, and the block stacks rows."""
    vec = 16 // itemsize if vector and L % (16 // itemsize) == 0 else 1
    tpr = min(THREADS, 1 << (_cdiv(L, vec) - 1).bit_length())
    rows_pass, step = THREADS // tpr, tpr * vec
    share = B * C * L // MIN_BLOCKS
    target = max(THREADS * vec, min(BLOCK_ELEMS, 1 << max(share.bit_length() - 1, 0)))
    col_steps = max(1, min(_cdiv(L, step), target // step))
    cols = col_steps * step
    row_passes = max(1, target // (rows_pass * cols))
    rows = rows_pass * row_passes
    ncb = _cdiv(L, cols)
    return SnakePlan(vec, tpr, col_steps, row_passes, rows, cols, ncb,
                     _cdiv(B * C, rows) * ncb)


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
    """Raises unless x [B, C, L] and alpha, beta [C] lie on one CUDA card and
    x's dtype is one the kernels take (the calls are launch-sized at small
    sites, so the checks are the cheap ones)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, L], got {tuple(x.shape)}")
    C = x.shape[1]
    if alpha.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"{name}: alpha/beta must be [{C}]")
    card = x.get_device()
    if alpha.get_device() != card or beta.get_device() != card:
        raise ValueError(f"{name}: alpha/beta not on {x.device} with x")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")


def _stream(x: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _forward(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda and x.device.type == "cpu":
        return snake_fused_plain(x, alpha, beta)
    _check("snake_fused", x, alpha, beta)
    x = x.contiguous()
    y = torch.empty_like(x)
    if not y.numel():
        return y
    B, C, L = x.shape
    p = snake_plan(B, C, L, x.element_size(), x.data_ptr() % 16 == 0)
    a, b = alpha.float().contiguous(), beta.float().contiguous()
    code = _build.bind("snake", "snake_fwd", _FWD_ARGTYPES)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), B * C, C, L,
        _DTYPES[x.dtype], p.vec > 1, p.tpr, p.col_steps, p.row_passes, p.ncb, _stream(x))
    if code:
        _build.check(code, "snake_fused (snake_fwd)")
    snake_fused.launches += 1
    return y


def snake_fused_bwd(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                    g: torch.Tensor):
    """(dx, dalpha f32 [C], dbeta f32 [C]) for the cotangent g of
    snake_fused(x, alpha, beta); CUDA tensors launch csrc/snake.cu's
    backward (one host call, two launches)."""
    if not x.is_cuda and x.device.type == "cpu":
        return snake_fused_bwd_plain(x, alpha, beta, g)
    _check("snake_fused_bwd", x, alpha, beta)
    if g.shape != x.shape or g.dtype != x.dtype or g.get_device() != x.get_device():
        raise ValueError(f"snake_fused_bwd: g {tuple(g.shape)} {g.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} differ")
    x, g = x.contiguous(), g.contiguous()
    B, C, L = x.shape
    dx = torch.empty_like(x)
    out = x.new_empty((2, C), dtype=torch.float32)
    if not x.numel():
        return (dx, *out.zero_().unbind(0))
    p = snake_plan(B, C, L, x.element_size(), (x.data_ptr() | g.data_ptr()) % 16 == 0)
    ws = x.new_empty(2 * B * C * p.ncb, dtype=torch.float32)
    a, b = alpha.float().contiguous(), beta.float().contiguous()
    code = _build.bind("snake", "snake_bwd", _BWD_ARGTYPES)(
        x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(), dx.data_ptr(), ws.data_ptr(),
        out.data_ptr(), B, C, L, _DTYPES[x.dtype], p.vec > 1, p.tpr, p.col_steps,
        p.row_passes, p.ncb, _stream(x))
    if code:
        _build.check(code, "snake_fused_bwd (snake_bwd)")
    snake_fused_bwd.launches += 1
    dalpha, dbeta = out.unbind(0)
    return dx, dalpha, dbeta


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
    differentiable in all three (an autograd node only where one is needed)."""
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad
                                    or beta.requires_grad):
        return _SnakeFused.apply(x, alpha, beta)
    return _forward(x, alpha, beta)


snake_fused.launches = 0
snake_fused_bwd.launches = 0
