"""Fused snake -> conv1d and its gradients: the Hopper port of the TPU
`snake_conv1d`, `snake_conv1d_res` and `conv1d_wgrad`.

    snake_conv1d(x, w, b, alpha, beta, pad_lo, pad_hi, d)
        = conv1d(snake(x; alpha, beta), w, stride 1, dilation d) + b
    snake_conv1d_res(..., residual) = the same + residual

x is [B, Ci, L] and w is [Co, Ci, k] (torch conv layouts, the port's
layout); alpha, beta are the post-exp per-channel values. Padding rows
contribute an exact 0 (the snake is applied before padding).

Both are `torch.autograd.Function`s (JAX `_snake_conv1d_bwd` :508,
`_snake_conv1d_res_bwd` :595). They save x, w, alpha and beta and recompute
the snake in the backward, which launches two kernels:
- `snake_conv1d_dx` (`csrc/snake_conv1d_dx.cu`, replaces `_bwd_dx_kernel`):
  dx and the dalpha/dbeta partials, on the forward's body (dy's window, no
  snake, the taps read flipped, the snake's derivative in the epilogue);
- `snake_conv1d_wgrad` (`csrc/conv1d_wgrad.cu` with the snake, replaces
  `_bwd_dw_kernel_snake`): dW and db in f32, `wgmma` products whose
  reduction is time over the forward's snake'd windows, planned by
  `wgrad_tile` and `wgrad_splits`.
The residual's gradient is dy itself. `conv1d_wgrad` (the same source
without the snake, replaces `_bwd_dw_kernel_plain`) is the weight gradient
of the plain stride-1 convs (ops/conv.py `Conv1dS1`).

The forward has two kernels in `csrc/snake_conv1d.cu`: `snake_conv1d` launches
`snake_conv1d_carry_kernel` (replaces `_fwd_kernel_carry`, the JAX package's
SAT_SNAKE_CARRY route, which keeps the previous x block in a scratch carry;
here a block walks a strip of output tiles and carries the snake'd halo in
shared memory), and `snake_conv1d_res` launches `snake_conv1d_kernel`
(replaces `_fwd_kernel` and `_fwd_kernel_res`). The JAX package's default
`snake_conv1d` runs `_fwd_kernel`; the port runs the carry for it on the
card, since the two kernels' outputs are equal bit for bit and the carry
loads and snakes no halo twice (PERF.md has both kernels' times). Both share
one body (`csrc/snake_conv.cuh`): `wgmma` products over a snake'd window that
producer warps build from x, the output tile chosen here by `tile_n` /
`block_tile`, the input channels in chunks of CI_CHUNK.

CUDA bf16 tensors launch the kernels (each source's note says what it
replaces, what bounds it and how it is tiled); they take every width on the
Oobleck path (Ci, Co = 2..2048), none of the TPU's 128-lane, VMEM or
big-channel gates apply. CPU tensors take the plain versions, through the same
autograd Functions: the snake in f32 rounded to x's dtype, then
`torch.nn.functional.conv1d` or f32 products.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_SPAN = 192  # (k - 1) * d the kernels' shared-memory window admits
CI_CHUNK = 64  # channels the kernels' producer warps lay into a window at a time


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


def snake_conv1d_dx_plain(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          alpha: torch.Tensor, beta: torch.Tensor, pad_lo: int, pad_hi: int,
                          d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dalpha f32 [Ci], dbeta f32 [Ci]) of snake_conv1d for
    dy [B, Co, Lout]: the conv of dy with the flipped, transposed weights
    (f32), then the snake's derivative in f32."""
    span = (w.shape[-1] - 1) * d
    # pads of (k-1)*d - pad on each side give length L; a negative pad crops
    dyp = F.pad(dy.float(), (span - pad_lo, span - pad_hi))
    ds = F.conv1d(dyp, w.float().flip(-1).transpose(0, 1), dilation=d)
    xf = x.float()
    a = alpha.float()[:, None]
    binv = 1.0 / (beta.float()[:, None] + 1e-9)
    s, c = torch.sin(xf * a), torch.cos(xf * a)
    ds2 = 2.0 * s * c
    dx = ds * (1.0 + a * binv * ds2)
    dalpha = (ds * xf * binv * ds2).sum(dim=(0, 2))
    dbeta = (-ds * (s * s) * (binv * binv)).sum(dim=(0, 2))
    return dx.to(x.dtype), dalpha, dbeta


def conv1d_wgrad_plain(dy: torch.Tensor, x: torch.Tensor, k: int, pad_lo: int, pad_hi: int,
                       d: int, pre_snake: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW f32 [Co, Ci, k], db f32 [Co]) of a stride-1 conv1d of x [B, Ci, L]
    (after snake(x) rounded to x's dtype, with `pre_snake`) for dy
    [B, Co, Lout]: one f32 product over batch and time per tap."""
    sx = x if pre_snake is None else _snake_f32(x, *pre_snake).to(x.dtype)
    sxp = F.pad(sx, (pad_lo, pad_hi)).float()
    dyf = dy.float()
    Lout = dy.shape[-1]
    dW = torch.stack([torch.einsum("bot,bit->oi", dyf, sxp[..., j * d:j * d + Lout])
                      for j in range(k)], dim=-1)
    return dW, dyf.sum(dim=(0, 2))


def _require_bf16(name: str, *tensors) -> None:
    for t in tensors:
        if t is not None and (t.device.type != "cuda" or t.dtype != torch.bfloat16):
            raise TypeError(f"{name}: the kernel takes bfloat16 CUDA tensors, got "
                            f"{t.dtype} on {t.device}")


def tile_n(Co: int) -> Tuple[int, bool]:
    """(N, split) of the forward kernels' output tile for Co channels: N
    channels a consumer warpgroup (8, 64 or 128, the least that covers Co
    up to 128), and whether the block's two warpgroups sit side by side in
    channels (Co > 128: 128 rows x 256 channels a block) or one above the
    other in time (256 rows x N channels)."""
    for n in (8, 64, 128):
        if Co <= n:
            return n, False
    return 128, True


def block_tile(Co: int) -> Tuple[int, int]:
    """(time rows, output channels) of one block's output tile for Co."""
    n, split = tile_n(Co)
    return (128, 2 * n) if split else (256, n)


def _launch(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation, residual):
    """Row 12 without the residual, row 3 with it."""
    if x.device.type != "cuda":
        raise ValueError(f"snake_conv1d: unsupported device {x.device}")
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
        if residual.data_ptr() % 16:  # the epilogue reads it 16 bytes at a time
            residual = residual.clone()
    x = x.contiguous()
    # [k, Co, Ci_pad]: each tap's weights K-major for the products, input
    # channels zero-padded to whole chunks
    w_kio = F.pad(w.permute(2, 0, 1), (0, -Ci % CI_CHUNK)).contiguous()
    a = alpha.detach().contiguous().float()
    b = beta.detach().contiguous().float()
    bias_f = bias.detach().contiguous().float() if bias is not None else None
    y = torch.empty((B, Co, Lout), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias_ptr = bias_f.data_ptr() if bias_f is not None else None
    nt, split = tile_n(Co)
    if residual is None:
        fn = _build.bind("snake_conv1d", "snake_conv1d_carry_fwd",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        code = fn(x.data_ptr(), w_kio.data_ptr(), a.data_ptr(), b.data_ptr(), bias_ptr,
                  y.data_ptr(), B, Ci, Co, L, Lout, k, dilation, pad_lo, nt, int(split),
                  stream)
        _build.check(code, "snake_conv1d_carry_fwd")
        return y
    fn = _build.bind("snake_conv1d", "snake_conv1d_fwd",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    code = fn(x.data_ptr(), w_kio.data_ptr(), a.data_ptr(), b.data_ptr(), bias_ptr,
              residual.data_ptr(), y.data_ptr(), B, Ci, Co, L, Lout, k, dilation, pad_lo,
              nt, int(split), stream)
    _build.check(code, "snake_conv1d_fwd")
    return y


def carry_strip_tiles(B: int, Ci: int, Co: int, Lout: int, k: int, d: int) -> Tuple[int, bool]:
    """(S, carry) of row 12 for this shape on the current card: the strip of
    output tiles one block walks (`block_tile(Co)` rows each), and whether
    the strip carries the snake'd halo from tile to tile (it does where S > 1
    and the carry fits in shared memory beside the weight ring)."""
    out = (ctypes.c_int * 4)()
    nt, split = tile_n(Co)
    fn = _build.bind("snake_conv1d", "snake_conv1d_carry_strip",
                     [ctypes.c_int] * 8 + [ctypes.c_void_p])
    _build.check(fn(B, Ci, Co, Lout, k, d, nt, int(split), out), "snake_conv1d_carry_strip")
    return out[0], bool(out[1])


def dx_tile(Ci: int) -> Tuple[int, bool]:
    """(N, split) of the dx kernel's output tile over Ci input channels:
    the forward's `tile_n` up to 64 channels, else two 64-channel
    warpgroups side by side (128 rows x 128 channels a block), so that 64
    accumulator registers a thread leave the epilogue's snake derivative
    room."""
    return tile_n(Ci) if Ci <= 64 else (64, True)


def dx_blocks(Ci: int, L: int) -> int:
    """Rows of `snake_conv1d_dx`'s dalpha/dbeta partials per batch row: one
    per 128 output rows of the tiles `dx_tile(Ci)` lays over L."""
    bm = 128 if dx_tile(Ci)[1] else 256
    return -(-L // bm) * bm // 128


def snake_conv1d_dx(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor, pad_lo: int, pad_hi: int, d: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dalpha f32 [Ci], dbeta f32 [Ci]) of snake_conv1d for dy
    [B, Co, Lout]; CUDA tensors launch `csrc/snake_conv1d_dx.cu`."""
    if x.device.type == "cpu":
        return snake_conv1d_dx_plain(dy, x, w, alpha, beta, pad_lo, pad_hi, d)
    _require_bf16("snake_conv1d_dx", dy, x, w)
    B, Ci, L = x.shape
    Co, _, k = w.shape
    Lout = L + pad_lo + pad_hi - (k - 1) * d
    if dy.shape != (B, Co, Lout):
        raise ValueError(f"snake_conv1d_dx: dy must be [{B}, {Co}, {Lout}], got {tuple(dy.shape)}")
    if (k - 1) * d > MAX_SPAN:
        raise ValueError(f"(k-1)*d = {(k - 1) * d} exceeds {MAX_SPAN}")
    dy, x = dy.contiguous(), x.contiguous()
    # [k, Ci, Co_pad]: each tap's weights K-major over the output channels
    # (the reduction), zero-padded to whole chunks; the kernel reads the taps
    # in reverse, so the flip costs no copy
    wp = F.pad(w.detach().permute(2, 1, 0), (0, -Co % CI_CHUNK)).contiguous()
    nt, split = dx_tile(Ci)
    nblk = dx_blocks(Ci, L)
    dx = torch.empty_like(x)
    pa = torch.empty((B, nblk, Ci), device=x.device, dtype=torch.float32)
    pb = torch.empty_like(pa)
    a, b = (p.detach().contiguous().float() for p in (alpha, beta))
    fn = _build.bind("snake_conv1d_dx", "snake_conv1d_dx",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    code = fn(dy.data_ptr(), wp.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
              dx.data_ptr(), pa.data_ptr(), pb.data_ptr(), B, Co, Ci, Lout, L, k, d, pad_lo,
              nt, int(split), nblk, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "snake_conv1d_dx")
    snake_conv1d_dx.launches += 1
    return dx, pa.sum(dim=(0, 1)), pb.sum(dim=(0, 1))


def wgrad_tile(Co: int, k: int) -> Tuple[int, bool, int]:
    """(mt, split_taps, T) of the weight-gradient kernel for Co output
    channels and k taps: a block's two consumer warpgroups either split the
    taps of one 64-channel co tile (more than 4 taps in a group of 8, or
    Co <= 64) or each take all its taps over mt 64-row co tiles of their own
    (mt = 2 where a group has at most 2 taps and Co > 128, else 1): at most 4
    (taps x 64-row tiles) of 64 x 64 f32 accumulators a warpgroup. T is the
    time samples of a chunk of the reduction (one window, one dy stage): 256
    where two dy stages and the windows fit beside each other at any span
    (64-channel co tiles, or 128 channels at k = 1), else 128."""
    kg = min(k, 8)
    split = kg > 4 or Co <= 64
    mt = 2 if not split and kg <= 2 and Co > 128 else 1
    return mt, split, 256 if split or (mt == 1 and k == 1) else 128


def wgrad_co_block(Co: int, k: int) -> int:
    """Output channels a block of the weight-gradient kernel covers."""
    mt, split, _ = wgrad_tile(Co, k)
    return 64 if split else 128 * mt


def wgrad_splits(B: int, Ci: int, Co: int, Lout: int, k: int, sms: int) -> int:
    """S, the ways the weight gradient's reduction over the B * ceil(Lout /
    T) (batch row, chunk) sequence is split: enough blocks (co tiles x
    tap groups of 8 x chunks of CI_CHUNK input channels, times S) to give
    each of `sms` SMs one, each split an equal run of the sequence."""
    blocks = -(-Co // wgrad_co_block(Co, k)) * -(-k // 8) * -(-Ci // CI_CHUNK)
    total = B * -(-Lout // wgrad_tile(Co, k)[2])
    S = min(-(-sms // blocks), total)
    per = -(-total // S)
    return -(-total // per)


def _wgrad(name, dy, x, k, pad_lo, pad_hi, d, pre_snake):
    _require_bf16(name, dy, x)
    B, Ci, L = x.shape
    Co = dy.shape[1]
    Lout = L + pad_lo + pad_hi - (k - 1) * d
    if dy.dim() != 3 or dy.shape != (B, Co, Lout):
        raise ValueError(f"{name}: dy must be [{B}, Co, {Lout}], got {tuple(dy.shape)}")
    if (k - 1) * d > MAX_SPAN:
        raise ValueError(f"(k-1)*d = {(k - 1) * d} exceeds {MAX_SPAN}")
    dy, x = dy.contiguous(), x.contiguous()
    # the kernel reads dy by TMA: rows on 16 bytes (zero samples past Lout)
    ld = -(-Lout // 8) * 8
    if ld != Lout:
        dy = F.pad(dy, (0, ld - Lout))
    elif dy.data_ptr() % 16:
        dy = dy.clone()
    dev = x.device
    mt, split, T = wgrad_tile(Co, k)
    S = wgrad_splits(B, Ci, Co, Lout, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = torch.empty((S, k, Co, Ci), device=dev, dtype=torch.float32)
    dbws = torch.empty((S, Co), device=dev, dtype=torch.float32)
    dW = torch.empty((Co, Ci, k), device=dev, dtype=torch.float32)
    db = torch.empty((Co,), device=dev, dtype=torch.float32)
    if pre_snake is not None:
        a, b = (p.detach().contiguous().float() for p in pre_snake)
        if a.shape != (Ci,) or b.shape != (Ci,):
            raise ValueError(f"{name}: alpha/beta must be [{Ci}]")
        ptrs = (a.data_ptr(), b.data_ptr())
    else:
        ptrs = (None, None)
    fn = _build.bind("conv1d_wgrad", "conv1d_wgrad",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    code = fn(dy.data_ptr(), x.data_ptr(), *ptrs, ws.data_ptr(), dbws.data_ptr(),
              dW.data_ptr(), db.data_ptr(), B, Co, Ci, L, Lout, ld, k, d, pad_lo, S, mt,
              int(split), T, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, name)
    return dW, db


def snake_conv1d_wgrad(dy: torch.Tensor, x: torch.Tensor, k: int, alpha: torch.Tensor,
                       beta: torch.Tensor, pad_lo: int, pad_hi: int, d: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW f32 [Co, Ci, k], db f32 [Co]) of snake_conv1d for dy; CUDA tensors
    launch `csrc/conv1d_wgrad.cu` with the snake recomputed in its loads."""
    if x.device.type == "cpu":
        return conv1d_wgrad_plain(dy, x, k, pad_lo, pad_hi, d, (alpha, beta))
    out = _wgrad("snake_conv1d_wgrad", dy, x, k, pad_lo, pad_hi, d, (alpha, beta))
    snake_conv1d_wgrad.launches += 1
    return out


def conv1d_wgrad(dy: torch.Tensor, x: torch.Tensor, k: int, pad_lo: int, pad_hi: int,
                 d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW f32 [Co, Ci, k], db f32 [Co]) of a plain stride-1 conv1d of x for
    dy; CUDA tensors launch `csrc/conv1d_wgrad.cu` without the snake."""
    if x.device.type == "cpu":
        return conv1d_wgrad_plain(dy, x, k, pad_lo, pad_hi, d)
    out = _wgrad("conv1d_wgrad", dy, x, k, pad_lo, pad_hi, d, None)
    conv1d_wgrad.launches += 1
    return out


class _SnakeConv1d(torch.autograd.Function):
    """conv1d(snake(x), w) + bias (+ residual), forward and backward by the
    kernels on CUDA and by the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w, bias, alpha, beta, residual, pad_lo, pad_hi, dilation):
        ctx.save_for_backward(x, w, alpha, beta)
        ctx.conv = (pad_lo, pad_hi, dilation)
        ctx.dtypes = (None if bias is None else bias.dtype,
                      None if residual is None else residual.dtype)
        if x.device.type == "cpu":
            return snake_conv1d_plain(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation,
                                      residual)
        y = _launch(x, w, bias, alpha, beta, pad_lo, pad_hi, dilation, residual)
        (snake_conv1d if residual is None else snake_conv1d_res).launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, alpha, beta = ctx.saved_tensors
        pad_lo, pad_hi, d = ctx.conv
        bias_dtype, res_dtype = ctx.dtypes
        need = ctx.needs_input_grad
        dy = dy.contiguous()
        a, b = (p.detach().contiguous().float() for p in (alpha, beta))  # once for both
        dx = dalpha = dbeta = dW = db = None
        if need[0] or need[3] or need[4]:
            dx, dalpha, dbeta = snake_conv1d_dx(dy, x, w, a, b, pad_lo, pad_hi, d)
            dalpha, dbeta = dalpha.to(alpha.dtype), dbeta.to(beta.dtype)
        if need[1] or need[2]:
            dW, db = snake_conv1d_wgrad(dy, x, w.shape[-1], a, b, pad_lo, pad_hi, d)
            dW = dW.to(w.dtype)
            db = None if bias_dtype is None else db.to(bias_dtype)
        dres = None if res_dtype is None else dy.to(res_dtype)
        return dx, dW, db, dalpha, dbeta, dres, None, None, None


def snake_conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                 alpha: torch.Tensor, beta: torch.Tensor, pad_lo: int, pad_hi: int,
                 dilation: int) -> torch.Tensor:
    """conv1d(snake(x), w) + bias; x [B, Ci, L], w [Co, Ci, k] -> [B, Co, Lout].
    CUDA tensors launch row 12 (the carry)."""
    return _SnakeConv1d.apply(x, w, bias, alpha, beta, None, pad_lo, pad_hi, dilation)


def snake_conv1d_res(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                     alpha: torch.Tensor, beta: torch.Tensor, residual: torch.Tensor,
                     pad_lo: int, pad_hi: int, dilation: int) -> torch.Tensor:
    """snake_conv1d with the residual [B, Co, Lout] added in the epilogue;
    CUDA tensors launch row 3."""
    return _SnakeConv1d.apply(x, w, bias, alpha, beta, residual, pad_lo, pad_hi, dilation)


snake_conv1d.launches = 0
snake_conv1d_res.launches = 0
snake_conv1d_dx.launches = 0
snake_conv1d_wgrad.launches = 0
conv1d_wgrad.launches = 0
