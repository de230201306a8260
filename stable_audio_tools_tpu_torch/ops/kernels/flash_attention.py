"""Flash attention: the Hopper ports of the TPU `flash_attention_prefix`, of
its backward, and of the strided-layout entry `flash_attention_nhd`.

`flash_attention_prefix(q, k, v, prefix_len)` computes non-causal, unmasked
softmax(QK^T / sqrt(d)) V over [B, H, N, D] where the first `prefix_len`
tokens are a short prepended prefix (SA-Open's DiT: one global-cond token
ahead of 1024 latent tokens). It returns the output and the f32 logsumexp,
and is a `torch.autograd.Function`: the gradient of the output flows to q, k
and v (the logsumexp is not differentiable), as the JAX package's
`custom_vjp` (`_prefix_fwd` / `_prefix_bwd`).

- CUDA bf16 tensors launch `csrc/flash_prefix.cu` forward and
  `csrc/flash_bwd.cu` backward (each source note says what it replaces, what
  bounds it and how it is tiled). A build or launch failure raises.
- CPU tensors take the plain versions, `flash_attention_prefix_plain` and
  `flash_attention_prefix_bwd_plain`: the same functions in plain PyTorch
  with f32 math; the CPU tests and chip_smoke.py compare against them.

The backward has two routes over the same function (`BWD_ROUTES`), as the
JAX package's `_flash_backward` has its fused and two-pass kernels:
- "fused": one pass over key tiles (dK/dV per tile, dQ added into an f32
  buffer with atomics), the counterpart of `_bwd_fused_kernel`;
- "two_pass": a dK/dV pass and a dQ pass with no atomics, the counterpart of
  `_bwd_dkv_kernel` + `_bwd_dq_kernel`.
`BWD_ROUTE` is the one the training path runs (picked by an A/B on the H100,
PERF.md).

`flash_attention_nhd(q, k, v, causal=False, prefix_len=0)` is the same
attention over q, k, v in the activation layout [B, N, H, 64], returned in
that layout: non-causal with a prefix of at most 128 rows, or causal with no
prefix. On CUDA it launches `csrc/flash_nhd.cu`, which reads each operand
through its own strides (q, k, v may be views of one fused [B, N, 3*H*64]
projection output, or fresh tensors) and writes [B, N, H*64], the operand of
the output projection: no transposed or contiguous copy on either side. A
layout the kernel cannot read (last stride not 1, rows off 16 bytes) raises;
nothing is copied silently. Its backward transposes to [B, H, N, 64] and
reuses `flash_attention_prefix_bwd`, as the JAX package's `_nhd_bwd` reuses
`_flash_backward`; the causal backward has no kernel yet and raises on CUDA.
CPU tensors take `flash_attention_nhd_plain`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

MAX_PREFIX = 64
MAX_PREFIX_NHD = 128
HEAD_DIM = 64
BWD_ROUTES = ("fused", "two_pass")
# the two-pass route measured 2.030 ms against the single pass's 2.145 ms at
# [4,24,1025,64] on an H100 (PERF.md), and needs no atomics: deterministic
BWD_ROUTE = "two_pass"


def flash_attention_prefix_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference: full attention in f32 (the prefix split does not change the
    function). Returns (out in q.dtype [B,H,N,D], lse f32 [B,H,N])."""
    del prefix_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_attention_prefix_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     out: torch.Tensor, lse: torch.Tensor,
                                     dout: torch.Tensor, causal: bool = False
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference backward in f32 from the saved logsumexp: with
    P = exp(QK^T s - lse) (0 above the diagonal when `causal`) and
    dsum = rowsum(dO * O),
    dV = P^T dO, dS = P (dO V^T - dsum) s, dK = dS^T Q, dQ = dS K.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.float()[..., None])
    if causal:
        p = p.tril()
    dsum = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - dsum) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, tensors, shape, dtype) -> None:
    for arg, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} on {t.device}, the kernel runs on CUDA")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _launch_fwd(q, k, v, prefix_len):
    B, H, N, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_prefix: unsupported device {q.device}")
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_prefix: head dim {D}, kernel needs {HEAD_DIM}")
    if not 0 <= prefix_len <= MAX_PREFIX or prefix_len >= N:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {MAX_PREFIX}] "
                         f"or not below N={N}")
    _check_cuda("flash_attention_prefix", (("q", q), ("k", k), ("v", v)), q.shape,
                torch.bfloat16)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    fn = _build.bind("flash_prefix", "flash_prefix_fwd", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              B, H, N, prefix_len, 1.0 / math.sqrt(D), _stream(q))
    _build.check(code, "flash_prefix_fwd")
    flash_attention_prefix.launches += 1
    return out, lse


def flash_attention_prefix_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                               route: str = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention_prefix` from its saved output and
    logsumexp; q, k, v, out, dout [B, H, N, 64] bf16, lse [B, H, N] f32.
    `route` is one of BWD_ROUTES (default BWD_ROUTE)."""
    if q.device.type == "cpu":
        return flash_attention_prefix_bwd_plain(q, k, v, out, lse, dout)
    route = BWD_ROUTE if route is None else route
    if route not in BWD_ROUTES:
        raise ValueError(f"flash_attention_prefix_bwd: route {route!r} not in {BWD_ROUTES}")
    B, H, N, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_prefix_bwd: head dim {D}, kernel needs {HEAD_DIM}")
    _check_cuda("flash_attention_prefix_bwd",
                (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)), q.shape,
                torch.bfloat16)
    _check_cuda("flash_attention_prefix_bwd", (("lse", lse),), (B, H, N), torch.float32)
    q, k, v, out, lse, dout = (t.contiguous() for t in (q, k, v, out, lse, dout))
    stream, scale, BH = _stream(q), 1.0 / math.sqrt(D), B * H
    ptr = ctypes.c_void_p
    dsum = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    fn = _build.bind("flash_bwd", "flash_bwd_dsum", [ptr] * 3 + [ctypes.c_int, ptr])
    _build.check(fn(out.data_ptr(), dout.data_ptr(), dsum.data_ptr(), BH * N, stream),
                 "flash_bwd_dsum")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fused = route == "fused"
    dq_acc = torch.zeros(q.shape, device=q.device, dtype=torch.float32) if fused else None
    fn = _build.bind("flash_bwd", "flash_bwd_dkv", [ptr] * 9 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ptr])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
              dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              dq_acc.data_ptr() if fused else None, BH, N, scale, int(fused), stream)
    _build.check(code, "flash_bwd_dkv")
    if fused:
        dq = dq_acc.to(q.dtype)
    else:
        dq = torch.empty_like(q)
        fn = _build.bind("flash_bwd", "flash_bwd_dq", [ptr] * 7 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ptr])
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                  dsum.data_ptr(), dq.data_ptr(), BH, N, scale, stream)
        _build.check(code, "flash_bwd_dq")
    flash_attention_prefix_bwd.launches += 1
    return dq, dk, dv


flash_attention_prefix_bwd.launches = 0


class _FlashAttentionPrefix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, prefix_len):
        if q.device.type == "cpu":
            out, lse = flash_attention_prefix_plain(q, k, v, prefix_len)
        else:
            out, lse = _launch_fwd(q, k, v, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_prefix_bwd(q, k, v, out, lse, dout)
        return dq, dk, dv, None


def flash_attention_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: [B, H, N, D]; the first `prefix_len` (<= 64) tokens are the
    prefix. Returns (out [B,H,N,D] in q.dtype, lse [B,H,N] f32)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_prefix: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    return _FlashAttentionPrefix.apply(q, k, v, prefix_len)


flash_attention_prefix.launches = 0


def flash_attention_nhd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False, prefix_len: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference over [B, N, H, D]: f32 logits, the causal mask, softmax and
    PV in plain PyTorch (the prefix split does not change the function).
    Returns (out in q.dtype [B,N,H,D], lse f32 [B,H,N])."""
    del prefix_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype).contiguous(), lse


def _nhd_strides(name: str, t: torch.Tensor):
    """(batch, row, head) element strides of a [B, N, H, 64] operand the
    kernel can read as it lies: last axis contiguous, every 64-element row
    starting on a 16-byte boundary."""
    sb, sn, sh, sd = t.stride()
    if sd != 1:
        raise ValueError(f"flash_attention_nhd: {name} has last-axis stride {sd}; the kernel "
                         "reads contiguous 64-element rows and makes no copy")
    if t.data_ptr() % 16 or any(s % 8 for s in (sb, sn, sh)):
        raise ValueError(f"flash_attention_nhd: {name} rows are not 16-byte aligned "
                         f"(data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()})")
    return sb, sn, sh


def _launch_nhd(q, k, v, causal, prefix_len):
    B, N, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_nhd: head dim {D}, kernel needs {HEAD_DIM}")
    _check_cuda("flash_attention_nhd", (("q", q), ("k", k), ("v", v)), q.shape, torch.bfloat16)
    out = torch.empty((B, N, H, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    strides = [s for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for s in _nhd_strides(name, t)]
    fn = _build.bind("flash_nhd", "flash_nhd_fwd", [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                   ctypes.c_void_p])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              (ctypes.c_longlong * 12)(*strides), B, H, N, prefix_len, int(causal),
              1.0 / math.sqrt(D), _stream(q))
    _build.check(code, "flash_nhd_fwd")
    flash_attention_nhd.launches += 1
    return out, lse


class _FlashAttentionNHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len):
        if q.device.type == "cpu":
            out, lse = flash_attention_nhd_plain(q, k, v, causal, prefix_len)
        else:
            out, lse = _launch_nhd(q, k, v, causal, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bhnd = [t.transpose(1, 2) for t in (q, k, v, out, dout)]
        if q.device.type == "cpu":
            grads = flash_attention_prefix_bwd_plain(*bhnd[:4], lse, bhnd[4], causal=ctx.causal)
        elif ctx.causal:
            raise RuntimeError(
                "flash_attention_nhd: the causal backward has no CUDA kernel yet (it comes "
                "with the causal flash-attention slice); call it under torch.no_grad()")
        else:
            grads = flash_attention_prefix_bwd(*bhnd[:4], lse, bhnd[4])
        return (*(g.transpose(1, 2) for g in grads), None, None)


def flash_attention_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, prefix_len: int = 0) -> torch.Tensor:
    """q, k, v: [B, N, H, D] (any strides with a contiguous last axis); the
    first `prefix_len` (<= 128, non-causal only) rows are a prepended prefix.
    Returns out [B, N, H, D], contiguous, in q.dtype."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, N, H, D] shape: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_nhd: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if prefix_len and causal:
        raise ValueError("flash_attention_nhd: the prefix fold is non-causal")
    if not 0 <= prefix_len <= MAX_PREFIX_NHD or prefix_len >= q.shape[1]:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {MAX_PREFIX_NHD}] or not "
                         f"below N={q.shape[1]}")
    return _FlashAttentionNHD.apply(q, k, v, bool(causal), int(prefix_len))


flash_attention_nhd.launches = 0
