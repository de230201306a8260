"""Flash attention: the Hopper ports of the TPU `flash_attention` (causal /
sliding window), `flash_attention_prefix`, their backward, the
strided-layout entry `flash_attention_nhd` and the fused-QKV entry
`flash_attention_fused_qkv`.

The four forward entries compute one function and launch one kernel,
`csrc/flash_fwd.cu` (warp-specialised `wgmma` with a TMA ring), which reads
each operand through its own (batch, head, row) strides (views of the
projections need no copy) and visits only the key tiles of each query
block's band. Each entry keeps the TPU kernel it replaces, its checks and
its launch counter.

`flash_attention(q, k, v, causal=False, window=None)` computes
softmax(QK^T / sqrt(d) + mask) V over [B, H, N, D], D in {64, 128}, any N,
where key j is visible from query i iff j < N, (not causal or j <= i),
i - left <= j (left >= 0) and j <= i + right (right >= 0) for
window = (left, right), -1 leaving a side open (JAX `_pos_mask` :114). It
returns the output and the f32 logsumexp and is a `torch.autograd.Function`;
the backward is `flash_attention_prefix_bwd` under the same band.

`flash_attention_prefix(q, k, v, prefix_len)` computes non-causal, unmasked
softmax(QK^T / sqrt(d)) V over [B, H, N, 64] where the first `prefix_len`
tokens are a short prepended prefix (SA-Open's DiT: one global-cond token
ahead of 1024 latent tokens). It returns the output and the f32 logsumexp,
and is a `torch.autograd.Function`: the gradient of the output flows to q, k
and v (the logsumexp is not differentiable), as the JAX package's
`custom_vjp` (`_prefix_fwd` / `_prefix_bwd`).

- CUDA bf16 tensors launch `csrc/flash_fwd.cu` forward and
  `csrc/flash_bwd.cu` backward (each source note says what it replaces, what
  bounds it and how it is tiled). A build or launch failure raises.
- CPU tensors take the plain versions, `flash_attention_plain`,
  `flash_attention_prefix_plain` and `flash_attention_prefix_bwd_plain`: the
  same functions in plain PyTorch with f32 math; the CPU tests and
  chip_smoke.py compare against them.

The backward (`flash_attention_prefix_bwd`, the backward of all three
entries, with the causal / window band and D in {64, 128}) has two routes
over the same function (`BWD_ROUTES`), as the JAX package's
`_flash_backward` has its fused and two-pass kernels:
- "fused": one pass over key tiles (dK/dV per tile, dQ added into an f32
  buffer with atomics), the counterpart of `_bwd_fused_kernel`;
- "two_pass": a dK/dV pass and a dQ pass with no atomics, the counterpart of
  `_bwd_dkv_kernel` + `_bwd_dq_kernel`.
`BWD_ROUTE` is the one the training path runs (picked by an A/B on the H100,
PERF.md).

`flash_attention_nhd(q, k, v, causal=False, prefix_len=0)` is the same
attention over q, k, v in the activation layout [B, N, H, 64], returned in
that layout: non-causal with a prefix of at most 128 rows, or causal with no
prefix. The kernel reads [B, H, N, 64] views of q, k, v (which may be views
of one fused [B, N, 3*H*64] projection output, or fresh tensors) and writes
out as [B, N, H*64], the operand of the output projection: no transposed or
contiguous copy on either side. A layout the kernel cannot read (last stride
not 1, rows off 16 bytes) raises; nothing is copied silently. Its backward
transposes to [B, H, N, 64] and reuses `flash_attention_prefix_bwd` (causal:
under the causal band), as the JAX package's `_nhd_bwd` reuses
`_flash_backward`. CPU tensors take `flash_attention_nhd_plain`.

`flash_attention_fused_qkv(qkv, cos, sin, heads, causal=False, window=None)`
is the same attention read off the fused projection [B, N, 3*H*D] (the
concat layout of `to_qkv`) as strided [B, H, N, D] views, with the partial
half-split rotary of the f32 tables cos, sin [N, rot_dim] applied to q and k
by the source's rotary pass ahead of the attention kernel (into contiguous
[B, N, H, D] buffers freed after the call; D 64 or 128, rot_dim 0 or any
even value up to D), causal, windowed or unmasked, any N; it returns
[B, N, H, D]. Its backward re-runs the unpack and rotary in plain PyTorch
and reuses `flash_attention_prefix_bwd`, as the JAX package's `_fused_bwd`
reuses `_flash_backward`. CPU tensors take
`flash_attention_fused_qkv_plain`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..embeddings import rotate_nhd
from . import _build

MAX_PREFIX = 64
MAX_PREFIX_NHD = 128
HEAD_DIM = 64
HEAD_DIMS = (64, 128)  # head dims of `flash_attention` and the backward
BWD_ROUTES = ("fused", "two_pass")
# the two-pass route measured 6.40 ms against the single pass's 9.22 ms at
# [4,24,6145,64] and 0.293 against 0.367 ms at [4,24,1025,64] on an H100
# (PERF.md), and needs no atomics: deterministic
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


def band(causal: bool, window: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """(left, right) of the kernels' band, -1 for an open side: causal folds
    into right = 0 (j <= i and j <= i + right with right >= 0 is j <= i)."""
    left, right = (-1, -1) if window is None else (int(window[0]), int(window[1]))
    left, right = max(left, -1), max(right, -1)
    return left, 0 if causal else right


def band_mask(n: int, causal: bool = False, window: Optional[Tuple[int, int]] = None,
              device=None) -> Optional[torch.Tensor]:
    """[n, n] bool, True where key j (column) is visible from query i (row);
    None when nothing is masked."""
    left, right = band(causal, window)
    if left < 0 and right < 0:
        return None
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    keep = torch.ones(n, n, dtype=torch.bool, device=device)
    if left >= 0:
        keep &= j >= i - left
    if right >= 0:
        keep &= j <= i + right
    return keep


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, window: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference of `flash_attention` over [B, H, N, D]: f32 logits, the band
    mask, softmax and PV. Returns (out in q.dtype, lse f32 [B, H, N])."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = band_mask(q.shape[-2], causal, window, q.device)
    if keep is not None:
        logits = logits.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_attention_prefix_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     out: torch.Tensor, lse: torch.Tensor,
                                     dout: torch.Tensor, causal: bool = False,
                                     window: Optional[Tuple[int, int]] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference backward in f32 from the saved logsumexp: with
    P = exp(QK^T s - lse) (0 outside the causal / window band) and
    dsum = rowsum(dO * O),
    dV = P^T dO, dS = P (dO V^T - dsum) s, dK = dS^T Q, dQ = dS K.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.float()[..., None])
    keep = band_mask(q.shape[-2], causal, window, q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dsum = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - dsum) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _grad_needed(*tensors) -> bool:
    """Whether autograd could need a backward through these inputs; when it
    cannot, the entries launch their kernel without an autograd node (its
    host cost is the larger part of a launch-sized call)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_cuda(name: str, tensors, shape, dtype) -> None:
    for arg, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} on {t.device}, the kernel runs on CUDA")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _launch_prefix(q, k, v, prefix_len):
    B, H, N, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_prefix: head dim {D}, kernel needs {HEAD_DIM}")
    if not 0 <= prefix_len <= MAX_PREFIX or prefix_len >= N:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {MAX_PREFIX}] "
                         f"or not below N={N}")
    _check_cuda("flash_attention_prefix", (("q", q), ("k", k), ("v", v)), q.shape,
                torch.bfloat16)
    out = torch.empty((B, H, N, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    _run_flash_fwd("flash_attention_prefix", q, k, v, out, lse, False, None)
    flash_attention_prefix.launches += 1
    return out, lse


def flash_attention_prefix_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                               route: str = None, causal: bool = False,
                               window: Optional[Tuple[int, int]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` (and of the prefix and NHD entries)
    from its saved output and logsumexp under the causal / window band;
    q, k, v, out, dout [B, H, N, D] bf16 with D in HEAD_DIMS, lse [B, H, N]
    f32. `route` is one of BWD_ROUTES (default BWD_ROUTE)."""
    if q.device.type == "cpu":
        return flash_attention_prefix_bwd_plain(q, k, v, out, lse, dout, causal, window)
    route = BWD_ROUTE if route is None else route
    if route not in BWD_ROUTES:
        raise ValueError(f"flash_attention_prefix_bwd: route {route!r} not in {BWD_ROUTES}")
    B, H, N, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_prefix_bwd: head dim {D}, kernel takes {HEAD_DIMS}")
    _check_cuda("flash_attention_prefix_bwd",
                (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)), q.shape,
                torch.bfloat16)
    _check_cuda("flash_attention_prefix_bwd", (("lse", lse),), (B, H, N), torch.float32)
    q, k, v, out, lse, dout = (t.contiguous() for t in (q, k, v, out, lse, dout))
    if any(t.data_ptr() % 16 for t in (q, k, v, dout, lse)):
        raise ValueError("flash_attention_prefix_bwd: q, k, v, dout and lse must start on "
                         "16-byte boundaries (the kernels read them through TMA tensor maps)")
    stream, scale, BH = _stream(q), 1.0 / math.sqrt(D), B * H
    left, right = band(causal, window)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    dsum = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    fn = _build.bind("flash_bwd", "flash_bwd_dsum", [ptr] * 3 + [c_int] * 2 + [ptr])
    _build.check(fn(out.data_ptr(), dout.data_ptr(), dsum.data_ptr(), BH * N, D, stream),
                 "flash_bwd_dsum")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fused = route == "fused"
    dq_acc = torch.zeros(q.shape, device=q.device, dtype=torch.float32) if fused else None
    fn = _build.bind("flash_bwd", "flash_bwd_dkv", [ptr] * 9 + [c_int] * 3 + [
        ctypes.c_float] + [c_int] * 3 + [ptr])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
              dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              dq_acc.data_ptr() if fused else None, BH, N, D, scale, left, right, int(fused),
              stream)
    _build.check(code, "flash_bwd_dkv")
    if fused:
        dq = dq_acc.to(q.dtype)
    else:
        dq = torch.empty_like(q)
        fn = _build.bind("flash_bwd", "flash_bwd_dq", [ptr] * 7 + [c_int] * 3 + [
            ctypes.c_float] + [c_int] * 2 + [ptr])
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                  dsum.data_ptr(), dq.data_ptr(), BH, N, D, scale, left, right, stream)
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
            out, lse = _launch_prefix(q, k, v, prefix_len)
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
    if q.is_cuda and not _grad_needed(q, k, v):
        return _launch_prefix(q, k, v, prefix_len)
    return _FlashAttentionPrefix.apply(q, k, v, prefix_len)


flash_attention_prefix.launches = 0


def _bhnd_strides(entry: str, name: str, t: torch.Tensor):
    """(batch, head, row) element strides of a [B, H, N, D] operand the
    kernel can read as it lies: last axis contiguous, every row starting on a
    16-byte boundary."""
    sb, sh, sn, sd = t.stride()
    if sd != 1:
        raise ValueError(f"{entry}: {name} has last-axis stride {sd}; the kernel "
                         "reads contiguous rows and makes no copy")
    if t.data_ptr() % 16 or any(s % 8 for s in (sb, sh, sn)):
        raise ValueError(f"{entry}: {name} rows are not 16-byte aligned "
                         f"(data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()})")
    return sb, sh, sn


def _run_flash_fwd(entry, q, k, v, out, lse, causal, window) -> None:
    """Launch `csrc/flash_fwd.cu` on q, k, v, out [B, H, N, D] (views through
    their own strides) and lse [B, H, N] f32 under the causal / window band."""
    B, H, N, D = q.shape
    strides = [s for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for s in _bhnd_strides(entry, name, t)]
    left, right = band(causal, window)
    ptr = ctypes.c_void_p
    fn = _build.bind("flash_fwd", "flash_fwd", [ptr] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6 + [ctypes.c_float, ptr])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              (ctypes.c_longlong * 12)(*strides), B, H, N, D, left, right,
              1.0 / math.sqrt(D), _stream(q))
    _build.check(code, f"{entry} (flash_fwd)")


def _rope_pass(entry, q, k, cos, sin):
    """q, k [B, N, H, D] (views through their strides) rotated by the tables
    cos, sin [N, rot_dim] f32 into new contiguous [B, N, H, D] tensors by
    `csrc/flash_fwd.cu`'s rotary pass."""
    B, N, H, D = q.shape
    strides = [s for name, t in (("q", q), ("k", k))
               for s in _bhnd_strides(entry, name, t.transpose(1, 2))]
    qr, kr = torch.empty_like(q, memory_format=torch.contiguous_format), torch.empty_like(
        k, memory_format=torch.contiguous_format)
    ptr = ctypes.c_void_p
    fn = _build.bind("flash_fwd", "flash_fwd_rope", [ptr] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4 + [ptr, ptr, ctypes.c_int, ptr])
    code = fn(q.data_ptr(), k.data_ptr(), qr.data_ptr(), kr.data_ptr(),
              (ctypes.c_longlong * 6)(*strides), B, H, N, D, cos.data_ptr(), sin.data_ptr(),
              cos.shape[-1], _stream(q))
    _build.check(code, f"{entry} (flash_fwd_rope)")
    return qr, kr


def _launch_flash(q, k, v, causal, window):
    B, H, N, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D}, kernel takes {HEAD_DIMS}")
    _check_cuda("flash_attention", (("q", q), ("k", k), ("v", v)), q.shape, torch.bfloat16)
    out = torch.empty((B, H, N, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    _run_flash_fwd("flash_attention", q, k, v, out, lse, causal, window)
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal, window)
        else:
            out, lse = _launch_flash(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.band = (causal, window)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window = ctx.band
        dq, dk, dv = flash_attention_prefix_bwd(q, k, v, out, lse, dout, causal=causal,
                                                window=window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    window: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: [B, H, N, D] (any strides with a contiguous last axis on
    CUDA), D in HEAD_DIMS; `window` = (left, right), -1 for an open side.
    Returns (out [B, H, N, D] in q.dtype, lse [B, H, N] f32)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, N, D] shape: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    window = None if window is None else (int(window[0]), int(window[1]))
    if q.is_cuda and not _grad_needed(q, k, v):
        return _launch_flash(q, k, v, bool(causal), window)
    return _FlashAttention.apply(q, k, v, bool(causal), window)


flash_attention.launches = 0


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


def _launch_nhd(q, k, v, causal):
    B, N, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_nhd: head dim {D}, kernel needs {HEAD_DIM}")
    _check_cuda("flash_attention_nhd", (("q", q), ("k", k), ("v", v)), q.shape, torch.bfloat16)
    out = torch.empty((B, N, H, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    _run_flash_fwd("flash_attention_nhd", *(t.transpose(1, 2) for t in (q, k, v, out)), lse,
                   causal, None)
    flash_attention_nhd.launches += 1
    return out, lse


class _FlashAttentionNHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len):
        if q.device.type == "cpu":
            out, lse = flash_attention_nhd_plain(q, k, v, causal, prefix_len)
        else:
            out, lse = _launch_nhd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bhnd = [t.transpose(1, 2) for t in (q, k, v, out, dout)]
        grads = flash_attention_prefix_bwd(*bhnd[:4], lse, bhnd[4], causal=ctx.causal)
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
    if q.is_cuda and not _grad_needed(q, k, v):
        return _launch_nhd(q, k, v, bool(causal))[0]
    return _FlashAttentionNHD.apply(q, k, v, bool(causal), int(prefix_len))


flash_attention_nhd.launches = 0


def fused_unpack_rope_plain(qkv: torch.Tensor, cos: Optional[torch.Tensor],
                            sin: Optional[torch.Tensor], heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused projection [B, N, 3*H*D] ([q | k | v], each [H][D]) ->
    q, k, v [B, N, H, D], q and k rotated when tables are given (v, and q and
    k without tables, are views)."""
    B, N, F = qkv.shape
    q, k, v = qkv.view(B, N, 3, heads, F // (3 * heads)).unbind(2)
    if cos is not None:
        q, k = rotate_nhd(q, cos, sin), rotate_nhd(k, cos, sin)
    return q, k, v


def flash_attention_fused_qkv_plain(qkv: torch.Tensor, cos: Optional[torch.Tensor],
                                    sin: Optional[torch.Tensor], heads: int,
                                    causal: bool = False,
                                    window: Optional[Tuple[int, int]] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference of `flash_attention_fused_qkv`: unpack, rotary, then
    `flash_attention_plain`. Returns (out [B, N, H, D] in qkv.dtype, lse f32
    [B, H, N])."""
    q, k, v = fused_unpack_rope_plain(qkv, cos, sin, heads)
    out, lse = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     causal, window)
    return out.transpose(1, 2).contiguous(), lse


def _launch_fused(qkv, cos, sin, heads, causal, window):
    B, N, F = qkv.shape
    D = F // (3 * heads)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fused_qkv: head dim {D}, kernel takes {HEAD_DIMS}")
    _check_cuda("flash_attention_fused_qkv", (("qkv", qkv),), (B, N, 3 * heads * D),
                torch.bfloat16)
    q, k, v = qkv.view(B, N, 3, heads, D).unbind(2)
    if cos is not None:
        rot = cos.shape[-1]
        _check_cuda("flash_attention_fused_qkv", (("cos", cos), ("sin", sin)), (N, rot),
                    torch.float32)
        if (rot % 2 or not 0 < rot <= D or not (cos.is_contiguous() and sin.is_contiguous())
                or cos.data_ptr() % 16 or sin.data_ptr() % 16):
            raise ValueError(f"flash_attention_fused_qkv: rotary tables [{N}, {rot}] must be "
                             f"contiguous and 16-byte aligned with an even width of at most {D}")
        q, k = _rope_pass("flash_attention_fused_qkv", q, k, cos, sin)
    out = torch.empty((B, N, heads, D), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty((B, heads, N), device=qkv.device, dtype=torch.float32)
    _run_flash_fwd("flash_attention_fused_qkv", *(t.transpose(1, 2) for t in (q, k, v, out)),
                   lse, causal, window)
    flash_attention_fused_qkv.launches += 1
    return out, lse


class _FlashAttentionFusedQKV(torch.autograd.Function):
    """Forward: the kernel (or its plain version) off the projection. The
    backward re-runs the unpack and rotary in plain PyTorch, takes row 6's
    backward of the rotated q, k and v, and the rotary's VJP back to d(qkv)
    (JAX `_fused_bwd`). Saved: the projection, the output and the
    logsumexp; the rotated q and k are not kept."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, heads, causal, window):
        if qkv.device.type == "cpu":
            out, lse = flash_attention_fused_qkv_plain(qkv, cos, sin, heads, causal, window)
        else:
            out, lse = _launch_fused(qkv, cos, sin, heads, causal, window)
        ctx.save_for_backward(qkv, cos, sin, out, lse)
        ctx.args = (heads, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, cos, sin, out, lse = ctx.saved_tensors
        heads, causal, window = ctx.args
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            qkv_rot = fused_unpack_rope_plain(x, cos, sin, heads)
        bhnd = [t.detach().transpose(1, 2) for t in (*qkv_rot, out, dout)]
        grads = flash_attention_prefix_bwd(*bhnd[:4], lse, bhnd[4], causal=causal,
                                           window=window)
        (dqkv,) = torch.autograd.grad(qkv_rot, x, [g.transpose(1, 2) for g in grads])
        return dqkv, None, None, None, None, None


def flash_attention_fused_qkv(qkv: torch.Tensor, cos: Optional[torch.Tensor],
                              sin: Optional[torch.Tensor], heads: int, causal: bool = False,
                              window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Attention straight off the fused projection qkv [B, N, 3*H*D] (the
    concat layout of `to_qkv`: [q | k | v], each [H][D]; D in HEAD_DIMS),
    with the half-split rotary of the tables cos, sin [N, rot_dim] f32
    applied to q and k (None: no rotary), causal / windowed or unmasked,
    any N. Returns out [B, N, H, D] in qkv.dtype, the layout `to_out` reads.

    Differentiable in qkv; the tables are constants and get no gradient (the
    JAX VJP also returns cos and sin gradients, which nothing reads)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be [B, N, 3 * {heads} * D], got {tuple(qkv.shape)}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_fused_qkv: unsupported device {qkv.device}")
    if (cos is None) != (sin is None):
        raise ValueError("flash_attention_fused_qkv: give both rotary tables or neither")
    window = None if window is None else (int(window[0]), int(window[1]))
    if qkv.is_cuda and not _grad_needed(qkv):
        return _launch_fused(qkv, cos, sin, int(heads), bool(causal), window)[0]
    return _FlashAttentionFusedQKV.apply(qkv, cos, sin, int(heads), bool(causal), window)


flash_attention_fused_qkv.launches = 0
