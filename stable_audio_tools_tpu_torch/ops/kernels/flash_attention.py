"""Prefix flash attention: the Hopper port of the TPU `flash_attention_prefix`.

`flash_attention_prefix(q, k, v, prefix_len)` computes non-causal, unmasked
softmax(QK^T / sqrt(d)) V over [B, H, N, D] where the first `prefix_len`
tokens are a short prepended prefix (SA-Open's DiT: one global-cond token
ahead of 1024 latent tokens). It returns the output and the f32 logsumexp.

- CUDA bf16 tensors launch `csrc/flash_prefix.cu` (its source note says what
  it replaces, what bounds it and how it is tiled).
- CPU tensors take `flash_attention_prefix_plain`, the same function in plain
  PyTorch with f32 softmax; the CPU tests and chip_smoke.py compare against it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

MAX_PREFIX = 64
HEAD_DIM = 64


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


def flash_attention_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: [B, H, N, D]; the first `prefix_len` (<= 64) tokens are the
    prefix. Returns (out [B,H,N,D] in q.dtype, lse [B,H,N] f32)."""
    if q.device.type == "cpu":
        return flash_attention_prefix_plain(q, k, v, prefix_len)
    B, H, N, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_prefix: unsupported device {q.device}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_prefix: head dim {D}, kernel needs {HEAD_DIM}")
    if not 0 <= prefix_len <= MAX_PREFIX or prefix_len >= N:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {MAX_PREFIX}] "
                         f"or not below N={N}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_prefix: {name} is {t.dtype}, kernel takes bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    fn = _build.bind("flash_prefix", "flash_prefix_fwd", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              B, H, N, prefix_len, 1.0 / math.sqrt(D),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_prefix_fwd")
    flash_attention_prefix.launches += 1
    return out, lse


flash_attention_prefix.launches = 0
