"""Attention; counterpart of stable_audio_tools_tpu/ops/attention.py.

The port keeps the reference's concatenated projections (`to_qkv` =
[q | k | v], `to_kv` = [k | v]); the JAX package stores them head-major
interleaved for tensor parallelism, and io/from_jax.py de-interleaves.

Dispatch of `Attention` (the port's own; the JAX package's `_should_use_pallas`
and `_should_use_nhd` gates are the TPU's and are not carried over):
- unmasked self-attention with head dim 64, no window, a prefix of at most
  128 tokens (none when causal) and a main sequence of at least
  `nhd_min_seq` tokens takes the strided-layout entry `flash_attention_nhd`,
  causal or not: q, k, v stay [B, N, H, 64] views of the `to_qkv` output (no
  head transposes in or out), the rotary runs in that layout, and `to_out`
  reads the kernel's output as it lies. SA-2.0's DiT self-attention is this
  case (N = 1 + 6144). It is the counterpart of the JAX package's NHD branch
  (ops/attention.py:507-570).
- the same case with a rotary table, in a training forward (the module in
  training mode with grad enabled, the condition of the block remat in
  ops/transformer.py, so that both passes of a recomputed block take one
  route), takes `flash_attention_fused_qkv`: the kernel reads q, k, v off
  the `to_qkv` output and applies the rotary itself, and its backward
  recomputes the rotary. SA-2.0's DiT training is this case. Generation
  keeps the rotary pass + `flash_attention_nhd` (the JAX package dispatches
  its fused entry nowhere; ROADMAP queues the A/B of moving generation).
- otherwise `attention_core` ([B, H, N, D] in and out): causal or windowed
  self-attention with head dim 64 or 128 and no key mask goes to
  `flash_attention` at any length (the LM backbone: causal, N = 500 in
  training, 503 in `lm_generate`); non-causal, unmasked self-attention with
  a prefix of at most 64 tokens and head dim 64 goes to
  `flash_attention_prefix` (SA-Open's DiT, N = 1 + 1024). Both are
  ops/kernels/flash_attention.py: the CUDA kernels on the card, their plain
  versions on the CPU.
- everything else (the cross-attention to the conditioning tokens, with or
  without a key mask, causal or not) is `dot_product_attention`: plain matmul
  + f32 softmax under the bottom-right-aligned mask of the JAX package's
  `_build_bias`, as the JAX package leaves it to XLA.

The LM's cross-attention is causal, as the JAX package builds it
(ops/transformer.py:247-250, 300-310): with the mask aligned bottom-right, a
sequence longer than the context leaves its first q_len - k_len rows with no
visible key, and they attend uniformly (the additive f32-min bias swallows
the logits). The cached decode calls the cross-attention with one query row,
which is never causal (JAX :645-646, and the `precomputed_kv` branch passes
causal=False), so the full and the cached paths compute different functions
for a context of more than one token; the port copies both.

KV-cached decode (`cache=`): the step's k and v are written into the
per-layer cache in place (the JAX package returns a new cache), the rotary
runs at the cache position, and `cached_decode_attention` attends over the
whole cache with the positions past the step masked, in plain PyTorch as the
JAX package leaves it to XLA.

The options of the JAX `Attention` (:365), which the TAAE and the DiT's
config keys reach:
- `qk_norm` ("l2", "ln", "dyt"): q and k normalised over the head dim after
  the head split and before the rotary (JAX :585-595): "l2" divides by the
  norm + 1e-12, "ln" is flax's `nn.LayerNorm` (scale and bias, epsilon 1e-6,
  in f32, cast back; `BiasedLayerNorm`, so the card runs it on row 2's beta
  variant), "dyt" a `DynamicTanh`; the cross-attention normalises its
  queries and its keys (`compute_kv`, so the cached decode's K/V carry it).
  The fused-QKV route cannot normalise, so qk-normed training forwards take
  `flash_attention_nhd` on the normalised views.
- `differential`: a second query / key pair (`to_qkv` [q | k | v | q_diff |
  k_diff], the cross-attention's `to_q` [q | q_diff] and `to_kv` [k | k_diff
  | v], in the concat layout the JAX package keeps for it), the output
  attn(q, k, v) - attn(q_diff, k_diff, v) (JAX :481-500, :652-656); it
  takes the [B, H, N, D] route and no cache.
- `feat_scale`: out + lambda_dc * mean_N(out) + lambda_hf * (out -
  mean_N(out)) after `to_out` (JAX :380-392); not with the cache (JAX
  refuses it there too).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .embeddings import apply_rotary_pos_emb, rotary_tables, rotate, rotate_nhd
from .kernels.flash_attention import (HEAD_DIM, HEAD_DIMS, MAX_PREFIX, MAX_PREFIX_NHD,
                                      flash_attention, flash_attention_fused_qkv,
                                      flash_attention_nhd, flash_attention_prefix)
from .norms import BiasedLayerNorm, DynamicTanh

QK_NORMS = ("none", "l2", "ln", "dyt")

# Main-sequence length from which self-attention takes `flash_attention_nhd`:
# between SA-Open's 1024 and SA-2.0's 6144. Both entries launch the same
# kernel; the [B, H, N, 64] route pays a transposed copy of its output
# (chip_smoke.py phase 2 times both routes at N = 6145 and 1025, PERF.md).
# The threshold keeps SA-Open's paths on the entry their records were taken
# with; lowering it is queued in ROADMAP.md.
NHD_MIN_SEQ = 2048


class Linear(nn.Linear):
    """nn.Linear whose f32 parameters are cast to the input's dtype at use
    (f32 master weights, bf16 compute, as the JAX package's Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), bias)


def build_bias(q_len: int, k_len: int, causal: bool = False,
               window: Optional[Tuple[int, int]] = None,
               mask: Optional[torch.Tensor] = None, device=None) -> Optional[torch.Tensor]:
    """Additive f32 bias for the causal / sliding-window / key-padding masks
    (JAX `_build_bias` :144): 0 where key j is visible from query i, the f32
    minimum elsewhere. The causal and window masks align the ends (offset =
    k_len - q_len, as flash-attn when q_len != k_len); window = (left,
    right) bounds i + offset - left <= j <= i + offset + right, a negative
    side open. `mask` [B, k_len] True = attend."""
    neg = torch.finfo(torch.float32).min
    bias = None
    if causal or window is not None:
        qi = torch.arange(q_len, device=device)[:, None]
        kj = torch.arange(k_len, device=device)[None, :]
        offset = k_len - q_len
        allowed = torch.ones(q_len, k_len, dtype=torch.bool, device=device)
        if causal:
            allowed &= kj <= qi + offset
        if window is not None:
            left, right = window
            if left >= 0:
                allowed &= kj >= qi + offset - left
            if right >= 0:
                allowed &= kj <= qi + offset + right
        bias = torch.where(allowed, 0.0, neg)[None, None]
    if mask is not None:
        key_bias = torch.where(mask[:, None, None, :], 0.0, neg)
        bias = key_bias if bias is None else bias + key_bias
    return bias


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, window: Optional[Tuple[int, int]] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, H, N, D]; softmax in f32 under `build_bias`, the weights
    cast to q's dtype before PV (as the JAX package)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = build_bias(q.shape[-2], k.shape[-2], causal, window, mask, q.device)
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   prefix_len: Optional[int] = None, causal: bool = False,
                   window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Attention over [B, H, N, D]. `prefix_len` is the count of prepended
    tokens of a self-attention sequence (None for cross-attention)."""
    self_attn = prefix_len is not None and mask is None and q.shape == k.shape
    if self_attn and (causal or window is not None) and q.shape[-1] in HEAD_DIMS:
        return flash_attention(q, k, v, causal=causal, window=window)[0]
    if (self_attn and not causal and window is None and prefix_len <= MAX_PREFIX
            and q.shape[-1] == HEAD_DIM):
        return flash_attention_prefix(q, k, v, prefix_len)[0]
    return dot_product_attention(q, k, v, causal, window, mask)


def init_kv_cache(batch: int, num_heads: int, max_len: int, dim_head: int,
                  dtype: torch.dtype = torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Empty KV cache for incremental decoding: k, v [B, H, max_len, D]."""
    shape = (batch, num_heads, max_len, dim_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cached_decode_attention(q: torch.Tensor, k_step: torch.Tensor, v_step: torch.Tensor,
                            cache: Dict[str, torch.Tensor], index: int) -> torch.Tensor:
    """One-token decode (JAX :344): q, k_step, v_step [B, H, 1, D]; writes the
    step into `cache` ({"k", "v": [B, H, S, D]}) at `index`, in place, and
    attends over the whole cache with the positions past `index` masked
    (f32 logits and softmax, the weights in q's dtype)."""
    cache["k"][:, :, index] = k_step[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, index] = v_step[:, :, 0].to(cache["v"].dtype)
    S = cache["k"].shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), cache["k"].float().transpose(-1, -2)) * scale
    pos = torch.arange(S, device=q.device)
    logits = torch.where(pos <= index, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, cache["v"].to(q.dtype))


class Attention(nn.Module):
    """Multi-head attention: self-attention (fused `to_qkv`) or
    cross-attention (`to_q` + fused `to_kv`) when `dim_context` is set;
    `causal` and `sliding_window` = (left, right) mask it (JAX `Attention`);
    `qk_norm`, `differential` and `feat_scale` as the module note says.

    As in the reference, cross-attention keys and values keep the context's
    width: dim_context // dim_heads key/value heads, each shared by
    consecutive query heads (SA-Open: 24 query heads over 12 kv heads)."""

    def __init__(self, dim: int, dim_heads: int = 64,
                 dim_context: Optional[int] = None,
                 nhd_min_seq: Optional[int] = None, causal: bool = False,
                 sliding_window: Optional[Tuple[int, int]] = None,
                 qk_norm: str = "none", differential: bool = False,
                 feat_scale: bool = False):
        """`nhd_min_seq`: the main-sequence length from which self-attention
        takes the strided-layout kernel (default NHD_MIN_SEQ)."""
        super().__init__()
        if qk_norm not in QK_NORMS:
            raise ValueError(f"qk_norm must be one of {QK_NORMS}, got {qk_norm!r}")
        self.dim = dim
        self.dim_heads = dim_heads
        self.nhd_min_seq = NHD_MIN_SEQ if nhd_min_seq is None else nhd_min_seq
        self.causal = causal
        self.sliding_window = None if sliding_window is None else tuple(sliding_window)
        self.qk_norm, self.differential, self.feat_scale = qk_norm, differential, feat_scale
        self.cross = dim_context is not None
        if self.cross:
            self.to_q = Linear(dim, dim * (2 if differential else 1), bias=False)
            self.to_kv = Linear(dim_context, dim_context * (3 if differential else 2), bias=False)
        else:
            self.to_qkv = Linear(dim, dim * (5 if differential else 3), bias=False)
        self.to_out = Linear(dim, dim, bias=False)
        if qk_norm in ("ln", "dyt"):
            norm = BiasedLayerNorm if qk_norm == "ln" else DynamicTanh
            self.q_norm, self.k_norm = norm(dim_heads), norm(dim_heads)
        if feat_scale:
            self.lambda_dc = nn.Parameter(torch.zeros(dim))
            self.lambda_hf = nn.Parameter(torch.zeros(dim))

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, _ = t.shape
        return t.view(b, n, -1, self.dim_heads).transpose(1, 2)

    def _norm(self, t: torch.Tensor, which: str) -> torch.Tensor:
        """The qk-norm of q or k (`which`) over t's last axis (the head dim)."""
        if self.qk_norm == "l2":
            return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
        if self.qk_norm == "none":
            return t
        return (self.q_norm if which == "q" else self.k_norm)(t)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        """to_out of out [B, N, dim], then the feature scaling."""
        out = self.to_out(out)
        if not self.feat_scale:
            return out
        dc = out.mean(dim=-2, keepdim=True)
        return (out + self.lambda_dc.to(out.dtype) * dc
                + self.lambda_hf.to(out.dtype) * (out - dc))

    def _merge_heads(self, out: torch.Tensor) -> torch.Tensor:
        b, _, n, _ = out.shape
        return self._project_out(out.transpose(1, 2).reshape(b, n, self.dim))

    @staticmethod
    def _repeat_kv(q, *kv):
        if kv[0].shape[1] != q.shape[1]:
            rep = q.shape[1] // kv[0].shape[1]
            kv = tuple(t.repeat_interleave(rep, dim=1) for t in kv)
        return kv

    def _forward_nhd(self, q, k, v, tables, prefix_len, causal) -> torch.Tensor:
        """q, k, v: [B, N, dim] views of the fused projection; tables: the
        rotary's (cos, sin) [N, rot_dim] or None. Nothing is transposed or
        made contiguous: the qk-norm and the rotary write new q and k, v
        stays a view, and the kernel reads each through its own strides."""
        b, n, _ = q.shape
        q, k, v = (t.view(b, n, -1, self.dim_heads) for t in (q, k, v))
        q, k = self._norm(q, "q"), self._norm(k, "k")
        if tables is not None:
            q, k = rotate_nhd(q, *tables), rotate_nhd(k, *tables)
        out = flash_attention_nhd(q, k, v, causal=causal, prefix_len=prefix_len)
        return self._project_out(out.view(b, n, self.dim))

    def _forward_fused(self, qkv, tables, causal) -> torch.Tensor:
        """qkv: the `to_qkv` output [B, N, 3 * dim], read by the kernel as it
        lies; the rotary tables cover all N rows, as `_forward_nhd`'s."""
        b, n, _ = qkv.shape
        out = flash_attention_fused_qkv(qkv, *tables, self.dim // self.dim_heads,
                                        causal=causal)
        return self._project_out(out.view(b, n, self.dim))

    def compute_kv(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split-head cross-attention K/V [B, H_kv, N_ctx, D] of a constant
        context, the keys qk-normed, projected once for every decode step
        (JAX `kv_only`)."""
        if self.differential:
            raise NotImplementedError("differential attention has no precomputed K/V "
                                      "(as in JAX)")
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self._norm(self._split_heads(k), "k"), self._split_heads(v)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                rotary_pos_emb: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                prefix_len: int = 0, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                precomputed_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """`rope_tables`: the rotary's cos / sin tables over this call's N
        rows, made once per forward by the caller (built here from
        `rotary_pos_emb` when absent); the cached decode rotates at its
        position instead."""
        # a single query row is never causal (JAX :645-646)
        causal = self.causal and x.shape[1] != 1
        if self.cross:
            return self._forward_cross(x, context, mask, precomputed_kv, causal)
        qkv = self.to_qkv(x)
        if cache is not None:
            if self.differential or self.feat_scale:
                raise NotImplementedError("the KV-cached decode takes no differential "
                                          "attention or feat_scale (as in JAX)")
            q, k, v = (self._split_heads(t) for t in qkv.chunk(3, dim=-1))
            q, k = self._norm(q, "q"), self._norm(k, "k")
            if rotary_pos_emb is not None:  # at the absolute cache position
                step = rotary_pos_emb[cache_index:cache_index + 1]
                q, k = apply_rotary_pos_emb(q, step), apply_rotary_pos_emb(k, step)
            return self._merge_heads(cached_decode_attention(q, k, v, cache, cache_index))
        tables = rope_tables
        if tables is None and rotary_pos_emb is not None:
            tables = rotary_tables(rotary_pos_emb[-x.shape[1]:])
        window = self.sliding_window
        if self.differential:
            parts = [self._split_heads(t) for t in qkv.chunk(5, dim=-1)]
            q, k, v, q_diff, k_diff = parts
            q, k = self._norm(q, "q"), self._norm(k, "k")
            if tables is not None:
                q, k, q_diff, k_diff = (rotate(t, *tables) for t in (q, k, q_diff, k_diff))
            out = attention_core(q, k, v, mask=mask, prefix_len=prefix_len, causal=causal,
                                 window=window)
            out = out - attention_core(q_diff, k_diff, v, mask=mask, prefix_len=prefix_len,
                                       causal=causal, window=window)
            return self._merge_heads(out)
        q, k, v = qkv.chunk(3, dim=-1)
        if (mask is None and window is None and self.dim_heads == HEAD_DIM
                and prefix_len <= MAX_PREFIX_NHD and not (causal and prefix_len)
                and x.shape[1] - prefix_len >= self.nhd_min_seq):
            if (tables is not None and self.qk_norm == "none" and self.training
                    and torch.is_grad_enabled()):
                return self._forward_fused(qkv, tables, causal)
            return self._forward_nhd(q, k, v, tables, prefix_len, causal)
        q, k, v = self._split_heads(q), self._split_heads(k), self._split_heads(v)
        q, k = self._norm(q, "q"), self._norm(k, "k")
        if tables is not None:
            q, k = rotate(q, *tables), rotate(k, *tables)
        out = attention_core(q, k, v, mask=mask, prefix_len=prefix_len, causal=causal,
                             window=window)
        return self._merge_heads(out)

    def _forward_cross(self, x, context, mask, precomputed_kv, causal) -> torch.Tensor:
        q = self.to_q(x)
        if self.differential:
            q, q_diff = (self._split_heads(t) for t in q.chunk(2, dim=-1))
            k, k_diff, v = (self._split_heads(t) for t in self.to_kv(context).chunk(3, dim=-1))
            q, k = self._norm(q, "q"), self._norm(k, "k")
            k, k_diff, v = self._repeat_kv(q, k, k_diff, v)
            out = (dot_product_attention(q, k, v, causal, None, mask)
                   - dot_product_attention(q_diff, k_diff, v, causal, None, mask))
            return self._merge_heads(out)
        q = self._norm(self._split_heads(q), "q")
        if precomputed_kv is not None:  # cached decode: causal=False, as JAX :460
            k, v = (t.to(q.dtype) for t in precomputed_kv)
            causal = False
        else:
            k, v = self.compute_kv(context)
        k, v = self._repeat_kv(q, k, v)
        return self._merge_heads(dot_product_attention(q, k, v, causal, None, mask))
