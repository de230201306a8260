"""Timestep and rotary embeddings; counterpart of
stable_audio_tools_tpu/ops/embeddings.py."""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn


class FourierFeatures(nn.Module):
    """[..., in] -> [..., out] = [cos(2 pi x W^T), sin(2 pi x W^T)], f32 inside."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_features // 2, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = 2 * math.pi * (x.float() @ self.weight.float().T)
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1).to(x.dtype)


def rotary_freqs(seq_len: int, rot_dim: int, device=None) -> torch.Tensor:
    """[seq_len, rot_dim] rotary angle table in f32, base 10000 (freqs
    repeated over the two halves)."""
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                            device=device) / rot_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def rotary_tables(freqs: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [N, rot_dim] in f32 of a `rotary_freqs` angle table, the
    operands of `flash_attention_fused_qkv`."""
    freqs = freqs.float()
    return torch.cos(freqs).contiguous(), torch.sin(freqs).contiguous()


class RotaryEmbedding(nn.Module):
    """Parameter-free rotary table generator (rotates the first `dim` dims)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, seq_len: int, device=None) -> torch.Tensor:
        return rotary_freqs(seq_len, self.dim, device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split partial rotary over t [..., N, dim_head] with the tables
    cos, sin [N, rot_dim] f32 of `rotary_tables` (or views that broadcast
    against t's first rot_dim columns): those columns rotate in f32 and round
    to t's dtype, the rest pass through (JAX ops/embeddings.py
    `apply_rotary_pos_emb` and `_fused_unpack_rope`)."""
    rot_dim = cos.shape[-1]
    tf = t.float()
    t_rot, t_pass = tf[..., :rot_dim], tf[..., rot_dim:]
    t_rot = t_rot * cos + _rotate_half(t_rot) * sin
    return torch.cat([t_rot, t_pass], dim=-1).to(t.dtype)


def rotate_nhd(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """`rotate` over t [B, N, H, dim_head] (sequence on axis 1): the tables
    broadcast over the head axis (JAX ops/embeddings.py:74)."""
    return rotate(t, cos[:, None, :], sin[:, None, :])


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """`rotate` over t [..., seq, dim_head] with the tables of the last seq
    rows of the angle table freqs; the first freqs.shape[-1] dims rotate."""
    return rotate(t, *rotary_tables(freqs[-t.shape[-2]:]))


def apply_rotary_pos_emb_nhd(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """`rotate_nhd` with the tables of the last N rows of the angle table
    freqs (sequence on axis 1 of t)."""
    return rotate_nhd(t, *rotary_tables(freqs[-t.shape[1]:]))
