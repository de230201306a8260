"""Token sampling; counterpart of stable_audio_tools_tpu/models/utils.py
(`multinomial`, `sample_top_k`, `sample_top_p` :16-42).

The JAX functions draw from a `jax.random` key; these draw from an explicit
`torch.Generator` (the two give different numbers from one seed, so the
tests compare greedy decoding, top_k = 1, and the distributions). Each is the
same distribution as its JAX counterpart: `sample_top_k` keeps every
probability at or above the k-th largest (ties at the threshold may admit a
few more, as the JAX threshold form does) and renormalises.
"""

from __future__ import annotations

from typing import Optional

import torch


def multinomial(probs: torch.Tensor, num_samples: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Indices drawn from probs along the last axis: [..., card] -> [..., n]."""
    flat = probs.reshape(-1, probs.shape[-1]).float().clamp_min(1e-12)
    out = torch.multinomial(flat, num_samples, replacement=True, generator=generator)
    return out.reshape(*probs.shape[:-1], num_samples)


def sample_top_k(probs: torch.Tensor, k: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Top-k sampling: [..., card] -> [..., 1]."""
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    kept = torch.where(probs >= thresh, probs.float().clamp_min(1e-12), 0.0)
    flat = kept.reshape(-1, kept.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(*probs.shape[:-1], 1)


def sample_top_p(probs: torch.Tensor, p: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Nucleus sampling: the smallest prefix of the sorted probabilities
    whose mass before each kept token is at most p. [..., card] -> [..., 1]."""
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    sorted_probs = torch.where(cum - sorted_probs > p, 0.0, sorted_probs)
    sorted_probs = sorted_probs / sorted_probs.sum(-1, keepdim=True)
    return torch.gather(sorted_idx, -1, multinomial(sorted_probs, 1, generator))
