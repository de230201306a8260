"""Multi-codebook interleaving patterns for token LMs; counterpart of
stable_audio_tools_tpu/models/codebook_patterns.py.

A pattern is a static host-side index map [K, S] (t, or -1 for the special
token): `build_pattern_sequence` gathers codes [B, K, T] into the pattern
sequence [B, K, S], the two `revert_*` gather back to [.., K, T]. The port
keeps its own copy of the index maps (numpy), which the JAX package builds
the same way; the gathers are `torch.gather`. Providers: delay (MusicGen's,
the one on the LM path), parallel, unroll, coarse-first, MusicLM grouping.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch


class Pattern:
    """index_map: [K, S] int; entry t >= 0 reads codes[:, k, t], -1 reads the
    special token. Valid patterns reference each (k, t) at most once."""

    def __init__(self, index_map: np.ndarray, timesteps: int):
        self.index_map = np.asarray(index_map, np.int64)
        self.K, self.S = self.index_map.shape
        self.T = timesteps
        # reverse map: for each (k, t) the pattern step s (or -1 if absent)
        rev = np.full((self.K, self.T), -1, np.int64)
        for k in range(self.K):
            for s in range(self.S):
                t = self.index_map[k, s]
                if 0 <= t < self.T:
                    rev[k, t] = s
        self.reverse_map = rev

    @property
    def max_delay(self) -> int:
        return self.S - self.T

    def valid_layout_steps(self) -> np.ndarray:
        """[S] bool: pattern steps where every codebook reads a real token."""
        return (self.index_map >= 0).all(axis=0)

    @staticmethod
    def _gather(x: torch.Tensor, index: np.ndarray, size: int, special) -> tp.Tuple[
            torch.Tensor, torch.Tensor]:
        """x [..., K, L] gathered along L by index [K, size] (-1: `special`)."""
        idx = torch.from_numpy(index).to(x.device)
        mask = idx >= 0
        gather = idx.clamp(0, x.shape[-1] - 1).expand(*x.shape[:-2], x.shape[-2], size)
        out = torch.gather(x, -1, gather)
        fill = torch.as_tensor(special, dtype=x.dtype, device=x.device)
        return torch.where(mask, out, fill), mask

    def build_pattern_sequence(self, codes: torch.Tensor, special_token: int):
        """codes [B, K, T] -> (seq [B, K, S], indexes [K, S], mask [K, S])."""
        seq, mask = self._gather(codes, self.index_map, self.S, special_token)
        return seq, torch.from_numpy(self.index_map), mask

    def revert_pattern_sequence(self, seq: torch.Tensor, special_token: int):
        """seq [B, K, S] -> (codes [B, K, T], indexes [K, T], mask [K, T])."""
        codes, mask = self._gather(seq, self.reverse_map, self.T, special_token)
        return codes, torch.from_numpy(self.reverse_map), mask

    def revert_pattern_logits(self, logits: torch.Tensor, special_value: float = 0.0
                              ) -> torch.Tensor:
        """logits [B, card, K, S] -> [B, card, K, T]."""
        return self._gather(logits, self.reverse_map, self.T, special_value)[0]


class CodebooksPatternProvider:
    def __init__(self, n_q: int):
        self.n_q = n_q
        self._cache: tp.Dict[int, Pattern] = {}

    def get_pattern(self, timesteps: int) -> Pattern:
        if timesteps not in self._cache:
            self._cache[timesteps] = self._build(timesteps)
        return self._cache[timesteps]

    def _build(self, timesteps: int) -> Pattern:
        raise NotImplementedError


class DelayedPatternProvider(CodebooksPatternProvider):
    """Per-codebook delays, default [0, 1, ..., K-1] (MusicGen 'delay')."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.Sequence[int]] = None,
                 flatten_first: int = 0, empty_initial: int = 0):
        super().__init__(n_q)
        self.delays = list(delays) if delays is not None else list(range(n_q))
        if len(self.delays) != n_q:
            raise ValueError(f"{len(self.delays)} delays for {n_q} codebooks")
        self.empty_initial = empty_initial

    def _build(self, T: int) -> Pattern:
        S = T + max(self.delays) + self.empty_initial
        idx = np.full((self.n_q, S), -1, np.int64)
        for q, d in enumerate(self.delays):
            for s in range(S):
                t = s - d - self.empty_initial
                if 0 <= t < T:
                    idx[q, s] = t
        return Pattern(idx, T)


class ParallelPatternProvider(DelayedPatternProvider):
    def __init__(self, n_q: int):
        super().__init__(n_q, delays=[0] * n_q)


class UnrolledPatternProvider(CodebooksPatternProvider):
    """One codebook per step: S = T * K (audiocraft 'unroll' flattening)."""

    def __init__(self, n_q: int, flattening: tp.Optional[tp.Sequence[int]] = None,
                 delays: tp.Optional[tp.Sequence[int]] = None):
        super().__init__(n_q)
        self.flattening = list(flattening) if flattening is not None else list(range(n_q))
        self.delays = list(delays) if delays is not None else [0] * n_q

    def _build(self, T: int) -> Pattern:
        n_steps_per_t = max(self.flattening) + 1
        S = T * n_steps_per_t + max(self.delays)
        idx = np.full((self.n_q, S), -1, np.int64)
        for t in range(T):
            for q in range(self.n_q):
                s = t * n_steps_per_t + self.flattening[q] + self.delays[q]
                if s < S:
                    idx[q, s] = t
        return Pattern(idx, T)


class CoarseFirstPattern(CodebooksPatternProvider):
    """All coarse (q = 0) tokens first, then the rest with delays."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.Sequence[int]] = None):
        super().__init__(n_q)
        self.delays = list(delays) if delays is not None else [0] * (n_q - 1)

    def _build(self, T: int) -> Pattern:
        S = 2 * T + (max(self.delays) if self.delays else 0)
        idx = np.full((self.n_q, S), -1, np.int64)
        idx[0, :T] = np.arange(T)
        for qi, d in enumerate(self.delays):
            for t in range(T):
                if T + t + d < S:
                    idx[qi + 1, T + t + d] = t
        return Pattern(idx, T)


class MusicLMPattern(CodebooksPatternProvider):
    """Grouped flattening: groups of codebooks emitted sequentially."""

    def __init__(self, n_q: int, group_by: int = 2):
        super().__init__(n_q)
        self.group_by = group_by

    def _build(self, T: int) -> Pattern:
        n_groups = self.n_q // self.group_by
        idx = np.full((self.n_q, T * n_groups), -1, np.int64)
        for t in range(T):
            for q in range(self.n_q):
                idx[q, t * n_groups + q // self.group_by] = t
        return Pattern(idx, T)


def pattern_provider_from_config(config: tp.Dict[str, tp.Any], n_q: int
                                 ) -> CodebooksPatternProvider:
    p_type = config.get("type", "delay")
    cfg = config.get("config", {})
    if p_type in ("delay", "delayed"):
        return DelayedPatternProvider(n_q, **cfg)
    if p_type == "parallel":
        return ParallelPatternProvider(n_q)
    if p_type == "unroll":
        return UnrolledPatternProvider(n_q, **cfg)
    if p_type == "coarse_first":
        return CoarseFirstPattern(n_q, **cfg)
    if p_type == "musiclm":
        return MusicLMPattern(n_q, **cfg)
    raise ValueError(f"Unknown pattern type {p_type}")
