"""Activations; counterpart of stable_audio_tools_tpu/ops/activations.py.

SnakeBeta: snake_beta(x, a, b) = x + sin^2(a x) / (b + 1e-9), per channel,
with log-scale parameters (alpha = exp(log_alpha)). The maths is exact sin in
f32, as in the JAX package's CPU path; the TPU's fast-sin^2 polynomial is not
ported. Layout: [B, C, T], channels before time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .kernels.snake import snake_fused


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, T]; alpha, beta [C] (post-exp). CUDA inputs run the fused
    CUDA kernels forward and backward (ops/kernels/snake.py, csrc/snake.cu)."""
    return snake_fused(x, alpha, beta)


class SnakeBeta(nn.Module):
    """Per-channel snake-beta with log-scale alpha/beta (reference parameter
    names `alpha`, `beta`; zeros at init, so alpha = beta = 1)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def params(self, dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Post-exp (alpha, beta) in f32, rounded through `dtype` when given
        (the JAX package casts them to the activation dtype)."""
        a, b = torch.exp(self.alpha.float()), torch.exp(self.beta.float())
        if dtype is not None:
            a, b = a.to(dtype).float(), b.to(dtype).float()
        return a, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake_beta(x, *self.params(x.dtype))
