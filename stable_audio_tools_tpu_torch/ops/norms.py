"""Normalization layers (last-axis features); counterpart of
stable_audio_tools_tpu/ops/norms.py."""

from __future__ import annotations

import torch
from torch import nn

from .kernels.layer_norm import fused_layer_norm


class LayerNorm(nn.Module):
    """Bias-less LayerNorm with f32 statistics, cast back to the input dtype.

    CUDA inputs run the fused CUDA kernel (ops/kernels/layer_norm.py)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.gamma, None, self.eps)
