"""VAE bottleneck; counterpart of stable_audio_tools_tpu/models/bottleneck.py
(`VAEBottleneck`, `vae_sample` :103). The other bottlenecks are later slices.
Layout: [B, C, T]; the channel axis holds [mean | scale]."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class VAEBottleneck(nn.Module):
    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, return_info: bool = False):
        """Sample mean + stdev * noise; `noise` [B, C/2, T] standard normal
        when given (tests replay the JAX package's), else drawn from
        `generator`. With `return_info`, also {"kl": KL to N(0, 1)}: the sum
        over channels of mean^2 + var - log var - 1, averaged over batch and
        time, in f32."""
        mean, scale = x.chunk(2, dim=1)
        stdev = F.softplus(scale) + 1e-4
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        latents = noise.to(mean.dtype) * stdev + mean
        if not return_info:
            return latents
        m, var = mean.float(), stdev.float() ** 2
        kl = (m * m + var - torch.log(var) - 1).sum(dim=1).mean()
        return latents, {"kl": kl}

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x
