"""Bottlenecks; counterpart of stable_audio_tools_tpu/models/bottleneck.py:
`VAEBottleneck` (`vae_sample` :103; the channel axis holds [mean | scale])
and, for a frozen codec, `ResidualVQ` (:211) with `RVQBottleneck` (:364).
The other bottlenecks are later slices. Layout: [B, C, T]."""

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


class ResidualVQ(nn.Module):
    """Residual VQ of a frozen codec (vector-quantize-pytorch semantics):
    each stage picks the nearest codeword (squared distance, the first on a
    tie) of the residual left by the stages before it. The codebooks
    [Q, card, dim] are a buffer (the JAX package's `quantizer_state`
    collection). The EMA codebook update, the k-means init and dead-code
    revival train the codec: they are not ported, and `train=True` raises."""

    def __init__(self, dim: int, codebook_size: int, num_quantizers: int):
        super().__init__()
        self.dim, self.codebook_size, self.num_quantizers = dim, codebook_size, num_quantizers
        self.register_buffer("codebooks", torch.randn(num_quantizers, codebook_size, dim))

    def forward(self, x: torch.Tensor, train: bool = False):
        """x [B, T, C] -> (quantized [B, T, C], indices [B, T, Q], the
        per-stage commitment losses [Q])."""
        if train:
            raise NotImplementedError("ResidualVQ: the EMA codebook update, k-means init and "
                                      "dead-code revival (codec training) are not ported")
        B, T, C = x.shape
        residual = x.reshape(-1, C)
        quantized = torch.zeros_like(residual)
        indices, losses = [], []
        for cb in self.codebooks.to(x.dtype):
            d = ((residual ** 2).sum(1, keepdim=True) - 2 * residual @ cb.T
                 + (cb ** 2).sum(1)[None])
            idx = d.argmin(dim=1)
            quant = cb[idx]
            losses.append(((residual - quant) ** 2).mean())
            quantized = quantized + quant
            residual = residual - quant
            indices.append(idx)
        return (quantized.reshape(B, T, C), torch.stack(indices, -1).reshape(B, T, -1),
                torch.stack(losses))

    def get_outputs_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, T, Q] -> summed codewords [B, T, C]."""
        return sum(self.codebooks[q][indices[..., q]] for q in range(self.num_quantizers))


class RVQBottleneck(nn.Module):
    """Discrete bottleneck over `ResidualVQ`: `encode` returns the quantized
    latents and, with `return_info`, {"quantizer_indices": [B, Q, T],
    "quantizer_loss"}; `decode_tokens` sums the codewords of codes [B, Q, T]
    (or [B, T, Q]). The training options of the JAX module (decay, k-means,
    dead-code threshold) are accepted with the config and not used."""

    is_discrete = True
    tokens_id = "quantizer_indices"

    def __init__(self, dim: int = 32, codebook_size: int = 1024, num_quantizers: int = 8,
                 **training_options):
        super().__init__()
        del training_options
        self.num_quantizers, self.codebook_size = num_quantizers, codebook_size
        self.quantizer = ResidualVQ(dim, codebook_size, num_quantizers)

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False, **_):
        z, indices, loss = self.quantizer(x.transpose(1, 2), train=train)
        z = z.transpose(1, 2)
        if not return_info:
            return z
        return z, {"quantizer_indices": indices.transpose(1, 2), "quantizer_loss": loss.mean()}

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode_tokens(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, Q, T] (or [B, T, Q]) -> latents [B, C, T]."""
        if codes.shape[1] == self.num_quantizers:
            codes = codes.transpose(1, 2)  # [B, Q, T] wins when ambiguous, as JAX
        return self.quantizer.get_outputs_from_indices(codes).transpose(1, 2)
