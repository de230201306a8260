"""Bottlenecks; counterpart of stable_audio_tools_tpu/models/bottleneck.py:
`VAEBottleneck` (`vae_sample` :103; the channel axis holds [mean | scale])
and `ResidualVQ` (:211, with its training state: k-means init, EMA codebook
update, dead-code revival) with `RVQBottleneck` (:364). The other
bottlenecks are later slices. Layout: [B, C, T]."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class VAEBottleneck(nn.Module):
    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, return_info: bool = False, **_):
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


def kmeans(data: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Lloyd k-means of data [N, C] into k centers [k, C] (JAX `_kmeans`
    :184): seeded with the rows at round(linspace(0, N - 1, k)) (an even
    stride over the batch; with N < k rows repeat), `iters` iterations of
    nearest-center assignment (squared distance, the first on a tie) and
    means; an empty cluster keeps its center."""
    n = data.shape[0]
    sel = torch.round(torch.arange(k, dtype=torch.float64) * ((n - 1) / max(k - 1, 1)))
    centers = data[sel.long().to(data.device)]
    for _ in range(iters):
        d = ((data ** 2).sum(1, keepdim=True) - 2 * data @ centers.T
             + (centers ** 2).sum(1)[None])
        assign = d.argmin(dim=1)
        counts = torch.bincount(assign, minlength=k).to(data.dtype)
        sums = torch.zeros_like(centers).index_add_(0, assign, data)
        centers = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], centers)
    return centers


class ResidualVQ(nn.Module):
    """Residual VQ (vector-quantize-pytorch semantics; JAX `ResidualVQ`
    :211): each stage picks the nearest codeword (squared distance, the
    first on a tie) of the residual the stages before it left.

    State (buffers, the JAX package's `quantizer_state` collection; no
    optimizer or parameter EMA touches them, checkpoints carry them):
    `codebooks` [Q, K, C], the EMA trackers `ema_counts` [Q, K] and
    `ema_sums` [Q, K, C], and `initted` (False until the first training pass
    when `kmeans_init`).

    With `train` the pass also updates the state, each stage from its own
    residual (JAX :255-329): on the first pass with `kmeans_init` the
    stage's codebook is first replaced by `kmeans_iters` of Lloyd k-means of
    the (detached) residual and its trackers restart from it; then the EMA
    of the code counts and sums (`decay`), the codebook as the sums over the
    counts smoothed by `eps`, and, with `threshold_ema_dead_code` > 0, every
    code whose count fell below it re-seeded from a random residual row
    (indices drawn from `generator`, or `revive_indices` [Q, K] given). The
    pass quantizes with the codebook it started from (the k-means one on
    the first pass); the update takes effect on the next. Each stage's
    commitment loss is the mean squared distance of its residual to the
    (detached) codeword, times `commitment_weight`; the output is the
    straight-through sum residual + (codeword - residual).detach()."""

    def __init__(self, dim: int, codebook_size: int, num_quantizers: int, decay: float = 0.99,
                 commitment_weight: float = 1.0, eps: float = 1e-5, kmeans_init: bool = False,
                 kmeans_iters: int = 10, threshold_ema_dead_code: float = 0.0):
        super().__init__()
        self.dim, self.codebook_size, self.num_quantizers = dim, codebook_size, num_quantizers
        self.decay, self.commitment_weight, self.eps = decay, commitment_weight, eps
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.threshold_ema_dead_code = threshold_ema_dead_code
        codebooks = torch.randn(num_quantizers, codebook_size, dim)
        self.register_buffer("codebooks", codebooks)
        self.register_buffer("ema_counts", torch.ones(num_quantizers, codebook_size))
        self.register_buffer("ema_sums", codebooks.clone())
        self.register_buffer("initted", torch.tensor(not kmeans_init))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                revive_indices: Optional[torch.Tensor] = None):
        """x [B, T, C] -> (quantized [B, T, C], indices [B, T, Q], the
        per-stage commitment losses [Q]); `train` updates the state."""
        B, T, C = x.shape
        K = self.codebook_size
        residual = x.reshape(-1, C)
        quantized = torch.zeros_like(residual)
        indices, losses, new_state = [], [], []
        initted = bool(self.initted) if train else True
        for q in range(self.num_quantizers):
            cb = self.codebooks[q].to(x.dtype)
            with torch.no_grad():
                r = residual.detach()
                if train and self.kmeans_init and not initted:
                    cb = kmeans(r, K, self.kmeans_iters)
                d = (r ** 2).sum(1, keepdim=True) - 2 * r @ cb.T + (cb ** 2).sum(1)[None]
                idx = d.argmin(dim=1)
                quant = cb[idx]
                if train:
                    new_state.append(self._ema_update(q, r, idx, cb, initted, generator,
                                                      revive_indices))
            losses.append(((residual - quant) ** 2).mean() * self.commitment_weight)
            quantized = quantized + (residual + (quant - residual).detach())
            residual = residual - quant
            indices.append(idx)
        if train:
            with torch.no_grad():
                for name, value in zip(("codebooks", "ema_counts", "ema_sums"), zip(*new_state)):
                    getattr(self, name).copy_(torch.stack(value))
                self.initted.fill_(True)
        return (quantized.reshape(B, T, C), torch.stack(indices, -1).reshape(B, T, -1),
                torch.stack(losses))

    def _ema_update(self, q, r, idx, cb, initted, generator, revive_indices):
        """(codebook, counts, sums) of stage q after this pass."""
        K = self.codebook_size
        counts = torch.bincount(idx, minlength=K).to(r.dtype)
        sums = torch.zeros_like(cb).index_add_(0, idx, r)
        prev_counts = self.ema_counts[q] if initted else torch.ones_like(counts)
        prev_sums = self.ema_sums[q] if initted else cb
        c_new = prev_counts * self.decay + counts * (1 - self.decay)
        s_new = prev_sums * self.decay + sums * (1 - self.decay)
        n = c_new.sum()
        smoothed = (c_new + self.eps) / (n + K * self.eps) * n
        cb_new = s_new / smoothed[:, None]
        if self.threshold_ema_dead_code > 0:
            if revive_indices is not None:
                sel = revive_indices[q].to(device=r.device, dtype=torch.long)
            else:
                sel = torch.randint(0, r.shape[0], (K,), generator=generator, device=r.device)
            samples = r[sel]
            dead = c_new < self.threshold_ema_dead_code
            cb_new = torch.where(dead[:, None], samples, cb_new)
            c_new = torch.where(dead, torch.full_like(c_new, self.threshold_ema_dead_code), c_new)
            s_new = torch.where(dead[:, None], samples * self.threshold_ema_dead_code, s_new)
        return cb_new, c_new, s_new

    def get_outputs_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, T, Q] -> summed codewords [B, T, C]."""
        return sum(self.codebooks[q][indices[..., q]] for q in range(self.num_quantizers))


class RVQBottleneck(nn.Module):
    """Discrete bottleneck over `ResidualVQ` (JAX :364): `encode` returns the
    quantized latents and, with `return_info`, {"quantizer_indices": [B, Q,
    T], "quantizer_loss": the mean of the stages' commitment losses};
    `train` updates the quantizer's state; `decode_tokens` sums the
    codewords of codes [B, Q, T] (or [B, T, Q])."""

    is_discrete = True
    tokens_id = "quantizer_indices"

    def __init__(self, dim: int = 32, codebook_size: int = 1024, num_quantizers: int = 8,
                 kmeans_init: bool = True, kmeans_iters: int = 50, decay: float = 0.99,
                 threshold_ema_dead_code: float = 0.0):
        super().__init__()
        self.num_quantizers, self.codebook_size = num_quantizers, codebook_size
        self.quantizer = ResidualVQ(dim, codebook_size, num_quantizers, decay=decay,
                                    kmeans_init=kmeans_init, kmeans_iters=kmeans_iters,
                                    threshold_ema_dead_code=threshold_ema_dead_code)

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None,
               revive_indices: Optional[torch.Tensor] = None, **_):
        z, indices, loss = self.quantizer(x.transpose(1, 2), train=train, generator=generator,
                                          revive_indices=revive_indices)
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
