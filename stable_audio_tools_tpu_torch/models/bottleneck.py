"""Bottlenecks; counterpart of stable_audio_tools_tpu/models/bottleneck.py:
`VAEBottleneck` (`vae_sample` :103; the channel axis holds [mean | scale]),
`ResidualVQ` (:211, with its training state: k-means init, EMA codebook
update, dead-code revival) with `RVQBottleneck` (:364) and
`RVQVAEBottleneck` (:405, the VAE's sample then the RVQ), the projected
DAC quantizers `DACVectorQuantize` (:452) and `DACResidualVQ` (:487) under
`DACRVQBottleneck` (:534) and `DACRVQVAEBottleneck` (:601),
`TanhBottleneck` (:51), `SoftNormBottleneck` (:64), `WassersteinBottleneck`
(:138, with `compute_mmd` :125), `L2Bottleneck` (:168), and the finite
scalar quantizers `FSQBottleneck` (:696) and `DitheredFSQBottleneck` (:753)
over `FSQCore` (:664). Layout: [B, C, T]; the JAX package's is [B, T, C], so
its "time" axis 1 is the port's axis 2.

Every draw comes from the `generator` handed to `encode` or `decode`, or is
injected as `noise` (the tests replay the JAX package's): the VAE's and the
Wasserstein MMD's standard normals [B, C, T], the dithered FSQ's {"keep":
[B] bool, "dither": [B, C, T] uniform in [0, 1), "apply": [B] bool}. On the
decode side, `noise_augment_dim` (softnorm, Wasserstein, FSQ, DAC RVQ) joins
D standard-normal channels [B, D, T] after the latents (softnorm's scaled
by its `noise_scaling_factor`), and softnorm's `noise_regularize` adds, in
training, normals times each channel's standard deviation over time x 1e-2;
softnorm's `noise` is then a dict {"regularize": [B, C, T], "augment": [B,
D, T]}.

The FSQ rounding is the straight-through round half to even of
`jnp.round` and `torch.round` alike; indices are int64. `FSQBottleneck`
reports its codes [B, Q, T] and `decode_tokens` takes [B, Q, T] or [B, T, Q]
([B, Q, T] when ambiguous), as do the RVQs and the DAC RVQs (whose codes are
`info["codes"]`); `DitheredFSQBottleneck` reports and takes [B, T, Q], as the
JAX package's does.

The DAC quantizers compute in f32 whatever the input's dtype (the JAX
package's f32 Dense projections promote), their projections are weight-norm
1 x 1 convs under the reference's names (`quantizers.{i}.in_proj`,
`.out_proj`, `.codebook.weight`), run as products on [B, T, C]. The JAX
`DACResidualVQ` has a `quantizer_dropout` field that nothing reads (its
bottlenecks do not pass it and its call ignores it); the port's takes and
ignores it too."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import WNConv1d


def augment_noise(x: torch.Tensor, dim: int, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, C, T] with `dim` standard-normal channels [B, dim, T] joined
    after it (times `scale` [dim] where given): the decoders' noise
    augmentation (JAX :92-99, :158-164, :570-577, :733-739). `noise`
    replaces the draw."""
    if dim <= 0:
        return x
    if noise is None:
        noise = torch.randn((x.shape[0], dim, x.shape[2]), generator=generator,
                            device=x.device, dtype=x.dtype)
    noise = noise.to(device=x.device, dtype=x.dtype)
    if scale is not None:
        noise = scale.to(x.dtype)[:, None] * noise
    return torch.cat([x, noise], dim=1)


class TanhBottleneck(nn.Module):
    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def encode(self, x: torch.Tensor, return_info: bool = False, **_):
        x = torch.tanh(x / self.scale) * self.scale
        return (x, {}) if return_info else x

    def decode(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x


class SoftNormBottleneck(nn.Module):
    """x * scaling_factor + bias per channel; in training with `return_info`
    {"softnorm_loss": the mean over (item, channel) of mean^2 + var - log var
    - 1 over time, + 0.4 x the same over channels per (item, time), var
    clipped at 1e-4} (JAX :64; its trainer adds no loss module for it).
    `decode`: in training with `noise_regularize`, x plus normals times each
    channel's standard deviation over time x 1e-2; then `noise_augment_dim`
    normals times `noise_scaling_factor` joined (module note)."""

    def __init__(self, dim: int = 32, noise_augment_dim: int = 0,
                 noise_regularize: bool = False):
        super().__init__()
        self.scaling_factor = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.noise_augment_dim, self.noise_regularize = noise_augment_dim, noise_regularize
        self.noise_scaling_factor = (nn.Parameter(torch.ones(noise_augment_dim))
                                     if noise_augment_dim > 0 else None)

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False, **_):
        x = x * self.scaling_factor.to(x.dtype)[:, None] + self.bias.to(x.dtype)[:, None]
        info = {}
        if train and return_info:
            def kl(axis):
                var = x.var(dim=axis, correction=0).clamp(min=1e-4)
                mean = x.mean(dim=axis)
                return (mean * mean + var - torch.log(var) - 1).mean()

            info["softnorm_loss"] = kl(2) + 0.4 * kl(1)
        return (x, info) if return_info else x

    def decode(self, x: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, torch.Tensor]] = None, **_) -> torch.Tensor:
        noise = noise or {}
        if self.noise_regularize and train:
            reg = noise.get("regularize")
            if reg is None:
                reg = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + reg.to(device=x.device, dtype=x.dtype) * x.std(
                dim=2, keepdim=True, correction=0) * 1e-2
        return augment_noise(x, self.noise_augment_dim, generator, noise.get("augment"),
                             self.noise_scaling_factor)


def compute_mmd(latents: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """RBF-kernel MMD of latents [B, C, T] against `noise` [B, C, T] drawn
    from N(0, I) (JAX :125): the rows are the (item, time) pairs; the kernel
    exp(-mean_c (a - b)^2 / C), its means over every pair of rows (the mean
    square by |a|^2 + |b|^2 - 2 a.b: memory N^2, not N^2 C; in f32 whatever
    the latents' type, since that expansion cancels badly in bf16)."""
    C = latents.shape[1]
    z, n = (t.float().transpose(1, 2).reshape(-1, C) for t in (latents, noise))

    def mean_kernel(a, b):
        sq = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T).clamp(min=0)
        return torch.exp(-(sq / C) / C).mean()

    return mean_kernel(z, z) + mean_kernel(n, n) - 2 * mean_kernel(z, n)


class WassersteinBottleneck(nn.Module):
    """In training with `return_info` {"mmd": `compute_mmd` of x} (zero with
    `bypass_mmd`); then tanh(x / tanh_scale) * tanh_scale with `use_tanh`
    (JAX :138)."""

    def __init__(self, noise_augment_dim: int = 0, bypass_mmd: bool = False,
                 use_tanh: bool = False, tanh_scale: float = 5.0):
        super().__init__()
        self.noise_augment_dim = noise_augment_dim
        self.bypass_mmd, self.use_tanh, self.tanh_scale = bypass_mmd, use_tanh, tanh_scale

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, **_):
        info = {}
        if train and return_info:
            if self.bypass_mmd:
                info["mmd"] = x.new_zeros(())
            else:
                if noise is None:
                    noise = torch.randn(x.shape, generator=generator, device=x.device,
                                        dtype=x.dtype)
                info["mmd"] = compute_mmd(x, noise)
        if self.use_tanh:
            x = torch.tanh(x / self.tanh_scale) * self.tanh_scale
        return (x, info) if return_info else x

    def decode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        return augment_noise(x, self.noise_augment_dim, generator, noise)


class L2Bottleneck(nn.Module):
    """x over its channel norm (+ 1e-12), on the way in and out (JAX :168)."""

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)

    def encode(self, x: torch.Tensor, return_info: bool = False, **_):
        x = self._normalize(x)
        return (x, {}) if return_info else x

    def decode(self, x: torch.Tensor, **_) -> torch.Tensor:
        return self._normalize(x)


def _round_ste(z: torch.Tensor) -> torch.Tensor:
    return z + (torch.round(z) - z).detach()


class FSQCore:
    """The FSQ maths (JAX :664, scale 1): per dim d of a codebook, levels
    L_d, the code grid {-1 + 2 k / (L_d - 1)}; an index is the mixed-radix
    number of the grid positions (so the product of the levels must fit an
    int64)."""

    def __init__(self, levels: Sequence[int], num_codebooks: int = 1, scale: float = 1.0):
        self.levels = list(levels)
        self.num_codebooks, self.scale = num_codebooks, scale
        self.codebook_dim = len(self.levels)
        self.codebook_size = int(np.prod(np.asarray(self.levels, dtype=np.int64)))
        self._basis = [int(b) for b in np.cumprod([1] + self.levels[:-1], dtype=np.int64)]
        self.half_l = scale * 2.0 / (np.asarray(self.levels, dtype=np.float64) - 1)
        self.dim = self.codebook_dim * num_codebooks

    def bounded(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, Q * D, T] -> tanh(x) [B, T, Q, D] in f32, the codebooks split."""
        B, _, T = x.shape
        return torch.tanh(x.float().transpose(1, 2).reshape(B, T, self.num_codebooks,
                                                            self.codebook_dim))

    def _half_l(self, t: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.half_l, dtype=t.dtype, device=t.device)

    def scale_and_shift(self, z: torch.Tensor) -> torch.Tensor:
        return (z + self.scale) / self._half_l(z)

    def scale_and_shift_inverse(self, li: torch.Tensor) -> torch.Tensor:
        return li * self._half_l(li) - self.scale

    def quantize_det(self, z: torch.Tensor) -> torch.Tensor:
        return self.scale_and_shift_inverse(_round_ste(self.scale_and_shift(z)))

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        li = torch.round(self.scale_and_shift(zhat)).long()
        return (li * torch.tensor(self._basis, device=li.device)).sum(-1)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        basis = torch.tensor(self._basis, device=indices.device)
        levels = torch.tensor(self.levels, device=indices.device)
        li = torch.div(indices.long()[..., None], basis, rounding_mode="floor") % levels
        return self.scale_and_shift_inverse(li.float())


class FSQBottleneck(nn.Module):
    """FSQ (JAX :696): x [B, Q * D, T] in f32 through tanh, each codebook's
    D dims rounded to their grid (straight through), the codes back in x's
    dtype; info {"quantizer_indices": [B, Q, T]}."""

    is_discrete = True
    tokens_id = "quantizer_indices"

    def __init__(self, levels: Sequence[int] = (8, 5, 5, 5), num_codebooks: int = 1,
                 noise_augment_dim: int = 0):
        super().__init__()
        self.noise_augment_dim = noise_augment_dim
        self.core = FSQCore(levels, num_codebooks)
        self.num_quantizers = num_codebooks
        self.codebook_size = self.core.codebook_size

    def encode(self, x: torch.Tensor, return_info: bool = False, **_):
        codes = self.core.quantize_det(self.core.bounded(x))
        indices = self.core.codes_to_indices(codes).transpose(1, 2)  # [B, Q, T]
        out = codes.flatten(2).transpose(1, 2).to(x.dtype)
        return (out, {"quantizer_indices": indices}) if return_info else out

    def decode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        return augment_noise(x, self.noise_augment_dim, generator, noise)

    def decode_tokens(self, tokens: torch.Tensor, **kwargs) -> torch.Tensor:
        """tokens [B, Q, T] or [B, T, Q] -> codes [B, C, T] (f32), through
        `decode` (its noise augmentation; `kwargs` are decode's)."""
        if tokens.shape[1] == self.num_quantizers:
            tokens = tokens.transpose(1, 2)  # [B, Q, T] wins when ambiguous, as JAX
        return self.decode(self.core.indices_to_codes(tokens).flatten(2).transpose(1, 2),
                           **kwargs)


class DitheredFSQBottleneck(nn.Module):
    """Dithered FSQ (JAX :753): `levels` per dim (an int: the same for each
    of `dim` dims) in each of `num_codebooks` codebooks over x [B, C, T], C =
    dim x num_codebooks. In training each item keeps its unquantized tanh
    with probability `noise_dropout`, and (drawn apart) takes tanh + uniform
    dither of one grid step with probability `noise_dropout`, which wins;
    otherwise, and in eval, the rounded codes. info {"quantizer_indices":
    [B, T, Q]}, the rounded codes' indices. `dither_inference` is kept as a
    setting and, as in JAX, read nowhere."""

    is_discrete = True
    tokens_id = "quantizer_indices"

    def __init__(self, dim: int = 32, levels: Union[int, Sequence[int]] = 5,
                 num_codebooks: int = 1, dither_inference: bool = True,
                 noise_dropout: float = 0.05):
        super().__init__()
        levels = [levels] * dim if isinstance(levels, int) else list(levels)
        self.core = FSQCore(levels, num_codebooks)
        self.num_quantizers = num_codebooks
        self.codebook_size = self.core.codebook_size
        self.dither_inference, self.noise_dropout = dither_inference, noise_dropout

    def draws(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """A training pass's draws for x [B, C, T]."""
        B, dev = x.shape[0], x.device
        rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
        return {"keep": rand(B) < self.noise_dropout, "dither": rand(*x.shape),
                "apply": rand(B) < self.noise_dropout}

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, torch.Tensor]] = None, **_):
        B, C, T = x.shape
        z = self.core.bounded(x)
        quant = self.core.quantize_det(z)
        q = quant
        if train:
            d = self.draws(x, generator) if noise is None else noise
            view = lambda m: m.to(device=x.device, dtype=torch.bool).view(B, 1, 1, 1)
            q = torch.where(view(d["keep"]), z, quant)
            dither = d["dither"].to(device=x.device, dtype=z.dtype).transpose(1, 2).reshape(
                z.shape)
            q = torch.where(view(d["apply"]), z + (dither - 0.5) * self.core._half_l(z), q)
        indices = self.core.codes_to_indices(quant)
        out = q.flatten(2).transpose(1, 2).to(x.dtype)
        return (out, {"quantizer_indices": indices}) if return_info else out

    def decode(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x

    def decode_tokens(self, tokens: torch.Tensor, **_) -> torch.Tensor:
        """tokens [B, T, Q] -> codes [B, C, T] (f32)."""
        return self.decode(self.core.indices_to_codes(tokens).flatten(2).transpose(1, 2))


def vae_sample(x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean + stdev * noise, KL to N(0, 1)) of x [B, 2 C, T] = [mean |
    scale] (JAX `vae_sample` :103): stdev = softplus(scale) + 1e-4; `noise`
    [B, C, T] standard normal when given, else drawn from `generator`; the
    KL the sum over channels of mean^2 + var - log var - 1, averaged over
    batch and time, in f32."""
    mean, scale = x.chunk(2, dim=1)
    stdev = F.softplus(scale) + 1e-4
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    latents = noise.to(mean.dtype) * stdev + mean
    m, var = mean.float(), stdev.float() ** 2
    return latents, (m * m + var - torch.log(var) - 1).sum(dim=1).mean()


class VAEBottleneck(nn.Module):
    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, return_info: bool = False, **_):
        """`vae_sample` of x; with `return_info`, also {"kl": its KL}."""
        latents, kl = vae_sample(x, generator, noise)
        return (latents, {"kl": kl}) if return_info else latents

    def decode(self, x: torch.Tensor, **_) -> torch.Tensor:
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

    def quantize(self, x: torch.Tensor, info: dict, train: bool,
                 generator: Optional[torch.Generator],
                 revive_indices: Optional[torch.Tensor]) -> torch.Tensor:
        z, indices, loss = self.quantizer(x.transpose(1, 2), train=train, generator=generator,
                                          revive_indices=revive_indices)
        info.update(quantizer_indices=indices.transpose(1, 2), quantizer_loss=loss.mean())
        return z.transpose(1, 2)

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None,
               revive_indices: Optional[torch.Tensor] = None, **_):
        info = {}
        z = self.quantize(x, info, train, generator, revive_indices)
        return (z, info) if return_info else z

    def decode(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x

    def decode_tokens(self, codes: torch.Tensor, **_) -> torch.Tensor:
        """codes [B, Q, T] (or [B, T, Q]) -> latents [B, C, T]."""
        if codes.shape[1] == self.num_quantizers:
            codes = codes.transpose(1, 2)  # [B, Q, T] wins when ambiguous, as JAX
        return self.quantizer.get_outputs_from_indices(codes).transpose(1, 2)


class RVQVAEBottleneck(RVQBottleneck):
    """`vae_sample` of x [B, 2 dim, T], then the RVQ (JAX :405); info adds
    the VAE's "kl". The VAE's `noise` is injected as `VAEBottleneck`'s."""

    def encode(self, x: torch.Tensor, return_info: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               revive_indices: Optional[torch.Tensor] = None, **_):
        z, kl = vae_sample(x, generator, noise)
        info = {"kl": kl}
        z = self.quantize(z, info, train, generator, revive_indices)
        return (z, info) if return_info else z


class DACProjection(WNConv1d):
    """A weight-norm 1 x 1 conv (the reference's `in_proj` / `out_proj`
    names) applied as a product in f32 over the last axis of [..., C]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight_v.dtype)
        return F.linear(x.to(dtype), self.weight(dtype)[:, :, 0], self.bias.to(dtype))


class DACVectorQuantize(nn.Module):
    """One DAC stage (JAX :452) on z [B, T, C] in f32: z_e = in_proj(z);
    the code of z_e / (||z_e|| + 1e-12) against the codebook's rows
    normalised alike, by the largest dot product (the first on a tie); the
    straight-through z_e + (codeword - z_e).detach() through out_proj. The
    commitment loss is the mean of (z_e - codeword.detach())^2, the codebook
    loss the mean of (z_e.detach() - codeword)^2."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_proj = DACProjection(input_dim, codebook_dim)
        self.out_proj = DACProjection(codebook_dim, input_dim)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def forward(self, z: torch.Tensor):
        """-> (z_q [B, T, input_dim], commitment, codebook_loss, codes [B, T],
        z_e [B, T, codebook_dim])."""
        z_e = self.in_proj(z)
        cb = self.codebook.weight
        e = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-12)
        c = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-12)
        idx = (-(e @ c.T)).argmin(dim=-1)
        z_q = cb[idx]
        commitment = ((z_e - z_q.detach()) ** 2).mean()
        codebook_loss = ((z_e.detach() - z_q) ** 2).mean()
        z_q = z_e + (z_q - z_e).detach()
        return self.out_proj(z_q), commitment, codebook_loss, idx, z_e

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.codebook.weight[codes])


class DACResidualVQ(nn.Module):
    """`n_codebooks` DAC stages over the residual (JAX :487), each stage's
    output subtracted from it as it comes (not detached); `n_quantizers`
    zeroes the outputs of the stages from that index on (their codes and
    losses still count). `quantizer_dropout` is kept and read nowhere, as
    in JAX (module note)."""

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: int = 8, quantizer_dropout: float = 0.0):
        super().__init__()
        self.quantizer_dropout = quantizer_dropout
        self.quantizers = nn.ModuleList(DACVectorQuantize(input_dim, codebook_size, codebook_dim)
                                        for _ in range(n_codebooks))

    def forward(self, z: torch.Tensor, n_quantizers: Optional[int] = None):
        """z [B, T, C] -> (z_q f32, codes [B, T, Q], latents [B, T, Q x
        codebook_dim], the summed commitment and codebook losses)."""
        residual = z.to(torch.promote_types(z.dtype, torch.float32))
        z_q = torch.zeros_like(residual)
        commitment = codebook_loss = 0.0
        codes, latents = [], []
        for i, quantizer in enumerate(self.quantizers):
            z_q_i, commit_i, cb_i, idx_i, z_e_i = quantizer(residual)
            if n_quantizers is not None and i >= n_quantizers:
                z_q_i = z_q_i * 0.0
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            commitment = commitment + commit_i
            codebook_loss = codebook_loss + cb_i
            codes.append(idx_i)
            latents.append(z_e_i)
        return z_q, torch.stack(codes, -1), torch.cat(latents, -1), commitment, codebook_loss

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q] -> the summed projected codewords [B, T, C]."""
        return sum(q.from_codes(codes[..., i]) for i, q in enumerate(self.quantizers))


class DACRVQBottleneck(nn.Module):
    """The DAC residual VQ as a bottleneck (JAX :534). `encode` gives the
    quantized latents (f32) and, with `return_info`, {"pre_quantizer",
    "z", "codes" [B, Q, T], "latents", "vq/commitment_loss",
    "vq/codebook_loss"} (the losses over `n_codebooks`). With
    `quantize_on_decode` `encode` passes its input through (with
    `return_info` it still quantizes, for the codes and losses) and `decode`
    quantizes; `decode_quantized` (encode's info["z"]) and `decode_tokens`
    never quantize again. `decode` then joins `noise_augment_dim` noise
    channels."""

    is_discrete = True
    tokens_id = "codes"

    def __init__(self, input_dim: int = 32, n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: int = 8, quantize_on_decode: bool = False,
                 noise_augment_dim: int = 0):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.codebook_size = codebook_size
        self.quantize_on_decode, self.noise_augment_dim = quantize_on_decode, noise_augment_dim
        self.quantizer = DACResidualVQ(input_dim, n_codebooks, codebook_size, codebook_dim)

    def quantize(self, x: torch.Tensor, info: dict,
                 n_quantizers: Optional[int] = None) -> torch.Tensor:
        """x [B, C, T] -> z_q [B, C, T]; the codes and losses into `info`."""
        z, codes, latents, commitment, codebook_loss = self.quantizer(x.transpose(1, 2),
                                                                      n_quantizers)
        z = z.transpose(1, 2)
        info.update({"z": z, "codes": codes.transpose(1, 2), "latents": latents.transpose(1, 2),
                     "vq/commitment_loss": commitment / self.n_codebooks,
                     "vq/codebook_loss": codebook_loss / self.n_codebooks})
        return z

    def encode(self, x: torch.Tensor, return_info: bool = False,
               n_quantizers: Optional[int] = None, **_):
        info = {"pre_quantizer": x}
        if self.quantize_on_decode and not return_info:
            return x
        z = self.quantize(x, info, n_quantizers)
        if not return_info:
            return z
        return (x if self.quantize_on_decode else z), info

    def decode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        if self.quantize_on_decode:
            x = self.quantize(x, {})
        return augment_noise(x, self.noise_augment_dim, generator, noise)

    def decode_quantized(self, z_q: torch.Tensor, generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        return augment_noise(z_q, self.noise_augment_dim, generator, noise)

    def decode_tokens(self, codes: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        """codes [B, Q, T] (or [B, T, Q]) -> latents [B, C (+ noise), T]."""
        if codes.shape[1] == self.n_codebooks:
            codes = codes.transpose(1, 2)  # [B, Q, T] wins when ambiguous, as JAX
        return self.decode_quantized(self.quantizer.from_codes(codes).transpose(1, 2),
                                     generator, noise)


class DACRVQVAEBottleneck(DACRVQBottleneck):
    """`vae_sample` of x [B, 2 input_dim, T], then the DAC RVQ (JAX :601);
    info {"pre_quantizer": the sample, "kl", and, unless
    `quantize_on_decode` (then `encode` returns the sample and `decode`
    quantizes), the DAC RVQ's}. No noise augmentation."""

    def __init__(self, input_dim: int = 32, n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: int = 8, quantize_on_decode: bool = False):
        super().__init__(input_dim, n_codebooks, codebook_size, codebook_dim,
                         quantize_on_decode)

    def encode(self, x: torch.Tensor, return_info: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               n_quantizers: Optional[int] = None, **_):
        z, kl = vae_sample(x, generator, noise)
        info = {"pre_quantizer": z, "kl": kl}
        if not self.quantize_on_decode:
            z = self.quantize(z, info, n_quantizers)
        return (z, info) if return_info else z
