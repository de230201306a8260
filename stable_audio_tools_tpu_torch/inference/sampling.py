"""k-diffusion samplers as eager loops; counterpart of
stable_audio_tools_tpu/inference/sampling.py (get_sigmas_polyexponential :46,
make_v_denoiser :116, sample_dpmpp_2m :442, sample_dpmpp_3m_sde :508,
sample_k :678), and the training-time schedule and timestep transforms
(get_alphas_sigmas :33, DistributionShift :63, sample_timesteps_logsnr :91,
truncated_logistic_normal_rescaled :98).

Layout: [B, C, T]. The per-step noise of the SDE samplers comes from
`step_noise(i, shape)` when given (tests replay the JAX package's noise
through it), else from `torch.randn` with the `generator`. The other samplers
of the JAX package are later slices.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

# step_noise(i, x) -> standard normal noise for step i, shaped like x
StepNoise = Callable[[int, torch.Tensor], torch.Tensor]


def get_alphas_sigmas(t: torch.Tensor):
    """cos/sin schedule of v-diffusion (JAX sampling.py:33)."""
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


class DistributionShift:
    """Sequence-length-dependent timestep shift (JAX sampling.py:63)."""

    def __init__(self, base_shift: float = 0.5, max_shift: float = 1.15,
                 max_length: int = 4096, min_length: int = 256, use_sine: bool = False):
        self.base_shift = base_shift
        self.max_shift = max_shift
        self.max_length = max_length
        self.min_length = min_length
        self.use_sine = use_sine

    def time_shift(self, t: torch.Tensor, seq_len: int) -> torch.Tensor:
        seq_len = min(max(seq_len, self.min_length), self.max_length)
        mu = -(self.base_shift + (self.max_shift - self.base_shift)
               * (seq_len - self.min_length) / (self.max_length - self.min_length))
        t_out = 1 - math.exp(mu) / (math.exp(mu) + (1 / (1 - t) - 1))
        return torch.sin(t_out * math.pi / 2) if self.use_sine else t_out


def _normal(shape, generator, device, normal):
    if normal is not None:
        return normal.to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device)


def sample_timesteps_logsnr(batch_size: int, mean_logsnr: float = -1.2, std_logsnr: float = 2.0,
                            generator: Optional[torch.Generator] = None, device=None,
                            normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """t = sigmoid(-logsnr), logsnr ~ N(mean, std), clipped to [1e-4, 1 - 1e-4]
    (JAX sampling.py:91). `normal` replaces the standard normal draw."""
    logsnr = _normal((batch_size,), generator, device, normal) * std_logsnr + mean_logsnr
    return torch.sigmoid(-logsnr).clamp(1e-4, 1 - 1e-4)


def truncated_logistic_normal_rescaled(shape, left_trunc: float = 0.075,
                                       right_trunc: float = 1.0,
                                       generator: Optional[torch.Generator] = None,
                                       device=None,
                                       normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated logit-normal draw rescaled to [0, 1] (JAX sampling.py:98).
    `normal` replaces the standard normal draw."""
    def cdf(x):
        return 0.5 * (1 + torch.erf(x / math.sqrt(2)))

    def logit(p):
        return torch.tensor(math.log(p / (1 - p)))

    logits = _normal(shape, generator, device, normal)
    lower, upper = cdf(logit(left_trunc)), cdf(logit(right_trunc - 1e-7))
    truncated = lower + (upper - lower) * cdf(logits)
    samples = torch.sigmoid(math.sqrt(2) * torch.erfinv(2 * truncated - 1))
    return (samples - left_trunc) / (right_trunc - left_trunc)


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                               rho: float = 1.0) -> np.ndarray:
    """Polyexponential sigma schedule plus a trailing zero (f32, numpy)."""
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return np.append(sigmas, 0.0).astype(np.float32)


def make_v_denoiser(model_fn, sigma_data: float = 1.0):
    """v-model -> denoised(x, sigma) with t = atan(sigma) * 2 / pi."""

    def denoiser(x: torch.Tensor, sigma: float, **kwargs) -> torch.Tensor:
        s = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        c = s.view(-1, *([1] * (x.dim() - 1)))
        c_skip = sigma_data ** 2 / (c ** 2 + sigma_data ** 2)
        c_out = -c * sigma_data / torch.sqrt(c ** 2 + sigma_data ** 2)
        c_in = 1.0 / torch.sqrt(c ** 2 + sigma_data ** 2)
        t = torch.atan(s) / math.pi * 2
        return model_fn(x * c_in, t, **kwargs) * c_out + x * c_skip

    return denoiser


def _default_noise(generator: Optional[torch.Generator]) -> StepNoise:
    def draw(i: int, like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=like.dtype)
    return draw


def sample_dpmpp_2m(denoiser, x: torch.Tensor, sigmas: np.ndarray, **extra) -> torch.Tensor:
    """DPM-Solver++(2M), deterministic."""
    old = None
    n = len(sigmas) - 1
    for i in range(n):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma, **extra)
        if sigma_next == 0:
            return denoised
        h = math.log(sigma) - math.log(sigma_next)
        d = denoised
        if old is not None:
            r = (math.log(float(sigmas[i - 1])) - math.log(sigma)) / h
            d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old
        x = (sigma_next / sigma) * x - math.expm1(-h) * d
        old = denoised
    return x


def sample_dpmpp_3m_sde(denoiser, x: torch.Tensor, sigmas: np.ndarray, eta: float = 1.0,
                        s_noise: float = 1.0, generator: Optional[torch.Generator] = None,
                        step_noise: Optional[StepNoise] = None, **extra) -> torch.Tensor:
    """DPM-Solver++(3M) SDE. `step_noise(i, x)` returns step i's standard
    normal noise shaped like x (default: torch.randn from `generator`)."""
    draw = step_noise if step_noise is not None else _default_noise(generator)
    d1_prev = d2_prev = None
    h1_prev = h2_prev = None
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma, **extra)
        if sigma_next == 0:
            return denoised
        h = math.log(sigma) - math.log(sigma_next)
        h_eta = h * (eta + 1)
        x = math.exp(-h_eta) * x - math.expm1(-h_eta) * denoised
        phi_2 = math.expm1(-h_eta) / h_eta + 1
        if h2_prev is not None:
            phi_3 = phi_2 / h_eta - 0.5
            r0, r1 = h1_prev / h, h2_prev / h
            d1_0 = (denoised - d1_prev) / r0
            d1_1 = (d1_prev - d2_prev) / r1
            d1 = d1_0 + (d1_0 - d1_1) * r0 / (r0 + r1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            x = x + phi_2 * d1 - phi_3 * d2
        elif h1_prev is not None:
            x = x + phi_2 * (denoised - d1_prev) / (h1_prev / h)
        x = x + draw(i, x) * (sigma_next * math.sqrt(-math.expm1(-2 * h * eta)) * s_noise)
        d1_prev, d2_prev = denoised, d1_prev
        h1_prev, h2_prev = h, h1_prev
    return x


def sample_k(model_fn, noise: torch.Tensor, steps: int = 100,
             sampler_type: str = "dpmpp-3m-sde", sigma_min: float = 0.01,
             sigma_max: float = 100.0, rho: float = 1.0,
             generator: Optional[torch.Generator] = None,
             step_noise: Optional[StepNoise] = None, **extra) -> torch.Tensor:
    """Sample from `noise` (standard normal, [B, C, T]) with a v-model."""
    denoiser = make_v_denoiser(model_fn)
    sigmas = get_sigmas_polyexponential(steps, sigma_min, sigma_max, rho)
    x = noise * float(sigmas[0])
    if sampler_type == "dpmpp-2m":
        return sample_dpmpp_2m(denoiser, x, sigmas, **extra)
    if sampler_type == "dpmpp-3m-sde":
        return sample_dpmpp_3m_sde(denoiser, x, sigmas, generator=generator,
                                   step_noise=step_noise, **extra)
    raise NotImplementedError(f"sampler {sampler_type} is not ported yet")
