"""k-diffusion samplers as eager loops; counterpart of
stable_audio_tools_tpu/inference/sampling.py (get_sigmas_polyexponential :46,
make_v_denoiser :116, sample_dpmpp_2m :442, sample_dpmpp_3m_sde :508,
sample_k :678).

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
