"""k-diffusion and v-DDIM samplers as eager loops; counterpart of
stable_audio_tools_tpu/inference/sampling.py (t_to_alpha_sigma :42,
get_sigmas_polyexponential :46, make_v_denoiser :116, the v-DDIM `sample`
:144, the k-diffusion family :300-657, sample_k :678), and the
training-time schedule and timestep transforms (get_alphas_sigmas :33,
DistributionShift :63, sample_timesteps_logsnr :91,
truncated_logistic_normal_rescaled :98).

Layout: [B, C, T] (the JAX package's scan carries [B, T, C], a TPU layout
matter that is not ported). The per-step noise of the stochastic samplers
comes from `step_noise(i, x)` when given (tests replay the JAX package's
noise through it), else from `torch.randn` with the `generator`. Where the JAX
scan computes both branches of a step and selects one (`jnp.where` on
sigma_next == 0), the loop here takes the one branch. The rectified-flow
family (`sample_rf`) is a later slice, and so is `v-ddim-cfgpp`: the JAX
package's cfg++ calls the model with `return_info=True`, which none of its
models accepts.
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


t_to_alpha_sigma = get_alphas_sigmas  # JAX sampling.py:42, the same schedule


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


def _to_d(x: torch.Tensor, sigma: float, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / sigma


def sample_heun(denoiser, x: torch.Tensor, sigmas: np.ndarray, **extra) -> torch.Tensor:
    """Heun's second-order method (Euler on the last step, to sigma = 0)."""
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        d = _to_d(x, sigma, denoiser(x, sigma, **extra))
        dt = sigma_next - sigma
        if sigma_next == 0:
            x = x + d * dt
        else:
            x_2 = x + d * dt
            d_2 = _to_d(x_2, sigma_next, denoiser(x_2, sigma_next, **extra))
            x = x + (d + d_2) / 2 * dt
    return x


def sample_dpm_2(denoiser, x: torch.Tensor, sigmas: np.ndarray, **extra) -> torch.Tensor:
    """DPM-Solver-2 (midpoint in log sigma; Euler on the last step)."""
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        d = _to_d(x, sigma, denoiser(x, sigma, **extra))
        if sigma_next == 0:
            x = x + d * (sigma_next - sigma)
        else:
            sigma_mid = math.exp((math.log(sigma) + math.log(sigma_next)) / 2)
            x_2 = x + d * (sigma_mid - sigma)
            d_2 = _to_d(x_2, sigma_mid, denoiser(x_2, sigma_mid, **extra))
            x = x + d_2 * (sigma_next - sigma)
    return x


def _lms_coeffs(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Linear-multistep coefficients [steps, order]: the integral over
    [sigma_i, sigma_{i+1}] of each Lagrange basis polynomial through the last
    min(i + 1, order) sigmas (scipy quad, epsrel 1e-4)."""
    from scipy import integrate

    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), dtype=np.float32)
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            def basis(tau, i=i, j=j, cur_order=cur_order):
                prod = 1.0
                for k in range(cur_order):
                    if k != j:
                        prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod

            coeffs[i, j] = integrate.quad(basis, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]
    return coeffs


def sample_lms(denoiser, x: torch.Tensor, sigmas: np.ndarray, order: int = 4,
               **extra) -> torch.Tensor:
    """Linear multistep over the last `order` derivatives."""
    coeffs = _lms_coeffs(np.asarray(sigmas, np.float64), order)
    ds = []  # newest first
    for i in range(len(sigmas) - 1):
        sigma = float(sigmas[i])
        ds = [_to_d(x, sigma, denoiser(x, sigma, **extra))] + ds[:order - 1]
        x = x + sum(float(c) * d for c, d in zip(coeffs[i], ds))
    return x


def _ancestral_step(sigma_from: float, sigma_to: float, eta: float = 1.0):
    sigma_up = min(sigma_to, eta * math.sqrt(sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2)
                                             / max(sigma_from ** 2, 1e-20)))
    return math.sqrt(max(sigma_to ** 2 - sigma_up ** 2, 0.0)), sigma_up


def sample_dpmpp_2s_ancestral(denoiser, x: torch.Tensor, sigmas: np.ndarray, eta: float = 1.0,
                              generator: Optional[torch.Generator] = None,
                              step_noise: Optional[StepNoise] = None, **extra) -> torch.Tensor:
    """DPM-Solver++(2S) with ancestral noise."""
    draw = step_noise if step_noise is not None else _default_noise(generator)
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma, **extra)
        sigma_down, sigma_up = _ancestral_step(sigma, sigma_next, eta)
        if sigma_down == 0:
            x = x + _to_d(x, sigma, denoised) * (sigma_down - sigma)
        else:
            t, t_next = -math.log(sigma), -math.log(sigma_down)
            h = t_next - t
            s_mid = t + 0.5 * h
            x_2 = (math.exp(-s_mid) / sigma) * x - math.expm1(-0.5 * h) * denoised
            denoised_2 = denoiser(x_2, math.exp(-s_mid), **extra)
            x = (sigma_down / sigma) * x - math.expm1(-h) * denoised_2
        if sigma_next > 0:
            x = x + draw(i, x) * sigma_up
    return x


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


def sample_dpmpp_2m_sde(denoiser, x: torch.Tensor, sigmas: np.ndarray, eta: float = 1.0,
                        s_noise: float = 1.0, generator: Optional[torch.Generator] = None,
                        step_noise: Optional[StepNoise] = None, solver_type: str = "midpoint",
                        **extra) -> torch.Tensor:
    """DPM-Solver++(2M) SDE, `midpoint` or `heun` correction."""
    draw = step_noise if step_noise is not None else _default_noise(generator)
    old, h_last = None, None
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma, **extra)
        if sigma_next == 0:
            return denoised
        h = math.log(sigma) - math.log(sigma_next)
        eta_h = eta * h
        x = sigma_next / sigma * math.exp(-eta_h) * x - math.expm1(-h - eta_h) * denoised
        if old is not None:
            r = h_last / h
            if solver_type == "midpoint":
                x = x + 0.5 * -math.expm1(-h - eta_h) * (1 / r) * (denoised - old)
            else:
                x = x + ((-math.expm1(-h - eta_h) / (-h - eta_h) + 1) * (1 / r)
                         * (denoised - old))
        x = x + draw(i, x) * (sigma_next * math.sqrt(max(-math.expm1(-2 * eta_h), 0.0))
                              * s_noise)
        old, h_last = denoised, h
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


def sample_dpm_fast(denoiser, x: torch.Tensor, sigma_min: float, sigma_max: float, n: int,
                    **extra) -> torch.Tensor:
    """DPM-Solver-fast: `n` model calls as steps of order 3 (and a last step
    of lower order) on a uniform grid of t = -log sigma, then a final
    denoising call at sigma_min."""
    m = n // 3 + 1
    ts = np.linspace(-math.log(sigma_max), -math.log(sigma_min), m + 1)
    orders = [3] * (m - 2) + [2, 1] if n % 3 == 0 else [3] * (m - 1) + [n % 3]
    sig = lambda t: math.exp(-t)
    eps_at = lambda x, t: _to_d(x, sig(t), denoiser(x, sig(t), **extra))
    for i, order in enumerate(orders):
        t, t_next = float(ts[i]), float(ts[i + 1])
        h = t_next - t
        eps = eps_at(x, t)
        if order == 1:
            x = x - sig(t_next) * math.expm1(h) * eps
        elif order == 2:
            s1 = t + h / 2
            eps_r1 = eps_at(x - sig(s1) * math.expm1(h / 2) * eps, s1)
            x = (x - sig(t_next) * math.expm1(h) * eps
                 - sig(t_next) * math.expm1(h) * (eps_r1 - eps))
        else:
            s1, s2 = t + h / 3, t + 2 * h / 3
            eps_r1 = eps_at(x - sig(s1) * math.expm1(h / 3) * eps, s1)
            u2 = (x - sig(s2) * math.expm1(2 * h / 3) * eps
                  - sig(s2) * 2.0 * (math.expm1(2 * h / 3) / (2 * h / 3) - 1) * (eps_r1 - eps))
            eps_r2 = eps_at(u2, s2)
            x = (x - sig(t_next) * math.expm1(h) * eps
                 - sig(t_next) * 1.5 * (math.expm1(h) / h - 1) * (eps_r2 - eps))
    return denoiser(x, sig(float(ts[-1])), **extra)


def sample_dpm_adaptive(denoiser, x: torch.Tensor, sigma_min: float, sigma_max: float,
                        rtol: float = 0.01, atol: float = 0.01, max_steps: int = 100,
                        **extra) -> torch.Tensor:
    """Adaptive DPM-Solver-2 with its order-1 estimate as the error gauge:
    a step is accepted when the scaled RMS difference is at most 1, and the
    step size follows 0.9 h error^-1/2 either way; at most `max_steps` tries,
    then a final denoising call at sigma_min. The error is read on the host
    each try, which the loop's control flow needs."""
    t, t_end = -math.log(sigma_max), -math.log(sigma_min)
    eps_at = lambda x, sigma: _to_d(x, sigma, denoiser(x, sigma, **extra))
    h = (t_end - t) / 10.0
    tries = 0
    while t < t_end - 1e-5 and tries < max_steps:
        h = min(h, t_end - t)
        t_next = t + h
        sig_t, sig_s1, sig_next = math.exp(-t), math.exp(-(t + h / 2)), math.exp(-t_next)
        eps = eps_at(x, sig_t)
        eps_r1 = eps_at(x - sig_s1 * math.expm1(h / 2) * eps, sig_s1)
        x_low = x - sig_next * math.expm1(h) * eps
        x_high = x_low - sig_next * math.expm1(h) * (eps_r1 - eps)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_high.abs()), min=atol)
        error = float(torch.sqrt(torch.mean(((x_low - x_high) / delta) ** 2)))
        if error <= 1.0:
            x, t = x_high, t_next
        h = min(max(0.9 * h * max(error, 1e-8) ** -0.5, 1e-4), t_end - t + 1e-8)
        tries += 1
    return denoiser(x, math.exp(-t_end), **extra)


def sample(model_fn, x: torch.Tensor, steps: int, eta: float = 0.0, sigma_max: float = 1.0,
           generator: Optional[torch.Generator] = None, step_noise: Optional[StepNoise] = None,
           **extra) -> torch.Tensor:
    """v-diffusion DDIM from x at t = sigma_max down `steps` even steps of t;
    returns the last step's prediction of the clean signal. With `eta` > 0
    each step but the last adds noise (`step_noise(i, x)`, else the
    generator's) of the DDIM sigma."""
    t = np.linspace(sigma_max, 0, steps + 1)[:-1].astype(np.float32)
    alphas = np.cos(t * math.pi / 2).astype(np.float32)
    sigmas = np.sin(t * math.pi / 2).astype(np.float32)
    draw = step_noise if step_noise is not None else _default_noise(generator)
    ts = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    pred = torch.zeros_like(x)
    for i in range(steps):
        alpha, sigma = float(alphas[i]), float(sigmas[i])
        v = model_fn(x, ts * float(t[i]), **extra)
        pred = x * alpha - v * sigma
        if i == steps - 1:
            break
        eps = x * sigma + v * alpha
        alpha_n, sigma_n = float(alphas[i + 1]), float(sigmas[i + 1])
        ddim_sigma = eta * math.sqrt(sigma_n ** 2 / max(sigma ** 2, 1e-20)) * math.sqrt(
            max(1 - alpha ** 2 / max(alpha_n ** 2, 1e-20), 0.0))
        x = pred * alpha_n + eps * math.sqrt(max(sigma_n ** 2 - ddim_sigma ** 2, 0.0))
        if eta:
            x = x + draw(i, x) * ddim_sigma
    return pred


K_DIFFUSION_SAMPLERS = ("k-heun", "k-lms", "k-dpmpp-2s-ancestral", "k-dpm-2", "k-dpm-fast",
                        "k-dpm-adaptive", "dpmpp-2m-sde", "dpmpp-3m-sde", "dpmpp-2m")
# samplers of the JAX package's sample_k and sample_rf that are not ported yet
UNPORTED_SAMPLERS = ("v-ddim-cfgpp", "euler", "rk4", "dpmpp", "pingpong")


def sample_k(model_fn, noise: torch.Tensor, init_data: Optional[torch.Tensor] = None,
             steps: int = 100, sampler_type: str = "dpmpp-3m-sde", sigma_min: float = 0.01,
             sigma_max: float = 100.0, rho: float = 1.0,
             generator: Optional[torch.Generator] = None,
             step_noise: Optional[StepNoise] = None, **extra) -> torch.Tensor:
    """Sample from `noise` (standard normal, [B, C, T]) with a v-model;
    `init_data` (latents to vary) is added to the scaled noise. `v-ddim`
    starts at t = min(sigma_max, 1) and ignores sigma_min and rho, as the
    JAX package does."""
    if sampler_type == "v-ddim-cfgpp":
        raise NotImplementedError("sampler v-ddim-cfgpp is not ported: the JAX package's cfg++ "
                                  "calls the model with return_info=True, which none of its "
                                  "models accepts")
    if sampler_type in UNPORTED_SAMPLERS:
        raise NotImplementedError(f"sampler {sampler_type} is not ported yet")
    if sampler_type == "v-ddim":
        sigma_max = min(sigma_max, 1.0)
        x = noise
        if init_data is not None:
            alpha, sigma = t_to_alpha_sigma(torch.tensor(sigma_max, dtype=torch.float32))
            x = init_data * alpha.item() + noise * sigma.item()
        return sample(model_fn, x, steps, eta=0.0, sigma_max=sigma_max, generator=generator,
                      step_noise=step_noise, **extra)
    if sampler_type not in K_DIFFUSION_SAMPLERS:
        raise ValueError(f"Unknown sampler type {sampler_type}")
    denoiser = make_v_denoiser(model_fn)
    sigmas = get_sigmas_polyexponential(steps, sigma_min, sigma_max, rho)
    x = noise * float(sigmas[0])
    if init_data is not None:
        x = init_data + x
    rand = dict(generator=generator, step_noise=step_noise)
    if sampler_type == "k-heun":
        return sample_heun(denoiser, x, sigmas, **extra)
    if sampler_type == "k-lms":
        return sample_lms(denoiser, x, sigmas, **extra)
    if sampler_type == "k-dpmpp-2s-ancestral":
        return sample_dpmpp_2s_ancestral(denoiser, x, sigmas, **rand, **extra)
    if sampler_type == "k-dpm-2":
        return sample_dpm_2(denoiser, x, sigmas, **extra)
    if sampler_type == "k-dpm-fast":
        return sample_dpm_fast(denoiser, x, sigma_min, sigma_max, steps, **extra)
    if sampler_type == "k-dpm-adaptive":
        return sample_dpm_adaptive(denoiser, x, sigma_min, sigma_max, **extra)
    if sampler_type == "dpmpp-2m":
        return sample_dpmpp_2m(denoiser, x, sigmas, **extra)
    if sampler_type == "dpmpp-2m-sde":
        return sample_dpmpp_2m_sde(denoiser, x, sigmas, **rand, **extra)
    return sample_dpmpp_3m_sde(denoiser, x, sigmas, **rand, **extra)
