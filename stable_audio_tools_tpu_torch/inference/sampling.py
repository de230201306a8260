"""Samplers as eager loops; counterpart of
stable_audio_tools_tpu/inference/sampling.py (t_to_alpha_sigma :42,
get_sigmas_polyexponential :46, get_rf_schedule :53, make_v_denoiser :116,
the v-DDIM `sample` :144, the rectified-flow samplers :193-288, the
k-diffusion family :300-657, sample_k :678, sample_rf :775), and the
training-time schedule and timestep transforms (get_alphas_sigmas :33,
DistributionShift :63, sample_timesteps_logsnr :91,
truncated_logistic_normal_rescaled :98).

Layout: [B, C, T] (the JAX package's k-diffusion scan carries [B, T, C], a
TPU layout matter that is not ported). The per-step noise of the stochastic
samplers comes from `step_noise(i, x)` when given (tests replay the JAX
package's noise through it), else from `torch.randn` with the `generator`.
Where the JAX scan computes both branches of a step and selects one
(`jnp.where` on sigma_next == 0), the loop here takes the one branch.

`denoised_tap(denoised, sigma)` is called with each model call's estimate of
the clean latents and its sigma, as the JAX package's preview taps
(`_wrap_denoised_tap` :599 and the taps in sample_k / sample_rf): the
k-diffusion denoiser's output at its sigma, v-DDIM's x·alpha - v·sigma at
sigma = tan(min(t, 0.9999)·pi/2), rectified flow's x - v·t at t.

`v-ddim-cfgpp` calls the model with `return_info=True` and takes its
`uncond_output` for the step's noise estimate; only the DiT answers that
call (generation refuses the other models, as the JAX package cannot run
them either).
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

    def time_shift(self, t, seq_len: int):
        """t: a torch tensor (training) or a numpy schedule (sampling), whose
        t = 1 maps to 1 (the division by zero is silenced, as in JAX)."""
        seq_len = min(max(seq_len, self.min_length), self.max_length)
        mu = -(self.base_shift + (self.max_shift - self.base_shift)
               * (seq_len - self.min_length) / (self.max_length - self.min_length))
        with np.errstate(divide="ignore"):
            t_out = 1 - math.exp(mu) / (math.exp(mu) + (1 / (1 - t) - 1))
        if not self.use_sine:
            return t_out
        return np.sin(t_out * math.pi / 2) if isinstance(t, np.ndarray) else torch.sin(
            t_out * math.pi / 2)


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


def get_rf_schedule(steps: int, sigma_max: float = 1.0) -> np.ndarray:
    """Rectified flow's t grid (f32, numpy): sigmoid(-logsnr) over logsnr
    evenly spaced from log((1 - sigma_max) / sigma_max + 1e-6) (-6 at
    sigma_max = 1) to 2, with t[0] = sigma_max and t[-1] = 0."""
    logsnr_max = math.log((1 - sigma_max) / sigma_max + 1e-6) if sigma_max < 1 else -6.0
    t = 1.0 / (1.0 + np.exp(np.linspace(logsnr_max, 2, steps + 1)))
    t[0], t[-1] = sigma_max, 0.0
    return t.astype(np.float32)


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
           cfg_pp: bool = False, **extra) -> torch.Tensor:
    """v-diffusion DDIM from x at t = sigma_max down `steps` even steps of t;
    returns the last step's prediction of the clean signal. With `eta` > 0
    each step but the last adds noise (`step_noise(i, x)`, else the
    generator's) of the DDIM sigma. `cfg_pp` (CFG++) takes the step's noise
    estimate from the model's unguided output (`return_info=True`, its
    `uncond_output`; the guided output where there is none)."""
    t = np.linspace(sigma_max, 0, steps + 1)[:-1].astype(np.float32)
    alphas = np.cos(t * math.pi / 2).astype(np.float32)
    sigmas = np.sin(t * math.pi / 2).astype(np.float32)
    draw = step_noise if step_noise is not None else _default_noise(generator)
    ts = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    pred = torch.zeros_like(x)
    for i in range(steps):
        alpha, sigma = float(alphas[i]), float(sigmas[i])
        if cfg_pp:
            v, info = model_fn(x, ts * float(t[i]), return_info=True, **extra)
            v_eps = info.get("uncond_output", v)
        else:
            v = v_eps = model_fn(x, ts * float(t[i]), **extra)
        pred = x * alpha - v * sigma
        if i == steps - 1:
            break
        eps = x * sigma + v_eps * alpha
        alpha_n, sigma_n = float(alphas[i + 1]), float(sigmas[i + 1])
        ddim_sigma = eta * math.sqrt(sigma_n ** 2 / max(sigma ** 2, 1e-20)) * math.sqrt(
            max(1 - alpha ** 2 / max(alpha_n ** 2, 1e-20), 0.0))
        x = pred * alpha_n + eps * math.sqrt(max(sigma_n ** 2 - ddim_sigma ** 2, 0.0))
        if eta:
            x = x + draw(i, x) * ddim_sigma
    return pred


# -- rectified flow: x_t = (1 - t) x_0 + t noise, the model predicts v = noise - x_0


def _flow_schedule(x: torch.Tensor, steps: Optional[int], sigma_max: float,
                   sigmas: Optional[np.ndarray], dist_shift: Optional[DistributionShift]
                   ) -> np.ndarray:
    """The given schedule, else t evenly from sigma_max to 0 in `steps`,
    shifted by `dist_shift` for x's length (JAX reads dist_shift only then)."""
    if sigmas is None:
        sigmas = np.linspace(sigma_max, 0, steps + 1).astype(np.float32)
        if dist_shift is not None:
            sigmas = dist_shift.time_shift(sigmas, x.shape[-1])
    return np.asarray(sigmas, dtype=np.float32)


def sample_discrete_euler(model_fn, x: torch.Tensor, steps: Optional[int] = None,
                          sigma_max: float = 1.0, sigmas: Optional[np.ndarray] = None,
                          dist_shift: Optional[DistributionShift] = None,
                          **extra) -> torch.Tensor:
    """Euler over the flow's t grid: x += (t_next - t) v."""
    t = _flow_schedule(x, steps, sigma_max, sigmas, dist_shift)
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for i in range(len(t) - 1):
        t_curr, t_next = float(t[i]), float(t[i + 1])
        x = x + (t_next - t_curr) * model_fn(x, t_curr * ones, **extra)
    return x


def sample_rk4(model_fn, x: torch.Tensor, steps: Optional[int] = None, sigma_max: float = 1.0,
               sigmas: Optional[np.ndarray] = None,
               dist_shift: Optional[DistributionShift] = None, **extra) -> torch.Tensor:
    """Classical Runge-Kutta 4 over the flow's t grid (four model calls a step)."""
    t = _flow_schedule(x, steps, sigma_max, sigmas, dist_shift)
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for i in range(len(t) - 1):
        t_curr, t_next = float(t[i]), float(t[i + 1])
        dt = t_next - t_curr
        k1 = model_fn(x, t_curr * ones, **extra)
        k2 = model_fn(x + dt / 2 * k1, (t_curr + dt / 2) * ones, **extra)
        k3 = model_fn(x + dt / 2 * k2, (t_curr + dt / 2) * ones, **extra)
        k4 = model_fn(x + dt * k3, t_next * ones, **extra)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def _flow_log_snr(s: float) -> float:
    return math.log(max((1 - s) / max(s, 1e-12), 1e-12))


def sample_flow_dpmpp(model_fn, x: torch.Tensor, steps: Optional[int] = None,
                      sigma_max: float = 1.0, sigmas: Optional[np.ndarray] = None,
                      dist_shift: Optional[DistributionShift] = None,
                      on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
                      **extra) -> torch.Tensor:
    """DPM-Solver++(2M) in the flow's log-SNR (first order on the first step
    and into t = 0). `on_step(i, x)` sees each step's input state (ARC's
    teacher trajectory keeps them)."""
    t = _flow_schedule(x, steps, sigma_max, sigmas, dist_shift)
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    old = None
    for i in range(len(t) - 1):
        t_curr, t_next = float(t[i]), float(t[i + 1])
        if on_step is not None:
            on_step(i, x)
        denoised = x - t_curr * model_fn(x, t_curr * ones, **extra)
        h = _flow_log_snr(t_next) - _flow_log_snr(t_curr)
        d = denoised
        if i > 0 and t_next != 0:
            r = (_flow_log_snr(t_curr) - _flow_log_snr(float(t[i - 1]))) / h
            d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old
        x = (t_next / t_curr) * x - (1 - t_next) * math.expm1(-h) * d
        old = denoised
    return x


def sample_flow_pingpong(model_fn, x: torch.Tensor, steps: Optional[int] = None,
                         sigma_max: float = 1.0, sigmas: Optional[np.ndarray] = None,
                         dist_shift: Optional[DistributionShift] = None,
                         generator: Optional[torch.Generator] = None,
                         step_noise: Optional[StepNoise] = None, **extra) -> torch.Tensor:
    """Ping-pong: each step denoises fully, then re-noises to t_next with
    fresh noise (`step_noise(i, x)`, else the generator's)."""
    t = _flow_schedule(x, steps, sigma_max, sigmas, dist_shift)
    draw = step_noise if step_noise is not None else _default_noise(generator)
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for i in range(len(t) - 1):
        t_curr, t_next = float(t[i]), float(t[i + 1])
        denoised = x - t_curr * model_fn(x, t_curr * ones, **extra)
        x = (1 - t_next) * denoised + t_next * draw(i, x)
    return x


K_DIFFUSION_SAMPLERS = ("k-heun", "k-lms", "k-dpmpp-2s-ancestral", "k-dpm-2", "k-dpm-fast",
                        "k-dpm-adaptive", "dpmpp-2m-sde", "dpmpp-3m-sde", "dpmpp-2m")
V_SAMPLERS = ("v-ddim", "v-ddim-cfgpp")
DenoisedTap = Callable[[torch.Tensor, float], None]


def _tapped_denoiser(denoiser, tap: DenoisedTap):
    def tapped(x, sigma, **kwargs):
        denoised = denoiser(x, sigma, **kwargs)
        tap(denoised, float(sigma))
        return denoised
    return tapped


def _tapped_v_model(model_fn, tap: DenoisedTap):
    """v-DDIM's tap: x alpha - v sigma at the k-space sigma tan(t pi / 2)
    (t clipped below 1, as the JAX tap clips it)."""
    def tapped(x, t, **kwargs):
        out = model_fn(x, t, **kwargs)
        v = out[0] if isinstance(out, tuple) else out
        a, s = (c.view(-1, *([1] * (x.dim() - 1))) for c in t_to_alpha_sigma(t))
        t_lbl = np.float32(min(float(t.max()), 0.9999))  # in f32, as the JAX tap
        tap(x * a - v * s, float(np.tan(t_lbl * np.float32(math.pi / 2))))
        return out
    return tapped


def sample_k(model_fn, noise: torch.Tensor, init_data: Optional[torch.Tensor] = None,
             steps: int = 100, sampler_type: str = "dpmpp-3m-sde", sigma_min: float = 0.01,
             sigma_max: float = 100.0, rho: float = 1.0,
             generator: Optional[torch.Generator] = None,
             step_noise: Optional[StepNoise] = None,
             denoised_tap: Optional[DenoisedTap] = None, **extra) -> torch.Tensor:
    """Sample from `noise` (standard normal, [B, C, T]) with a v-model;
    `init_data` (latents to vary) is added to the scaled noise. `v-ddim`
    and `v-ddim-cfgpp` start at t = min(sigma_max, 1) and ignore sigma_min
    and rho, as the JAX package does."""
    if sampler_type in V_SAMPLERS:
        sigma_max = min(sigma_max, 1.0)
        x = noise
        if init_data is not None:
            alpha, sigma = t_to_alpha_sigma(torch.tensor(sigma_max, dtype=torch.float32))
            x = init_data * alpha.item() + noise * sigma.item()
        if denoised_tap is not None:
            model_fn = _tapped_v_model(model_fn, denoised_tap)
        return sample(model_fn, x, steps, eta=0.0, sigma_max=sigma_max, generator=generator,
                      step_noise=step_noise, cfg_pp=sampler_type == "v-ddim-cfgpp", **extra)
    if sampler_type not in K_DIFFUSION_SAMPLERS:
        raise ValueError(f"Unknown sampler type {sampler_type}")
    denoiser = make_v_denoiser(model_fn)
    if denoised_tap is not None:
        denoiser = _tapped_denoiser(denoiser, denoised_tap)
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


def sample_rf(model_fn, noise: torch.Tensor, init_data: Optional[torch.Tensor] = None,
              steps: int = 100, sampler_type: str = "euler", sigma_max: float = 1.0,
              generator: Optional[torch.Generator] = None,
              step_noise: Optional[StepNoise] = None,
              dist_shift: Optional[DistributionShift] = None,
              denoised_tap: Optional[DenoisedTap] = None, **extra) -> torch.Tensor:
    """Sample from `noise` (standard normal, [B, C, T]) with a flow model
    (v = noise - x_0); `init_data` is mixed in at t = min(sigma_max, 1).

    As in the JAX package (:805-820), `euler`, `dpmpp` and `pingpong` run on
    `get_rf_schedule(steps, sigma_max)` and are handed it, so they never read
    `dist_shift`; `rk4` runs on the even grid and shifts it."""
    sigma_max = min(sigma_max, 1.0)
    x = noise if init_data is None else init_data * (1 - sigma_max) + noise * sigma_max
    if denoised_tap is not None:
        base = model_fn

        def model_fn(x, t, **kwargs):
            v = base(x, t, **kwargs)
            denoised_tap(x - v * t.view(-1, *([1] * (x.dim() - 1))), float(t.max()))
            return v

    t = get_rf_schedule(steps, sigma_max)
    if sampler_type == "euler":
        return sample_discrete_euler(model_fn, x, sigmas=t, dist_shift=dist_shift, **extra)
    if sampler_type == "rk4":
        return sample_rk4(model_fn, x, steps=steps, sigma_max=sigma_max, dist_shift=dist_shift,
                          **extra)
    if sampler_type == "dpmpp":
        return sample_flow_dpmpp(model_fn, x, sigmas=t, dist_shift=dist_shift, **extra)
    if sampler_type == "pingpong":
        return sample_flow_pingpong(model_fn, x, sigmas=t, dist_shift=dist_shift,
                                    generator=generator, step_noise=step_noise, **extra)
    raise ValueError(f"Unknown sampler_type: {sampler_type}")
