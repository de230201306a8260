"""Pseudo-QMF filter bank; counterpart of stable_audio_tools_tpu/models/pqmf.py.

The design is the JAX package's, copied: a Kaiser-windowed prototype lowpass
whose cutoff a bounded scalar search tunes towards perfect reconstruction
(`_kaiser_prototype`, `_pr_objective`, scipy's `minimize_scalar`), cosine
modulated into `num_bands` bands. Analysis is one grouped strided
`F.conv1d` per call (each input channel through every band); synthesis is
its adjoint, a grouped `F.conv_transpose1d`, times the band count, as the
JAX package takes it by `jax.vjp`. Both run in full f32 (TF32 off on the
card). Layout: [B, C, T] -> [B, C * M, T / M], channel c's bands together.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import _full_f32_convs


def _kaiser_prototype(wc: float, atten: float, M: int) -> np.ndarray:
    from scipy import signal as sps

    beta = sps.kaiser_beta(atten)
    N, _ = sps.kaiserord(atten, wc / np.pi / M)
    N = 2 * (N // 2) + 1  # odd length
    return sps.firwin(N, wc / np.pi / M, window=("kaiser", beta))


def _pr_objective(wc: float, atten: float, M: int) -> float:
    """Energy of the prototype's autocorrelation off the centre at the 2M
    lags: zero for an alias-free, perfectly reconstructing bank."""
    h = _kaiser_prototype(wc, atten, M)
    g = np.convolve(h, h[::-1], "full")
    taps = g[len(g) // 2::2 * M]
    return float(np.sum(taps[1:] ** 2))


@lru_cache(maxsize=8)
def design_pqmf(attenuation: int, num_bands: int) -> np.ndarray:
    """The modulated bank, f32 [num_bands, N]."""
    from scipy import optimize

    M = num_bands
    res = optimize.minimize_scalar(lambda wc: _pr_objective(wc, attenuation, M),
                                   bounds=(0.1 * np.pi, np.pi), method="bounded")
    h = _kaiser_prototype(res.x, attenuation, M)
    N = len(h)
    n = np.arange(N)
    hk = np.stack([2 * h * np.cos((2 * k + 1) * math.pi / (2 * M) * (n - (N - 1) / 2)
                                  + (-1) ** k * math.pi / 4) for k in range(M)])
    return hk.astype(np.float32)


def _bank(attenuation: int, num_bands: int, channels: int, like: torch.Tensor) -> torch.Tensor:
    """The grouped conv weight [C * M, 1, N]: output channel c * M + m is
    band m of input channel c."""
    bank = torch.from_numpy(design_pqmf(attenuation, num_bands)).to(like.device, like.dtype)
    return bank[None].expand(channels, -1, -1).reshape(-1, 1, bank.shape[-1])


def _pads(T: int, M: int, N: int):
    """The JAX package's padding: N // 2 on the left; on the right that less
    the shortfall of T to a multiple of M, plus M - 1."""
    pad = N // 2
    return pad, pad - (M - T % M) % M + (M - 1)


def pqmf_analysis(x: torch.Tensor, attenuation: int = 100, num_bands: int = 16) -> torch.Tensor:
    """x [B, C, T] -> [B, C * M, T // M]."""
    B, C, T = x.shape
    w = _bank(attenuation, num_bands, C, x)
    left, right = _pads(T, num_bands, w.shape[-1])
    with _full_f32_convs():
        out = F.conv1d(F.pad(x, (left, right)), w, stride=num_bands, groups=C)
    return out[:, :, : T // num_bands]


def pqmf_synthesis(z: torch.Tensor, attenuation: int = 100, num_bands: int = 16) -> torch.Tensor:
    """z [B, C * M, S] -> [B, C, S * M]: M times the adjoint of the analysis
    of an S * M long signal."""
    B, CM, S = z.shape
    M = num_bands
    C, T = CM // M, S * M
    w = _bank(attenuation, M, C, z)
    N = w.shape[-1]
    left, right = _pads(T, M, N)
    n_out = (T + left + right - N) // M + 1  # the analysis conv's length before the crop
    with _full_f32_convs():
        y = F.conv_transpose1d(F.pad(z, (0, n_out - S)), w, stride=M, groups=C)
    y = F.pad(y, (0, max(T + left + right - y.shape[-1], 0)))
    return y[:, :, left: left + T] * M
