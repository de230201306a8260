"""STFT utilities of the autoencoder losses and discriminators; counterpart of
stable_audio_tools_tpu/ops/stft.py (`hann_window` :18, `mel_filterbank` :72,
`a_weighting_fir` :119, `apply_fir` :170, `stft_reim_conv` :222, `stft_mag_conv` :263).

Framing follows torch.stft: with `center`, reflect-pad n_fft // 2 on each
side; frames = 1 + (T - n_fft) // hop of the (padded) signal; a periodic Hann
window of `win_length`, zero-padded to n_fft in the middle. Outputs keep the
JAX package's layout, frames before bins. The transforms run through
`torch.stft` (cuFFT on the card) in f32; the JAX package's conv-DFT,
frame-packing and Toeplitz-fold forms are TPU workarounds and are not ported.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window(win_length, periodic=True) as f32 numpy."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * math.pi * n / win_length)).astype(np.float32)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True, normalized: bool = False) -> torch.Tensor:
    """x [..., T] -> complex64 [..., frames, n_fft // 2 + 1]. `normalized`
    divides by sqrt(sum window^2), as torchaudio's Spectrogram (and the JAX
    `_dft_conv_kernel`) do; torch.stft's own `normalized` divides by
    sqrt(n_fft) instead and is not used."""
    lead, T = x.shape[:-1], x.shape[-1]
    win = torch.from_numpy(hann_window(win_length)).to(x.device)
    z = torch.stft(x.reshape(-1, T).float(), n_fft, hop_length=hop_length,
                   win_length=win_length, window=win, center=center, pad_mode="reflect",
                   return_complex=True)
    if normalized:
        z = z / float(np.sqrt(np.sum(hann_window(win_length).astype(np.float64) ** 2)))
    return z.transpose(-1, -2).reshape(*lead, z.shape[-1], z.shape[-2])


def stft_reim(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
              center: bool = True, normalized: bool = False) -> torch.Tensor:
    """Real and imaginary parts: [..., T] -> f32 [..., frames, 2 * bins],
    channel order [re_0..re_bins, im_0..im_bins] (JAX `stft_reim_conv`)."""
    z = stft(x, n_fft, hop_length, win_length, center=center, normalized=normalized)
    return torch.cat([z.real, z.imag], dim=-1)


def stft_mag(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
             center: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """|STFT| = sqrt(max(re^2 + im^2, eps)): [..., T] -> f32 [..., frames, bins]
    (JAX `stft_mag_conv`)."""
    z = stft(x, n_fft, hop_length, win_length, center=center)
    return torch.sqrt(torch.clamp(z.real * z.real + z.imag * z.imag, min=eps))


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: tp.Optional[float] = None, htk: bool = True,
                   norm: tp.Optional[str] = None) -> np.ndarray:
    """Triangular mel filterbank, f32 [n_mels, n_fft // 2 + 1] (JAX :72):
    by default the HTK mel scale from 0 to sr / 2, without normalisation;
    `htk=False, norm="slaney"` gives librosa's defaults (the Slaney scale,
    linear below 1 kHz, and each band scaled to unit area), what laion-clap's
    log-mel front end builds."""
    fmax = fmax or sr / 2
    if htk:
        def hz_to_mel(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

        def mel_to_hz(m):
            return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
    else:
        log_step = np.log(6.4) / 27.0

        def hz_to_mel(f):
            f = np.asarray(f, np.float64)
            return np.where(f >= 1000.0,
                            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step,
                            f / (200.0 / 3.0))

        def mel_to_hz(m):
            m = np.asarray(m, np.float64)
            return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), 200.0 / 3.0 * m)

    freqs = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-8)
        fb[i] = np.clip(np.minimum(up, down), 0, None)
    if norm == "slaney":
        fb *= (2.0 / (freqs[2: n_mels + 2] - freqs[:n_mels]))[:, None].astype(np.float32)
    return fb


def a_weighting_fir(ntaps: int = 101, sr: int = 44100) -> np.ndarray:
    """FIR approximation of IEC 61672 A-weighting (auraloss FIRFilter 'aw'),
    designed with scipy.signal.firwin2."""
    from scipy import signal as sps

    f = np.linspace(1.0, sr / 2, 512)
    f2 = f ** 2
    ra = (12194 ** 2 * f2 ** 2) / (
        (f2 + 20.6 ** 2)
        * np.sqrt((f2 + 107.7 ** 2) * (f2 + 737.9 ** 2))
        * (f2 + 12194 ** 2)
    )
    a_db = 20 * np.log10(ra) + 2.0
    gains = np.concatenate([[0.0], 10 ** (a_db / 20)])
    freqs_norm = np.concatenate([[0.0], f / (sr / 2)])
    freqs_norm[-1] = 1.0
    return sps.firwin2(ntaps, freqs_norm, gains).astype(np.float32)


@contextlib.contextmanager
def _full_f32_convs():
    """cuDNN runs f32 convolutions in TF32 by default (~3 decimal digits);
    the JAX package runs the FIR at Precision.HIGHEST. Off for the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _FIR(torch.autograd.Function):
    """x [N, 1, T] f32 -> the same-length FIR of x, with TF32 off in both
    directions: the input gradient (the transposed conv) runs inside
    `loss.backward()`, after any block around the forward has ended."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(k)
        with _full_f32_convs():
            return F.conv1d(x, k, padding=k.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        k, = ctx.saved_tensors
        with _full_f32_convs():
            return F.conv_transpose1d(g, k, padding=k.shape[-1] // 2), None


def apply_fir(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Same-length FIR filtering of x [B, C, T] or [B, T] along time:
    F.conv1d(x, taps, padding=ntaps // 2) per channel (zero edges), f32 in
    the forward and the backward (odd ntaps)."""
    shape, T = x.shape, x.shape[-1]
    k = torch.from_numpy(np.asarray(taps, np.float32)).to(x.device)[None, None]
    return _FIR.apply(x.reshape(-1, 1, T).float(), k).reshape(shape)
