"""Dataset transforms (numpy); counterpart of stable_audio_tools_tpu/data/utils.py
(PadCrop_Normalized_T :34, PhaseFlipper :59, Mono :67, Stereo :74, VolumeNorm
:118 with the numpy BS.1770 loudness; the native LUFS kernel is not ported).
Random choices use Python's `random`, which torch's DataLoader seeds in each
worker."""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np
from scipy import signal as sps


class PadCrop_Normalized_T:
    """Crop (random offset, or 0) or zero-pad to n_samples; also returns the
    crop's normalised start/end, seconds_start, seconds_total and the
    padding mask (1 where the crop holds audio)."""

    def __init__(self, n_samples: int, sample_rate: int, randomize: bool = True):
        self.n_samples = n_samples
        self.sample_rate = sample_rate
        self.randomize = randomize

    def __call__(self, source: np.ndarray) -> Tuple:
        n_channels, n_samples = source.shape
        upper_bound = max(0, n_samples - self.n_samples)
        offset = random.randint(0, upper_bound) if self.randomize and upper_bound else 0
        t_start = offset / (upper_bound + self.n_samples)
        t_end = (offset + self.n_samples) / (upper_bound + self.n_samples)
        chunk = np.zeros((n_channels, self.n_samples), source.dtype)
        chunk[:, : min(n_samples, self.n_samples)] = source[:, offset: offset + self.n_samples]
        seconds_start = math.floor(offset / self.sample_rate)
        seconds_total = math.ceil(n_samples / self.sample_rate)
        padding_mask = np.zeros(self.n_samples, np.float32)
        padding_mask[: min(n_samples, self.n_samples)] = 1
        return chunk, t_start, t_end, seconds_start, seconds_total, padding_mask


class PhaseFlipper:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        return -signal if random.random() < self.p else signal


class Mono:
    def __call__(self, signal: np.ndarray) -> np.ndarray:
        return np.mean(signal, axis=0, keepdims=True) if signal.ndim > 1 else signal


class Stereo:
    def __call__(self, signal: np.ndarray) -> np.ndarray:
        if signal.ndim == 1:
            return np.stack([signal, signal])
        if signal.shape[0] == 1:
            return np.concatenate([signal, signal], axis=0)
        return signal[:2]


def _k_weighting_filters(sample_rate: int):
    """ITU-R BS.1770 K-weighting: a high-shelf then a high-pass biquad."""
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = math.tan(math.pi * f0 / sample_rate)
    Vh = 10 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    shelf = (np.array([(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0,
                       (Vh - Vb * K / Q + K * K) / a0]),
             np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]))
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / sample_rate)
    den = 1.0 + K / Q + K * K
    hp = (np.array([1.0, -2.0, 1.0]) / den,
          np.array([1.0, 2.0 * (K * K - 1.0) / den, (1.0 - K / Q + K * K) / den]))
    return shelf, hp


def measure_loudness_lufs(signal: np.ndarray, sample_rate: int) -> float:
    """Integrated loudness (BS.1770 K-weighted, ungated)."""
    if signal.ndim == 1:
        signal = signal[None]
    (b1, a1), (b2, a2) = _k_weighting_filters(sample_rate)
    weighted = sps.lfilter(b2, a2, sps.lfilter(b1, a1, signal, axis=-1), axis=-1)
    return float(-0.691 + 10 * np.log10(np.mean(weighted ** 2, axis=-1).sum() + 1e-12))


class VolumeNorm:
    """Normalise to a random loudness in value +- gain (LUFS), peak-limited."""

    def __init__(self, params=(-16, 2), sample_rate: int = 16000,
                 energy_threshold: float = 1e-6):
        self.value = params[0]
        self.gain_range = (-params[1], params[1])
        self.sample_rate = sample_rate
        self.energy_threshold = energy_threshold

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        if float(np.mean(signal ** 2)) < self.energy_threshold:
            return signal
        loudness = measure_loudness_lufs(signal, self.sample_rate)
        target = self.value + random.uniform(*self.gain_range)
        out = 10.0 ** ((target - loudness) / 20.0) * signal
        peak = float(np.max(np.abs(out)))
        return out / peak * 0.95 if peak >= 1.0 else out
