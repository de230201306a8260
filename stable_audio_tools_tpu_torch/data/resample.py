"""Polyphase resampling in scipy; counterpart of
stable_audio_tools_tpu/data/resample.py (`resample_poly_np`). The JAX
package's native C++ resampler is not ported: scipy's `resample_poly` is the
JAX package's own fallback."""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as sps


def resample_poly_np(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """1-D polyphase resample from orig_sr to target_sr (float32 out)."""
    if orig_sr == target_sr:
        return np.asarray(x, np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    return sps.resample_poly(np.asarray(x, np.float64), target_sr // g,
                             orig_sr // g).astype(np.float32)
