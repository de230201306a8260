"""The 1-D discrete wavelet transform as strided convs; counterpart of
stable_audio_tools_tpu/models/wavelets.py.

The filter banks are the JAX package's, in its own numpy, copied here: the
embedded CDF 9/7 (`bior4.4`), LeGall 5/3 (`bior2.2`) and db4 banks; the
spline-biorthogonal family designed from the binomial and the halfband
polynomial, its alignment searched by `_bior_bank_validated`; the Daubechies
family by spectral factorisation; every designed bank checked for perfect
reconstruction by `_validate_pr`. `_bior_bank_validated` returns the first
alignment that reconstructs, in the JAX package's search order, so the port
picks the same bank for every order (the tests hold all four arrays of
`get_filter_bank` to the JAX package's). A level is one grouped stride-2
`F.conv1d` over the circularly padded input ([B, C, T] -> [B, 2C, T / 2],
lo and hi of channel c together); its inverse is the adjoint of the analysis
with the time-reversed synthesis filters: a grouped `F.conv_transpose1d`
whose circular halos are folded back. Both run in full f32 (TF32 off on the
card), as the JAX package runs them at `Precision.HIGHEST`.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import _full_f32_convs

SQRT2 = math.sqrt(2.0)

# analysis lowpass h0, synthesis lowpass g0 (unit-DC normalization), pywt
# convention scales by sqrt(2).
_CDF97_H0 = np.array([
    0.026748757410810, -0.016864118442875, -0.078223266528990,
    0.266864118442875, 0.602949018236360, 0.266864118442875,
    -0.078223266528990, -0.016864118442875, 0.026748757410810,
])
_CDF97_G0 = np.array([
    -0.045635881557125, -0.028771763114250, 0.295635881557125,
    0.557543526228500, 0.295635881557125, -0.028771763114250,
    -0.045635881557125,
])
_LEGALL53_H0 = np.array([-1 / 8, 2 / 8, 6 / 8, 2 / 8, -1 / 8])
_LEGALL53_G0 = np.array([1 / 2, 1, 1 / 2])
_DB4_DEC_LO = np.array([
    -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
    -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
    0.7148465705525415, 0.23037781330885523,
])


def _orthogonal_bank(dec_lo: np.ndarray):
    L = len(dec_lo)
    signs = (-1.0) ** np.arange(L)
    dec_hi = signs * dec_lo[::-1]
    return dec_lo, dec_hi, dec_lo[::-1].copy(), dec_hi[::-1].copy()


def _biorthogonal_bank(h0: np.ndarray, g0: np.ndarray):
    """PR construction validated numerically (circular DWT, adjoint IDWT):
    pad h0 left-aligned / g0 shifted by 2; hi filters are rolled
    alternating-sign flips of the dual lowpasses."""
    L = max(len(h0), len(g0)) + 1
    L = L + (L % 2)
    h0p = np.pad(h0, (0, L - len(h0)))
    g0p = np.pad(g0, (2, L - len(g0) - 2))
    signs = (-1.0) ** np.arange(L)
    dec_hi = np.roll(signs * g0p[::-1], 1)
    rec_hi = -np.roll(signs * h0p[::-1], -1)
    return h0p, dec_hi, g0p, rec_hi


def _binom(n: int) -> np.ndarray:
    out = np.array([1.0])
    for _ in range(n):
        out = np.convolve(out, [1.0, 1.0])
    return out


def _halfband_q(L: int) -> np.ndarray:
    """Q(z) = sum_{k<L} C(L-1+k, k) y^k with y = sin^2(w/2) expressed as the
    centered z-poly [-1/4, 1/2, -1/4] — the complementary factor of the
    Daubechies/CDF halfband product filter."""
    y = np.array([-0.25, 0.5, -0.25])
    q = np.array([0.0])
    yk = np.array([1.0])
    c = 1.0
    for k in range(L):
        qk = c * yk
        # center-align accumulate
        pad = (len(qk) - len(q)) // 2
        q = np.pad(q, (max(pad, 0), max(pad, 0)))
        qk = np.pad(qk, (max(-pad, 0), max(-pad, 0)))
        q = q + qk
        yk = np.convolve(yk, y)
        c = c * (L + k) / (k + 1)
    return q


def _design_spline_bior(nr: int, nd: int) -> Tuple[np.ndarray, np.ndarray]:
    """CDF spline biorthogonal pair (analysis lowpass h0, synthesis lowpass
    g0), pywt-normalized (sum = sqrt(2) each). nr + nd must be even."""
    if (nr + nd) % 2:
        raise ValueError(f"bior{nr}.{nd}: orders must have equal parity")
    L = (nr + nd) // 2
    g0 = SQRT2 * _binom(nr) / 2.0 ** nr
    h0 = SQRT2 * np.convolve(_binom(nd) / 2.0 ** nd, _halfband_q(L))
    return h0, g0


def _design_daubechies(n: int) -> np.ndarray:
    """Minimum-phase Daubechies-N scaling filter → pywt dec_lo (reversed
    scaling filter). Validated against the embedded db4 bank."""
    if n == 1:
        return np.array([1.0, 1.0]) / SQRT2
    # Roots of Q(y) = sum_{k<n} C(n-1+k,k) y^k in the y-domain (degree n-1,
    # well-conditioned) instead of the degree-2(n-1) z-polynomial — the
    # z-domain np.roots drifts to ~6e-6 PR error by db20. Each y-root maps
    # to a z-pair via y = (2 - z - 1/z)/4; keep the in-circle member.
    qy = [1.0]
    c = 1.0
    for k in range(1, n):
        c = c * (n - 1 + k) / k
        qy.append(c)
    yroots = np.roots(qy[::-1])
    zroots = []
    for y in yroots:
        b_ = 2.0 - 4.0 * y
        disc = np.sqrt(b_ * b_ - 4.0 + 0j)
        z1, z2 = (b_ + disc) / 2.0, (b_ - disc) / 2.0
        zroots.append(z1 if abs(z1) < 1.0 else z2)
    keep = np.asarray(zroots)
    if len(keep) != n - 1 or np.any(np.abs(keep) >= 1.0):
        raise ValueError(f"db{n}: spectral factorization found "
                         f"{np.sum(np.abs(keep) < 1.0)} in-circle roots, "
                         f"expected {n - 1}")
    b = np.real(np.poly(keep))  # minimum-phase factor, length n
    h = np.convolve(_binom(n), b)
    h = h * (SQRT2 / h.sum())  # pywt normalization: sum = sqrt(2)
    return h[::-1].copy()  # pywt dec_lo is the reversed scaling filter


def _validate_pr(bank, name: str, T: int = 32) -> None:
    """Numpy mirror of _dwt_level/_idwt_level (circular, stride 2, adjoint
    synthesis): assert synthesis^T . analysis == I."""
    dec_lo, dec_hi, rec_lo, rec_hi = (np.asarray(f, np.float64) for f in bank)

    def analysis_matrix(lo, hi):
        L = len(lo)
        pad_l = L // 2 - 1 if L > 2 else 0
        pad_r = L - 2 - pad_l if L > 2 else 0
        rows = []
        for i in range(T):
            e = np.zeros(T)
            e[i] = 1.0
            xp = np.concatenate([e[T - pad_l:] if pad_l else e[:0], e,
                                 e[:pad_r]])
            lo_out = [xp[2 * j:2 * j + L] @ lo for j in range((len(xp) - L) // 2 + 1)]
            hi_out = [xp[2 * j:2 * j + L] @ hi for j in range((len(xp) - L) // 2 + 1)]
            rows.append(np.concatenate([lo_out, hi_out]))
        return np.stack(rows, 1)  # [2*(T/2), T] columns are unit responses

    A = analysis_matrix(dec_lo, dec_hi)
    S = analysis_matrix(rec_lo[::-1], rec_hi[::-1])  # synthesis = S^T
    err = np.max(np.abs(S.T @ A - np.eye(T)))
    if err > 1e-6:
        raise ValueError(
            f"wavelet {name}: designed filter bank fails perfect "
            f"reconstruction (max |S^T A - I| = {err:.2e})")


def _bior_bank_validated(h0: np.ndarray, g0: np.ndarray, name: str):
    """_biorthogonal_bank's fixed g0-shift of 2 is correct for the embedded
    pairs; other length combinations may need a different even alignment —
    search shifts and return the first that reconstructs perfectly."""
    last_err = None
    L = max(len(h0), len(g0))
    L = L + (L % 2)
    for shift in range(0, L - len(g0) + 1, 2):
        h0p = np.pad(h0, (0, L - len(h0)))
        g0p = np.pad(g0, (shift, L - len(g0) - shift))
        signs = (-1.0) ** np.arange(L)
        for r1, r2 in ((1, -1), (-1, 1), (1, 1), (-1, -1), (0, 0), (2, -2)):
            dec_hi = np.roll(signs * g0p[::-1], r1)
            rec_hi = -np.roll(signs * h0p[::-1], r2)
            bank = (h0p, dec_hi, g0p, rec_hi)
            try:
                _validate_pr(bank, name)
                return bank
            except ValueError as e:
                last_err = e
    raise last_err


@lru_cache(maxsize=32)
def get_filter_bank(wavelet: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (dec_lo, dec_hi, rec_lo, rec_hi), pywt-normalized.

    Accepts: haar, dbN (N <= 20), biorN.M / rbioN.M (spline family; 4.4 is
    the embedded CDF 9/7), plus the aliases cdf97 / legall53. This is the
    supported contract — bior5.5/6.8 and the sym/coif families are
    root-split designs the reference gets from pywt and are rejected with
    this message (reference models/wavelets.py:17-30 accepts any pywt name).
    """
    if wavelet in ("bior4.4", "rbio4.4", "cdf97"):
        bank = _biorthogonal_bank(_CDF97_H0 * SQRT2, _CDF97_G0 * SQRT2)
        if wavelet == "rbio4.4":
            bank = _swap_bior(bank)
    elif wavelet in ("bior2.2", "legall53"):
        bank = _biorthogonal_bank(_LEGALL53_H0 * SQRT2, _LEGALL53_G0 / SQRT2)
    elif wavelet == "haar":
        bank = _orthogonal_bank(np.array([1.0, 1.0]) / SQRT2)
    elif wavelet == "db4":
        bank = _orthogonal_bank(_DB4_DEC_LO.copy())
    elif wavelet.startswith("db") and wavelet[2:].isdigit():
        n = int(wavelet[2:])
        if not 1 <= n <= 20:
            raise ValueError(f"db{n}: supported range is db1..db20")
        bank = _orthogonal_bank(_design_daubechies(n))
        _validate_pr(bank, wavelet)
    elif (wavelet[:4] in ("bior", "rbio") and len(wavelet) == 7
          and wavelet[4].isdigit() and wavelet[5] == "."
          and wavelet[6].isdigit()):
        nr, nd = int(wavelet[4]), int(wavelet[6])
        if (nr, nd) in ((5, 5), (6, 8)):
            raise ValueError(
                f"{wavelet}: pywt's 5.5/6.8 banks are root-split designs "
                "with no closed spline form; supported bior orders are the "
                "spline family (1.1-1.5, 2.2-2.8, 3.1-3.9) and 4.4 (CDF 9/7)")
        h0, g0 = _design_spline_bior(nr, nd)
        bank = _bior_bank_validated(h0, g0, wavelet)
        if wavelet.startswith("rbio"):
            bank = _swap_bior(bank)
    else:
        raise ValueError(
            f"Unknown wavelet {wavelet!r}: supported are haar, db1..db20, "
            "biorN.M/rbioN.M (spline family + 4.4), cdf97, legall53")
    return tuple(np.asarray(f, np.float32) for f in bank)


def _swap_bior(bank):
    """rbio = bior with analysis/synthesis roles exchanged. The adjoint
    synthesis in _idwt_level uses time-reversed rec filters, so the role
    swap is (dec, rec) -> (rec[::-1], dec[::-1])."""
    dec_lo, dec_hi, rec_lo, rec_hi = bank
    bank = (rec_lo[::-1].copy(), rec_hi[::-1].copy(),
            dec_lo[::-1].copy(), dec_hi[::-1].copy())
    _validate_pr(bank, "rbio")
    return bank


def _pads(L: int) -> Tuple[int, int]:
    """The circular halo on each side of a level's input."""
    if L <= 2:
        return 0, 0
    pad_l = L // 2 - 1
    return pad_l, L - 2 - pad_l


def _weight(lo: np.ndarray, hi: np.ndarray, channels: int, like: torch.Tensor) -> torch.Tensor:
    """The grouped conv weight [2C, 1, L]: output channel 2c is channel c's
    lowpass, 2c + 1 its highpass."""
    w = torch.from_numpy(np.stack([np.asarray(lo, np.float32), np.asarray(hi, np.float32)]))
    return w.to(like.device, like.dtype).repeat(channels, 1)[:, None, :]


def _dwt_level(x: torch.Tensor, dec_lo, dec_hi) -> torch.Tensor:
    """x [B, C, T] -> [B, 2C, T / 2]."""
    C, T = x.shape[1], x.shape[2]
    pad_l, pad_r = _pads(len(dec_lo))
    xp = torch.cat([x[:, :, T - pad_l:], x, x[:, :, :pad_r]], dim=2) if pad_l or pad_r else x
    with _full_f32_convs():
        return F.conv1d(xp, _weight(dec_lo, dec_hi, C, x), stride=2, groups=C)


def _idwt_level(z: torch.Tensor, rec_lo, rec_hi) -> torch.Tensor:
    """z [B, 2C, S] -> [B, C, 2S]: the adjoint of `_dwt_level` with the
    time-reversed synthesis filters, which inverts a perfect-reconstruction
    bank exactly (the halos folded back onto the ends they came from)."""
    C, T = z.shape[1] // 2, 2 * z.shape[2]
    lo, hi = np.asarray(rec_lo)[::-1].copy(), np.asarray(rec_hi)[::-1].copy()
    pad_l, pad_r = _pads(len(lo))
    with _full_f32_convs():
        y = F.conv_transpose1d(z, _weight(lo, hi, C, z), stride=2, groups=C)
    x = y[:, :, pad_l: pad_l + T].clone()
    if pad_l:
        x[:, :, T - pad_l:] += y[:, :, :pad_l]
    if pad_r:
        x[:, :, :pad_r] += y[:, :, pad_l + T:]
    return x


def wavelet_encode(x: torch.Tensor, wavelet: str, levels: int) -> torch.Tensor:
    """[B, C, T] -> [B, C * 2^levels, T / 2^levels] (JAX :293)."""
    dec_lo, dec_hi, _, _ = get_filter_bank(wavelet)
    for _ in range(levels):
        x = _dwt_level(x, dec_lo, dec_hi)
    return x


def wavelet_decode(z: torch.Tensor, wavelet: str, levels: int) -> torch.Tensor:
    _, _, rec_lo, rec_hi = get_filter_bank(wavelet)
    for _ in range(levels):
        z = _idwt_level(z, rec_lo, rec_hi)
    return z
