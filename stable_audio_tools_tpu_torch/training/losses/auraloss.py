"""STFT losses (auraloss); counterpart of
stable_audio_tools_tpu/training/losses/auraloss.py: SpectralConvergenceLoss
:38, STFTMagnitudeLoss :45, STFTLoss :61 (spectral convergence + log / linear
magnitude, A-weighting prefilter, scale invariance), MultiResolutionSTFTLoss
:165, SumAndDifferenceSTFTLoss :203, SISDRLoss :235 and MelSTFTLoss :276
(the mel-scale STFTLoss: magnitudes times the HTK mel filterbank, less the
bands that hold no FFT bin, which make the JAX package's loss NaN).

Each is a callable loss(input, target) -> scalar over [B, C, T] or [B, T],
differentiable through `torch.stft`.
"""

from __future__ import annotations

import typing as tp

import torch

from ...ops.stft import a_weighting_fir, apply_fir, mel_filterbank, stft_mag


class SpectralConvergenceLoss:
    def __call__(self, x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
        num = torch.linalg.norm(y_mag - x_mag, dim=(-2, -1))
        den = torch.linalg.norm(y_mag, dim=(-2, -1)) + 1e-8
        return torch.mean(num / den)


class STFTMagnitudeLoss:
    def __init__(self, log: bool = True, distance: str = "L1", log_eps: float = 0.0,
                 log_fac: float = 1.0):
        self.log, self.distance, self.log_eps, self.log_fac = log, distance, log_eps, log_fac

    def __call__(self, x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
        if self.log:
            x_mag = torch.log(self.log_eps + x_mag * self.log_fac)
            y_mag = torch.log(self.log_eps + y_mag * self.log_fac)
        if self.distance == "L1":
            return torch.mean(torch.abs(x_mag - y_mag))
        return torch.mean(torch.square(x_mag - y_mag))


class STFTLoss:
    """auraloss.STFTLoss: w_sc * SC + w_log_mag * log-mag + w_lin_mag * lin-mag
    of |STFT| (reflect-centred), optionally after the A-weighting FIR."""

    def __init__(self, fft_size: int = 1024, hop_size: int = 256, win_length: int = 1024,
                 w_sc: float = 1.0, w_log_mag: float = 1.0, w_lin_mag: float = 0.0,
                 w_phs: float = 0.0, sample_rate: tp.Optional[int] = None,
                 scale: tp.Optional[str] = None, n_bins: tp.Optional[int] = None,
                 perceptual_weighting: bool = False, scale_invariance: bool = False,
                 eps: float = 1e-8, mag_distance: str = "L1", **kwargs):
        if scale not in (None, "mel"):
            raise NotImplementedError(f"STFTLoss scale={scale!r} is not ported yet")
        self._fb = None
        if scale == "mel":
            if sample_rate is None or n_bins is None:
                raise ValueError("the mel scale needs sample_rate and n_bins")
            fb = mel_filterbank(sample_rate, fft_size, n_bins)
            # bands narrower than the FFT's bin spacing (the lowest HTK bands
            # at 44.1 kHz and n_fft 1024) hold no bin: their magnitude is 0,
            # its log -inf, and the loss NaN in the JAX package; they are
            # left out here, which changes nothing where no band is empty
            self._fb = torch.from_numpy(fb[fb.any(axis=1)])
        self.fft_size, self.hop_size, self.win_length = fft_size, hop_size, win_length
        self.w_sc, self.w_log_mag, self.w_lin_mag = w_sc, w_log_mag, w_lin_mag
        self.scale_invariance = scale_invariance
        self.eps = eps
        self.sc = SpectralConvergenceLoss()
        self.logmag = STFTMagnitudeLoss(log=True, distance=mag_distance)
        self.linmag = STFTMagnitudeLoss(log=False, distance=mag_distance)
        self._aw_taps = a_weighting_fir(101, sample_rate) if perceptual_weighting else None

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        # one FIR + STFT over [input; target] (both per-sample: exact)
        xy = torch.cat([input, target], dim=0)
        if self._aw_taps is not None:
            xy = apply_fir(xy[:, None] if xy.dim() == 2 else xy, self._aw_taps)
        mag = stft_mag(xy.reshape(-1, xy.shape[-1]), self.fft_size, self.hop_size,
                       self.win_length, eps=self.eps)
        if self._fb is not None:
            mag = mag @ self._fb.to(mag.device).T
        x_mag, y_mag = mag.chunk(2, dim=0)
        if self.scale_invariance:
            alpha = (x_mag * y_mag).sum(dim=(-2, -1), keepdim=True) / (
                (y_mag ** 2).sum(dim=(-2, -1), keepdim=True) + self.eps)
            y_mag = y_mag * alpha
        loss = 0.0
        if self.w_sc:
            loss = loss + self.w_sc * self.sc(x_mag, y_mag)
        if self.w_log_mag:
            loss = loss + self.w_log_mag * self.logmag(x_mag, y_mag)
        if self.w_lin_mag:
            loss = loss + self.w_lin_mag * self.linmag(x_mag, y_mag)
        return loss


class MultiResolutionSTFTLoss:
    """The mean of STFTLoss over resolutions; the A-weighting FIR, which does
    not depend on the resolution, runs once."""

    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), **stft_kwargs):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        self._aw_taps = None
        if stft_kwargs.get("perceptual_weighting"):
            if stft_kwargs.get("sample_rate") is None:
                raise ValueError("perceptual_weighting needs sample_rate")
            self._aw_taps = a_weighting_fir(101, stft_kwargs["sample_rate"])
            stft_kwargs = dict(stft_kwargs, perceptual_weighting=False)
        self.losses = [STFTLoss(f, h, w, **stft_kwargs)
                       for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)]

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self._aw_taps is not None:
            xy = torch.cat([input[:, None] if input.dim() == 2 else input,
                            target[:, None] if target.dim() == 2 else target], dim=0)
            input, target = apply_fir(xy, self._aw_taps).chunk(2, dim=0)
        total = 0.0
        for loss in self.losses:
            total = total + loss(input, target)
        return total / len(self.losses)


class SumAndDifferenceSTFTLoss:
    """Mid/side multi-resolution STFT loss of stereo [B, 2, T] signals."""

    def __init__(self, fft_sizes, hop_sizes, win_lengths, **stft_kwargs):
        self.mrstft = MultiResolutionSTFTLoss(fft_sizes, hop_sizes, win_lengths, **stft_kwargs)

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """(loss(sum) + loss(difference)) / 2; every term is a mean over
        items, so it is one loss over the stacked [sum; difference] batch."""
        if input.shape[1] != 2:
            raise ValueError("SumAndDifferenceSTFTLoss takes stereo input")
        return self.mrstft(torch.cat([input[:, 0] + input[:, 1], input[:, 0] - input[:, 1]]),
                           torch.cat([target[:, 0] + target[:, 1], target[:, 0] - target[:, 1]]))


class SISDRLoss:
    """Negative scale-invariant SDR in dB, averaged over items and channels."""

    def __init__(self, zero_mean: bool = True, eps: float = 1e-8):
        self.zero_mean, self.eps = zero_mean, eps

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        x, y = input, target
        if self.zero_mean:
            x = x - x.mean(dim=-1, keepdim=True)
            y = y - y.mean(dim=-1, keepdim=True)
        alpha = (x * y).sum(dim=-1, keepdim=True) / ((y * y).sum(dim=-1, keepdim=True) + self.eps)
        y_scaled = alpha * y
        sisdr = 10 * torch.log10(((y_scaled ** 2).sum(dim=-1) + self.eps)
                                 / (((x - y_scaled) ** 2).sum(dim=-1) + self.eps))
        return -sisdr.mean()


class MelSTFTLoss(STFTLoss):
    """STFTLoss over `n_mels` HTK mel bands."""

    def __init__(self, sample_rate: int, fft_size: int = 1024, hop_size: int = 256,
                 win_length: int = 1024, n_mels: int = 128, **kwargs):
        super().__init__(fft_size=fft_size, hop_size=hop_size, win_length=win_length,
                         sample_rate=sample_rate, scale="mel", n_bins=n_mels, **kwargs)
