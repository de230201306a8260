"""Audio preparation for generation inputs; counterpart of
stable_audio_tools_tpu/inference/utils.py."""

from __future__ import annotations

import numpy as np
import torch

from ..data.resample import resample_poly_np


def set_audio_channels(audio: torch.Tensor, target_channels: int) -> torch.Tensor:
    """audio [B, C, T] -> [B, target_channels, T]: mono by the mean, stereo
    by duplicating a mono channel, else the first channels."""
    if target_channels == 1:
        return audio.mean(1, keepdim=True)
    if target_channels == 2 and audio.shape[1] == 1:
        return torch.cat([audio, audio], dim=1)
    if audio.shape[1] < target_channels:
        raise ValueError(f"audio has {audio.shape[1]} channels, {target_channels} wanted")
    return audio[:, :target_channels, :]


def prepare_audio(audio, in_sr: int, target_sr: int, target_length: int,
                  target_channels: int) -> torch.Tensor:
    """Resample (polyphase, on the host), zero-pad or crop to `target_length`
    and fix the channel count: [T], [C, T] or [B, C, T] in, f32 [B, C,
    target_length] out on the input's device."""
    device = audio.device if isinstance(audio, torch.Tensor) else None
    a = np.asarray(audio.detach().cpu() if isinstance(audio, torch.Tensor) else audio,
                   np.float32)
    a = a.reshape((1,) * (3 - a.ndim) + a.shape)
    if in_sr != target_sr:
        a = np.stack([np.stack([resample_poly_np(ch, in_sr, target_sr) for ch in b]) for b in a])
    if a.shape[-1] < target_length:
        a = np.pad(a, ((0, 0), (0, 0), (0, target_length - a.shape[-1])))
    out = torch.from_numpy(np.ascontiguousarray(a[..., :target_length])).to(device or "cpu")
    return set_audio_channels(out, target_channels)
