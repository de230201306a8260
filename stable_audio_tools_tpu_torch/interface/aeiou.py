"""Audio and latent pictures of the demos; counterpart of
stable_audio_tools_tpu/interface/aeiou.py (`audio_spectrogram_image` :26,
`tokens_spectrogram_image` :53, `pca_point_cloud` :69).

Numpy in, an RGB image (uint8 [H, W, 3]) out, drawn with matplotlib, which
each function imports when called: where it is not installed, the function
raises ImportError and the demos write their audio without pictures.
"""

from __future__ import annotations

import numpy as np

from ..ops.stft import mel_filterbank


def _fig_to_rgb(fig) -> np.ndarray:
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    plt.close(fig)
    return buf[..., :3].copy()


def pyplot():
    """matplotlib's pyplot on the Agg backend (ImportError without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def mel_spectrogram_db(audio: np.ndarray, sample_rate: int = 48000, n_fft: int = 1024,
                       n_mels: int = 128) -> np.ndarray:
    """audio [C, T] (channels averaged) or [T] -> the power mel spectrogram in
    dB, [n_mels, frames]: Hann frames of `n_fft` at a hop of n_fft / 4."""
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio.mean(0)
    hop = n_fft // 4
    n_frames = max(1 + (len(audio) - n_fft) // hop, 1)
    frames = np.lib.stride_tricks.sliding_window_view(
        np.pad(audio, (0, max(n_fft - len(audio), 0))), n_fft)[::hop][:n_frames]
    spec = np.abs(np.fft.rfft(frames * np.hanning(n_fft), axis=-1)) ** 2
    mel = spec @ mel_filterbank(sample_rate, n_fft, n_mels).T
    return 10 * np.log10(np.maximum(mel, 1e-10)).T


def audio_spectrogram_image(audio: np.ndarray, sample_rate: int = 48000, n_fft: int = 1024,
                            n_mels: int = 128) -> np.ndarray:
    """audio [C, T] or [T] -> its mel spectrogram as an image."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(mel_spectrogram_db(audio, sample_rate, n_fft, n_mels), aspect="auto",
              origin="lower", cmap="magma")
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bin")
    fig.tight_layout()
    return _fig_to_rgb(fig)


def tokens_spectrogram_image(tokens: np.ndarray, title: str = "Tokens") -> np.ndarray:
    """Latents [C, T] or [B, C, T] (the first item) -> a channel heat map."""
    plt = pyplot()
    tokens = np.asarray(tokens)
    if tokens.ndim == 3:
        tokens = tokens[0]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(tokens, aspect="auto", origin="lower", cmap="coolwarm")
    ax.set_title(title)
    ax.set_xlabel("time")
    ax.set_ylabel("channel")
    fig.tight_layout()
    return _fig_to_rgb(fig)


def pca_components(latents: np.ndarray) -> np.ndarray:
    """Latents [C, T] or [B, C, T] (the first item) -> their first three
    principal components over time, [T, <= 3]."""
    z = np.asarray(latents)
    if z.ndim == 3:
        z = z[0]
    pts = z.T - z.T.mean(0)
    _, _, vt = np.linalg.svd(pts, full_matrices=False)
    return pts @ vt[:3].T


def pca_point_cloud(latents: np.ndarray, color_by_time: bool = True) -> np.ndarray:
    """Latents -> a 3-D scatter of `pca_components`, coloured by time."""
    plt = pyplot()
    proj = pca_components(latents)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(proj[:, 0], proj[:, 1], proj[:, 2] if proj.shape[1] > 2 else 0,
               c=np.arange(len(proj)) if color_by_time else None, cmap="viridis", s=4)
    fig.tight_layout()
    return _fig_to_rgb(fig)
