"""WAV audio IO in numpy; counterpart of stable_audio_tools_tpu/data/wav.py.

Reads 8/16/24/32-bit PCM and 32-bit float WAV into float32 [channels,
samples]; writes 16-bit PCM or 32-bit float. Other formats need `soundfile`.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

AUDIO_EXTENSIONS = (".wav", ".flac", ".ogg", ".aif", ".aiff", ".mp3", ".opus")


def _chunks(path: str):
    """(fmt, data) chunk payloads of a RIFF/WAVE file."""
    fmt = data = None
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        while fmt is None or data is None:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (audio [C, T] float32 in [-1, 1], sample_rate)."""
    fmt, data = _chunks(path)
    audio_format, channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        x = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        x = np.where(x >= 2 ** 23, x - 2 ** 24, x).astype(np.float32) / (2 ** 23)
    elif bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / (2 ** 31)
    elif bits == 8:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported bit depth {bits}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), sample_rate


def save_wav(path: str, audio: np.ndarray, sample_rate: int, float32: bool = False) -> None:
    """audio: [C, T] or [T] float in [-1, 1]."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    C = audio.shape[0]
    interleaved = audio.T.reshape(-1)
    if float32:
        data = interleaved.astype("<f4").tobytes()
        fmt_chunk = struct.pack("<HHIIHH", 3, C, sample_rate, sample_rate * C * 4, C * 4, 32)
    else:
        data = np.clip(interleaved * 32767.0, -32768, 32767).astype("<i2").tobytes()
        fmt_chunk = struct.pack("<HHIIHH", 1, C, sample_rate, sample_rate * C * 2, C * 2, 16)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """WAV natively; other formats through `soundfile` when it is installed."""
    if path.lower().endswith(".wav"):
        return load_wav(path)
    try:
        import soundfile as sf
    except ImportError:
        raise ValueError(f"Cannot decode {path}: only WAV is read without soundfile") from None
    x, sr = sf.read(path, dtype="float32", always_2d=True)
    return x.T.copy(), sr
