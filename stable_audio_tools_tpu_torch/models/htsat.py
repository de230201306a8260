"""The HTSAT audio tower of laion-clap (CLAP's audio branch); counterpart of
stable_audio_tools_tpu/models/htsat.py.

48 kHz mono -> `clap_logmel` (the port's stft, a periodic Hann window of
1024, hop 480, reflect-centred; the power spectrum through librosa's slaney
mel bank of 64 bands from 50 Hz to 14 kHz; 10 log10) -> `bn0` over the mel
bands (its running statistics, always) -> the spectrogram folded into a
256 x 256 image (time resized to 1024 frames by align-corners bicubic,
`bicubic_resize_1d`) -> 4 x 4 patches -> Swin stages (windows of 8, shifted
every other block, relative position bias, patch merging between stages)
-> LayerNorm -> the token mean: CLAP's audio "embedding" [B, 8 x embed_dim].

Parameters keep laion-clap's names under the caller's prefix
(`audio_branch.` in a CLAP checkpoint): `bn0`, `patch_embed.{proj, norm,
mel_conv2d, fusion_model.{local_att, global_att}}`,
`layers.{i}.blocks.{j}.{norm1, attn.{qkv, proj,
relative_position_bias_table}, norm2, mlp.{fc1, fc2}}`,
`layers.{i}.downsample.{norm, reduction}`, `norm`; so the JAX package's
`import_htsat` (:438) loads the port's state dict. The relative position
index is a buffer left out of the state dict.

The tower is inference-only and frozen, as the JAX package's: no dropout or
drop-path, and every BatchNorm reads its running statistics whatever the
module's mode. The JAX package's attention and LayerNorm are plain flax, so
the port's are plain PyTorch (no kernel of the port runs here). The JAX
LayerNorms take flax's epsilon 1e-6 where laion-clap's torch modules take
1e-5; the port copies the JAX package. With `enable_fusion` the patch embed
builds laion's fusion branch (`mel_conv2d` over the three local mel stacks,
`AFF2d`); it runs only for a `longer` flag, which CLAP's conditioner never
passes, as in the JAX package.
"""

from __future__ import annotations

import typing as tp
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import mel_filterbank, stft

LN_EPS = 1e-6  # flax's LayerNorm epsilon, which the JAX tower runs with
BN_EPS = 1e-5


@lru_cache(maxsize=16)
def _relative_position_index(window: int) -> np.ndarray:
    """Swin's relative position index [window^2, window^2]."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@lru_cache(maxsize=32)
def _shift_attn_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """The shifted windows' mask [nW, N, N]: 0 within a region, -100 across."""
    img = np.zeros((H, W))
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    wins = img.reshape(H // window, window, W // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=16)
def _bicubic_weights(n_in: int, n_out: int) -> tp.Tuple[np.ndarray, np.ndarray]:
    """torch's bicubic (a = -0.75), align-corners tables: indices and weights
    [n_out, 4]."""
    a = -0.75
    pos = np.zeros(1) if n_out == 1 else np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(pos).astype(np.int64)

    def k(x):
        x = np.abs(x)
        return np.where(x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                        np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a, 0.0))

    idx = np.stack([i0 - 1, i0, i0 + 1, i0 + 2], axis=1)
    w = k(idx - pos[:, None])
    return np.clip(idx, 0, n_in - 1), w.astype(np.float32)


def bicubic_resize_1d(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """F.interpolate(mode="bicubic", align_corners=True) along one axis."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    idx, w = _bicubic_weights(n_in, n_out)
    g = x.index_select(dim, torch.from_numpy(idx.reshape(-1)).to(x.device))
    shape = list(x.shape)
    shape[dim: dim + 1] = [n_out, 4]
    g = g.reshape(shape)
    w_shape = [1] * g.dim()
    w_shape[dim], w_shape[dim + 1] = n_out, 4
    return (g * torch.from_numpy(w).to(x.device, x.dtype).reshape(w_shape)).sum(dim + 1)


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """`bn` with its running statistics whatever its mode (the tower is frozen)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, BN_EPS)


class SwinMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.tensor(_relative_position_index(window).reshape(-1)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B_, N, C] windows; mask [nW, N, N] or None."""
        B_, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        attn = (q * (C // h) ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(B_, h, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(B_, N, C))


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def _window_reverse(wins: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    B = wins.shape[0] // (H * W // window // window)
    x = wins.reshape(B, H // window, W // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: tp.Tuple[int, int], num_heads: int, window: int,
                 shift: int, mlp_ratio: float = 4.0):
        super().__init__()
        H, W = resolution
        if min(H, W) <= window:
            window, shift = min(H, W), 0
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio))
        mask = _shift_attn_mask(H, W, window, shift) if shift > 0 else np.zeros(0, np.float32)
        self.register_buffer("attn_mask", torch.tensor(mask), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (H, W), window, shift = self.resolution, self.window, self.shift
        B, N, C = x.shape
        h = self.norm1(x).reshape(B, H, W, C)
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        wins = self.attn(_window_partition(h, window),
                         mask=self.attn_mask if shift > 0 else None)
        h = _window_reverse(wins, window, H, W)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h.reshape(B, N, C)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: tp.Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(B, -1, 4 * C)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, resolution: tp.Tuple[int, int], depth: int, num_heads: int,
                 window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, resolution, num_heads, window, 0 if j % 2 == 0 else window // 2)
            for j in range(depth)])
        self.downsample = PatchMerging(dim, resolution) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


def _aff_branch(channels: int, inter: int, pooled: bool) -> nn.Sequential:
    """laion-clap's AFF branch: [pool,] conv 1x1, BN, ReLU, conv 1x1, BN."""
    layers = [nn.AdaptiveAvgPool2d(1)] if pooled else []
    layers += [nn.Conv2d(channels, inter, 1), nn.BatchNorm2d(inter), nn.ReLU(),
               nn.Conv2d(inter, channels, 1), nn.BatchNorm2d(channels)]
    return nn.Sequential(*layers)


class AFF2d(nn.Module):
    """laion-clap's attention feature fusion (2-D), BatchNorms on their
    running statistics."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = max(channels // r, 1)
        self.local_att = _aff_branch(channels, inter, False)
        self.global_att = _aff_branch(channels, inter, True)

    @staticmethod
    def _run(branch: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        for layer in branch:
            h = _batch_norm(layer, h) if isinstance(layer, nn.BatchNorm2d) else layer(h)
        return h

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(self._run(self.local_att, xa) + self._run(self.global_att, xa))
        return 2 * x * wei + 2 * residual * (1 - wei)


class HTSATPatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int = 4, patch_stride: int = 4,
                 enable_fusion: bool = False):
        super().__init__()
        self.enable_fusion = enable_fusion
        self.proj = nn.Conv2d(1, embed_dim, patch_size, stride=patch_stride)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        if enable_fusion:
            self.mel_conv2d = nn.Conv2d(1, embed_dim, (patch_size, patch_size * 3),
                                        stride=(patch_stride, patch_stride * 3))
            self.fusion_model = AFF2d(embed_dim)

    def forward(self, x: torch.Tensor, longer: tp.Optional[torch.Tensor] = None):
        """x [B, C_in, H, W] (1 channel, or 4 mel stacks with fusion) ->
        (tokens [B, Hp * Wp, D], (Hp, Wp))."""
        g = self.proj(x[:, 0:1] if self.enable_fusion else x)  # [B, D, Hp, Wp]
        if self.enable_fusion and longer is not None:
            B, _, H, W = x.shape
            local = self.mel_conv2d(x[:, 1:].reshape(B * 3, 1, H, W))
            local = local.reshape(B, 3, *local.shape[1:])
            local = torch.cat([local[:, 0], local[:, 1], local[:, 2]], dim=3)
            TW = g.shape[3]
            local = (F.pad(local, (0, TW - local.shape[3])) if local.shape[3] < TW
                     else local[..., :TW])
            use = longer.to(g.dtype).reshape(-1, 1, 1, 1)
            g = self.fusion_model(g, local) * use + g * (1 - use)
        Hp, Wp = g.shape[2], g.shape[3]
        return self.norm(g.flatten(2).transpose(1, 2)), (Hp, Wp)


class HTSAT(nn.Module):
    """The Swin trunk -> CLAP's audio embedding (before the projection)."""

    def __init__(self, spec_size: int = 256, patch_size: int = 4, embed_dim: int = 128,
                 depths: tp.Sequence[int] = (2, 2, 12, 2),
                 num_heads: tp.Sequence[int] = (4, 8, 16, 32), window: int = 8,
                 mel_bins: int = 64, enable_fusion: bool = False):
        super().__init__()
        self.spec_size, self.mel_bins = spec_size, mel_bins
        self.freq_ratio = spec_size // mel_bins
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.bn0 = nn.BatchNorm2d(mel_bins)
        self.patch_embed = HTSATPatchEmbed(embed_dim, patch_size, patch_size, enable_fusion)
        res = (spec_size // patch_size,) * 2
        layers, dim = [], embed_dim
        for i, depth in enumerate(depths):
            last = i == len(depths) - 1
            layers.append(BasicLayer(dim, res, depth, num_heads[i], window, not last))
            if not last:
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def reshape_wav2img(self, x: torch.Tensor) -> torch.Tensor:
        """Log-mel [B, C, T, F] -> the image [B, C, spec, spec]."""
        target_t, target_f = self.spec_size * self.freq_ratio, self.spec_size // self.freq_ratio
        x = x[:, :, :target_t, :target_f]
        if x.shape[2] < target_t:
            x = bicubic_resize_1d(x, target_t, 2)
        if x.shape[3] < target_f:
            x = bicubic_resize_1d(x, target_f, 3)
        B, C, T, Fb = x.shape
        x = x.transpose(2, 3).reshape(B, C, Fb, self.freq_ratio, T // self.freq_ratio)
        return x.transpose(2, 3).reshape(B, C, Fb * self.freq_ratio, T // self.freq_ratio)

    def forward(self, mel: torch.Tensor, longer: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, C, T, F] (C 1, or 4 with fusion) -> [B, num_features]."""
        x = _batch_norm(self.bn0, mel.transpose(1, 3)).transpose(1, 3)
        x, _ = self.patch_embed(self.reshape_wav2img(x), longer=longer)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x).mean(dim=1)


def clap_logmel(audio: torch.Tensor, sample_rate: int = 48000, n_fft: int = 1024,
                hop: int = 480, mels: int = 64, fmin: float = 50.0,
                fmax: float = 14000.0) -> torch.Tensor:
    """audio [B, T] mono -> log-mel [B, 1, frames, mels] (torchlibrosa's
    Spectrogram + LogmelFilterBank: power, slaney mel, 10 log10 of at least
    1e-10)."""
    s = stft(audio, n_fft, hop, n_fft, center=True)
    power = s.real ** 2 + s.imag ** 2
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, mels, fmin, fmax, htk=False,
                                         norm="slaney")).to(audio.device)
    return (10.0 * torch.log10(torch.clamp(power @ fb.T, min=1e-10)))[:, None]


def prepare_clap_audio(audio: np.ndarray, max_len: int = 480000) -> np.ndarray:
    """laion-clap's "repeatpad" for a clip of at most `max_len` samples: the
    clip tiled to fill, the tail zero-padded; a longer clip is cut to its
    centre `max_len` samples (JAX :396)."""
    audio = np.asarray(audio, np.float32).ravel()
    if audio.size == 0:
        return np.zeros(max_len, np.float32)
    if audio.size < max_len:
        tiled = np.tile(audio, max(int(max_len / audio.size), 1))
        out = np.zeros(max_len, np.float32)
        out[: tiled.size] = tiled[:max_len]
        return out
    start = (audio.size - max_len) // 2
    return audio[start: start + max_len]
