"""Pretransforms; counterpart of stable_audio_tools_tpu/models/pretransforms.py
(`AutoencoderPretransform` :42, `PretrainedCodecPretransform` :80,
`PatchedPretransform` :100, `WaveletPretransform` :117, `PQMFPretransform`
:133).
`model_half` runs the autoencoder in bf16 with f32 in and out, as the JAX
package; the parameters stay f32 and are cast at use. Layout: [B, C, T].
The pretransform is frozen: the diffusion factory turns its gradients off,
and training encodes under `torch.no_grad()`.

`chunked` sends encode and decode through the autoencoder's overlap-paste
codec (`encode_audio` / `decode_audio`: long audio in windows of 128 latents),
as the JAX package's. `iterate_batch` (the reference's flag, set by the
shipped SA-1.0 / SA-2.0 configs; the JAX package accepts and ignores it, its
compiled program batches what it likes) runs the batch items one at a time
through the codec, which bounds the decoder's activation memory by one item's.
A discrete codec (SEANet + RVQ, the LM's) adds `tokenize` and
`decode_tokens`, unchunked, in bf16 where `model_half` is set.

`PretrainedCodecPretransform` is an `AutoencoderPretransform` over a public
codec's architecture (DAC, EnCodec), built by the factory, that also
carries `num_quantizers`, `codebook_size` and `ckpt_path`; the codec's
weights come from that local file (`load_codec_state`), else they stay the
seeded random ones. On the card the factory runs a DAC codec in bf16
(`model_half`; the card's snake kernels take bf16 alone), where the JAX
package runs it in f32: a divergence, held against f32 by
tests/test_torch_pretransforms.py and by chip_smoke.py's phase 18b. On the
CPU it runs in f32, as the JAX package. The signal-domain pretransforms
(patching, the wavelet and PQMF filter banks) have no parameters."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .autoencoders import AudioAutoencoder
from .pqmf import pqmf_analysis, pqmf_synthesis
from .wavelets import get_filter_bank, wavelet_decode, wavelet_encode


class AutoencoderPretransform(nn.Module):
    def __init__(self, model: AudioAutoencoder, scale: float = 1.0,
                 model_half: bool = False, chunked: bool = False,
                 iterate_batch: bool = False):
        super().__init__()
        self.model = model
        self.scale = scale
        self.model_half = model_half
        self.chunked = chunked
        self.iterate_batch = iterate_batch
        self.io_channels = model.io_channels
        self.encoded_channels = model.latent_dim
        self.downsampling_ratio = model.downsampling_ratio

    def _items(self, batch: int):
        """Index of each pass through the codec: one item at a time with
        `iterate_batch`, else the whole batch."""
        if self.iterate_batch and batch > 1:
            return [slice(i, i + 1) for i in range(batch)]
        return [slice(None)]

    def encode(self, x: torch.Tensor, generator=None, noise=None) -> torch.Tensor:
        if self.model_half:
            x = x.to(torch.bfloat16)
        z = torch.cat([self.model.encode_audio(
            x[i], chunked=self.chunked, generator=generator,
            noise=None if noise is None else noise[i]) for i in self._items(x.shape[0])])
        return z.float() / self.scale if self.model_half else z / self.scale

    @property
    def is_discrete(self) -> bool:
        return self.model.is_discrete

    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """Audio [B, C, T] -> the codec's codes [B, Q, T / ratio] (JAX
        `tokenize` :70)."""
        if not self.is_discrete:
            raise ValueError("tokenize needs a discrete pretransform")
        if self.model_half:
            x = x.to(torch.bfloat16)
        return self.model.encode(x, return_info=True)[1][self.model.bottleneck.tokens_id]

    def decode_tokens(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        """Codes [B, Q, T] -> audio (JAX `decode_tokens` :75)."""
        if not self.is_discrete:
            raise ValueError("decode_tokens needs a discrete pretransform")
        out = self.model.decode_tokens(tokens, generator=generator,
                                       dtype=torch.bfloat16 if self.model_half else None)
        return out.float() if self.model_half else out

    def decode(self, z: torch.Tensor, generator=None) -> torch.Tensor:
        """Latents -> audio; a noise-augmenting bottleneck draws from
        `generator`."""
        z = z * self.scale
        if self.model_half:
            z = z.to(torch.bfloat16)
        out = torch.cat([self.model.decode_audio(z[i], chunked=self.chunked, generator=generator)
                         for i in self._items(z.shape[0])])
        return out.float() if self.model_half else out


class PretrainedCodecPretransform(AutoencoderPretransform):
    """A frozen public codec (DAC towers + the DAC RVQ, or SEANet towers +
    the EMA RVQ) as a discrete pretransform. With `ckpt_path` its weights
    load from that local file, in the codec's own layout or the port's
    (`load_codec_state`); without, they are the seeded random ones, as in the
    JAX package. Nothing is downloaded."""

    def __init__(self, model: AudioAutoencoder, num_quantizers: int, codebook_size: int,
                 ckpt_path: tp.Optional[str] = None, scale: float = 1.0, chunked: bool = False,
                 model_half: bool = False):
        super().__init__(model, scale=scale, model_half=model_half, chunked=chunked)
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.ckpt_path = ckpt_path
        if ckpt_path and next(model.parameters()).device.type != "meta":
            from ..io.checkpoints import load_codec_state, load_ckpt_state_dict

            load_codec_state(model, load_ckpt_state_dict(ckpt_path))

    def decode(self, z: torch.Tensor, generator=None) -> torch.Tensor:
        """Latents -> audio: the bottleneck's decode (the DAC RVQ quantizing
        on decode in f32, frame by frame, so the whole clip at once gives
        each chunk's codes) runs first, then the decoder, in bf16 where
        `model_half` is set."""
        z = self.model.bottleneck.decode(z * self.scale, generator=generator)
        out = self.model.decode_audio(z.to(torch.bfloat16) if self.model_half else z,
                                      chunked=self.chunked, skip_bottleneck=True)
        return out.float() if self.model_half else out


class _SignalPretransform(nn.Module):
    """A parameterless transform of the signal: [B, C, T] -> [B, C * r, T / r]."""

    is_discrete = False

    def __init__(self, io_channels: int, encoded_channels: tp.Optional[int],
                 downsampling_ratio: int, enable_grad: bool = False):
        super().__init__()
        self.io_channels = io_channels
        self.encoded_channels = encoded_channels
        self.downsampling_ratio = downsampling_ratio
        self.enable_grad = enable_grad


class PatchedPretransform(_SignalPretransform):
    """[B, C, T] -> [B, C * p, T / p]: each channel's time folded into p
    channels (sample i * p + j of channel c to channel c * p + j)."""

    def __init__(self, patch_size: int = 1, io_channels: int = 2, enable_grad: bool = False):
        super().__init__(io_channels, io_channels * patch_size, patch_size, enable_grad)
        self.patch_size = patch_size

    def encode(self, x: torch.Tensor, **_) -> torch.Tensor:
        B, C, T = x.shape
        p = self.patch_size
        return x.reshape(B, C, T // p, p).transpose(2, 3).reshape(B, C * p, T // p)

    def decode(self, z: torch.Tensor, **_) -> torch.Tensor:
        B, CP, S = z.shape
        p = self.patch_size
        return z.reshape(B, CP // p, p, S).transpose(2, 3).reshape(B, CP // p, S * p)


class WaveletPretransform(_SignalPretransform):
    """`levels` levels of the discrete wavelet transform (models/wavelets.py)."""

    def __init__(self, channels: int = 2, levels: int = 4, wavelet: str = "bior4.4",
                 enable_grad: bool = False):
        super().__init__(channels, channels * 2 ** levels, 2 ** levels, enable_grad)
        get_filter_bank(wavelet)  # an unknown or unsupported name raises here
        self.levels, self.wavelet = levels, wavelet

    def encode(self, x: torch.Tensor, **_) -> torch.Tensor:
        return wavelet_encode(x, self.wavelet, self.levels)

    def decode(self, z: torch.Tensor, **_) -> torch.Tensor:
        return wavelet_decode(z, self.wavelet, self.levels)


class PQMFPretransform(_SignalPretransform):
    """The pseudo-QMF bank of `num_bands` bands (models/pqmf.py).
    `io_channels` and `encoded_channels` are what the config says (the JAX
    factory passes them through, with io_channels 2 by default)."""

    def __init__(self, attenuation: int = 100, num_bands: int = 16, io_channels: int = 2,
                 encoded_channels: tp.Optional[int] = None, enable_grad: bool = False):
        super().__init__(io_channels, encoded_channels, num_bands, enable_grad)
        self.attenuation, self.num_bands = attenuation, num_bands

    def encode(self, x: torch.Tensor, **_) -> torch.Tensor:
        return pqmf_analysis(x, self.attenuation, self.num_bands)

    def decode(self, z: torch.Tensor, **_) -> torch.Tensor:
        return pqmf_synthesis(z, self.attenuation, self.num_bands)
