"""Autoencoder pretransform; counterpart of
stable_audio_tools_tpu/models/pretransforms.py (`AutoencoderPretransform`).
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
`decode_tokens`; the JAX package runs neither chunked nor in half precision,
and neither does the port."""

from __future__ import annotations

import torch
from torch import nn

from .autoencoders import AudioAutoencoder


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
        return self.model.encode(x, return_info=True)[1][self.model.bottleneck.tokens_id]

    def decode_tokens(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        """Codes [B, Q, T] -> audio (JAX `decode_tokens` :75)."""
        if not self.is_discrete:
            raise ValueError("decode_tokens needs a discrete pretransform")
        return self.model.decode_tokens(tokens, generator=generator)

    def decode(self, z: torch.Tensor, generator=None) -> torch.Tensor:
        """Latents -> audio; a noise-augmenting bottleneck draws from
        `generator`."""
        z = z * self.scale
        if self.model_half:
            z = z.to(torch.bfloat16)
        out = torch.cat([self.model.decode_audio(z[i], chunked=self.chunked, generator=generator)
                         for i in self._items(z.shape[0])])
        return out.float() if self.model_half else out
