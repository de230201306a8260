"""Autoencoder pretransform; counterpart of
stable_audio_tools_tpu/models/pretransforms.py (`AutoencoderPretransform`).
`model_half` runs the autoencoder in bf16 with f32 in and out, as the JAX
package; the parameters stay f32 and are cast at use. Layout: [B, C, T].
The pretransform is frozen: the diffusion factory turns its gradients off,
and training encodes under `torch.no_grad()`."""

from __future__ import annotations

import torch
from torch import nn

from .autoencoders import AudioAutoencoder


class AutoencoderPretransform(nn.Module):
    def __init__(self, model: AudioAutoencoder, scale: float = 1.0,
                 model_half: bool = False):
        super().__init__()
        self.model = model
        self.scale = scale
        self.model_half = model_half
        self.io_channels = model.io_channels
        self.encoded_channels = model.latent_dim
        self.downsampling_ratio = model.downsampling_ratio

    def encode(self, x: torch.Tensor, generator=None, noise=None) -> torch.Tensor:
        if self.model_half:
            x = x.to(torch.bfloat16)
        z = self.model.encode(x, generator=generator, noise=noise)
        return z.float() / self.scale if self.model_half else z / self.scale

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z * self.scale
        if self.model_half:
            z = z.to(torch.bfloat16)
        out = self.model.decode(z)
        return out.float() if self.model_half else out
