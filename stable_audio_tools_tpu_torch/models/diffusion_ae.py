"""The diffusion autoencoder; counterpart of
stable_audio_tools_tpu/models/diffusion_ae.py (`DiffusionAutoencoder` :23,
`create_diffAE_from_config` :112).

An encoder (and bottleneck) gives latents; the decoder is a v-diffusion
model conditioned on them by input concatenation: `diffusion_forward` runs
the optional `decoder` tower on the latents, upsamples them to the noised
input's length by nearest index (floor(arange(L) * (T / L)), JAX :62-67)
and hands them to the diffusion model as `input_concat_cond`; `decode`
samples from noise by v-DDIM (`inference/sampling.py::sample`, eta 0) and
decodes through the pretransform where there is one. The diffusion model is
Dance's UNet with `cond_dim` (`DAU1d`, under `DAU1DCondWrapper`), the ADP
`UNet1d` (`adp_1d`, under `UNet1DCondWrapper`, its `context_channels` the
latents') or the DiT (`dit`, its `input_concat_dim` the latents'; objective
"v"); `diffusion_downsampling_ratio` is the product of its strides or
factors (1 for the DiT), kept as in JAX.

Module names follow the reference layout: `encoder.*`, `decoder.*`,
`bottleneck.*`, `diffusion.model.*`, `pretransform.model.*`. The pretransform
is frozen (no gradient, `requires_grad` off).

`encoder_compute_dtype` (a key of the model config the JAX factory does not
read): the encoder and the bottleneck run in that dtype (the audio cast to
it; the latents come back f32). The card's snake kernels take bf16 only, so
an Oobleck encoder with the snake needs "bfloat16" there; the JAX module
encodes in f32 (`tests/test_torch_diffae.py` pins the distance). The
bottleneck's decode-side draws and the sampler's noise come from the
`generator` handed to `decode`, or are injected (`noise`,
`bottleneck_noise`)."""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from ..inference.sampling import sample


class DiffusionAutoencoder(nn.Module):
    def __init__(self, encoder: tp.Optional[nn.Module], decoder: tp.Optional[nn.Module],
                 diffusion: nn.Module, io_channels: int, sample_rate: int, latent_dim: int,
                 downsampling_ratio: int, diffusion_downsampling_ratio: int = 1,
                 bottleneck: tp.Optional[nn.Module] = None, pretransform=None,
                 encoder_compute_dtype: tp.Optional[str] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.diffusion = diffusion
        self.bottleneck = bottleneck
        self.pretransform = pretransform
        self.io_channels = io_channels
        self.sample_rate = sample_rate
        self.latent_dim = latent_dim
        self.downsampling_ratio = downsampling_ratio
        self.diffusion_downsampling_ratio = diffusion_downsampling_ratio
        self.encoder_compute_dtype = (None if encoder_compute_dtype is None
                                      else getattr(torch, encoder_compute_dtype))

    @property
    def min_length(self) -> int:
        return self.downsampling_ratio

    def encode(self, audio: torch.Tensor, return_info: bool = False, train: bool = False,
               generator: tp.Optional[torch.Generator] = None, noise=None):
        """audio [B, C, T] -> latents [B, latent_dim, T / ratio] (f32): the
        frozen pretransform's encode, the encoder, then the bottleneck (its
        losses in info; `train` moves an RVQ's state)."""
        if self.pretransform is not None:
            with torch.no_grad():
                audio = self.pretransform.encode(audio)
        if self.encoder_compute_dtype is not None:
            audio = audio.to(self.encoder_compute_dtype)
        latents = self.encoder(audio) if self.encoder is not None else audio
        info = {}
        if self.bottleneck is not None:
            latents, info = self.bottleneck.encode(latents, return_info=True, train=train,
                                                   generator=generator, noise=noise)
        latents = latents.float()
        return (latents, info) if return_info else latents

    def upsample_latents(self, latents: torch.Tensor, length: int) -> torch.Tensor:
        """The decoder tower's output of `latents`, taken to `length` by
        nearest index."""
        cond = self.decoder(latents) if self.decoder is not None else latents
        if cond.shape[2] != length:  # the index in f32, as JAX's, made on the card
            idx = torch.arange(length, dtype=torch.float32, device=cond.device)
            cond = cond[:, :, torch.floor(idx * (cond.shape[2] / length)).long()]
        return cond

    def diffusion_forward(self, x: torch.Tensor, t: torch.Tensor, latents: torch.Tensor,
                          **draws) -> torch.Tensor:
        """v of the noised x [B, io_channels, T] at t [B], conditioned on
        `latents`; `draws` (the DAU1d's `generator`, `aug_level`,
        `cond_noise`) go to the diffusion model."""
        return self.diffusion(x, t, input_concat_cond=self.upsample_latents(latents, x.shape[2]),
                              **draws)

    def decode(self, latents: torch.Tensor, steps: int = 100,
               generator: tp.Optional[torch.Generator] = None,
               noise: tp.Optional[torch.Tensor] = None, bottleneck_noise=None,
               **draws) -> torch.Tensor:
        """latents [B, latent_dim, S] -> audio [B, io_channels, S x ratio]
        (through the pretransform's decode where there is one): the
        bottleneck's decode, then `steps` of v-DDIM from `noise` (default:
        standard normals from `generator`), the model conditioned on the
        latents at every step."""
        length = latents.shape[2] * self.downsampling_ratio
        if self.bottleneck is not None:
            latents = self.bottleneck.decode(latents, generator=generator, noise=bottleneck_noise)
        if noise is None:
            noise = torch.randn((latents.shape[0], self.io_channels, length),
                                generator=generator, device=latents.device)
        draws.setdefault("generator", generator)
        decoded = sample(lambda x, t, **kw: self.diffusion_forward(x, t, latents, **draws),
                         noise.to(latents.device, torch.float32), steps, 0.0)
        if self.pretransform is not None:
            with torch.no_grad():
                decoded = self.pretransform.decode(decoded, generator=generator)
        return decoded

    @torch.no_grad()
    def pretransform_encode(self, audio: torch.Tensor) -> torch.Tensor:
        return self.pretransform.encode(audio)


def create_diffAE_from_config(config: tp.Dict[str, tp.Any], device=None) -> DiffusionAutoencoder:
    """`diffusion_autoencoder` configs -> the model, its parameters on
    `device` (default: the current CUDA card)."""
    from .adp import create_adp_cond_wrapper
    from .dance_unet import DiffusionAttnUnet1D
    from .diffusion import DAU1D_FIELDS, DAU1DCondWrapper, DiTWrapper
    from .dit import DiffusionTransformer
    from .autoencoders import OobleckDecoder, OobleckEncoder
    from .dac import DACDecoderWrapper, DACEncoderWrapper
    from .factory import _bottleneck, _tower, create_pretransform_from_config, resolve_device
    from .seanet import SEANetDecoder, SEANetEncoder

    device = resolve_device(device)
    cfg = config["model"]
    sample_rate = config.get("sample_rate")
    if sample_rate is None:
        raise ValueError("Must specify sample_rate in config")
    d_type, d_cfg = cfg["diffusion"]["type"], cfg["diffusion"]["config"]
    pretransform = cfg.get("pretransform")
    if pretransform is not None:
        pretransform = create_pretransform_from_config(pretransform, sample_rate, device)
        pretransform.requires_grad_(False)
    with device:
        encoder = (_tower(cfg["encoder"], "in_channels", OobleckEncoder, SEANetEncoder,
                          DACEncoderWrapper) if "encoder" in cfg else None)
        decoder = (_tower(cfg["decoder"], "out_channels", OobleckDecoder, SEANetDecoder,
                          DACDecoderWrapper) if "decoder" in cfg else None)
        if d_type == "DAU1d":
            diffusion = DAU1DCondWrapper(DiffusionAttnUnet1D(
                **{k: d_cfg[k] for k in DAU1D_FIELDS if k in d_cfg}))
            ddr = math.prod(d_cfg["strides"])
        elif d_type == "adp_1d":
            diffusion = create_adp_cond_wrapper("adp_1d", d_cfg)
            ddr = math.prod(d_cfg["factors"])
        elif d_type == "dit":
            diffusion = DiTWrapper(DiffusionTransformer(**d_cfg, diffusion_objective="v"))
            ddr = 1
        else:
            raise ValueError(f"Unknown diffusion type {d_type}")
        bottleneck = _bottleneck(cfg.get("bottleneck"))
    return DiffusionAutoencoder(
        encoder=encoder, decoder=decoder, diffusion=diffusion, io_channels=cfg["io_channels"],
        sample_rate=sample_rate, latent_dim=cfg["latent_dim"],
        downsampling_ratio=cfg["downsampling_ratio"], diffusion_downsampling_ratio=ddr,
        bottleneck=bottleneck, pretransform=pretransform,
        encoder_compute_dtype=cfg.get("encoder_compute_dtype"))
