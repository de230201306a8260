"""Diffusion wrappers; counterpart of stable_audio_tools_tpu/models/diffusion.py
(DiffusionModelWrapper :33, ConditionedDiffusionModelWrapper :62, DiTWrapper
:175, DiTUncondWrapper :208, DAU1DCondWrapper :215,
create_diffusion_uncond_from_config :234, create_diffusion_cond_from_config
:285).

Module names follow the reference checkpoint layout: `model.model.*` (the
DiT, or SA-1.0's ADP `UNetCFG1d`, models/adp.py), `conditioner.conditioners.<id>.*`,
`pretransform.model.*`.

The unconditional wrapper holds the v-model under `model` (Dance Diffusion's
`DAU1d`, models/dance_unet.py; `adp_uncond_1d`, the ADP `UNet1d` under
`UNet1DUncondWrapper`; `dit`, the DiT under `DiTUncondWrapper`, its
objective "v") and an optional pretransform. The conditioned one also takes
`adp_1d` (models/adp.py `UNet1DCondWrapper`); `DAU1DCondWrapper` is the
diffusion autoencoder's (models/diffusion_ae.py).

Trainable: the DiT and the conditioners' own layers (the number embedders,
the list and phoneme tables, the T5, CLAP and audio-prompt projections),
which get gradients in the JAX package and the reference. Frozen
(`requires_grad` off): the pretransform (which a `pretransform` or
`source_mix` conditioner with `use_model_pretransform` encodes with), the T5
and CLAP towers, as in the reference.
"""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from .adp import (UNET_FIELDS, UNet1d, UNet1DCondWrapper, UNet1DUncondWrapper,
                  UNetCFG1DWrapper, create_adp_cond_wrapper)
from .conditioners import MultiConditioner, create_multi_conditioner_from_conditioning_config
from .dance_unet import DiffusionAttnUnet1D
from .dit import DiffusionTransformer
from .pretransforms import AutoencoderPretransform


class DiffusionModelWrapper(nn.Module):
    """An unconditional v-model: forward(x, t) -> v, and the frozen
    pretransform's encode and decode."""

    def __init__(self, model: nn.Module, io_channels: int, sample_size: int, sample_rate: int,
                 min_input_length: int, pretransform: tp.Optional[AutoencoderPretransform] = None,
                 diffusion_objective: str = "v"):
        super().__init__()
        self.model = model
        self.pretransform = pretransform
        self.io_channels = io_channels
        self.sample_size = sample_size
        self.sample_rate = sample_rate
        self.min_input_length = min_input_length
        self.diffusion_objective = diffusion_objective

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.model(x, t)

    @torch.no_grad()
    def pretransform_encode(self, audio: torch.Tensor, generator=None, noise=None) -> torch.Tensor:
        return self.pretransform.encode(audio, generator=generator, noise=noise)

    def pretransform_decode(self, latents: torch.Tensor, generator=None) -> torch.Tensor:
        return self.pretransform.decode(latents, generator=generator)


# the keyword arguments of the JAX DiffusionAttnUnet1D (its factory drops others)
DAU1D_FIELDS = ("io_channels", "depth", "n_attn_layers", "channels", "cond_dim",
                "cond_noise_aug", "kernel_size", "learned_resample", "strides", "conv_bias",
                "compute_dtype")


def create_diffusion_uncond_from_config(config: tp.Dict[str, tp.Any], device=None
                                        ) -> DiffusionModelWrapper:
    """`diffusion_uncond` configs -> the wrapper, its parameters on `device`
    (default: the current CUDA card)."""
    from .factory import create_pretransform_from_config, resolve_device

    device = resolve_device(device)
    model_config = config["model"]
    model_type = model_config.get("type")
    for key in ("sample_size", "sample_rate"):
        if config.get(key) is None:
            raise ValueError(f"Must specify {key} in config")
    if model_type not in ("DAU1d", "adp_uncond_1d", "dit"):
        raise NotImplementedError(f"Unknown model type: {model_type}")
    pretransform = model_config.get("pretransform")
    min_input_length = 1
    if pretransform is not None:
        pretransform = create_pretransform_from_config(pretransform, config["sample_rate"], device)
        pretransform.requires_grad_(False)
        min_input_length = pretransform.downsampling_ratio
    cfg = model_config.get("config", {})
    with device:
        if model_type == "DAU1d":
            model = DiffusionAttnUnet1D(**{k: cfg[k] for k in DAU1D_FIELDS if k in cfg})
            io_channels = model.io_channels
            min_input_length *= math.prod(model.strides)
        elif model_type == "adp_uncond_1d":
            model = UNet1DUncondWrapper(UNet1d(**{k: v for k, v in cfg.items()
                                                  if k in UNET_FIELDS}))
            io_channels = cfg["in_channels"]
            min_input_length *= math.prod(cfg["factors"]) * cfg.get("patch_size", 1)
        else:
            model = DiTUncondWrapper(DiffusionTransformer(**cfg, diffusion_objective="v"))
            io_channels = model.model.io_channels
            min_input_length *= model.model.patch_size
    return DiffusionModelWrapper(
        model, io_channels=io_channels, sample_size=config["sample_size"],
        sample_rate=config["sample_rate"], min_input_length=min_input_length,
        pretransform=pretransform)


class DiTUncondWrapper(nn.Module):
    """The unconditional DiT (JAX :208): forward(x, t, **kwargs) ->
    the DiT's."""

    def __init__(self, model: DiffusionTransformer):
        super().__init__()
        self.model = model

    def forward(self, x, t, **kwargs):
        return self.model(x, t, **kwargs)


class DAU1DCondWrapper(nn.Module):
    """Dance's UNet with input-concat conditioning (JAX :215): the
    conditioned wrappers' `input_concat_cond` as its `cond`; its draws
    (`generator`, `aug_level`, `cond_noise`) pass on, the rest is dropped."""

    def __init__(self, model: DiffusionAttnUnet1D):
        super().__init__()
        self.model = model

    def forward(self, x, t, input_concat_cond=None, generator=None, aug_level=None,
                cond_noise=None, **kwargs):
        del kwargs
        return self.model(x, t, cond=input_concat_cond, generator=generator,
                          aug_level=aug_level, cond_noise=cond_noise)


class DiTWrapper(nn.Module):
    """Adapter: wrapper kwargs -> DiffusionTransformer. As in the JAX package
    (:175), `cross_attn_mask`, `negative_global_cond` and
    `negative_input_concat_cond` are accepted and not used by the DiT; the
    rest (`return_info`, `exit_layer_ix`, ...) pass through."""

    takes_return_info = True  # cfg++ and ARC call the model with it

    def __init__(self, model: DiffusionTransformer):
        super().__init__()
        self.model = model

    def forward(self, x, t, cross_attn_cond=None, cross_attn_mask=None,
                negative_cross_attn_cond=None, negative_cross_attn_mask=None,
                input_concat_cond=None, negative_input_concat_cond=None,
                global_cond=None, negative_global_cond=None,
                prepend_cond=None, prepend_cond_mask=None, **kwargs):
        del cross_attn_mask, negative_input_concat_cond, negative_global_cond
        return self.model(x, t, cross_attn_cond=cross_attn_cond,
                          negative_cross_attn_cond=negative_cross_attn_cond,
                          negative_cross_attn_mask=negative_cross_attn_mask,
                          input_concat_cond=input_concat_cond, global_embed=global_cond,
                          prepend_cond=prepend_cond, prepend_cond_mask=prepend_cond_mask,
                          **kwargs)


class ConditionedDiffusionModelWrapper(nn.Module):
    def __init__(self, model: tp.Union[DiTWrapper, UNetCFG1DWrapper], conditioner: tp.Optional[MultiConditioner],
                 io_channels: int, sample_rate: int, diffusion_objective: str = "v",
                 pretransform: tp.Optional[AutoencoderPretransform] = None,
                 cross_attn_cond_ids: tp.Sequence[str] = (),
                 global_cond_ids: tp.Sequence[str] = (),
                 input_concat_ids: tp.Sequence[str] = (),
                 prepend_cond_ids: tp.Sequence[str] = (),
                 distribution_shift_options: tp.Optional[tp.Mapping[str, tp.Any]] = None):
        super().__init__()
        self.model = model
        self.conditioner = conditioner
        self.pretransform = pretransform
        self.io_channels = io_channels
        self.sample_rate = sample_rate
        self.diffusion_objective = diffusion_objective
        self.cross_attn_cond_ids = tuple(cross_attn_cond_ids)
        self.global_cond_ids = tuple(global_cond_ids)
        self.input_concat_ids = tuple(input_concat_ids)
        self.prepend_cond_ids = tuple(prepend_cond_ids)
        # the timestep shift's options (JAX :76); an empty dict means no shift
        self.distribution_shift_options = distribution_shift_options

    def get_conditioning_inputs(self, cond: tp.Dict[str, tp.Tuple[torch.Tensor, torch.Tensor]],
                                negative: bool = False) -> tp.Dict[str, torch.Tensor]:
        """Route {key: (tensor, mask)} into the DiT's keyword arguments (JAX
        :78): cross-attention tokens and masks concatenated along the
        sequence, global conditions along the width, input-concat conditions
        along the channels, prepend conditions along the sequence. With
        `negative` the same routing under the `negative_*` names (the CFG
        pass's unconditional half)."""
        def with_mask(key):
            c, m = cond[key]
            if c.dim() == 2:
                c, m = c[:, None, :], (m[:, None] if m is not None else None)
            if m is None:
                m = torch.ones(c.shape[:2], dtype=torch.bool, device=c.device)
            return c, m

        def along_sequence(keys):
            pairs = [with_mask(key) for key in keys]
            return torch.cat([c for c, _ in pairs], dim=1), torch.cat([m for _, m in pairs], dim=1)

        cross = cross_mask = glob = concat = prepend = prepend_mask = None
        if self.cross_attn_cond_ids:
            cross, cross_mask = along_sequence(self.cross_attn_cond_ids)
        if self.global_cond_ids:
            glob = torch.cat([cond[key][0] for key in self.global_cond_ids], dim=-1)
            if glob.dim() == 3:
                glob = glob.squeeze(1)
        if self.input_concat_ids:
            concat = torch.cat([cond[key][0] for key in self.input_concat_ids], dim=1)
        if self.prepend_cond_ids:
            prepend, prepend_mask = along_sequence(self.prepend_cond_ids)
        if negative:
            return {"negative_cross_attn_cond": cross, "negative_cross_attn_mask": cross_mask,
                    "negative_global_cond": glob, "negative_input_concat_cond": concat}
        return {"cross_attn_cond": cross, "cross_attn_mask": cross_mask, "global_cond": glob,
                "input_concat_cond": concat, "prepend_cond": prepend,
                "prepend_cond_mask": prepend_mask}

    def forward(self, x: torch.Tensor, t: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.model(x, t, **kwargs)

    @torch.no_grad()
    def pretransform_encode(self, audio: torch.Tensor, generator=None, noise=None) -> torch.Tensor:
        """Audio [B, C, T] -> latents, with no gradient (the pretransform is
        frozen: JAX `pretransform_encode` :167 stops the gradient)."""
        return self.pretransform.encode(audio, generator=generator, noise=noise)


def create_diffusion_cond_from_config(config: tp.Dict[str, tp.Any], device=None
                                      ) -> ConditionedDiffusionModelWrapper:
    """`diffusion_cond` / `diffusion_cond_inpaint` configs -> the wrapper,
    its parameters on `device` (default: the current CUDA card)."""
    from .factory import create_pretransform_from_config, resolve_device

    device = resolve_device(device)
    model_config = config["model"]
    diffusion = model_config["diffusion"]
    if diffusion["type"] not in ("dit", "adp_cfg_1d", "adp_1d"):
        raise NotImplementedError(f"diffusion model type {diffusion['type']} is not ported yet")
    pretransform = model_config.get("pretransform")
    if pretransform is not None:
        pretransform = create_pretransform_from_config(pretransform, config["sample_rate"], device)
        pretransform.requires_grad_(False)
    conditioning = model_config.get("conditioning")
    with device:
        conditioner = (create_multi_conditioner_from_conditioning_config(
            conditioning, pretransform=pretransform, device=device)
                       if conditioning is not None else None)
        if diffusion["type"] == "dit":
            model = DiTWrapper(DiffusionTransformer(
                **diffusion["config"],
                diffusion_objective=diffusion.get("diffusion_objective", "v")))
        else:
            model = create_adp_cond_wrapper(diffusion["type"], diffusion["config"])
    return ConditionedDiffusionModelWrapper(
        model, conditioner,
        io_channels=model_config["io_channels"],
        sample_rate=config["sample_rate"],
        diffusion_objective=diffusion.get("diffusion_objective", "v"),
        pretransform=pretransform,
        cross_attn_cond_ids=diffusion.get("cross_attention_cond_ids", ()),
        global_cond_ids=diffusion.get("global_cond_ids", ()),
        input_concat_ids=diffusion.get("input_concat_ids", ()),
        prepend_cond_ids=diffusion.get("prepend_cond_ids", ()),
        distribution_shift_options=diffusion.get("distribution_shift_options"),
    )
