"""Conditioned diffusion wrapper; counterpart of
stable_audio_tools_tpu/models/diffusion.py (ConditionedDiffusionModelWrapper
:62, DiTWrapper :175, create_diffusion_cond_from_config :285).

Module names follow the reference checkpoint layout: `model.model.*` (the
DiT), `conditioner.conditioners.<id>.*`, `pretransform.model.*`.

Trainable: the DiT and the conditioners' own layers (the number embedders, a
T5 projection), which get gradients in the JAX package and the reference.
Frozen (`requires_grad` off): the pretransform and the T5 tower, as in the
reference.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .conditioners import MultiConditioner, create_multi_conditioner_from_conditioning_config
from .dit import DiffusionTransformer
from .pretransforms import AutoencoderPretransform


class DiTWrapper(nn.Module):
    """Adapter: wrapper kwargs -> DiffusionTransformer."""

    def __init__(self, model: DiffusionTransformer):
        super().__init__()
        self.model = model

    def forward(self, x, t, cross_attn_cond=None, global_cond=None, **kwargs):
        return self.model(x, t, cross_attn_cond=cross_attn_cond, global_embed=global_cond,
                          **kwargs)


class ConditionedDiffusionModelWrapper(nn.Module):
    def __init__(self, model: DiTWrapper, conditioner: tp.Optional[MultiConditioner],
                 io_channels: int, sample_rate: int, diffusion_objective: str = "v",
                 pretransform: tp.Optional[AutoencoderPretransform] = None,
                 cross_attn_cond_ids: tp.Sequence[str] = (),
                 global_cond_ids: tp.Sequence[str] = ()):
        super().__init__()
        self.model = model
        self.conditioner = conditioner
        self.pretransform = pretransform
        self.io_channels = io_channels
        self.sample_rate = sample_rate
        self.diffusion_objective = diffusion_objective
        self.cross_attn_cond_ids = tuple(cross_attn_cond_ids)
        self.global_cond_ids = tuple(global_cond_ids)

    def get_conditioning_inputs(self, cond: tp.Dict[str, tp.Tuple[torch.Tensor, torch.Tensor]]
                                ) -> tp.Dict[str, torch.Tensor]:
        """Route {key: (tensor, mask)} into the DiT's keyword arguments. The
        masks are not routed: the DiT does not use a cross-attention mask
        (as the reference's), and padding tokens arrive zeroed."""
        cross = glob = None
        if self.cross_attn_cond_ids:
            cross = torch.cat([cond[key][0] if cond[key][0].dim() == 3 else cond[key][0][:, None]
                               for key in self.cross_attn_cond_ids], dim=1)
        if self.global_cond_ids:
            glob = torch.cat([cond[key][0] for key in self.global_cond_ids], dim=-1)
            if glob.dim() == 3:
                glob = glob.squeeze(1)
        return {"cross_attn_cond": cross, "global_cond": glob}

    def forward(self, x: torch.Tensor, t: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.model(x, t, **kwargs)

    @torch.no_grad()
    def pretransform_encode(self, audio: torch.Tensor, generator=None, noise=None) -> torch.Tensor:
        """Audio [B, C, T] -> latents, with no gradient (the pretransform is
        frozen: JAX `pretransform_encode` :167 stops the gradient)."""
        return self.pretransform.encode(audio, generator=generator, noise=noise)


def create_diffusion_cond_from_config(config: tp.Dict[str, tp.Any]) -> ConditionedDiffusionModelWrapper:
    from .factory import create_pretransform_from_config

    model_config = config["model"]
    diffusion = model_config["diffusion"]
    if diffusion["type"] != "dit":
        raise NotImplementedError(f"diffusion model type {diffusion['type']} is not ported yet")
    pretransform = model_config.get("pretransform")
    if pretransform is not None:
        pretransform = create_pretransform_from_config(pretransform, config["sample_rate"])
        pretransform.requires_grad_(False)
    conditioning = model_config.get("conditioning")
    conditioner = (create_multi_conditioner_from_conditioning_config(conditioning)
                   if conditioning is not None else None)
    dit = DiffusionTransformer(**diffusion["config"])
    return ConditionedDiffusionModelWrapper(
        DiTWrapper(dit), conditioner,
        io_channels=model_config["io_channels"],
        sample_rate=config["sample_rate"],
        diffusion_objective=diffusion.get("diffusion_objective", "v"),
        pretransform=pretransform,
        cross_attn_cond_ids=diffusion.get("cross_attention_cond_ids", ()),
        global_cond_ids=diffusion.get("global_cond_ids", ()),
    )
