"""Text/metadata-conditioned generation; counterpart of
stable_audio_tools_tpu/inference/generation.py (`generate_diffusion_cond` :207).

An eager Python loop over the sampler steps (the JAX package compiles the
loop into one program; CUDA graphs are later work). The initial noise and the
per-step noise are injectable (`noise`, `step_noise`) so tests can replay the
JAX package's random numbers; otherwise both come from a `torch.Generator`
seeded with `seed`. Audio is returned as [B, C, sample_size].
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .sampling import StepNoise, sample_k


def _latent_shape(model, batch_size: int, sample_size: int) -> tp.Tuple[int, int, int]:
    if model.pretransform is not None:
        return (batch_size, model.pretransform.encoded_channels,
                sample_size // model.pretransform.downsampling_ratio)
    return (batch_size, model.io_channels, sample_size)


@torch.inference_mode()
def generate_diffusion_cond(
    model,
    steps: int = 250,
    cfg_scale: float = 6.0,
    conditioning: tp.Optional[tp.List[dict]] = None,
    batch_size: int = 1,
    sample_size: int = 2097152,
    seed: int = -1,
    sampler_type: str = "dpmpp-3m-sde",
    sigma_min: float = 0.3,
    sigma_max: float = 500.0,
    rho: float = 1.0,
    cfg_interval: tp.Tuple[float, float] = (0.0, 1.0),
    scale_phi: float = 0.0,
    return_latents: bool = False,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: tp.Optional[StepNoise] = None,
) -> torch.Tensor:
    """model: a ConditionedDiffusionModelWrapper (models/factory.py), on the
    device it runs on; `conditioning` holds one metadata dict per batch item.
    Returns audio [B, C, sample_size] (or latents with return_latents)."""
    if model.diffusion_objective != "v":
        raise NotImplementedError("only the v objective is ported")
    if conditioning is None or len(conditioning) != batch_size:
        raise ValueError("pass one conditioning dict per batch item")
    device = next(model.parameters()).device
    if seed == -1:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    generator = torch.Generator(device=device).manual_seed(seed)
    shape = _latent_shape(model, batch_size, sample_size)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    noise = noise.to(device=device, dtype=torch.float32)

    cond = model.get_conditioning_inputs(model.conditioner(conditioning, device))

    def model_fn(x, t):
        return model(x, t, cfg_scale=cfg_scale, cfg_interval=tuple(cfg_interval),
                     scale_phi=scale_phi, **cond)

    latents = sample_k(model_fn, noise, steps=steps, sampler_type=sampler_type,
                       sigma_min=sigma_min, sigma_max=sigma_max, rho=rho,
                       generator=generator, step_noise=step_noise)
    if return_latents or model.pretransform is None:
        return latents
    return model.pretransform.decode(latents)
