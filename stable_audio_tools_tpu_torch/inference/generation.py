"""Generation; counterpart of stable_audio_tools_tpu/inference/generation.py
(`generate_diffusion_uncond` :131, `generate_diffusion_cond` :207,
`build_mask` :358, `generate_diffusion_cond_inpaint` :382).

An eager Python loop over the sampler steps (the JAX package compiles the
loop into one program; CUDA graphs are later work). The initial noise and the
per-step noise are injectable (`noise`, `step_noise`), and so is the VAE
encoder's noise for `init_audio` (`init_noise`), so tests can replay the JAX
package's random numbers; otherwise all come from a `torch.Generator` seeded
with `seed`. Audio is returned as [B, C, sample_size]; a pretransform built
with `chunked` decodes (and encodes `init_audio`) in overlapping windows.

Arguments of the JAX entry points that are not ported are refused, not
ignored: `mesh` and `tp_rules` (several cards) and `preview` (the UI's
per-step tap).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .sampling import StepNoise, sample_k

CondTensors = tp.Dict[str, tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]]


def _latent_shape(model, batch_size: int, sample_size: int) -> tp.Tuple[int, int, int]:
    if model.pretransform is not None:
        return (batch_size, model.pretransform.encoded_channels,
                sample_size // model.pretransform.downsampling_ratio)
    return (batch_size, model.io_channels, sample_size)


def _refuse_unported(mesh, tp_rules, preview) -> None:
    if mesh is not None or tp_rules is not None:
        raise NotImplementedError("mesh / tp_rules: generation across several cards is not "
                                  "ported yet")
    if preview:
        raise NotImplementedError("preview: the per-step denoised tap is not ported yet")


def _setup(model, seed: int, batch_size: int, sample_size: int, noise):
    """(device, generator, initial latent noise [B, C, S] f32)."""
    if model.diffusion_objective != "v":
        raise NotImplementedError("only the v objective is ported")
    device = next(model.parameters()).device
    if seed == -1:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    generator = torch.Generator(device=device).manual_seed(seed)
    if noise is None:
        noise = torch.randn(_latent_shape(model, batch_size, sample_size), generator=generator,
                            device=device)
    return device, generator, noise.to(device=device, dtype=torch.float32)


def _conditioning_inputs(model, device, batch_size, conditioning, conditioning_tensors,
                         negative_conditioning, negative_conditioning_tensors) -> dict:
    """The DiT's keyword arguments from metadata dicts or ready tensors, for
    the conditional pass and (when given) the negative one."""
    if conditioning_tensors is None:
        if conditioning is None:
            raise ValueError("pass conditioning (one dict per batch item) or "
                             "conditioning_tensors")
        if len(conditioning) != batch_size:
            raise ValueError("pass one conditioning dict per batch item")
        conditioning_tensors = model.conditioner(conditioning, device)
    inputs = model.get_conditioning_inputs(conditioning_tensors)
    if negative_conditioning is not None or negative_conditioning_tensors is not None:
        if negative_conditioning_tensors is None:
            negative_conditioning_tensors = model.conditioner(negative_conditioning, device)
        neg = model.get_conditioning_inputs(negative_conditioning_tensors, negative=True)
        inputs.update({k: v for k, v in neg.items() if v is not None})
    return inputs


def _encode_init_audio(model, init_audio, device, generator, init_noise) -> torch.Tensor:
    """(sample rate, audio [C, T] or [B, C, T]) -> latents. The audio is
    taken as it is (prepare it with inference/utils.py `prepare_audio`)."""
    _, audio = init_audio
    audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
    if audio.dim() == 2:
        audio = audio[None]
    if model.pretransform is None:
        return audio
    return model.pretransform_encode(audio, generator=generator, noise=init_noise)


def _sample_and_decode(model, cond: dict, noise: torch.Tensor, return_latents: bool,
                       cfg_scale: float, cfg_interval, scale_phi: float,
                       **sampler_kwargs) -> torch.Tensor:
    """The sampler loop over the model with its CFG arguments and `cond`
    bound, then the pretransform's decode."""
    def model_fn(x, t):
        return model(x, t, cfg_scale=cfg_scale, cfg_interval=tuple(cfg_interval),
                     scale_phi=scale_phi, **cond)

    latents = sample_k(model_fn, noise, **sampler_kwargs)
    if return_latents or model.pretransform is None:
        return latents
    return model.pretransform.decode(latents)


@torch.inference_mode()
def generate_diffusion_uncond(
    model,
    steps: int = 250,
    batch_size: int = 1,
    sample_size: int = 2097152,
    seed: int = -1,
    init_audio: tp.Optional[tp.Tuple[int, tp.Any]] = None,
    init_noise_level: float = 1.0,
    sampler_type: str = "dpmpp-2m-sde",
    sigma_min: float = 0.3,
    sigma_max: float = 500.0,
    rho: float = 1.0,
    return_latents: bool = False,
    mesh=None,
    tp_rules=None,
    preview: bool = False,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: tp.Optional[StepNoise] = None,
    init_noise: tp.Optional[torch.Tensor] = None,
    **sampler_kwargs,
) -> torch.Tensor:
    """model: a DiffusionModelWrapper (an unconditional v-model, e.g. Dance
    Diffusion) on the device it runs on. `init_audio` = (sample rate, audio)
    is varied: the sampler starts from it (or its latents) plus noise at
    sigma `init_noise_level`. Returns audio [B, C, sample_size] (or the
    latents with return_latents, where there is a pretransform)."""
    _refuse_unported(mesh, tp_rules, preview)
    device, generator, noise = _setup(model, seed, batch_size, sample_size, noise)
    init_data = None
    if init_audio is not None:
        init_data = _encode_init_audio(model, init_audio, device, generator, init_noise)
        sigma_max = init_noise_level
    out = sample_k(model, noise, init_data=init_data, steps=steps, sampler_type=sampler_type,
                   sigma_min=sigma_min, sigma_max=sigma_max, rho=rho, generator=generator,
                   step_noise=step_noise, **sampler_kwargs)
    if return_latents or model.pretransform is None:
        return out
    return model.pretransform_decode(out)


@torch.inference_mode()
def generate_diffusion_cond(
    model,
    steps: int = 250,
    cfg_scale: float = 6.0,
    conditioning: tp.Optional[tp.List[dict]] = None,
    conditioning_tensors: tp.Optional[CondTensors] = None,
    negative_conditioning: tp.Optional[tp.List[dict]] = None,
    negative_conditioning_tensors: tp.Optional[CondTensors] = None,
    batch_size: int = 1,
    sample_size: int = 2097152,
    seed: int = -1,
    init_audio: tp.Optional[tp.Tuple[int, tp.Any]] = None,
    init_noise_level: float = 1.0,
    return_latents: bool = False,
    sampler_type: str = "dpmpp-3m-sde",
    sigma_min: float = 0.3,
    sigma_max: float = 500.0,
    rho: float = 1.0,
    cfg_interval: tp.Tuple[float, float] = (0.0, 1.0),
    scale_phi: float = 0.0,
    mesh=None,
    tp_rules=None,
    preview: bool = False,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: tp.Optional[StepNoise] = None,
    init_noise: tp.Optional[torch.Tensor] = None,
    **sampler_kwargs,
) -> torch.Tensor:
    """model: a ConditionedDiffusionModelWrapper (models/factory.py), on the
    device it runs on. `conditioning` holds one metadata dict per batch item
    (or pass `conditioning_tensors`, the conditioner's output);
    `negative_conditioning(_tensors)` feeds the CFG pass's unconditional
    half. `init_audio` = (sample rate, audio) is encoded and varied: the
    sampler starts from its latents plus noise at sigma `init_noise_level`.
    Returns audio [B, C, sample_size] (or latents with return_latents)."""
    _refuse_unported(mesh, tp_rules, preview)
    device, generator, noise = _setup(model, seed, batch_size, sample_size, noise)
    cond = _conditioning_inputs(model, device, batch_size, conditioning, conditioning_tensors,
                                negative_conditioning, negative_conditioning_tensors)
    init_data = None
    if init_audio is not None:
        init_data = _encode_init_audio(model, init_audio, device, generator, init_noise)
        sigma_max = init_noise_level

    return _sample_and_decode(
        model, cond, noise, return_latents, cfg_scale=cfg_scale, cfg_interval=cfg_interval,
        scale_phi=scale_phi, init_data=init_data, steps=steps, sampler_type=sampler_type,
        sigma_min=sigma_min, sigma_max=sigma_max, rho=rho, generator=generator,
        step_noise=step_noise, **sampler_kwargs)


def build_mask(sample_size: int, mask_args: dict) -> torch.Tensor:
    """Inpainting mask over the samples, f32 [sample_size]: 0 in
    [maskstart, maskend) (the region to generate), 1 outside, with half-Hann
    ramps of `softnessL` / `softnessR` (fractions of sample_size) outside the
    hole's edges and a floor of `marination`."""
    maskstart, maskend = int(mask_args["maskstart"]), int(mask_args["maskend"])
    hann_l = int(float(mask_args.get("softnessL", 0.0)) * sample_size)
    hann_r = int(float(mask_args.get("softnessR", 0.0)) * sample_size)
    marination = float(mask_args.get("marination", 0.0))
    mask = np.ones(sample_size, np.float32)
    mask[maskstart:maskend] = 0.0
    if hann_l > 0:
        ramp = 0.5 * (1 + np.cos(np.linspace(0, np.pi, hann_l)))
        lo = max(maskstart - hann_l, 0)
        mask[lo:maskstart] = np.minimum(mask[lo:maskstart], ramp[-(maskstart - lo):])
    if hann_r > 0:
        ramp = 0.5 * (1 - np.cos(np.linspace(0, np.pi, hann_r)))
        hi = min(maskend + hann_r, sample_size)
        mask[maskend:hi] = np.minimum(mask[maskend:hi], ramp[: hi - maskend])
    if marination > 0:
        mask = np.maximum(mask, marination)
    return torch.from_numpy(mask)


@torch.inference_mode()
def generate_diffusion_cond_inpaint(
    model,
    steps: int = 250,
    cfg_scale: float = 6.0,
    conditioning: tp.Optional[tp.List[dict]] = None,
    conditioning_tensors: tp.Optional[CondTensors] = None,
    negative_conditioning: tp.Optional[tp.List[dict]] = None,
    negative_conditioning_tensors: tp.Optional[CondTensors] = None,
    batch_size: int = 1,
    sample_size: int = 2097152,
    seed: int = -1,
    init_audio: tp.Optional[tp.Tuple[int, tp.Any]] = None,
    mask_args: tp.Optional[dict] = None,
    return_latents: bool = False,
    sampler_type: str = "dpmpp-3m-sde",
    sigma_min: float = 0.3,
    sigma_max: float = 500.0,
    rho: float = 1.0,
    cfg_interval: tp.Tuple[float, float] = (0.0, 1.0),
    scale_phi: float = 0.0,
    mesh=None,
    tp_rules=None,
    preview: bool = False,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: tp.Optional[StepNoise] = None,
    init_noise: tp.Optional[torch.Tensor] = None,
    **sampler_kwargs,
) -> torch.Tensor:
    """Inpainting with a model trained on masked-input conditioning channels
    (model type `diffusion_cond_inpaint`): `init_audio`'s latents, zeroed
    where the mask (`build_mask(sample_size, mask_args)`, sampled once per
    latent) is 0, and the mask itself are joined to the DiT's input on the
    channel axis at every step. Without `mask_args` everything is generated."""
    _refuse_unported(mesh, tp_rules, preview)
    if init_audio is None:
        raise ValueError("inpainting requires init_audio")
    device, generator, noise = _setup(model, seed, batch_size, sample_size, noise)
    latent_size = noise.shape[-1]
    ratio = model.pretransform.downsampling_ratio if model.pretransform is not None else 1
    init_latents = _encode_init_audio(model, init_audio, device, generator, init_noise)
    init_latents = torch.nn.functional.pad(
        init_latents[..., :latent_size], (0, max(latent_size - init_latents.shape[-1], 0)))
    if mask_args is not None:
        latent_mask = build_mask(sample_size, mask_args)[::ratio][:latent_size].to(device)
    else:
        latent_mask = torch.zeros(latent_size, device=device)
    inpaint_cond = torch.cat([init_latents * latent_mask,
                              latent_mask.expand(batch_size, 1, latent_size)], dim=1)
    cond = _conditioning_inputs(model, device, batch_size, conditioning, conditioning_tensors,
                                negative_conditioning, negative_conditioning_tensors)
    cond["input_concat_cond"] = inpaint_cond

    return _sample_and_decode(
        model, cond, noise, return_latents, cfg_scale=cfg_scale, cfg_interval=cfg_interval,
        scale_phi=scale_phi, steps=steps, sampler_type=sampler_type, sigma_min=sigma_min,
        sigma_max=sigma_max, rho=rho, generator=generator, step_noise=step_noise,
        **sampler_kwargs)
