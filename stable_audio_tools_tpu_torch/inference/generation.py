"""Generation; counterpart of stable_audio_tools_tpu/inference/generation.py
(`_get_dist_shift` :43, `get_preview_tap` :100, `generate_diffusion_uncond`
:131, `generate_diffusion_cond` :207, `build_mask` :358,
`generate_diffusion_cond_inpaint` :382).

An eager Python loop over the sampler steps (the JAX package compiles the
loop into one program; CUDA graphs are later work). The initial noise and the
per-step noise are injectable (`noise`, `step_noise`), and so is the VAE
encoder's noise for `init_audio` (`init_noise`), so tests can replay the JAX
package's random numbers; otherwise all come from a `torch.Generator` seeded
with `seed`. Audio is returned as [B, C, sample_size]; a pretransform built
with `chunked` decodes (and encodes `init_audio`) in overlapping windows.

The model's `diffusion_objective` picks the sampler family: `v` runs
`sample_k` (k-diffusion and v-DDIM), `rectified_flow` and `rf_denoiser` run
`sample_rf` (euler, rk4, dpmpp, pingpong), and under a flow objective the
k-diffusion defaults `dpmpp-3m-sde` / `dpmpp-2m-sde` become `euler`. The
timestep shift is built from the model's `distribution_shift_options` when
that dict is not empty (an empty dict means no shift, as in JAX).

`preview=True` collects every model call's (denoised latents, sigma) in
`model._preview_buffer` (cleared at the start of the call), as the JAX
package's `get_preview_tap`: a numpy copy of the denoised latents each call.
`mesh` and `tp_rules` (several cards) are refused, not ignored.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .sampling import DistributionShift, StepNoise, sample_k, sample_rf

CondTensors = tp.Dict[str, tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]]


def _latent_shape(model, batch_size: int, sample_size: int) -> tp.Tuple[int, int, int]:
    if model.pretransform is not None:
        return (batch_size, model.pretransform.encoded_channels,
                sample_size // model.pretransform.downsampling_ratio)
    return (batch_size, model.io_channels, sample_size)


FLOW_OBJECTIVES = ("rectified_flow", "rf_denoiser")


def _refuse_unported(mesh, tp_rules) -> None:
    if mesh is not None or tp_rules is not None:
        raise NotImplementedError("mesh / tp_rules: generation across several cards is not "
                                  "ported yet")


def _get_dist_shift(model) -> tp.Optional[DistributionShift]:
    options = getattr(model, "distribution_shift_options", None)
    return DistributionShift(**dict(options)) if options else None


def get_preview_tap(model) -> tp.Callable[[torch.Tensor, float], None]:
    """The tap that appends (denoised latents as numpy, sigma) to
    `model._preview_buffer`."""
    if not hasattr(model, "_preview_buffer"):
        model._preview_buffer = []

    def tap(denoised: torch.Tensor, sigma: float) -> None:
        model._preview_buffer.append((denoised.float().cpu().numpy(), float(sigma)))

    return tap


def _sampler_kwargs(model, preview: bool, sampler_type: str, **kwargs) -> dict:
    """The preview tap (its buffer emptied) and cfg++'s model check."""
    if sampler_type == "v-ddim-cfgpp" and not getattr(model.model, "takes_return_info", False):
        raise NotImplementedError(
            f"v-ddim-cfgpp on {type(model.model).__name__}: cfg++ needs the model's unguided "
            "output (return_info=True), which only the DiT gives; the JAX package cannot run "
            "it on this model either (its ADP wrapper drops return_info, the unconditional "
            "models do not take it)")
    if preview:
        kwargs["denoised_tap"] = get_preview_tap(model)
        model._preview_buffer.clear()
    return kwargs


def _sample(model, model_fn, noise: torch.Tensor, sampler_type: str, sigma_max: float,
            **kwargs) -> torch.Tensor:
    """`sample_k` for a v-model; `sample_rf` under a flow objective, its
    k-diffusion defaults turned to euler and the model's shift handed on."""
    objective = model.diffusion_objective
    if objective == "v":
        return sample_k(model_fn, noise, sampler_type=sampler_type, sigma_max=sigma_max,
                        **kwargs)
    if objective not in FLOW_OBJECTIVES:
        raise ValueError(f"Unknown diffusion objective {objective}")
    if sampler_type in ("dpmpp-3m-sde", "dpmpp-2m-sde"):
        sampler_type = "euler"
    for key in ("sigma_min", "rho"):
        kwargs.pop(key, None)
    return sample_rf(model_fn, noise, sampler_type=sampler_type, sigma_max=min(sigma_max, 1.0),
                     dist_shift=_get_dist_shift(model), **kwargs)


def _setup(model, seed: int, batch_size: int, sample_size: int, noise):
    """(device, generator, initial latent noise [B, C, S] f32)."""
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
                       cfg_scale: float, cfg_interval, scale_phi: float, preview: bool,
                       sampler_type: str, sigma_max: float, **sampler_kwargs) -> torch.Tensor:
    """The sampler loop over the model with its CFG arguments and `cond`
    bound, then the pretransform's decode."""
    def model_fn(x, t, **kwargs):
        return model(x, t, cfg_scale=cfg_scale, cfg_interval=tuple(cfg_interval),
                     scale_phi=scale_phi, **cond, **kwargs)

    latents = _sample(model, model_fn, noise, sampler_type, sigma_max,
                      **_sampler_kwargs(model, preview, sampler_type, **sampler_kwargs))
    if return_latents or model.pretransform is None:
        return latents
    return model.pretransform.decode(latents, generator=sampler_kwargs.get("generator"))


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
    _refuse_unported(mesh, tp_rules)
    device, generator, noise = _setup(model, seed, batch_size, sample_size, noise)
    init_data = None
    if init_audio is not None:
        init_data = _encode_init_audio(model, init_audio, device, generator, init_noise)
        sigma_max = init_noise_level
    kwargs = _sampler_kwargs(model, preview, sampler_type, **sampler_kwargs)
    if model.diffusion_objective == "v":
        out = sample_k(model, noise, init_data=init_data, steps=steps, sampler_type=sampler_type,
                       sigma_min=sigma_min, sigma_max=sigma_max, rho=rho, generator=generator,
                       step_noise=step_noise, **kwargs)
    else:  # as the JAX package: no shift and no change of sampler here
        out = sample_rf(model, noise, init_data=init_data, steps=steps,
                        sampler_type=sampler_type, sigma_max=sigma_max, generator=generator,
                        step_noise=step_noise, **kwargs)
    if return_latents or model.pretransform is None:
        return out
    return model.pretransform_decode(out, generator=generator)


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
    _refuse_unported(mesh, tp_rules)
    device, generator, noise = _setup(model, seed, batch_size, sample_size, noise)
    cond = _conditioning_inputs(model, device, batch_size, conditioning, conditioning_tensors,
                                negative_conditioning, negative_conditioning_tensors)
    init_data = None
    if init_audio is not None:
        init_data = _encode_init_audio(model, init_audio, device, generator, init_noise)
        sigma_max = init_noise_level

    return _sample_and_decode(
        model, cond, noise, return_latents, cfg_scale=cfg_scale, cfg_interval=cfg_interval,
        scale_phi=scale_phi, preview=preview, init_data=init_data, steps=steps,
        sampler_type=sampler_type, sigma_min=sigma_min, sigma_max=sigma_max, rho=rho,
        generator=generator, step_noise=step_noise, **sampler_kwargs)


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
    _refuse_unported(mesh, tp_rules)
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
        scale_phi=scale_phi, preview=preview, steps=steps, sampler_type=sampler_type,
        sigma_min=sigma_min, sigma_max=sigma_max, rho=rho, generator=generator,
        step_noise=step_noise, **sampler_kwargs)
