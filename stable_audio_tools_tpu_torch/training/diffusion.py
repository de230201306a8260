"""Diffusion training; counterpart of
stable_audio_tools_tpu/training/diffusion.py (`_sobol_timesteps` :46,
`_sample_timesteps` :62, `DiffusionCondTrainer` :85,
`DiffusionAutoencoderTrainer` :338, `DiffusionUncondTrainer` :418).

One train step: the frozen pretransform encodes the audio (no gradient), a
timestep t and noise are drawn, the objective's target is formed, the model
runs with CFG dropout on the conditioned inputs, the MSE is taken, then the
backward, the optimizer and scheduler step, and the EMA update.

`pre_encoded`: the batch holds the pretransform's latents (a pre-encoded
dataset, `pre_encode.py`), divided by the pretransform's `scale` instead of
encoded (JAX :177-180). `mask_padding`: the MSE is averaged over the
positions of the batch's `padding_mask` (the items' metadata) only; a mask
at the audio rate is taken to the latent rate by nearest-index sampling when
the step encodes (JAX :171-176). `mask_padding_dropout` is accepted and
stored as the JAX trainer stores it; neither reads it.
`accum_steps` > 1 splits the batch into microbatches whose gradients are
averaged (the JAX package's `lax.scan` accumulation).

Under a flow objective (`rectified_flow`, `rf_denoiser`) the noised input is
(1 - t) x + t noise and the target noise - x (JAX :194-204, `val_step`
:318-330). The model's `distribution_shift_options` (when not empty) shift
the drawn t by the latents' length (:188-189); `p_one_shot` sets t to 1 for
that share of the batch (:190-192); `log_loss_info` adds the per-sample MSE
averaged over the samples whose sigma (sin(t pi/2), or t under a flow
objective) falls in each tenth of [0, 1) as `loss_all_{lo:.1f}` (0 where
none does; :231-241); `inpainting_config` (a `diffusion_cond_inpaint`
model's, `{}` by default) draws `random_inpaint_mask` over the latents
within the step's padding masks, and joins the masked latents and the mask
as the DiT's `input_concat_cond` (:207-218). As in JAX, the inpainting runs
only where the batch's items carry padding masks, and the MSE reads them
only with `mask_padding`.

Where the JAX step is one jitted program with an explicit PRNG key, this
step runs eagerly and draws its random numbers (the VAE's sampling noise, t,
the diffusion noise, then, where they are on, the one-shot uniforms and the
inpainting mask's draws, then the CFG-dropout mask, in that order) from a
`torch.Generator` seeded from (seed, step, microbatch), so a resumed run
draws what the uninterrupted one would have; a config without the new
options draws what it drew before them. Tests inject each of them.

Trainable: the parameters with `requires_grad` (the DiT and the
conditioners' own layers; models/diffusion.py). The JAX step hands its whole
parameter tree, the frozen pretransform included, to `optax.adamw`, whose
decoupled weight decay then shrinks the pretransform's weights every step
although their gradient is zero; the port leaves the pretransform alone, as
the reference does.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..inference.sampling import (
    DistributionShift,
    get_alphas_sigmas,
    sample_timesteps_logsnr,
    truncated_logistic_normal_rescaled,
)
from ..models.inpainting import random_inpaint_mask
from .ema import ema_init, ema_update
from .losses.losses import MSELoss, MultiLoss
from .utils import build_optimizer

Tensor = torch.Tensor


def _sobol_timesteps(step: int, batch_size: int, device=None) -> Tensor:
    """Dimension-1 Sobol points: the base-2 radical inverse (32-bit reversal)
    of the global counter step * batch_size + i, as float32 * 2^-32."""
    m = 0xFFFFFFFF
    idx = (step * batch_size + torch.arange(batch_size, dtype=torch.int64, device=device)) & m
    for mask, shift in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8)):
        idx = ((idx & mask) << shift) | ((idx >> shift) & mask)
    idx = ((idx << 16) | (idx >> 16)) & m
    return idx.to(torch.float32) * (2.0 ** -32)


def sample_timesteps(batch_size: int, sampler: str, options: tp.Mapping[str, tp.Any],
                     generator: tp.Optional[torch.Generator] = None, device=None,
                     step: tp.Optional[int] = None) -> Tensor:
    """Training timesteps in [0, 1] by the config's `timestep_sampler`."""
    if sampler == "uniform":
        return torch.rand((batch_size,), generator=generator, device=device)
    if sampler == "sobol":
        if step is not None:
            return _sobol_timesteps(step, batch_size, device)
        u = torch.rand((batch_size,), generator=generator, device=device)
        strata = (torch.arange(batch_size, device=device) + u) / batch_size
        return strata[torch.randperm(batch_size, generator=generator, device=device)]
    if sampler == "logit_normal":
        return torch.sigmoid(torch.randn((batch_size,), generator=generator, device=device))
    if sampler == "trunc_logit_normal":
        return 1.0 - truncated_logistic_normal_rescaled((batch_size,), generator=generator,
                                                        device=device)
    if sampler == "log_snr":
        return sample_timesteps_logsnr(batch_size, options.get("mean_logsnr", -1.2),
                                       options.get("std_logsnr", 2.0),
                                       generator=generator, device=device)
    raise ValueError(f"Invalid timestep_sampler: {sampler}")


class DiffusionCondTrainer:
    """Trains a ConditionedDiffusionModelWrapper (models/diffusion.py) in
    place: its trainable parameters, a `torch.optim` optimizer and LR
    scheduler built from the config, an f32 EMA, and the step count."""

    def __init__(self, model, lr: tp.Optional[float] = None, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None, cfg_dropout_prob: float = 0.1,
                 timestep_sampler: str = "uniform",
                 timestep_sampler_options: tp.Optional[dict] = None,
                 validation_timesteps: tp.Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
                 gradient_clip_val: float = 0.0, seed: int = 42, pre_encoded: bool = False,
                 mask_padding: bool = False, mask_padding_dropout: float = 0.0,
                 log_loss_info: bool = False, p_one_shot: float = 0.0,
                 inpainting_config: tp.Optional[dict] = None):
        if lr is None and optimizer_configs is None:
            raise ValueError("Must specify either lr or optimizer_configs in training config")
        if model.diffusion_objective not in ("v", "rectified_flow", "rf_denoiser"):
            raise ValueError(f"Unknown diffusion objective {model.diffusion_objective}")
        self.model = model
        self.diffusion_objective = model.diffusion_objective
        options = getattr(model, "distribution_shift_options", None)
        self.dist_shift = DistributionShift(**dict(options)) if options else None
        self.log_loss_info = log_loss_info
        self.p_one_shot = p_one_shot
        self.inpainting_config = inpainting_config
        self.cfg_dropout_prob = cfg_dropout_prob
        self.timestep_sampler = timestep_sampler
        self.timestep_sampler_options = dict(timestep_sampler_options or {})
        self.validation_timesteps = list(validation_timesteps)
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.pre_encoded = pre_encoded
        self.mask_padding = mask_padding
        self.mask_padding_dropout = mask_padding_dropout
        if optimizer_configs is None:
            optimizer_configs = {"diffusion": {"optimizer": {"type": "Adam",
                                                             "config": {"lr": lr}}}}
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["diffusion"],
                                                         list(self.params.values()))
        self.ema = ema_init(self.params) if use_ema else None
        self.losses = MultiLoss([MSELoss("output", "targets", weight=1.0, name="mse_loss",
                                         mask_key="padding_mask" if mask_padding else None)])
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def learning_rates(self) -> tp.Dict[str, float]:
        return {"lr": self.optimizer.param_groups[0]["lr"]}

    def generator(self, counter: int) -> torch.Generator:
        """The generator of draw `counter` (step * accum_steps + microbatch)."""
        seed = (self.seed * 0x9E3779B1 + counter) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- pieces of a step ---------------------------------------------------

    def encode(self, audio: Tensor, generator: tp.Optional[torch.Generator] = None,
               noise: tp.Optional[Tensor] = None) -> Tensor:
        """The batch [B, C, T] -> diffusion input: the pretransform's latents
        of the audio, or, `pre_encoded`, the batch's latents over the
        pretransform's scale."""
        pretransform = self.model.pretransform
        if pretransform is None:
            return audio
        if self.pre_encoded:
            scale = getattr(pretransform, "scale", 1.0)
            return audio / scale if scale != 1.0 else audio
        return self.model.pretransform_encode(audio, generator=generator, noise=noise)

    def padding_mask(self, metadata: tp.Sequence[dict], length: int) -> tp.Optional[Tensor]:
        """The batch's padding masks [B, length] f32 on the card when the
        step reads them (`mask_padding` or inpainting, and every item has
        one), else None. A mask at another rate (the audio's, when the step
        encodes) is sampled at floor(i * T / length) (JAX :171-176)."""
        wanted = self.mask_padding or self.inpainting_config is not None
        if not wanted or not metadata or any("padding_mask" not in md for md in metadata):
            return None
        mask = torch.from_numpy(np.stack([np.asarray(md["padding_mask"], np.float32)
                                          for md in metadata]))
        if mask.shape[1] != length:  # in f32, as the JAX step computes it
            ratio = torch.tensor(mask.shape[1] / length, dtype=torch.float32)
            mask = mask[:, torch.floor(torch.arange(length, dtype=torch.float32) * ratio).long()]
        return mask.to(self.device, non_blocking=True)

    def condition(self, metadata: tp.Sequence[dict]) -> tp.Dict[str, Tensor]:
        """Batch metadata -> the DiT's conditioning inputs (the T5 tower runs
        under no_grad; the conditioners' own layers are differentiated)."""
        if self.model.conditioner is None:
            return {}
        return self.model.get_conditioning_inputs(self.model.conditioner(metadata, self.device))

    def alphas_sigmas(self, t: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """The objective's signal and noise scales at t."""
        if self.diffusion_objective == "v":
            return get_alphas_sigmas(t)
        return 1 - t, t

    def loss(self, latents: Tensor, cond: tp.Dict[str, Tensor], t: tp.Optional[Tensor] = None,
             noise: tp.Optional[Tensor] = None, cfg_dropout_mask: tp.Optional[Tensor] = None,
             generator: tp.Optional[torch.Generator] = None, counter: tp.Optional[int] = None,
             train: bool = True, padding_mask: tp.Optional[Tensor] = None,
             one_shot: tp.Optional[Tensor] = None,
             inpaint_draws: tp.Optional[tp.Dict[str, Tensor]] = None
             ) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
        """The diffusion loss of one batch of latents [B, C, T] (JAX
        `_loss_and_info`); `counter` indexes the Sobol sequence; the MSE is
        averaged over `padding_mask` [B, T] where it is given and
        `mask_padding` is set. `t` replaces the timestep draw; in training
        the shift and the one-shot draw then apply to it (validation takes its
        t as it is). `one_shot` [B] and `inpaint_draws` (models/inpainting.py)
        replace those draws."""
        B, device = latents.shape[0], latents.device
        if t is None:
            t = sample_timesteps(B, self.timestep_sampler, self.timestep_sampler_options,
                                 generator=generator, device=device, step=counter)
        t = t.to(device=device, dtype=torch.float32)
        if train and self.dist_shift is not None:
            t = self.dist_shift.time_shift(t, latents.shape[2])
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=device)
        noise = noise.to(device=device, dtype=latents.dtype)
        if train and self.p_one_shot > 0:
            if one_shot is None:
                one_shot = torch.rand((B,), generator=generator, device=device)
            t = torch.where(one_shot.to(device) < self.p_one_shot, torch.ones_like(t), t)
        alphas, sigmas = (a[:, None, None] for a in self.alphas_sigmas(t))
        noised = latents * alphas + noise * sigmas
        targets = noise * alphas - latents * sigmas if self.diffusion_objective == "v" \
            else noise - latents
        extra = {}
        if train and self.inpainting_config is not None and padding_mask is not None:
            masked, mask = random_inpaint_mask(
                latents, generator, padding_masks=padding_mask, draws=inpaint_draws,
                **self.inpainting_config.get("mask_kwargs", {}))
            extra["input_concat_cond"] = torch.cat([masked, mask], dim=1)
        output = self.denoise(noised, t, cond, train, cfg_dropout_mask, generator, **extra)
        loss, losses = self.losses({
            "output": output, "targets": targets,
            "padding_mask": padding_mask if self.mask_padding else None})
        aux = {"loss": loss.detach(), "std_data": latents.std(correction=0).detach(),
               **{k: v.detach() for k, v in losses.items()}}
        if self.log_loss_info:
            mse_all = (output.detach().float() - targets.float()).square().mean(dim=(1, 2))
            sig = sigmas.reshape(-1)
            for i in range(10):
                lo, hi = i / 10, (i + 1) / 10
                in_bucket = (sig >= lo) & (sig < hi)
                aux[f"loss_all_{lo:.1f}"] = (torch.where(in_bucket, mse_all, 0.0).sum()
                                             / in_bucket.sum().clamp(min=1))
        return loss, aux

    def denoise(self, x: Tensor, t: Tensor, cond: tp.Dict[str, Tensor], train: bool,
                cfg_dropout_mask: tp.Optional[Tensor], generator: tp.Optional[torch.Generator],
                **extra) -> Tensor:
        """The model's output on the noised input, with CFG dropout in
        training; `extra` (the inpainting's input_concat_cond) overrides the
        conditioning's routing."""
        return self.model(x, t, **{**cond, **extra},
                          cfg_dropout_prob=self.cfg_dropout_prob if train else 0.0,
                          cfg_dropout_mask=cfg_dropout_mask, generator=generator)

    def optimizer_step(self) -> None:
        """Clip (when set), step the optimizer and the LR schedule."""
        if self.gradient_clip_val > 0:
            torch.nn.utils.clip_grad_norm_(list(self.params.values()), self.gradient_clip_val)
        self.optimizer.step()
        self.scheduler.step()

    def ema_step(self) -> None:
        if self.ema is not None:
            ema_update(self.ema, self.params, self.step)

    # -- steps --------------------------------------------------------------

    def train_step(self, audio: Tensor, metadata: tp.Sequence[dict], accum_steps: int = 1,
                   t: tp.Optional[Tensor] = None, noise: tp.Optional[Tensor] = None,
                   encode_noise: tp.Optional[Tensor] = None,
                   cfg_dropout_mask: tp.Optional[Tensor] = None,
                   one_shot: tp.Optional[Tensor] = None,
                   inpaint_draws: tp.Optional[tp.Dict[str, Tensor]] = None
                   ) -> tp.Dict[str, Tensor]:
        """One optimizer step on a batch; returns the step's losses (device
        scalars, averaged over microbatches). t, noise, encode_noise,
        cfg_dropout_mask, one_shot and inpaint_draws replace the generator's
        draws (whole batch; a given t is used as it is, unshifted)."""
        B = audio.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} microbatches")
        mb = B // accum_steps
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        auxs = []
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            part = lambda x: None if x is None else x[sl]
            counter = self.step * accum_steps + i
            gen = self.generator(counter)
            latents = self.encode(audio[sl], generator=gen, noise=part(encode_noise))
            loss, aux = self.loss(latents, self.condition(metadata[sl]),
                                  t=part(t), noise=part(noise),
                                  cfg_dropout_mask=part(cfg_dropout_mask), generator=gen,
                                  counter=counter,
                                  padding_mask=self.padding_mask(metadata[sl], latents.shape[2]),
                                  one_shot=part(one_shot),
                                  inpaint_draws=None if inpaint_draws is None else
                                  {k: v[sl] for k, v in inpaint_draws.items()})
            (loss / accum_steps).backward()
            auxs.append(aux)
        self.optimizer_step()
        self.ema_step()
        self.step += 1
        return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

    @torch.no_grad()
    def val_step(self, audio: Tensor, metadata: tp.Sequence[dict],
                 noises: tp.Optional[tp.Sequence[Tensor]] = None,
                 encode_noise: tp.Optional[Tensor] = None) -> tp.Dict[str, Tensor]:
        """Fixed-timestep validation losses (JAX `make_val_step`); `noises`
        (one per validation timestep) and `encode_noise` replace the draws."""
        self.model.eval()
        gen = self.generator(-1 - self.step)
        latents = self.encode(audio, generator=gen, noise=encode_noise)
        cond = self.condition(metadata)
        out = {}
        for i, vt in enumerate(self.validation_timesteps):
            t = torch.full((latents.shape[0],), vt, device=latents.device)
            _, aux = self.loss(latents, cond, t=t, generator=gen, train=False,
                               noise=None if noises is None else noises[i])
            out[f"val/loss_{vt:.1f}"] = aux["mse_loss"]
        self.model.train()
        return out


class DiffusionUncondTrainer(DiffusionCondTrainer):
    """Trains an unconditional DiffusionModelWrapper (Dance Diffusion's
    DAU1d, the ADP `UNet1d`, the DiT): the conditioned step without
    conditioning or CFG dropout, its timesteps the dimension-1 Sobol
    sequence continued across steps (JAX :418). The batch's metadata is
    ignored.

    On the card a DAU1d must compute in bfloat16: the weight gradient of its
    convs is the hand-written kernel (`conv1d_wgrad`), which takes bfloat16
    only, so an f32 DAU1d is refused here rather than failing in its first
    backward."""

    def __init__(self, model, lr: float = 1e-4, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None, pre_encoded: bool = False,
                 gradient_clip_val: float = 0.0, seed: int = 42):
        super().__init__(model, lr=lr, use_ema=use_ema, optimizer_configs=optimizer_configs,
                         cfg_dropout_prob=0.0, timestep_sampler="sobol",
                         gradient_clip_val=gradient_clip_val, seed=seed,
                         pre_encoded=pre_encoded)
        from ..models.dance_unet import DiffusionAttnUnet1D

        dtype = getattr(model.model, "compute_dtype", None)
        if (self.device.type == "cuda" and isinstance(model.model, DiffusionAttnUnet1D)
                and dtype != torch.bfloat16):
            raise TypeError(f"training this model on the card needs compute_dtype bfloat16, "
                            f"not {dtype}: its convs' weight gradient (conv1d_wgrad) takes "
                            "bfloat16 only")

    def condition(self, metadata: tp.Sequence[dict]) -> tp.Dict[str, Tensor]:
        return {}

    def denoise(self, x, t, cond, train, cfg_dropout_mask, generator) -> Tensor:
        return self.model(x, t)


class DiffusionAutoencoderTrainer:
    """Trains a DiffusionAutoencoder (models/diffusion_ae.py) in place (JAX
    :338): encoder, bottleneck and diffusion model together. A step: the
    encode with the bottleneck's info (its VAE noise; an RVQ's state moves),
    t uniform [B], the target at the pretransform's rate (its encode of the
    audio, frozen) noised by v-diffusion, the model's v conditioned on the
    latents, the MSE to noise x alpha - x x sigma, plus 1e-6 x the
    bottleneck's KL where it reports one (`kl_loss`); the gradient reaches
    the encoder through the latents. Adam at `lr` unless
    `optimizer_configs["diffusion"]`, then the EMA of the trainable
    parameters.

    `use_reconstruction_loss` is stored and `accum_steps` accepted, and
    neither is read, as in JAX (:343-345, :401). The draws come from a
    generator seeded from (seed, step), in the order of the JAX step (the
    encode's noise, t, the diffusion noise, then the model's own: a DAU1d's
    conditioning augmentation), or are injected (`encode_noise`, `t`,
    `noise`, `aug_level`, `cond_noise`)."""

    def __init__(self, model, lr: float = 1e-4, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None,
                 use_reconstruction_loss: bool = False, gradient_clip_val: float = 0.0,
                 seed: int = 42):
        self.model = model
        self.use_reconstruction_loss = use_reconstruction_loss
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        if optimizer_configs is None:
            optimizer_configs = {"diffusion": {"optimizer": {"type": "Adam",
                                                             "config": {"lr": lr}}}}
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["diffusion"],
                                                         list(self.params.values()))
        self.ema = ema_init(self.params) if use_ema else None
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def learning_rates(self) -> tp.Dict[str, float]:
        return {"lr": self.optimizer.param_groups[0]["lr"]}

    def generator(self, step: int) -> torch.Generator:
        seed = (self.seed * 0x9E3779B1 + step) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def loss(self, audio: Tensor, generator: tp.Optional[torch.Generator] = None,
             t: tp.Optional[Tensor] = None, noise: tp.Optional[Tensor] = None,
             encode_noise=None, **model_draws) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
        """The step's loss of audio [B, C, T] and its parts (JAX `_loss`)."""
        model = self.model
        latents, info = model.encode(audio, return_info=True, train=True, generator=generator,
                                     noise=encode_noise)
        B, device = audio.shape[0], audio.device
        if t is None:
            t = torch.rand((B,), generator=generator, device=device)
        t = t.to(device=device, dtype=torch.float32)
        alphas, sigmas = (a[:, None, None] for a in get_alphas_sigmas(t))
        target = model.pretransform_encode(audio) if model.pretransform is not None else audio
        if noise is None:
            noise = torch.randn(target.shape, generator=generator, device=device)
        noise = noise.to(device=device, dtype=target.dtype)
        noised = target * alphas + noise * sigmas
        targets = noise * alphas - target * sigmas
        v = model.diffusion_forward(noised, t, latents, generator=generator, **model_draws)
        loss = (v.float() - targets.float()).square().mean()
        aux = {"mse_loss": loss.detach()}
        if "kl" in info:
            kl = info["kl"] * 1e-6
            loss = loss + kl
            aux["kl_loss"] = kl.detach()
        aux["loss"] = loss.detach()
        return loss, aux

    def train_step(self, audio: Tensor, metadata=None, accum_steps: int = 1,
                   **draws) -> tp.Dict[str, Tensor]:
        """One Adam step on a batch (metadata ignored; `accum_steps` unread,
        as in JAX); `draws` replace the generator's (class note)."""
        del metadata, accum_steps
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss(audio, self.generator(self.step), **draws)
        loss.backward()
        if self.gradient_clip_val > 0:
            torch.nn.utils.clip_grad_norm_(list(self.params.values()), self.gradient_clip_val)
        self.optimizer.step()
        self.scheduler.step()
        if self.ema is not None:
            ema_update(self.ema, self.params, self.step)
        self.step += 1
        return aux
