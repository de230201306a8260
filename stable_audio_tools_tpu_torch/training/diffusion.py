"""Diffusion training; counterpart of
stable_audio_tools_tpu/training/diffusion.py (`_sobol_timesteps` :46,
`_sample_timesteps` :62, `DiffusionCondTrainer` :85,
`DiffusionUncondTrainer` :418).

One train step: the frozen pretransform encodes the audio (no gradient), a
timestep t and noise are drawn, the v-objective target is formed, the model
runs with CFG dropout on the conditioned inputs, the MSE is taken, then the
backward, the optimizer and scheduler step, and the EMA update.

`pre_encoded`: the batch holds the pretransform's latents (a pre-encoded
dataset, `pre_encode.py`), divided by the pretransform's `scale` instead of
encoded (JAX :177-180). `mask_padding`: the MSE is averaged over the
positions of the batch's `padding_mask` (the items' metadata) only; a mask
at the audio rate is taken to the latent rate by nearest-index sampling when
the step encodes (JAX :171-176). `mask_padding_dropout` is accepted and
stored as the JAX trainer stores it; neither reads it. The JAX trainer's
other options (inpainting, one-shot t, per-sigma loss logging, the timestep
shift, non-v objectives) are later slices; the training factory refuses
configs that set them.
`accum_steps` > 1 splits the batch into microbatches whose gradients are
averaged (the JAX package's `lax.scan` accumulation).

Where the JAX step is one jitted program with an explicit PRNG key, this
step runs eagerly and draws its random numbers (the VAE's sampling noise, t,
the diffusion noise, the CFG-dropout mask, in that order) from a
`torch.Generator` seeded from (seed, step, microbatch), so a resumed run
draws what the uninterrupted one would have. Tests inject each of them.

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
    get_alphas_sigmas,
    sample_timesteps_logsnr,
    truncated_logistic_normal_rescaled,
)
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
                 mask_padding: bool = False, mask_padding_dropout: float = 0.0):
        if lr is None and optimizer_configs is None:
            raise ValueError("Must specify either lr or optimizer_configs in training config")
        if model.diffusion_objective != "v":
            raise NotImplementedError(f"the {model.diffusion_objective} objective is not ported")
        self.model = model
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
        loss reads them (`mask_padding` and every item has one), else None.
        A mask at another rate (the audio's, when the step encodes) is
        sampled at floor(i * T / length) (JAX :171-176)."""
        if not self.mask_padding or not metadata or any(
                "padding_mask" not in md for md in metadata):
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

    def loss(self, latents: Tensor, cond: tp.Dict[str, Tensor], t: tp.Optional[Tensor] = None,
             noise: tp.Optional[Tensor] = None, cfg_dropout_mask: tp.Optional[Tensor] = None,
             generator: tp.Optional[torch.Generator] = None, counter: tp.Optional[int] = None,
             train: bool = True, padding_mask: tp.Optional[Tensor] = None
             ) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
        """The diffusion loss of one batch of latents [B, C, T] (JAX
        `_loss_and_info`); `counter` indexes the Sobol sequence; the MSE is
        averaged over `padding_mask` [B, T] where it is given."""
        B, device = latents.shape[0], latents.device
        if t is None:
            t = sample_timesteps(B, self.timestep_sampler, self.timestep_sampler_options,
                                 generator=generator, device=device, step=counter)
        t = t.to(device=device, dtype=torch.float32)
        alphas, sigmas = (a[:, None, None] for a in get_alphas_sigmas(t))
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=device)
        noise = noise.to(device=device, dtype=latents.dtype)
        output = self.denoise(latents * alphas + noise * sigmas, t, cond, train,
                              cfg_dropout_mask, generator)
        loss, losses = self.losses({"output": output, "targets": noise * alphas - latents * sigmas,
                                    "padding_mask": padding_mask})
        aux = {"loss": loss.detach(), "std_data": latents.std(correction=0).detach(),
               **{k: v.detach() for k, v in losses.items()}}
        return loss, aux

    def denoise(self, x: Tensor, t: Tensor, cond: tp.Dict[str, Tensor], train: bool,
                cfg_dropout_mask: tp.Optional[Tensor], generator: tp.Optional[torch.Generator]
                ) -> Tensor:
        """The model's output on the noised input, with CFG dropout in training."""
        return self.model(x, t, **cond, cfg_dropout_prob=self.cfg_dropout_prob if train else 0.0,
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
                   cfg_dropout_mask: tp.Optional[Tensor] = None) -> tp.Dict[str, Tensor]:
        """One optimizer step on a batch; returns the step's losses (device
        scalars, averaged over microbatches). t, noise, encode_noise and
        cfg_dropout_mask replace the generator's draws (whole batch)."""
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
                                  padding_mask=self.padding_mask(metadata[sl], latents.shape[2]))
            (loss / accum_steps).backward()
            auxs.append(aux)
        self.optimizer_step()
        self.ema_step()
        self.step += 1
        return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

    @torch.no_grad()
    def val_step(self, audio: Tensor, metadata: tp.Sequence[dict]) -> tp.Dict[str, Tensor]:
        """Fixed-timestep validation losses (JAX `make_val_step`)."""
        self.model.eval()
        gen = self.generator(-1 - self.step)
        latents = self.encode(audio, generator=gen)
        cond = self.condition(metadata)
        out = {}
        for vt in self.validation_timesteps:
            t = torch.full((latents.shape[0],), vt, device=latents.device)
            _, aux = self.loss(latents, cond, t=t, generator=gen, train=False)
            out[f"val/loss_{vt:.1f}"] = aux["mse_loss"]
        self.model.train()
        return out


class DiffusionUncondTrainer(DiffusionCondTrainer):
    """Trains an unconditional DiffusionModelWrapper (Dance Diffusion): the
    conditioned step without conditioning or CFG dropout, its timesteps the
    dimension-1 Sobol sequence continued across steps (JAX :418). The
    batch's metadata is ignored.

    On the card the model must compute in bfloat16: the weight gradient of
    its convs is the hand-written kernel (`conv1d_wgrad`), which takes
    bfloat16 only, so an f32 model is refused here rather than failing in
    its first backward."""

    def __init__(self, model, lr: float = 1e-4, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None, pre_encoded: bool = False,
                 gradient_clip_val: float = 0.0, seed: int = 42):
        super().__init__(model, lr=lr, use_ema=use_ema, optimizer_configs=optimizer_configs,
                         cfg_dropout_prob=0.0, timestep_sampler="sobol",
                         gradient_clip_val=gradient_clip_val, seed=seed,
                         pre_encoded=pre_encoded)
        dtype = getattr(model.model, "compute_dtype", None)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise TypeError(f"training this model on the card needs compute_dtype bfloat16, "
                            f"not {dtype}: its convs' weight gradient (conv1d_wgrad) takes "
                            "bfloat16 only")

    def condition(self, metadata: tp.Sequence[dict]) -> tp.Dict[str, Tensor]:
        return {}

    def denoise(self, x, t, cond, train, cfg_dropout_mask, generator) -> Tensor:
        return self.model(x, t)
