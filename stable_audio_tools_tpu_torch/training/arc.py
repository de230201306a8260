"""ARC post-training (adversarial relativistic-contrastive few-step
distillation); counterpart of stable_audio_tools_tpu/training/arc.py
(`euler_step` :31, `build_noise_dist` :66, `ARCTrainer` :101; the
teacher's trajectory, `sample_flow_dpmpp_w_intermediates` :35, is
`inference/sampling.py::sample_flow_dpmpp` with its states kept).

The student is a flow-objective ConditionedDiffusionModelWrapper; the
discriminator is a DiT of the same family whose hidden states at
`discriminator_dit_layer` (default -1: after the last block and
`project_out`, io_channels wide; a block's index gives embed_dim) feed a
head (models/arc.py) whose input width is that of those states. A step is
chosen on the host by its number, as in JAX (:440):
- while `step < ode_warmup.warmup_steps`, an ODE step: the teacher's
  DPM++ trajectory (`n_sampling_steps` steps at `cfg_scale`, no gradient;
  refreshed every `refresh_rate` steps and kept between) gives states x_t at
  its grid's t; the student regresses the one-step Euler denoise of a state
  drawn per item onto the trajectory's end. The teacher is the student's own
  weights unless a `teacher_model` is given;
- then even steps train the generator: the student denoises x_t at t from
  `gen_noise_dist` in one Euler step; the result and the real latents are
  noised alike at t from `dis_noise_dist`, and the loss is
  softplus(real score - fake score) through the frozen discriminator and
  head (the gradient reaches the student through the discriminator's
  input);
- odd steps train the discriminator and head: softplus(-(real - fake)) on
  the student's (frozen) denoise, plus the approximate R1/R2 penalty (the
  scores' change under input noise of 0.05: no double backward) and the
  contrastive term softplus(-(real - rolled)) on the reals scored under
  `rolled_cond_tensors` (the batch's prompts rolled).
After the ODE warmup a `trim_config` crops the latents at random to a data
length rounded up to `bucket_multiple` (`_maybe_trim`, numpy's generator
seeded with the step, as JAX).

Each optimizer (AdamW by default; `clip_grad_norm` > 0 clips the global
norm first) has its LR schedule; the EMA of the student moves on the ODE
and generator steps with the global step count. The random numbers of step
n come from a `torch.Generator` seeded from (seed, n), in this order: ODE:
the teacher's noise (when refreshed), the states' indices, the CFG-dropout
mask; generator: t, noise, the CFG-dropout mask, t_gan, the GAN noise;
discriminator: t, noise, t_gan, the GAN noise, the penalty's two noises.
`train_step(..., draws={...})` replaces any of them (`ode_noise`, `ixs`,
`cfg_dropout_mask`, `t`, `noise`, `t_gan`, `gan_noise`, `gp_noise_real`,
`gp_noise_fake`).

The JAX trainer stores `pre_encoded` and `gan.contrastive_key` and reads
neither (its latents come in encoded, the rolled conditioning ready-made);
the port takes neither.

Trainable: the student's and the discriminator's parameters with
`requires_grad` and the head's. The conditioning comes in as the
conditioner's output, so the conditioners' own layers get no gradient; the
JAX package's `optax.adamw` still decays them (its whole parameter tree),
torch's AdamW skips a parameter without a gradient.

The JAX package's training entry cannot run this trainer (its `init_state`
and `train_step` signatures are not the ones `train.py` and its Trainer
call); ARC runs through `training/factory.py` and `train_step`, here as
there, and the port's `train` entry refuses a config with `arc`.
"""

from __future__ import annotations

import contextlib
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..inference.sampling import (get_rf_schedule, sample_flow_dpmpp,
                                  truncated_logistic_normal_rescaled)
from ..models.arc import ConvDiscriminator, ConvNeXtDiscriminator
from .ema import ema_init, ema_update
from .utils import build_optimizer

Tensor = torch.Tensor


def euler_step(x_t: Tensor, v_t: Tensor, t: Tensor, s: Tensor) -> Tensor:
    """x at s from x_t and the flow v_t at t."""
    return x_t + (s - t)[:, None, None] * v_t


def build_noise_dist(config: tp.Optional[dict]):
    """A role's timestep distribution: (batch, generator, device) -> t [B]."""
    config = config or {"type": "uniform"}
    d_type = config.get("type", "uniform") if isinstance(config, dict) else "uniform"
    if d_type not in ("uniform", "logit_normal", "trunc_logit_normal", "discrete"):
        raise ValueError(f"Unknown noise dist {d_type}")

    def sampler(batch: int, generator: tp.Optional[torch.Generator], device) -> Tensor:
        if d_type == "uniform":
            lo, hi = config.get("min", 0.0), config.get("max", 1.0)
            return torch.rand((batch,), generator=generator, device=device) * (hi - lo) + lo
        if d_type == "logit_normal":
            z = torch.randn((batch,), generator=generator, device=device)
            return torch.sigmoid(z * config.get("std", 1.0) + config.get("mean", 0.0))
        if d_type == "trunc_logit_normal":
            return 1.0 - truncated_logistic_normal_rescaled((batch,), generator=generator,
                                                            device=device)
        values = torch.tensor(config.get("values", [1.0]), dtype=torch.float32, device=device)
        return values[torch.randint(0, len(values), (batch,), generator=generator,
                                    device=device)]

    return sampler


@contextlib.contextmanager
def _frozen(params: tp.Iterable[torch.nn.Parameter]):
    """The parameters without requires_grad for the block (no gradient is
    kept for them; autograd still carries it through to their inputs)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class ARCTrainer:
    def __init__(self, model, discriminator, arc_config: dict, optimizer_configs: dict,
                 teacher_model=None, use_ema: bool = True, cfg_dropout_prob: float = 0.0, clip_grad_norm: float = 0.0,
                 trim_config: tp.Optional[dict] = None, seed: int = 42):
        self.model = model
        self.discriminator = discriminator
        self.teacher_model = teacher_model
        self.cfg_dropout_prob = cfg_dropout_prob
        self.clip_grad_norm = clip_grad_norm
        self.seed = seed

        ode_cfg = arc_config.get("ode_warmup", {}) or {}
        self.ode_warmup_steps = ode_cfg.get("warmup_steps", 0)
        self.ode_refresh_rate = ode_cfg.get("refresh_rate", 1)
        self.ode_n_sampling_steps = ode_cfg.get("n_sampling_steps", 8)
        self.ode_warmup_cfg = ode_cfg.get("cfg_scale", 1.0)

        gan_cfg = arc_config.get("gan", {}) or {}
        self.gen_gan_weight = gan_cfg.get("gen_weight", 1.0)
        self.dis_gan_weight = gan_cfg.get("dis_weight", 1.0)
        self.discriminator_dit_layer = gan_cfg.get("discriminator_dit_layer", -1)
        self.include_grad_penalties = gan_cfg.get("grad_penalties", True)
        self.do_contrastive_disc = gan_cfg.get("contrastive", True)
        self.contrastive_loss_weight = gan_cfg.get("contrastive_weight", 1.0)
        self.gen_noise_dist = build_noise_dist(gan_cfg.get("gen_noise_dist"))
        self.dis_noise_dist = build_noise_dist(gan_cfg.get("dis_noise_dist"))

        dit = getattr(discriminator.model, "model", None)
        embed_dim = getattr(dit, "embed_dim", 512)
        in_channels = (embed_dim if 0 <= self.discriminator_dit_layer < getattr(dit, "depth", 0)
                       else getattr(dit, "io_channels", embed_dim))
        head_cfg = gan_cfg.get("head", {"type": "conv"})
        channels = head_cfg.get("channels", embed_dim)
        device = next(discriminator.parameters()).device
        with torch.device(device):
            if head_cfg.get("type", "conv") == "convnext":
                self.head = ConvNeXtDiscriminator(in_channels=in_channels)
            else:
                self.head = ConvDiscriminator(in_channels, channels)

        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.disc_params = {**{f"discriminator.{n}": p
                               for n, p in discriminator.named_parameters() if p.requires_grad},
                            **{f"head.{n}": p for n, p in self.head.named_parameters()}}
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["diffusion"],
                                                         list(self.params.values()))
        self.disc_optimizer, self.disc_scheduler = build_optimizer(
            optimizer_configs["discriminator"], list(self.disc_params.values()))
        self.ema = ema_init(self.params) if use_ema else None

        self.trim_config = trim_config
        if trim_config is not None:
            self.trim_prob = trim_config.get("trim_prob", 0.0)
            self.trim_type = trim_config.get("type", "random_item")
            self.trim_bucket = trim_config.get("bucket_multiple", 128)
        self.ode_states: tp.Optional[tp.Dict[str, Tensor]] = None
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def learning_rates(self) -> tp.Dict[str, float]:
        return {"lr": self.optimizer.param_groups[0]["lr"],
                "disc_lr": self.disc_optimizer.param_groups[0]["lr"]}

    def generator(self, step: int) -> torch.Generator:
        seed = (self.seed * 0x9E3779B1 + step) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _maybe_trim(self, latents, padding_masks, step: int):
        """Random trim of the latent sequence (after the ODE warmup): with
        probability trim_prob, to one item's data length (`random_item`) or
        the shortest (else), at least 128, rounded up to the bucket."""
        if self.trim_config is None or self.trim_prob <= 0.0:
            return latents
        rng = np.random.default_rng(step)
        if rng.random() >= self.trim_prob:
            return latents
        T = latents.shape[-1]
        if padding_masks is not None:
            if isinstance(padding_masks, torch.Tensor):
                padding_masks = padding_masks.cpu().numpy()
            data_lengths = np.asarray(padding_masks).sum(axis=1).astype(int) - 1
        else:
            data_lengths = np.asarray([T])
        if self.trim_type == "random_item":
            trim_length = max(int(rng.choice(data_lengths)), 128)
        else:
            trim_length = max(int(data_lengths.min()), 128)
        b = self.trim_bucket
        trim_length = min(-(-trim_length // b) * b, T)
        if trim_length >= T:
            return latents
        return latents[:, :, :trim_length]

    # -- pieces ----------------------------------------------------------------

    def hidden_states(self, x: Tensor, t: Tensor, cond_tensors) -> Tensor:
        disc = self.discriminator
        return disc(x, t, **disc.get_conditioning_inputs(cond_tensors),
                    exit_layer_ix=self.discriminator_dit_layer)

    def scores(self, x: Tensor, t: Tensor, cond_tensors) -> Tensor:
        return self.head(self.hidden_states(x, t, cond_tensors))

    def _draw(self, draws: dict, key: str, make):
        v = draws.get(key)
        return make() if v is None else v.to(self.device)

    @torch.no_grad()
    def refresh_ode_states(self, latents: Tensor, cond_tensors, generator,
                           noise: tp.Optional[Tensor] = None) -> tp.Dict[str, Tensor]:
        """The teacher's DPM++ trajectory from fresh noise over
        `get_rf_schedule(n_sampling_steps)` (JAX :35, :232): {"target": its
        end [B, C, T], "x": each step's input state [steps, B, C, T], "t":
        each step's t [steps]}."""
        teacher = self.teacher_model if self.teacher_model is not None else self.model
        t = get_rf_schedule(self.ode_n_sampling_steps)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=self.device)
        cond = teacher.get_conditioning_inputs(cond_tensors)
        states = []
        target = sample_flow_dpmpp(
            lambda x, tt: teacher(x, tt, cfg_scale=self.ode_warmup_cfg, **cond),
            noise.to(self.device), sigmas=t, on_step=lambda i, x: states.append(x))
        return {"target": target, "x": torch.stack(states),
                "t": torch.from_numpy(t[:-1].copy()).to(self.device)}

    def _student(self, x: Tensor, t: Tensor, cond_tensors, generator, cfg_dropout_mask):
        return self.model(x, t, **self.model.get_conditioning_inputs(cond_tensors),
                          cfg_dropout_prob=self.cfg_dropout_prob, generator=generator,
                          cfg_dropout_mask=cfg_dropout_mask)

    def _ode_loss(self, cond_tensors, gen, draws):
        states = self.ode_states
        B = states["target"].shape[0]
        ixs = self._draw(draws, "ixs", lambda: torch.randint(
            0, self.ode_n_sampling_steps, (B,), generator=gen, device=self.device))
        t = states["t"][ixs]
        x_t = states["x"][ixs, torch.arange(B, device=self.device)]
        v = self._student(x_t, t, cond_tensors, gen, draws.get("cfg_dropout_mask"))
        loss = (euler_step(x_t, v, t, torch.zeros_like(t)) - states["target"]).square().mean()
        return loss, {"ode_mse_loss": loss.detach(), "loss": loss.detach()}

    def _noised(self, latents, gen, draws, dist, t_key, noise_key):
        B = latents.shape[0]
        t = self._draw(draws, t_key, lambda: dist(B, gen, self.device)).float()
        noise = self._draw(draws, noise_key, lambda: torch.randn(
            latents.shape, generator=gen, device=self.device)).to(latents.dtype)
        return t, noise

    def _gen_loss(self, latents, cond_tensors, gen, draws):
        t, noise = self._noised(latents, gen, draws, self.gen_noise_dist, "t", "noise")
        x_t = latents * (1 - t)[:, None, None] + noise * t[:, None, None]
        v = self._student(x_t, t, cond_tensors, gen, draws.get("cfg_dropout_mask"))
        denoised = euler_step(x_t, v, t, torch.zeros_like(t))
        t_gan, gan_noise = self._noised(latents, gen, draws, self.dis_noise_dist, "t_gan",
                                        "gan_noise")
        tg = t_gan[:, None, None]
        fake = self.scores(denoised * (1 - tg) + gan_noise * tg, t_gan, cond_tensors)
        with torch.no_grad():  # no path to the student's parameters
            real = self.scores(latents * (1 - tg) + gan_noise * tg, t_gan, cond_tensors)
        loss = F.softplus(real - fake).mean() * self.gen_gan_weight
        return loss, {"loss": loss.detach(), "adv_loss": loss.detach(),
                      "gen_disc_scores_mean": fake.detach().float().mean()}

    def _disc_loss(self, latents, cond_tensors, rolled_cond_tensors, gen, draws):
        t, noise = self._noised(latents, gen, draws, self.gen_noise_dist, "t", "noise")
        x_t = latents * (1 - t)[:, None, None] + noise * t[:, None, None]
        with torch.no_grad():
            v = self.model(x_t, t, **self.model.get_conditioning_inputs(cond_tensors))
            denoised = euler_step(x_t, v, t, torch.zeros_like(t))
        t_gan, gan_noise = self._noised(latents, gen, draws, self.dis_noise_dist, "t_gan",
                                        "gan_noise")
        tg = t_gan[:, None, None]
        reals_t = latents * (1 - tg) + gan_noise * tg
        fakes_t = denoised * (1 - tg) + gan_noise * tg
        scores_real = self.scores(reals_t, t_gan, cond_tensors)
        scores_fake = self.scores(fakes_t, t_gan, cond_tensors)
        loss_dis = F.softplus(-(scores_real - scores_fake)).mean() * self.dis_gan_weight
        aux = {"loss_dis": loss_dis.detach(),
               "disc_real_scores_mean": scores_real.detach().float().mean(),
               "disc_fake_scores_mean": scores_fake.detach().float().mean()}
        total = loss_dis
        if self.include_grad_penalties:
            eps = 0.05
            nr = reals_t + eps * self._draw(draws, "gp_noise_real", lambda: torch.randn(
                reals_t.shape, generator=gen, device=self.device)).to(reals_t.dtype)
            nf = fakes_t + eps * self._draw(draws, "gp_noise_fake", lambda: torch.randn(
                fakes_t.shape, generator=gen, device=self.device)).to(fakes_t.dtype)
            r1 = (self.scores(nr, t_gan, cond_tensors) - scores_real).square().sum(
                dim=(1, 2)).mean()
            r2 = (self.scores(nf, t_gan, cond_tensors) - scores_fake).square().sum(
                dim=(1, 2)).mean()
            gp = (r1 + r2) / 2
            aux["grad_penalty_loss"] = gp.detach()
            total = total + gp
        if self.do_contrastive_disc and rolled_cond_tensors is not None:
            scores_rolled = self.scores(reals_t, t_gan, rolled_cond_tensors)
            contrastive = (F.softplus(-(scores_real - scores_rolled)).mean()
                           * self.dis_gan_weight * self.contrastive_loss_weight)
            aux["contrastive_loss_dis"] = contrastive.detach()
            total = total + contrastive
        aux["loss"] = total.detach()
        return total, aux

    def _update(self, loss, optimizer, scheduler, params) -> None:
        loss.backward()
        if self.clip_grad_norm > 0:
            torch.nn.utils.clip_grad_norm_(list(params), self.clip_grad_norm)
        optimizer.step()
        scheduler.step()

    # -- the step ---------------------------------------------------------------

    def train_step(self, latents: Tensor, cond_tensors, step: tp.Optional[int] = None,
                   rolled_cond_tensors=None, padding_masks=None,
                   draws: tp.Optional[tp.Dict[str, Tensor]] = None) -> tp.Dict[str, Tensor]:
        """One step of the phase `step` (default: the trainer's count) falls
        in; `cond_tensors` is the conditioner's output ({id: (tensor,
        mask)}). Returns the step's losses as device scalars."""
        step = self.step if step is None else step
        draws = draws or {}
        # the conditioning is an input, as in JAX: no gradient reaches the
        # conditioner that made it
        cond_tensors, rolled_cond_tensors = (
            None if c is None else {k: tuple(None if a is None else a.detach() for a in v)
                                    for k, v in c.items()}
            for c in (cond_tensors, rolled_cond_tensors))
        gen = self.generator(step)
        latents = latents.to(self.device)
        self.model.train()
        self.discriminator.train()
        self.optimizer.zero_grad(set_to_none=True)
        self.disc_optimizer.zero_grad(set_to_none=True)
        if step < self.ode_warmup_steps:
            if self.ode_states is None or step % self.ode_refresh_rate == 0:
                self.ode_states = self.refresh_ode_states(latents, cond_tensors, gen,
                                                          draws.get("ode_noise"))
            loss, aux = self._ode_loss(cond_tensors, gen, draws)
            self._update(loss, self.optimizer, self.scheduler, self.params.values())
            if self.ema is not None:
                ema_update(self.ema, self.params, self.step)
        elif step % 2 == 0:
            latents = self._maybe_trim(latents, padding_masks, step)
            # the discriminator and head frozen through the backward too: its
            # rematerialised blocks must save what their forward saved
            with _frozen(self.disc_params.values()):
                loss, aux = self._gen_loss(latents, cond_tensors, gen, draws)
                self._update(loss, self.optimizer, self.scheduler, self.params.values())
            if self.ema is not None:
                ema_update(self.ema, self.params, self.step)
        else:
            latents = self._maybe_trim(latents, padding_masks, step)
            loss, aux = self._disc_loss(latents, cond_tensors, rolled_cond_tensors, gen, draws)
            self._update(loss, self.disc_optimizer, self.disc_scheduler,
                         self.disc_params.values())
        self.step += 1
        return aux
