"""Autoencoder GAN training; counterpart of
stable_audio_tools_tpu/training/autoencoders.py (`AutoencoderTrainer` :86,
`create_loss_modules_from_bottleneck` :54).

Two optimizers alternate on the step's parity (JAX `train_step` :513): odd
steps train the discriminator (from step 0 with `warmup_mode` "adv", from
`warmup_steps` with "full"), even steps the generator (the autoencoder),
whose adversarial and feature-matching losses join from `warmup_steps`.

- `ae_forward` (JAX `_ae_forward` :337): encode with the bottleneck's loss
  (the VAE's KL, the RVQ's commitment loss, the DAC RVQ's codebook and
  commitment losses), decode (a `quantize_on_decode` bottleneck's quantized
  latents from the encode's info, unless the latents were masked; the
  decode-side noise augmentation drawn there), in `compute_dtype`
  (bf16 on the card); decoded audio, latents and the loss info come back in
  f32 (:403-412), trimmed to the shorter length, with the left/right
  channels split out for stereo. The decoder takes the latents in
  `compute_dtype`: the JAX step hands it the latents as they come, f32
  behind a DAC encoder's f32 `proj_out` or an RVQ, so its DAC and SEANet
  decoders compute in f32 under a bf16 compute dtype.
- An RVQ's state (codebooks, EMA trackers, the k-means flag; buffers that
  no optimizer, weight decay or parameter EMA touches) moves in the
  generator step only, as the JAX step keeps `quantizer_state` from its
  generator step and drops the discriminator step's. The discriminator step
  quantizes with the state as it stands: the JAX step's train-mode pass
  quantizes with the same codebooks once the first (generator) step has
  run its k-means init, and its update is discarded.
- The generator step: the MRSTFT losses (sum/difference and L/R, with
  A-weighting), the KL and, warmed up, the discriminator's adversarial and
  feature-matching terms; the discriminator takes no gradient and does not
  move (the backward only reaches the autoencoder's parameters). AdamW with
  its LR schedule, then the EMA of the autoencoder's parameters.
- The discriminator step: the autoencoder forward under `no_grad`, its output
  detached, the hinge loss, the discriminator's AdamW.
- `val_step` (JAX `make_val_step` :533): the STFT, SI-SDR and mel distances
  of the eval-mode forward with the training weights.

- `encoder_freeze_on_warmup` (JAX :365-367, :442): once warmed up, the
  generator step detaches the latents and the bottleneck's info, so the
  encoder takes a zero gradient; as in JAX every parameter without a
  gradient gets zeros, so AdamW still moves it by its moments and its weight
  decay.
- `latent_mask_ratio` (JAX :379-382): in the training passes (both steps,
  as JAX's `train=True`), the latents are zeroed where a uniform draw falls
  below the ratio, after `info["latents"]` keeps them whole.
- `teacher_model` (+ `teacher_variables`, a state dict loaded into it, as
  JAX takes them :100-101): a frozen autoencoder. Its encode of the input
  gives `teacher_latents`; its decodes of those and of the (masked) student
  latents, and the student's decode of the teacher latents, feed five
  losses at weight mrstft x 0.25 that replace the MRSTFT terms (JAX
  :211-230, :371-376, :425-436): latent MSE, MRSTFT of the output, of the
  output against the teacher's, of each cross decode. The decodes take the
  latents in the compute dtype, as the student's own.
- The stochastic bottlenecks' training behaviour (the dithered FSQ's
  dropout and dither, the Wasserstein MMD) runs in both steps, as JAX's
  `train=True`; an RVQ's state moves in the generator step only.

The losses, STFTs and FIR run in f32; weights, gradients, Adam state and the
EMA stay f32. Random numbers come from a `torch.Generator` seeded from
(seed, step), or are injected, as the tests replay the JAX package's:
`noise=` (the bottleneck's: the VAE's normals, the Wasserstein's, the
dithered FSQ's dict) and `draws=` ({"latent_mask": [B, C, T] uniform,
"teacher_noise": the teacher's VAE normals, "decode_noise": the
bottleneck's decode-side draws, models/bottleneck.py}). The mrmel and hubert losses
and the discriminators other than EnCodec's are refused by name, and so is
gradient accumulation (JAX's GAN trainer ignores `accum_batches`).
"""

from __future__ import annotations

import time
import typing as tp

import torch

from ..models import bottleneck as B
from ..models.discriminators import EncodecDiscriminator
from .ema import ema_init, ema_update
from .losses.auraloss import MultiResolutionSTFTLoss, SumAndDifferenceSTFTLoss
from .losses.losses import AuralossLoss, L1Loss, LossModule, MSELoss, MultiLoss, ValueLoss
from .losses.metrics import make_eval_metrics
from .utils import build_optimizer

Tensor = torch.Tensor


def create_loss_modules_from_bottleneck(bottleneck, loss_config: dict) -> tp.List[LossModule]:
    """The bottleneck's losses (JAX :54), in JAX's order: the KL of the VAE,
    RVQ-VAE and DAC RVQ-VAE (weight `kl`, 1e-6 by default), the RVQs'
    commitment loss (`quantizer_loss`, weight 1), the DAC RVQs' codebook and
    commitment losses (`codebook` 1.0, `commitment` 0.25 by default), the
    Wasserstein's MMD (`mmd`, 100); the tanh, softnorm, L2 and FSQ
    bottlenecks take none; a bottleneck of another class is refused."""
    weights = loss_config.get("bottleneck", {}).get("weights", {})
    losses: tp.List[LossModule] = []
    if isinstance(bottleneck, (B.VAEBottleneck, B.DACRVQVAEBottleneck, B.RVQVAEBottleneck)):
        losses.append(ValueLoss(key="kl", weight=weights.get("kl", 1e-6), name="kl_loss"))
    if isinstance(bottleneck, B.RVQBottleneck):
        losses.append(ValueLoss(key="quantizer_loss", weight=1.0, name="quantizer_loss"))
    if isinstance(bottleneck, B.DACRVQBottleneck):
        losses += [ValueLoss(key="vq/codebook_loss", weight=weights.get("codebook", 1.0),
                             name="codebook_loss"),
                   ValueLoss(key="vq/commitment_loss", weight=weights.get("commitment", 0.25),
                             name="commitment_loss")]
    if isinstance(bottleneck, B.WassersteinBottleneck):
        losses.append(ValueLoss(key="mmd", weight=weights.get("mmd", 100), name="mmd_loss"))
    if not isinstance(bottleneck, (B.VAEBottleneck, B.RVQBottleneck, B.DACRVQBottleneck,
                                   B.WassersteinBottleneck, B.TanhBottleneck,
                                   B.SoftNormBottleneck, B.L2Bottleneck, B.FSQBottleneck,
                                   B.DitheredFSQBottleneck)):
        raise NotImplementedError(f"losses of the {type(bottleneck).__name__} bottleneck "
                                  "are not ported")
    return losses


def _default_loss_config() -> dict:
    scales = [2048, 1024, 512, 256, 128, 64, 32]
    hops = [s // 4 for s in scales]
    return {
        "discriminator": {"type": "encodec",
                          "config": {"n_ffts": scales, "hop_lengths": hops,
                                     "win_lengths": scales, "filters": 32},
                          "weights": {"adversarial": 0.1, "feature_matching": 5.0}},
        "spectral": {"type": "mrstft",
                     "config": {"fft_sizes": scales, "hop_sizes": hops, "win_lengths": scales,
                                "perceptual_weighting": True},
                     "weights": {"mrstft": 1.0}},
        "time": {"type": "l1", "config": {}, "weights": {"l1": 0.0}},
    }


class AutoencoderTrainer:
    """Trains an AudioAutoencoder (models/autoencoders.py) in place against an
    EnCodec discriminator it builds: two `torch.optim` optimizers with their
    LR schedules, an f32 EMA of the autoencoder's parameters, the step count.
    `model`, `optimizer`, `scheduler` are the generator's (the names the
    checkpoint and the loop read); `discriminator`, `disc_optimizer`,
    `disc_scheduler` the discriminator's."""

    def __init__(self, autoencoder, sample_rate: int = 48000,
                 loss_config: tp.Optional[dict] = None,
                 optimizer_configs: tp.Optional[dict] = None, lr: tp.Optional[float] = 1e-4,
                 warmup_steps: int = 0, warmup_mode: str = "adv",
                 encoder_freeze_on_warmup: bool = False, use_ema: bool = True,
                 latent_mask_ratio: float = 0.0,
                 teacher_model=None, teacher_variables: tp.Optional[dict] = None,
                 clip_grad_norm: float = 0.0,
                 compute_dtype: tp.Optional[str] = None, seed: int = 42):
        if warmup_mode not in ("adv", "full"):
            raise ValueError(f"warmup_mode must be 'adv' or 'full', got {warmup_mode!r}")
        self.model = autoencoder
        self.sample_rate = sample_rate
        self.warmup_steps, self.warmup_mode = warmup_steps, warmup_mode
        self.encoder_freeze_on_warmup = encoder_freeze_on_warmup
        self.latent_mask_ratio = latent_mask_ratio
        self.teacher = teacher_model
        if teacher_model is not None:
            if teacher_variables is not None:
                teacher_model.load_state_dict(teacher_variables)
            teacher_model.requires_grad_(False)
        self.clip_grad_norm = clip_grad_norm
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.seed = seed
        lr = 1e-4 if lr is None else lr
        if optimizer_configs is None:
            adamw = {"optimizer": {"type": "AdamW", "config": {"lr": lr, "betas": (0.8, 0.99)}}}
            optimizer_configs = {"autoencoder": adamw, "discriminator": adamw}
        loss_config = loss_config or _default_loss_config()
        for key in ("mrmel", "hubert"):
            if key in loss_config and loss_config[key]["weights"][key] > 0:
                raise NotImplementedError(f"the {key} loss is not ported yet")
        self.use_disc = "discriminator" in loss_config
        device = next(autoencoder.parameters()).device

        stft_args = dict(loss_config["spectral"]["config"])
        stft_args.pop("sample_rate", None)
        scales = [tuple(stft_args.pop(k)) for k in ("fft_sizes", "hop_sizes", "win_lengths")]
        self.out_channels = autoencoder.io_channels
        mrstft = SumAndDifferenceSTFTLoss if self.out_channels == 2 else MultiResolutionSTFTLoss
        self.sdstft = mrstft(*scales, sample_rate=sample_rate, **stft_args)

        gen_losses: tp.List[LossModule] = []
        self.discriminator = None
        if self.use_disc:
            d_type = loss_config["discriminator"]["type"]
            if d_type != "encodec":
                raise NotImplementedError(f"the {d_type} discriminator is not ported yet")
            d_cfg = dict(loss_config["discriminator"]["config"])
            # the conv stacks follow the autoencoder's compute dtype, as in JAX
            d_cfg.setdefault("compute_dtype", compute_dtype or "float32")
            from ..models.factory import init_random_

            self.discriminator = init_random_(
                EncodecDiscriminator(in_channels=self.out_channels, **d_cfg).to(device),
                torch.Generator(device=device).manual_seed(seed + 1))
            w = loss_config["discriminator"]["weights"]
            gen_losses += [
                ValueLoss(key="loss_adv", weight=w["adversarial"], name="loss_adv"),
                ValueLoss(key="feature_matching_distance", weight=w["feature_matching"],
                          name="feature_matching_loss")]
        decay = loss_config["spectral"].get("decay", 1.0)
        weight = loss_config["spectral"]["weights"]["mrstft"]
        if teacher_model is not None:
            w = weight * 0.25
            gen_losses += [
                MSELoss("teacher_latents", "latents", weight=w, name="latent_distill_loss",
                        decay=decay),
                *(AuralossLoss(self.sdstft, input_key=a, target_key=b, name=name, weight=w,
                               decay=decay) for a, b, name in (
                    ("decoded", "reals", "mrstft_loss"),
                    ("decoded", "teacher_decoded", "mrstft_loss_distill"),
                    ("own_latents_teacher_decoded", "reals", "mrstft_loss_own_latents_teacher"),
                    ("teacher_latents_own_decoded", "reals", "mrstft_loss_teacher_latents_own")))]
        else:
            gen_losses.append(AuralossLoss(self.sdstft, input_key="decoded", target_key="reals",
                                           name="mrstft_loss", weight=weight, decay=decay))
        if self.out_channels == 2:
            self.lrstft = MultiResolutionSTFTLoss(*scales, sample_rate=sample_rate, **stft_args)
            if teacher_model is None:
                gen_losses += [AuralossLoss(self.lrstft, input_key=f"decoded_{side}",
                                            target_key=f"reals_{side}",
                                            name=f"stft_loss_{side}", weight=weight / 2,
                                            decay=decay)
                               for side in ("left", "right")]
        time_cfg = loss_config.get("time", {})
        tw, tdecay = time_cfg.get("weights", {}), time_cfg.get("decay", 1.0)
        if tw.get("l1", 0.0) > 0.0:
            gen_losses.append(L1Loss("reals", "decoded", weight=tw["l1"], name="l1_time_loss",
                                     decay=tdecay))
        if tw.get("l2", 0.0) > 0.0:
            gen_losses.append(MSELoss("reals", "decoded", weight=tw["l2"], name="l2_time_loss",
                                      decay=tdecay))
        if autoencoder.bottleneck is not None:
            gen_losses += create_loss_modules_from_bottleneck(autoencoder.bottleneck, loss_config)
        self.losses_gen = MultiLoss(gen_losses)
        self.losses_disc = MultiLoss([ValueLoss(key="loss_dis", weight=1.0,
                                                name="discriminator_loss")])

        self.params = dict(autoencoder.named_parameters())
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["autoencoder"],
                                                         list(self.params.values()))
        self.disc_params = {}
        self.disc_optimizer = self.disc_scheduler = None
        if self.use_disc:
            self.disc_params = dict(self.discriminator.named_parameters())
            self.disc_optimizer, self.disc_scheduler = build_optimizer(
                optimizer_configs["discriminator"], list(self.disc_params.values()))
        self.ema = ema_init(self.params) if use_ema else None
        self.step = 0
        # a dict here times the pieces of the generator steps that follow
        # (ms each, the card synchronised at every boundary); None: no timing
        self.gen_split: tp.Optional[tp.Dict[str, float]] = None
        self._lap_t = 0.0
        self._metrics: tp.Optional[tp.Dict[str, tp.Callable]] = None  # built on first use

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def generator(self, step: int) -> torch.Generator:
        """The generator of the VAE noise of `step`."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 0x9E3779B1 + step) % (2 ** 63))

    def learning_rates(self) -> tp.Dict[str, float]:
        rates = {"lr": self.optimizer.param_groups[0]["lr"]}
        if self.disc_optimizer is not None:
            rates["lr_disc"] = self.disc_optimizer.param_groups[0]["lr"]
        return rates

    # -- pieces of a step ---------------------------------------------------

    def ae_forward(self, reals: Tensor, noise=None,
                   generator: tp.Optional[torch.Generator] = None, train: bool = False,
                   revive_indices: tp.Optional[Tensor] = None, keep_state: bool = True,
                   freeze_encoder: bool = False, draws: tp.Optional[dict] = None
                   ) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
        """(decoded f32, loss info) of reals [B, C, T]. `train` is JAX's
        training pass (the latent mask, the bottleneck's training draws);
        with `keep_state` False an RVQ quantizes without moving its state
        (`revive_indices` replaces its dead-code draws); `freeze_encoder`
        detaches the latents; `draws` injects the trainer's own draws."""
        draws = draws or {}
        info: tp.Dict[str, Tensor] = {"encoder_input": reals}
        encoder_input = reals
        if self.compute_dtype is not None:
            encoder_input = encoder_input.to(self.compute_dtype)
        extra = {} if revive_indices is None else {"revive_indices": revive_indices}
        stateful = isinstance(self.model.bottleneck, B.RVQBottleneck)
        latents, enc_info = self.model.encode(
            encoder_input, generator=generator, noise=noise, return_info=True,
            train=train and (keep_state or not stateful), **extra)
        if freeze_encoder:
            latents = latents.detach()
            enc_info = {k: v.detach() if torch.is_tensor(v) else v for k, v in enc_info.items()}
        info["latents"] = latents
        info.update(enc_info)
        if self.teacher is not None:
            with torch.no_grad():
                info["teacher_latents"] = self.teacher.encode(
                    encoder_input, generator=generator, noise=draws.get("teacher_noise"))
        if self.latent_mask_ratio > 0 and train:
            mask = draws.get("latent_mask")
            if mask is None:
                mask = torch.rand(latents.shape, generator=generator, device=latents.device)
            latents = torch.where(mask.to(latents.device) < self.latent_mask_ratio,
                                  torch.zeros_like(latents), latents)
        # a quantize_on_decode bottleneck's encode already quantized (its
        # info["z"]): decode that, unless the latents were masked (JAX :384-395)
        decode_in, quantized = latents, False
        if (getattr(self.model.bottleneck, "quantize_on_decode", False) and "z" in enc_info
                and not (self.latent_mask_ratio > 0 and train)):
            decode_in, quantized = enc_info["z"], True
        # the decoder computes in the compute dtype: a DAC encoder's f32
        # proj_out and an RVQ give f32 latents, which would carry the JAX
        # decoder into f32 (and the card's bf16 snake kernels refuse them)
        to_compute = (lambda t: t) if self.compute_dtype is None else (
            lambda t: t.to(self.compute_dtype))
        decoded = self.model.decode(to_compute(decode_in), train=train, quantized=quantized,
                                    generator=generator, noise=draws.get("decode_noise"))
        if self.compute_dtype is not None:
            # the losses and the discriminator's STFT run in f32
            decoded = decoded.float()
            info = {k: v.float() if v.dtype == self.compute_dtype else v
                    for k, v in info.items()}
        T = min(decoded.shape[-1], reals.shape[-1])  # transposed-conv length drift
        decoded, reals = decoded[..., :T], reals[..., :T]
        info.update(decoded=decoded, reals=reals)
        if self.out_channels == 2:
            info.update(decoded_left=decoded[:, 0:1], decoded_right=decoded[:, 1:2],
                        reals_left=reals[:, 0:1], reals_right=reals[:, 1:2])
        if self.teacher is not None:
            t_latents = to_compute(info["teacher_latents"])
            with torch.no_grad():
                info["teacher_decoded"] = self.teacher.decode(t_latents).float()
            info["own_latents_teacher_decoded"] = self.teacher.decode(to_compute(latents)).float()
            info["teacher_latents_own_decoded"] = self.model.decode(t_latents).float()
        return decoded, info

    def _lap(self, piece: tp.Optional[str] = None) -> None:
        """Ends the timed `piece` of a generator step where `gen_split` is set."""
        if self.gen_split is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if piece is not None:
            self.gen_split[f"{piece}_ms"] = (now - self._lap_t) * 1e3
        self._lap_t = now

    def _clip(self, params) -> None:
        if self.clip_grad_norm > 0:
            torch.nn.utils.clip_grad_norm_(params, self.clip_grad_norm)

    def gen_step(self, reals: Tensor, noise=None, revive_indices: tp.Optional[Tensor] = None,
                 draws: tp.Optional[dict] = None) -> tp.Dict[str, Tensor]:
        """One generator update (JAX :441); returns its losses (device scalars)."""
        warmed_up = self.step >= self.warmup_steps
        self._lap()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        decoded, info = self.ae_forward(reals, noise, self.generator(self.step), train=True,
                                        revive_indices=revive_indices, draws=draws,
                                        freeze_encoder=warmed_up and self.encoder_freeze_on_warmup)
        self._lap("ae_forward")
        if self.use_disc:
            if warmed_up:
                _, info["loss_adv"], info["feature_matching_distance"] = (
                    self.discriminator.loss(info["reals"], decoded))
            else:
                info["loss_adv"] = info["feature_matching_distance"] = decoded.new_zeros(())
        self._lap("discriminator")
        loss, losses = self.losses_gen(info, self.step)
        self._lap("losses")
        params = list(self.params.values())
        loss.backward(inputs=params)  # the discriminator takes no gradient
        for p in params:  # JAX's zero gradient (a frozen encoder): AdamW moves it all the same
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._lap("backward")
        self._clip(params)
        self.optimizer.step()
        self.scheduler.step()
        self._lap("optimizer")
        if self.ema is not None:
            ema_update(self.ema, self.params, self.step)
        self._lap("ema")
        aux = {"loss": loss, "latent_std": info["latents"].std(correction=0),
               "data_std": reals.std(correction=0), **losses}
        return {k: v.detach() for k, v in aux.items()}

    def disc_step(self, reals: Tensor, noise=None, revive_indices: tp.Optional[Tensor] = None,
                  draws: tp.Optional[dict] = None) -> tp.Dict[str, Tensor]:
        """One discriminator update (JAX :483) against the autoencoder's
        training pass under no_grad (an RVQ's state stays); returns its
        losses."""
        del revive_indices
        with torch.no_grad():
            decoded, info = self.ae_forward(reals, noise, self.generator(self.step), train=True,
                                            keep_state=False, draws=draws)
        self.disc_optimizer.zero_grad(set_to_none=True)
        info["loss_dis"], _, _ = self.discriminator.loss(info["reals"], decoded)
        loss, losses = self.losses_disc(info, self.step)
        params = list(self.disc_params.values())
        loss.backward(inputs=params)
        self._clip(params)
        self.disc_optimizer.step()
        self.disc_scheduler.step()
        return {"loss_dis": info["loss_dis"].detach(), **{k: v.detach() for k, v in losses.items()}}

    def uses_disc(self, step: int) -> bool:
        """Whether `step` trains the discriminator (JAX :513)."""
        warmed_up = step >= self.warmup_steps
        return (self.use_disc and step % 2 == 1
                and (self.warmup_mode == "adv" or warmed_up))

    def train_step(self, audio: Tensor, metadata=None, accum_steps: int = 1, noise=None,
                   revive_indices: tp.Optional[Tensor] = None,
                   draws: tp.Optional[dict] = None) -> tp.Dict[str, Tensor]:
        """The step's update, by parity; `noise` replaces the bottleneck's
        draws, `revive_indices` [Q, K] the RVQ's dead-code draws, `draws`
        the latent mask's and the teacher's (module note)."""
        if accum_steps != 1:
            raise NotImplementedError("gradient accumulation is not ported for autoencoders "
                                      "(the JAX GAN trainer ignores accum_batches)")
        step_fn = self.disc_step if self.uses_disc(self.step) else self.gen_step
        aux = step_fn(audio, noise, revive_indices, draws)
        self.step += 1
        return aux

    @torch.no_grad()
    def val_step(self, audio: Tensor, metadata=None, noise: tp.Optional[Tensor] = None
                 ) -> tp.Dict[str, Tensor]:
        """Validation metrics of a batch (JAX `make_val_step` :533): the
        autoencoder in eval mode with the training weights (no EMA), an RVQ's
        state left as it is, each `make_eval_metrics` metric of the decoded
        audio against the reals under `val/<name>`. The VAE noise comes from
        a generator of its own (or `noise`), never the training's."""
        if self._metrics is None:
            self._metrics = make_eval_metrics(self.sample_rate)
        self.model.eval()
        try:
            decoded, info = self.ae_forward(audio, noise, self.generator(-1 - self.step))
        finally:
            self.model.train()
        return {f"val/{name}": fn(info["decoded"], info["reals"])
                for name, fn in self._metrics.items()}

    def export_params(self) -> tp.Dict[str, Tensor]:
        """The weights to export: the EMA where kept (JAX :550)."""
        return self.ema if self.ema is not None else {n: p.detach() for n, p in self.params.items()}
