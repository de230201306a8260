"""Training factory; counterpart of stable_audio_tools_tpu/training/factory.py
(`create_training_wrapper_from_config` :8). The port trains `autoencoder`
(:17; Oobleck, DAC and SEANet towers, VAE and RVQ bottlenecks),
`diffusion_uncond` (:33), `diffusion_cond` (the DiT and the ADP
`adp_cfg_1d` UNet) and `lm` (:116) models; the other model and diffusion
types raise NotImplementedError."""

from __future__ import annotations

import typing as tp

# training-config keys of the JAX DiffusionCondTrainer that this port does not
# implement yet; a config that sets one (to a true value) is refused rather
# than half-run
_UNPORTED = ("arc", "inpainting_config", "p_one_shot", "log_loss_info")


def create_training_wrapper_from_config(model_config: tp.Dict[str, tp.Any], model,
                                        gradient_clip_val: float = 0.0, seed: int = 42):
    model_type = model_config.get("model_type")
    training_config = model_config.get("training")
    if training_config is None:
        raise ValueError("training config must be specified in model config")
    if model_type == "autoencoder":
        from .autoencoders import AutoencoderTrainer

        return AutoencoderTrainer(
            model,
            lr=training_config.get("learning_rate"),
            warmup_steps=training_config.get("warmup_steps", 0),
            warmup_mode=training_config.get("warmup_mode", "adv"),
            encoder_freeze_on_warmup=training_config.get("encoder_freeze_on_warmup", False),
            sample_rate=model_config["sample_rate"],
            loss_config=training_config.get("loss_configs"),
            optimizer_configs=training_config.get("optimizer_configs"),
            use_ema=training_config.get("use_ema", True),
            latent_mask_ratio=training_config.get("latent_mask_ratio", 0.0),
            teacher_model=training_config.get("teacher_model"),
            compute_dtype=training_config.get("compute_dtype"),
            clip_grad_norm=gradient_clip_val,
            seed=seed,
        )
    if model_type == "lm":
        from .lm import AudioLanguageModelTrainer

        return AudioLanguageModelTrainer(
            model,
            lr=training_config.get("learning_rate"),
            use_ema=training_config.get("use_ema", False),
            optimizer_configs=training_config.get("optimizer_configs"),
            pre_tokenized=training_config.get("pre_tokenized", False),
        )
    if model_type == "diffusion_uncond":
        from .diffusion import DiffusionUncondTrainer

        return DiffusionUncondTrainer(
            model,
            lr=training_config.get("learning_rate", 1e-4),
            pre_encoded=training_config.get("pre_encoded", False),
            use_ema=training_config.get("use_ema", True),
            optimizer_configs=training_config.get("optimizer_configs"),
            gradient_clip_val=gradient_clip_val,
            seed=seed,
        )
    if model_type != "diffusion_cond":
        raise NotImplementedError(f"training {model_type} models is not ported yet")
    diffusion_type = model_config["model"]["diffusion"]["type"]
    if diffusion_type not in ("dit", "adp_cfg_1d"):
        raise NotImplementedError(f"training diffusion model type {diffusion_type} is not "
                                  "ported yet (ROADMAP.md queue 1)")
    unported = [k for k in _UNPORTED if training_config.get(k)]
    if model_config["model"]["diffusion"].get("distribution_shift_options"):
        unported.append("distribution_shift_options")
    if unported:
        raise NotImplementedError(f"training config keys not ported yet: {unported}")
    from .diffusion import DiffusionCondTrainer

    return DiffusionCondTrainer(
        model,
        lr=training_config.get("learning_rate"),
        use_ema=training_config.get("use_ema", True),
        optimizer_configs=training_config.get("optimizer_configs"),
        cfg_dropout_prob=training_config.get("cfg_dropout_prob", 0.1),
        timestep_sampler=training_config.get("timestep_sampler", "uniform"),
        timestep_sampler_options=training_config.get("timestep_sampler_options"),
        gradient_clip_val=gradient_clip_val,
        seed=seed,
        pre_encoded=training_config.get("pre_encoded", False),
        mask_padding=training_config.get("mask_padding", False),
        mask_padding_dropout=training_config.get("mask_padding_dropout", 0.0),
    )
