"""Training factory; counterpart of stable_audio_tools_tpu/training/factory.py
(`create_training_wrapper_from_config` :8). The port trains `autoencoder`
(:17; Oobleck, TAAE, DAC and SEANet towers, the bottlenecks
models/factory.py builds; `encoder_freeze_on_warmup` and
`latent_mask_ratio` from the config, as JAX :25, :30; a `teacher_model` key
is refused by name: the JAX factory builds no teacher and ignores the key,
and a teacher is handed to `AutoencoderTrainer(teacher_model=...)`),
`diffusion_uncond` (:33; DAU1d, `adp_uncond_1d`, `dit`), `diffusion_cond`
and `diffusion_cond_inpaint` (:43; the DiT and the ADP `adp_cfg_1d` and
`adp_1d` UNets; with `arc` in the training config, ARC post-training,
training/arc.py), `diffusion_autoencoder` (:104) and `lm` (:116) models;
another model type raises NotImplementedError."""

from __future__ import annotations

import copy
import typing as tp


def create_training_wrapper_from_config(model_config: tp.Dict[str, tp.Any], model,
                                        gradient_clip_val: float = 0.0, seed: int = 42):
    model_type = model_config.get("model_type")
    training_config = model_config.get("training")
    if training_config is None:
        raise ValueError("training config must be specified in model config")
    if model_type == "autoencoder":
        from .autoencoders import AutoencoderTrainer

        if "teacher_model" in training_config:
            raise NotImplementedError("teacher_model in the config: the factory builds no "
                                      "teacher (the JAX factory ignores the key); pass one to "
                                      "AutoencoderTrainer(teacher_model=..., teacher_variables=...)")

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
    if model_type == "diffusion_autoencoder":
        from .diffusion import DiffusionAutoencoderTrainer

        return DiffusionAutoencoderTrainer(
            model,
            lr=training_config.get("learning_rate", 1e-4),
            use_ema=training_config.get("use_ema", True),
            optimizer_configs=training_config.get("optimizer_configs"),
            use_reconstruction_loss=training_config.get("use_reconstruction_loss", False),
            gradient_clip_val=gradient_clip_val,
            seed=seed,
        )
    if model_type not in ("diffusion_cond", "diffusion_cond_inpaint"):
        raise NotImplementedError(f"Unknown model type: {model_type}")
    if "arc" in training_config:
        return _arc_trainer(model_config, model, training_config, seed)
    from .diffusion import DiffusionCondTrainer

    inpaint_default = {} if model_type == "diffusion_cond_inpaint" else None
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
        log_loss_info=training_config.get("log_loss_info", False),
        p_one_shot=training_config.get("p_one_shot", 0.0),
        inpainting_config=training_config.get("inpainting_config", inpaint_default),
    )


def _arc_trainer(model_config: dict, model, training_config: dict, seed: int):
    """ARC post-training (JAX :44-80). The discriminator is built from
    `discriminator_base_model` (a model config) or, by default, is a copy of
    the student with its weights. The teacher is the student's own weights:
    the JAX factory builds a `teacher_model` but hands the trainer no
    variables for it, so its trajectories always run on the student's
    parameters (JAX training/arc.py:235); the port does the same and builds
    no teacher."""
    from ..models.factory import create_model_from_config
    from .arc import ARCTrainer

    arc_config = training_config["arc"]
    disc_config = arc_config.get("discriminator_base_model")
    if disc_config is None and arc_config.get("use_model_as_discriminator", True):
        discriminator = copy.deepcopy(model)
    else:
        device = next(model.parameters()).device
        discriminator = create_model_from_config(disc_config, device)
    lr = training_config.get("learning_rate", 1e-5)
    default_opt = {"optimizer": {"type": "AdamW", "config": {"lr": lr}}}
    return ARCTrainer(
        model=model,
        discriminator=discriminator,
        arc_config=arc_config,
        optimizer_configs=training_config.get(
            "optimizer_configs", {"diffusion": default_opt, "discriminator": default_opt}),
        use_ema=training_config.get("use_ema", True),
        cfg_dropout_prob=training_config.get("cfg_dropout_prob", 0.1),
        clip_grad_norm=training_config.get("clip_grad_norm", 0.0),
        trim_config=training_config.get("trim_config"),
        seed=seed,
    )
