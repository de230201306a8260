"""Training entry point of the PyTorch port (the JAX package's root `train.py`).

    python -m stable_audio_tools_tpu_torch.train --model-config MODEL.json \\
        --dataset-config DATASET.json [--batch-size 4] [--max-steps N] ...

Builds the model from its JSON config (a conditioned or unconditional
diffusion model, an autoencoder or a token LM; random weights drawn from a `torch.Generator`
seeded with --seed; the T5 tower is random unless the config's conditioner
loads weights), the training wrapper from the config's `training` section
(for an autoencoder, the GAN trainer with its discriminator; for an LM, the
next-token trainer over the frozen codec's codes) and the dataloader (an
`audio_dir` dataset, or a `pre_encoded` one of latents for a diffusion model
whose training config sets `pre_encoded`; its `latent_crop_length` defaults,
as in the JAX entry, to the model's sample_size), then trains on the current
CUDA card (on the CPU only with `--device cpu`), writing `train_log.jsonl` and
`step=N.ckpt` files to --save-dir. Defaults come from the repository's
`defaults.ini`. Flags of the JAX entry point that the port does not implement
yet are refused.
"""

from __future__ import annotations

import argparse
import configparser
import json
import random
import typing as tp
from pathlib import Path

import numpy as np
import torch

DEFAULTS_INI = Path(__file__).resolve().parents[1] / "defaults.ini"

# --precision values -> the compute dtype when the config sets none: the
# DiT's, the unconditional model's (`model.config`), or the autoencoder
# trainer's `training.compute_dtype` (the JAX entry's mapping; it does not
# reach an LM, whose backbone config rules)
PRECISION_DTYPE = {
    "16-mixed": "bfloat16", "16-true": "bfloat16", "16": "bfloat16",
    "bf16-mixed": "bfloat16", "bf16-true": "bfloat16", "bf16": "bfloat16",
    "32-true": "float32", "32": "float32", "64": "float32",
}

# flags of the JAX train.py that this entry does not implement yet
UNPORTED_FLAGS = ("name", "project", "num_gpus", "num_nodes", "strategy", "recover",
                  "save_top_k", "remove_pretransform_weight_norm", "val_every",
                  "pretrained_ckpt_path", "pretransform_ckpt_path", "val_dataset_config",
                  "logger", "demo_every", "mesh_model", "multihost", "profile_dir")


def _defaults() -> tp.Dict[str, str]:
    ini = configparser.ConfigParser()
    ini.read(DEFAULTS_INI)
    return {k: v.strip("'\"") for k, v in ini["DEFAULTS"].items()} if "DEFAULTS" in ini else {}


def parse_args(argv: tp.Optional[tp.Sequence[str]] = None) -> argparse.Namespace:
    d = _defaults()
    p = argparse.ArgumentParser(description="stable-audio-tools PyTorch trainer")
    p.add_argument("--model-config", default=d.get("model_config", ""))
    p.add_argument("--dataset-config", default=d.get("dataset_config", ""))
    p.add_argument("--batch-size", type=int, default=int(d.get("batch_size", 4)))
    p.add_argument("--num-workers", type=int, default=int(d.get("num_workers", 6)))
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=int(d.get("checkpoint_every", 10000)))
    p.add_argument("--save-dir", default=d.get("save_dir", "checkpoints"))
    p.add_argument("--seed", type=int, default=int(d.get("seed", 42)))
    p.add_argument("--accum-batches", type=int, default=int(d.get("accum_batches", 1)))
    p.add_argument("--ckpt-path", default=d.get("ckpt_path", ""))
    p.add_argument("--precision", default=d.get("precision", "16-mixed"))
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the current CUDA card)")
    p.add_argument("--gradient-clip-val", type=float,
                   default=float(d.get("gradient_clip_val", 0.0)))
    for flag in UNPORTED_FLAGS:
        p.add_argument("--" + flag.replace("_", "-"), default=None, nargs="?", const=True,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    given = [f"--{f.replace('_', '-')}" for f in UNPORTED_FLAGS if getattr(args, f) is not None]
    if given:
        p.error(f"not implemented by the PyTorch trainer yet: {' '.join(given)}")
    if args.precision not in PRECISION_DTYPE:
        p.error(f"--precision {args.precision!r} is not one of {sorted(PRECISION_DTYPE)}")
    if not args.model_config or not args.dataset_config:
        p.error("--model-config and --dataset-config are required")
    return args


def build(args: argparse.Namespace, device: tp.Optional[torch.device] = None):
    """(Trainer, dataloader) for the parsed arguments; the model lives on
    `device` (default: --device, else the current CUDA card)."""
    from .data.dataset import create_dataloader_from_config
    from .models.factory import create_model_from_config, init_random_, resolve_device
    from .training.factory import create_training_wrapper_from_config
    from .training.trainer import Trainer
    from .training.utils import get_rank

    device = resolve_device(device if device is not None else args.device)
    with open(args.model_config) as f:
        model_config = json.load(f)
    with open(args.dataset_config) as f:
        dataset_config = json.load(f)
    model_type = model_config.get("model_type")
    if model_type == "autoencoder":
        compute = model_config.setdefault("training", {})
    elif model_type == "lm":
        compute = None  # the backbone config's compute_dtype alone, as the JAX entry
    elif model_type == "diffusion_uncond":
        compute = model_config["model"].setdefault("config", {})
    else:
        compute = model_config["model"]["diffusion"]["config"]
    if compute is not None:
        compute.setdefault("compute_dtype", PRECISION_DTYPE[args.precision])
    random.seed(args.seed)
    np.random.seed(args.seed)
    model = create_model_from_config(model_config, device)
    init_random_(model, torch.Generator(device=device).manual_seed(args.seed))
    wrapper = create_training_wrapper_from_config(
        model_config, model, gradient_clip_val=args.gradient_clip_val, seed=args.seed)
    dataloader = create_dataloader_from_config(
        dataset_config, batch_size=args.batch_size, sample_size=model_config["sample_size"],
        sample_rate=model_config["sample_rate"],
        audio_channels=model_config.get("audio_channels", 2), num_workers=args.num_workers,
        rank=get_rank(), seed=args.seed)
    trainer = Trainer(wrapper, model_config, save_dir=args.save_dir,
                      checkpoint_every=args.checkpoint_every, max_steps=args.max_steps,
                      accum_batches=args.accum_batches)
    return trainer, dataloader


def main(argv: tp.Optional[tp.Sequence[str]] = None):
    args = parse_args(argv)
    trainer, dataloader = build(args)
    trainer.fit(dataloader, ckpt_path=args.ckpt_path or None)
    return trainer


if __name__ == "__main__":
    main()
