"""Training entry point of the PyTorch port (the JAX package's root `train.py`).

    python -m stable_audio_tools_tpu_torch.train --model-config MODEL.json \\
        --dataset-config DATASET.json [--batch-size 4] [--max-steps N] ...

Builds the model from its JSON config (a conditioned or unconditional
diffusion model, an autoencoder, a diffusion autoencoder or a token LM;
random weights drawn from a
`torch.Generator` seeded with --seed; the T5 tower is random unless the
config's conditioner loads weights), then, in the JAX entry's order
(`train.py:218-232`): `--remove-pretransform-weight-norm pre_load`, the
pretransform's weights from `--pretransform-ckpt-path` (an autoencoder's
state dict, or a whole model's whose `pretransform.model.*` part is taken;
every tensor of the pretransform must be there), `post_load`, then
`--pretrained-ckpt-path` (a model file, e.g. what `unwrap_model` writes;
what matches by name and shape is copied and the counts printed). Then the
training wrapper from the config's `training` section (for an autoencoder
the GAN trainer with its discriminator, for an LM the next-token trainer
over the frozen codec's codes, for a diffusion autoencoder its v-objective
trainer), the dataloader (`audio_dir`, local `tar`
shards, or `pre_encoded` latents for a diffusion model whose training config
sets `pre_encoded`; `latent_crop_length` defaults, as in the JAX entry, to
the model's sample_size), the validation loader (`--val-dataset-config`,
not shuffled, every `--val-every` steps), the demo callback of the config's
`training.demo` section (every `--demo-every` steps; 0 takes the config's
`demo_every`, as the JAX entry does), the logger (`--logger jsonl`; `--name`
and `--project` are accepted and, as in JAX, unused by it), and trains on the
current CUDA card (on the CPU only with `--device cpu`), writing
`train_log.jsonl`, `step=N.ckpt` (the newest `--save-top-k`), demos under
`save_dir/demos` and, with `--profile-dir`, a trace of steps 10-12.
`--recover` resumes from the newest `step=*.ckpt` under `--save-dir`.

Defaults come from the repository's `defaults.ini`. The flags of several
cards (`--num-gpus` above 1, `--num-nodes` above 1, a `--strategy` other
than `auto`, `--mesh-model` other than 1, `--multihost`) are refused by name:
the port trains on one card. A model config whose training section holds
`arc` is refused with the reason (`ARC_REFUSAL`): the JAX entry cannot run
ARC either, and ARC runs through the training factory and
`ARCTrainer.train_step` (training/arc.py).
"""

from __future__ import annotations

import argparse
import configparser
import json
import os
import random
import typing as tp
from pathlib import Path

import numpy as np
import torch

DEFAULTS_INI = Path(__file__).resolve().parents[1] / "defaults.ini"

# --precision values -> the compute dtype when the config sets none: the
# DiT's (a diffusion autoencoder's diffusion model's), the unconditional
# model's (`model.config`), or the autoencoder
# trainer's `training.compute_dtype` (the JAX entry's mapping; it does not
# reach an LM, whose backbone config rules)
PRECISION_DTYPE = {
    "16-mixed": "bfloat16", "16-true": "bfloat16", "16": "bfloat16",
    "bf16-mixed": "bfloat16", "bf16-true": "bfloat16", "bf16": "bfloat16",
    "32-true": "float32", "32": "float32", "64": "float32",
}

# the JAX entry's flags of several cards or hosts, with the value that means
# one card; any other value is refused
MULTI_CARD_FLAGS = {"num_gpus": 1, "num_nodes": 1, "strategy": "auto", "mesh_model": 1,
                    "multihost": False}


def _defaults() -> tp.Dict[str, str]:
    ini = configparser.ConfigParser()
    ini.read(DEFAULTS_INI)
    return {k: v.strip("'\"") for k, v in ini["DEFAULTS"].items()} if "DEFAULTS" in ini else {}


def build_parser() -> argparse.ArgumentParser:
    """The entry's flags: the JAX `train.py`'s (:38-93), their defaults from
    `defaults.ini`, and `--device`."""
    d = _defaults()

    def dget(key, fallback, cast=str):
        v = d.get(key, fallback)
        if v in ("None", ""):
            v = fallback
        return None if v is None else cast(v)

    p = argparse.ArgumentParser(description="stable-audio-tools PyTorch trainer")
    p.add_argument("--name", default=dget("name", "stable_audio_tools"))
    p.add_argument("--project", default=dget("project", None))
    p.add_argument("--model-config", default=d.get("model_config", ""))
    p.add_argument("--dataset-config", default=d.get("dataset_config", ""))
    p.add_argument("--val-dataset-config", default=d.get("val_dataset_config", ""))
    p.add_argument("--batch-size", type=int, default=dget("batch_size", 4, int))
    p.add_argument("--num-workers", type=int, default=dget("num_workers", 6, int))
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=dget("checkpoint_every", 10000, int))
    p.add_argument("--val-every", type=int, default=dget("val_every", -1, int))
    p.add_argument("--demo-every", type=int, default=0,
                   help="steps between demos; 0 takes the model config's demo.demo_every")
    p.add_argument("--save-dir", default=d.get("save_dir", "checkpoints"))
    p.add_argument("--save-top-k", type=int, default=dget("save_top_k", -1, int),
                   help="keep only the newest K step=*.ckpt files (-1 keeps all)")
    p.add_argument("--recover", action="store_true",
                   default=d.get("recover", "false").lower() in ("true", "1", "yes"),
                   help="resume from the newest step=*.ckpt in --save-dir")
    p.add_argument("--seed", type=int, default=dget("seed", 42, int))
    p.add_argument("--accum-batches", type=int, default=dget("accum_batches", 1, int))
    p.add_argument("--ckpt-path", default=d.get("ckpt_path", ""))
    p.add_argument("--pretrained-ckpt-path", default=d.get("pretrained_ckpt_path", ""),
                   help="a model file (.ckpt or .safetensors, reference names) to start from")
    p.add_argument("--pretransform-ckpt-path", default=d.get("pretransform_ckpt_path", ""),
                   help="an autoencoder's (or a whole model's) file for the pretransform")
    p.add_argument("--remove-pretransform-weight-norm", choices=["", "pre_load", "post_load"],
                   default=d.get("remove_pretransform_weight_norm", ""))
    p.add_argument("--precision", default=d.get("precision", "16-mixed"))
    p.add_argument("--gradient-clip-val", type=float,
                   default=dget("gradient_clip_val", 0.0, float))
    p.add_argument("--logger", default=d.get("logger", "jsonl"))
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace of steps 10-12 here")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the current CUDA card)")
    p.add_argument("--num-gpus", type=int, default=dget("num_gpus", 1, int))
    p.add_argument("--num-nodes", type=int, default=dget("num_nodes", 1, int))
    p.add_argument("--strategy", default=d.get("strategy", "auto"))
    p.add_argument("--mesh-model", type=int, default=dget("mesh_model", 1, int))
    p.add_argument("--multihost", action="store_true")
    return p


def parse_args(argv: tp.Optional[tp.Sequence[str]] = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    given = [f"--{f.replace('_', '-')} {getattr(args, f)}" for f, one in MULTI_CARD_FLAGS.items()
             if getattr(args, f) != one]
    if given:
        p.error(f"the PyTorch trainer trains on one card; several cards or hosts are not "
                f"ported: {', '.join(given)}")
    if args.precision not in PRECISION_DTYPE:
        p.error(f"--precision {args.precision!r} is not one of {sorted(PRECISION_DTYPE)}")
    if not args.model_config or not args.dataset_config:
        p.error("--model-config and --dataset-config are required")
    return args


def recover_path(args: argparse.Namespace) -> str:
    """The checkpoint to resume from: --ckpt-path, else with --recover the
    newest `step=*.ckpt` under --save-dir (JAX :128-142), else ''."""
    if args.ckpt_path or not args.recover:
        return args.ckpt_path
    from .training.trainer import step_checkpoints

    found = step_checkpoints(args.save_dir)
    if not found:
        print(f"[train] --recover: no step=*.ckpt under {args.save_dir!r}; starting fresh")
        return ""
    print(f"[train] --recover: resuming from {found[-1][1]}")
    return found[-1][1]


def _compute_config(model_config: dict) -> tp.Optional[dict]:
    """The config section whose `compute_dtype` --precision supplies."""
    model_type = model_config.get("model_type")
    if model_type == "autoencoder":
        return model_config.setdefault("training", {})
    if model_type == "lm":
        return None  # the backbone config's compute_dtype alone, as the JAX entry
    if model_type == "diffusion_uncond":
        return model_config["model"].setdefault("config", {})
    return model_config["model"]["diffusion"]["config"]


def build_model(args: argparse.Namespace, model_config: dict, device: torch.device):
    """The model with seeded random weights, then the checkpoints the flags
    name, in the JAX entry's order; returns (model, {"pretrained_loaded",
    "pretrained_skipped", "pretransform_loaded"})."""
    from .io.checkpoints import (copy_state_dict, load_ckpt_state_dict,
                                 load_pretransform_state, remove_weight_norm_from_model)
    from .models.factory import create_model_from_config, init_random_

    compute = _compute_config(model_config)
    if compute is not None:
        compute.setdefault("compute_dtype", PRECISION_DTYPE[args.precision])
    random.seed(args.seed)
    np.random.seed(args.seed)
    model = create_model_from_config(model_config, device)
    init_random_(model, torch.Generator(device=device).manual_seed(args.seed))
    report: tp.Dict[str, tp.Any] = {}
    pretransform = getattr(model, "pretransform", None)
    wn = args.remove_pretransform_weight_norm
    if wn and model_config.get("model_type") == "autoencoder":
        print("[train] --remove-pretransform-weight-norm does not apply to an autoencoder's "
              "training; ignored")
        wn = ""
    elif wn and pretransform is None:
        raise ValueError("--remove-pretransform-weight-norm: the model has no pretransform")
    if wn == "pre_load":
        remove_weight_norm_from_model(pretransform)
    if args.pretransform_ckpt_path:
        report["pretransform_loaded"] = load_pretransform_state(
            model, load_ckpt_state_dict(args.pretransform_ckpt_path))
        print(f"Loaded {report['pretransform_loaded']} tensors into the pretransform from "
              f"{args.pretransform_ckpt_path}")
    if wn == "post_load":
        remove_weight_norm_from_model(pretransform)
    if args.pretrained_ckpt_path:
        loaded, skipped = copy_state_dict(model, load_ckpt_state_dict(args.pretrained_ckpt_path))
        report.update(pretrained_loaded=loaded, pretrained_skipped=skipped)
        print(f"Loaded {loaded} tensors from pretrained ckpt ({len(skipped)} skipped)")
    return model, report


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def make_loader(args: argparse.Namespace, model_config: dict, dataset_config: dict,
                shuffle: bool = True, num_workers: tp.Optional[int] = None):
    from .data.dataset import create_dataloader_from_config
    from .training.utils import get_rank

    return create_dataloader_from_config(
        dataset_config, batch_size=args.batch_size, sample_size=model_config["sample_size"],
        sample_rate=model_config["sample_rate"],
        audio_channels=model_config.get("audio_channels", 2),
        num_workers=args.num_workers if num_workers is None else num_workers,
        shuffle=shuffle, rank=get_rank(), seed=args.seed)


def configure(trainer, args: argparse.Namespace, dataset_config: dict):
    """Set the trainer's demo, validation, checkpoint, logging and profiling
    options from the flags; returns the validation loader (None without
    --val-dataset-config or a positive --val-every)."""
    from .training.demos import create_demo_callback_from_config
    from .training.utils import create_logger

    model_config = trainer.model_config
    trainer.logger = create_logger(args.logger, args.save_dir, project=args.project,
                                   name=args.name, config=model_config)
    demo_every = args.demo_every
    if demo_every == 0:
        demo_every = model_config.get("training", {}).get("demo", {}).get("demo_every", 0)
    trainer.demo_every = demo_every
    trainer.demo_callback = None
    if demo_every:
        # the autoencoder, diffusion autoencoder and inpainting demos read
        # their reals from a loader of their own, in this process and in
        # order, so the training loader never moves
        demo_dl = (make_loader(args, model_config, dataset_config, shuffle=False, num_workers=0)
                   if model_config["model_type"] in ("autoencoder", "diffusion_autoencoder",
                                                     "diffusion_cond_inpaint")
                   else None)
        trainer.demo_callback = create_demo_callback_from_config(
            model_config, demo_dir=os.path.join(args.save_dir, "demos"), demo_dl=demo_dl,
            logger=trainer.logger)
    trainer.checkpoint_every = args.checkpoint_every
    trainer.save_top_k = args.save_top_k
    trainer.profile_dir = args.profile_dir or None
    trainer.val_every = max(args.val_every, 0)
    if not (args.val_dataset_config and args.val_every > 0):
        return None
    return make_loader(args, model_config, _read_json(args.val_dataset_config), shuffle=False)


# the JAX entry cannot run ARC either: train.py:233 calls
# wrapper.init_state(variables) and training/trainer.py:228 calls
# wrapper.train_step(state, audio, rng, step), neither of which matches
# ARCTrainer's signatures (training/arc.py :201, :440)
ARC_REFUSAL = ("a training config with `arc`: ARC post-training does not run through the "
               "training entry, in the JAX package or here (its ARCTrainer's init_state and "
               "train_step do not take what the entry passes); build it with "
               "training/factory.py create_training_wrapper_from_config and call "
               "ARCTrainer.train_step(latents, cond_tensors, ...)")


def build(args: argparse.Namespace, device: tp.Optional[torch.device] = None):
    """(Trainer, dataloader, validation loader or None) for the parsed
    arguments; the model lives on `device` (default: --device, else the
    current CUDA card)."""
    from .models.factory import resolve_device
    from .training.factory import create_training_wrapper_from_config
    from .training.trainer import Trainer

    device = resolve_device(device if device is not None else args.device)
    model_config = _read_json(args.model_config)
    if "arc" in model_config.get("training", {}):
        raise NotImplementedError(ARC_REFUSAL)
    dataset_config = _read_json(args.dataset_config)
    model, _ = build_model(args, model_config, device)
    wrapper = create_training_wrapper_from_config(
        model_config, model, gradient_clip_val=args.gradient_clip_val, seed=args.seed)
    dataloader = make_loader(args, model_config, dataset_config)
    trainer = Trainer(wrapper, model_config, save_dir=args.save_dir,
                      max_steps=args.max_steps, accum_batches=args.accum_batches)
    val_dataloader = configure(trainer, args, dataset_config)
    return trainer, dataloader, val_dataloader


def main(argv: tp.Optional[tp.Sequence[str]] = None):
    args = parse_args(argv)
    ckpt_path = recover_path(args)
    trainer, dataloader, val_dataloader = build(args)
    trainer.fit(dataloader, ckpt_path=ckpt_path or None, val_dataloader=val_dataloader)
    return trainer


if __name__ == "__main__":
    main()
