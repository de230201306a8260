"""Export the bare model of a training checkpoint; the port's counterpart of
the repository's root `unwrap_model.py`.

    python -m stable_audio_tools_tpu_torch.unwrap_model --ckpt-path RUN/step=N.ckpt \\
        [--name exported_model] [--use-safetensors] [--model-config MODEL.json]

Reads a checkpoint that the port's trainer wrote, puts the EMA weights in
place of the trained parameters they track (where the run kept an EMA), and
writes the model's state dict alone, under the reference torch names the
port keeps: `NAME.ckpt` ({"state_dict", "model_config"}, `torch.save`) or,
with --use-safetensors, `NAME.safetensors` (the model config in its
metadata). The discriminator, optimizers and schedulers are left out. The
file is what `--pretrained-ckpt-path` (and, for an autoencoder or a model
with a pretransform, `--pretransform-ckpt-path`) of the port's `train`
reads, and what the JAX package's importers read. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import typing as tp

import torch


def unwrap_state_dict(ckpt: dict) -> tp.Dict[str, torch.Tensor]:
    """The model's state dict of a training checkpoint with its EMA swapped
    in, each EMA tensor in its parameter's dtype."""
    state = dict(ckpt["state_dict"])
    for name, value in (ckpt.get("ema") or {}).items():
        if name not in state:
            raise KeyError(f"the checkpoint's EMA names {name}, which its model lacks")
        state[name] = value.to(state[name].dtype)
    return state


def parse_args(argv: tp.Optional[tp.Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="export the bare (EMA) model of a training "
                                            "checkpoint of the PyTorch port")
    p.add_argument("--model-config", default=None,
                   help="the model config (default: the one the checkpoint embeds)")
    p.add_argument("--ckpt-path", required=True)
    p.add_argument("--name", default="exported_model")
    p.add_argument("--use-safetensors", action="store_true")
    p.add_argument("--reference-layout", action="store_true",
                   help="accepted for the JAX entry's sake; changes nothing: the port always "
                        "writes the reference torch names and layouts")
    return p.parse_args(argv)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> str:
    """Write the export; returns its path."""
    from .io.checkpoints import save_safetensors

    args = parse_args(argv)
    ckpt = torch.load(args.ckpt_path, map_location="cpu", weights_only=True, mmap=True)
    model_config = ckpt.get("model_config")
    if args.model_config is not None:
        with open(args.model_config) as f:
            model_config = json.load(f)
    if model_config is None:
        raise SystemExit("--model-config is required: the checkpoint embeds no config")
    state = unwrap_state_dict(ckpt)
    if args.use_safetensors:
        out = f"{args.name}.safetensors"
        save_safetensors(out, state, metadata={"model_config": json.dumps(model_config)})
    else:
        out = f"{args.name}.ckpt"
        tmp = f"{out}.tmp"
        torch.save({"state_dict": state, "model_config": model_config}, tmp)
        os.replace(tmp, out)
    print(f"Exported model to {out}")
    return out


if __name__ == "__main__":
    main()
