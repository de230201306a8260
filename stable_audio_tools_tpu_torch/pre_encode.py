"""Pre-encode an audio dataset to latents: the port's counterpart of the JAX
package's root `pre_encode.py`, with the same flags and the same output.

    python -m stable_audio_tools_tpu_torch.pre_encode \\
        --model-config AUTOENCODER.json --ckpt-path WEIGHTS.ckpt \\
        --dataset-config DATASET.json --output-path OUT [--batch-size 8] \\
        [--sample-size N] [--limit N]

Builds the autoencoder of the config (weights from --ckpt-path, a port
checkpoint: `io/checkpoints.py` `save_model_state` or a training
checkpoint; without one, random weights drawn from a seeded generator),
reads the dataset in order (no shuffle) at --sample-size samples (default:
the config's), encodes each batch on the current CUDA card (on the CPU only
with `--device cpu`) and writes, for item i of rank r (the process rank):
- `OUT/r/i.npy`: the latents [latent_dim, T / downsampling_ratio] f32;
- `OUT/r/i.json`: the item's metadata with JSON-scalar and list values,
  and `padding_mask` taken to the latent rate by nearest-index sampling
  (entry i of T latents reads the audio-rate mask at floor(i * len / T)).
The JAX package's `PreEncodedDataset` and the port's read these files, and
each reads the other's.

The compute dtype is --precision's (default from defaults.ini: bf16, the
type the card's snake kernels take; the latents are written in f32). The JAX
entry encodes in f32. The VAE's posterior noise is drawn from a generator
seeded with the batch's first item index.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import typing as tp

import numpy as np
import torch

from .train import PRECISION_DTYPE, _defaults

def parse_args(argv: tp.Optional[tp.Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="pre-encode a dataset with the PyTorch port")
    p.add_argument("--model-config", required=True)
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--dataset-config", required=True)
    p.add_argument("--output-path", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--sample-size", type=int, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--precision", default=_defaults().get("precision", "16-mixed"))
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the current CUDA card)")
    args = p.parse_args(argv)
    if args.precision not in PRECISION_DTYPE:
        p.error(f"--precision {args.precision!r} is not one of {sorted(PRECISION_DTYPE)}")
    return args


def latent_padding_mask(mask: np.ndarray, length: int) -> np.ndarray:
    """An audio-rate padding mask sampled at `length` latent positions (JAX
    pre_encode.py:82-85, numpy's f64 index arithmetic)."""
    mask = np.asarray(mask)
    return mask[np.floor(np.arange(length) * (len(mask) / length)).astype(int)]


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> dict:
    """Encode the dataset; returns {"out_dir", "items", "encode_ms"} (the
    synchronised encode time of each batch)."""
    from .data.dataset import create_dataloader_from_config
    from .io.checkpoints import load_model_state
    from .models.factory import create_model_from_config, init_random_, resolve_device
    from .training.utils import get_rank

    args = parse_args(argv)
    device = resolve_device(args.device)
    with open(args.model_config) as f:
        model_config = json.load(f)
    with open(args.dataset_config) as f:
        dataset_config = json.load(f)
    if model_config.get("model_type") != "autoencoder":
        raise ValueError("pre_encode expects an autoencoder model config")
    model = create_model_from_config(model_config, device)
    if args.ckpt_path:
        load_model_state(args.ckpt_path, model)
    else:
        init_random_(model, torch.Generator(device=device).manual_seed(0))
    model.eval().requires_grad_(False)
    dtype = getattr(torch, PRECISION_DTYPE[args.precision])
    loader = create_dataloader_from_config(
        dataset_config, batch_size=args.batch_size,
        sample_size=args.sample_size or model_config["sample_size"],
        sample_rate=model_config["sample_rate"],
        audio_channels=model_config.get("audio_channels", 2), num_workers=args.num_workers,
        shuffle=False)

    out_dir = os.path.join(args.output_path, str(get_rank()))
    os.makedirs(out_dir, exist_ok=True)
    idx, encode_ms = 0, []
    for audio, metadata in loader:
        t0 = time.perf_counter()
        with torch.no_grad():
            gen = torch.Generator(device=device).manual_seed(idx)
            latents = model.encode(audio.to(device, dtype), generator=gen).float()
        latents = latents.cpu().numpy()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        for b in range(latents.shape[0]):
            md = dict(metadata[b])
            pm = md.pop("padding_mask", np.ones(audio.shape[-1]))
            md["padding_mask"] = latent_padding_mask(pm, latents.shape[-1]).tolist()
            md = {k: v for k, v in md.items() if isinstance(v, (str, int, float, list, bool))}
            np.save(os.path.join(out_dir, f"{idx}.npy"), latents[b])
            with open(os.path.join(out_dir, f"{idx}.json"), "w") as f:
                json.dump(md, f)
            idx += 1
            if args.limit is not None and idx >= args.limit:
                break
        if args.limit is not None and idx >= args.limit:
            break
    print(f"Pre-encoded {idx} samples to {out_dir}")
    return {"out_dir": out_dir, "items": idx, "encode_ms": encode_ms}


if __name__ == "__main__":
    main()
