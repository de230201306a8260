"""The training loop; counterpart of stable_audio_tools_tpu/training/trainer.py.

One card, no data parallelism (multi-GPU is a later slice). The loop: fetch a
batch, move it to the card (`prepare_batch`, JAX `_prepare_batch` :77; the
conditioners run inside the step, the T5 tower under no_grad), run the
wrapper's `train_step` (a diffusion or an autoencoder GAN step), log every
step to `train_log.jsonl` (the losses read back from the card, which
synchronises it, and the learning rate of each optimizer),
checkpoint every `checkpoint_every` steps and at the end (with the model
config embedded, JAX :149), stop at `max_steps`, resume from a checkpoint.
Demo callbacks are a later slice.
"""

from __future__ import annotations

import json
import os
import time
import typing as tp

import torch

from ..io.checkpoints import load_training_state, save_training_state
from .utils import JSONLLogger, get_rank


class Trainer:
    def __init__(self, wrapper, model_config: dict, save_dir: str = "checkpoints",
                 checkpoint_every: int = 10000, max_steps: tp.Optional[int] = None,
                 accum_batches: int = 1):
        self.wrapper = wrapper
        self.model_config = model_config
        self.save_dir = save_dir
        self.checkpoint_every = checkpoint_every
        self.max_steps = max_steps
        self.accum_batches = accum_batches
        self.rank = get_rank()
        os.makedirs(save_dir, exist_ok=True)
        self.logger = JSONLLogger(os.path.join(save_dir, "train_log.jsonl"))
        self.history: tp.List[dict] = []  # every logged record, in order

    def prepare_batch(self, audio) -> torch.Tensor:
        """Audio [B, C, T] -> on the trainer's device."""
        return torch.as_tensor(audio).to(self.wrapper.device, non_blocking=True)

    def save(self, step: int) -> tp.Optional[str]:
        if self.rank != 0:
            return None
        path = os.path.join(self.save_dir, f"step={step}.ckpt")
        save_training_state(path, self.wrapper, self.model_config)
        with open(os.path.join(self.save_dir, "model_config.json"), "w") as f:
            json.dump(self.model_config, f)
        return path

    def restore(self, ckpt_path: str) -> None:
        load_training_state(ckpt_path, self.wrapper)

    def fit(self, dataloader, ckpt_path: tp.Optional[str] = None,
            max_steps: tp.Optional[int] = None, save_at_end: bool = True):
        """Train until `max_steps` (default: the trainer's; None trains
        until interrupted), cycling the dataloader; returns the wrapper."""
        wrapper = self.wrapper
        max_steps = self.max_steps if max_steps is None else max_steps
        if ckpt_path:
            self.restore(ckpt_path)
        t_last = time.perf_counter()
        saved_at = None
        done = max_steps is not None and wrapper.step >= max_steps
        while not done:
            n_batches = 0
            for audio, metadata in dataloader:
                n_batches += 1
                if max_steps is not None and wrapper.step >= max_steps:
                    done = True
                    break
                aux = wrapper.train_step(self.prepare_batch(audio), metadata,
                                         accum_steps=self.accum_batches)
                step = wrapper.step
                if self.rank == 0:
                    metrics = {f"train/{k}": float(v) for k, v in aux.items()}
                    metrics.update({f"train/{k}": v for k, v in wrapper.learning_rates().items()})
                    now = time.perf_counter()
                    metrics["train/steps_per_sec"] = 1.0 / max(now - t_last, 1e-9)
                    t_last = now
                    self.logger.log_metrics(metrics, step=step)
                    self.history.append({"step": step, **metrics})
                if self.checkpoint_every and step % self.checkpoint_every == 0:
                    self.save(step)
                    saved_at = step
            if n_batches == 0:
                raise ValueError("the dataloader yielded no batch")
        if save_at_end and saved_at != wrapper.step:
            self.save(wrapper.step)
        return wrapper
