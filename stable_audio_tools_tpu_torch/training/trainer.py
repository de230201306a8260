"""The training loop; counterpart of stable_audio_tools_tpu/training/trainer.py
(`Trainer.fit` :180-279).

One card, no data parallelism (multi-GPU is a later slice). The loop: fetch a
batch, move it to the card (`prepare_batch`, JAX `_prepare_batch` :77; the
conditioners run inside the step, the T5 tower under no_grad), run the
wrapper's `train_step` (a diffusion, an autoencoder GAN or an LM step), log
every step to the logger (`train_log.jsonl`; the losses read back from the
card, which synchronises it, the learning rate of each optimizer, and
`steps_per_sec` over the time from the last log write, as JAX :241: the step,
the wait for its batch, and the log write, checkpoint, demo and validation
that came after the step before), then:
- every `checkpoint_every` steps and at the end, a checkpoint with the model
  config embedded (JAX :149); with `save_top_k` > 0 only the newest K
  `step=*.ckpt` files are kept (:160-173; -1 keeps all);
- every `demo_every` steps, on rank 0, the demo callback (training/demos.py).
  A demo that raises is printed, logged as `demo/error`, and the run goes on
  (JAX :249-255);
- every `val_every` steps, when a validation loader is given, the wrapper's
  `val_step` over the whole loader, the means of its `val/` metrics logged.
Demos and validation leave the training as they found it: its weights, its
optimizer and EMA, its loader and every random stream the host and the card
keep (saved and restored around them), so a run with them trains the same
bits as one without.
With `profile_dir`, torch.profiler traces steps 10-12 (the steps that start
at counts 10, 11 and 12, as JAX :226-235) into a Chrome trace there.
`max_steps` stops the run; a checkpoint resumes it.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import random
import re
import time
import traceback
import typing as tp

import numpy as np
import torch

from ..io.checkpoints import load_training_state, save_training_state
from .utils import JSONLLogger, get_rank

PROFILE_STEPS = (10, 12)  # the first and the last traced step's starting count


def step_checkpoints(save_dir: str) -> tp.List[tp.Tuple[int, str]]:
    """(step, path) of the `step=N.ckpt` files under `save_dir`, by step."""
    out = []
    for path in glob.glob(os.path.join(save_dir, "step=*.ckpt")):
        m = re.search(r"step=(\d+)\.ckpt$", path)
        if m:
            out.append((int(m.group(1)), path))
    return sorted(out)


@contextlib.contextmanager
def random_streams_kept(device: torch.device):
    """The host's (Python, numpy, torch) and the card's random states put back
    after the block."""
    py, npy = random.getstate(), np.random.get_state()
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        try:
            yield
        finally:
            random.setstate(py)
            np.random.set_state(npy)


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
        # set from the flags by train.configure
        self.demo_every = 0
        self.demo_callback: tp.Optional[tp.Callable] = None
        self.val_every = 0
        self.save_top_k = -1
        self.profile_dir: tp.Optional[str] = None
        self.rank = get_rank()
        os.makedirs(save_dir, exist_ok=True)
        self.logger = JSONLLogger(os.path.join(save_dir, "train_log.jsonl"))
        self.history: tp.List[dict] = []  # every logged training record, in order
        self.val_history: tp.List[dict] = []  # every validation pass's means
        self._profiler = None

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
        if self.save_top_k > 0:
            for _, old in step_checkpoints(self.save_dir)[:-self.save_top_k]:
                os.remove(old)
        return path

    def restore(self, ckpt_path: str) -> None:
        load_training_state(ckpt_path, self.wrapper)

    def demo(self, step: int) -> None:
        """The demo callback at `step`; a failure is printed and logged as
        `demo/error`, and training goes on."""
        try:
            with random_streams_kept(self.wrapper.device):
                self.demo_callback(self.wrapper, step)
        except Exception as e:  # noqa: BLE001 - a demo never stops the run (JAX :249-255)
            traceback.print_exc()
            print(f"Demo callback failed at step {step}: {e!r}")
            self.logger.log_metrics({"demo/error": repr(e)}, step=step)

    def validate(self, val_dataloader, step: int) -> tp.Dict[str, float]:
        """The means of the wrapper's `val_step` metrics over `val_dataloader`,
        logged at `step` (rank 0)."""
        sums: tp.Dict[str, float] = {}
        n = 0
        with random_streams_kept(self.wrapper.device):
            for audio, metadata in val_dataloader:
                out = self.wrapper.val_step(self.prepare_batch(audio), metadata)
                for k, v in out.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
        means = {k: v / n for k, v in sums.items()}
        if means and self.rank == 0:
            self.logger.log_metrics(means, step=step)
            self.val_history.append({"step": step, **means})
        return means

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.wrapper.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()

    def _end_profile(self) -> None:
        if self._profiler is None:
            return
        if self.wrapper.device.type == "cuda":
            torch.cuda.synchronize(self.wrapper.device)
        self._profiler.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(
            self.profile_dir, f"trace_steps_{PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}.json"))
        self._profiler = None

    def fit(self, dataloader, ckpt_path: tp.Optional[str] = None,
            max_steps: tp.Optional[int] = None, save_at_end: bool = True, val_dataloader=None):
        """Train until `max_steps` (default: the trainer's; None trains
        until interrupted), cycling the dataloader; returns the wrapper."""
        wrapper = self.wrapper
        max_steps = self.max_steps if max_steps is None else max_steps
        if val_dataloader is not None and not hasattr(wrapper, "val_step"):
            raise NotImplementedError(f"{type(wrapper).__name__} has no validation step")
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
                if self.profile_dir and wrapper.step == PROFILE_STEPS[0]:
                    self._start_profile()
                aux = wrapper.train_step(self.prepare_batch(audio), metadata,
                                         accum_steps=self.accum_batches)
                step = wrapper.step
                if self._profiler is not None and step == PROFILE_STEPS[1] + 1:
                    self._end_profile()
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
                if (self.demo_every and step % self.demo_every == 0
                        and self.demo_callback is not None and self.rank == 0):
                    self.demo(step)
                if val_dataloader is not None and self.val_every and step % self.val_every == 0:
                    self.validate(val_dataloader, step)
            if n_batches == 0:
                raise ValueError("the dataloader yielded no batch")
        self._end_profile()
        if save_at_end and saved_at != wrapper.step:
            self.save(wrapper.step)
        return wrapper
