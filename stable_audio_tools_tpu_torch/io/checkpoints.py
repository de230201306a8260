"""Training-state checkpoints of the port (`torch.save` files).

A checkpoint holds the model's `state_dict` under the reference torch names
(the names the JAX package's importers read: io/torch_mapping.py
`import_diffusion_cond_state_dict`, io/checkpoints.py), the optimizer's and
the LR scheduler's state, the EMA of the trainable parameters, the step, and
the model config embedded, as the JAX trainer's checkpoint does
(training/trainer.py:149). An autoencoder GAN wrapper adds its
discriminator's state_dict, optimizer and scheduler (`discriminator`,
`disc_optimizer`, `disc_scheduler`); a diffusion checkpoint has none of them. Files are written to a temporary name and renamed,
so a cut run never leaves a truncated checkpoint under the final name.

A model checkpoint (`save_model_state`) holds a model's `state_dict` and its
config alone, the weights `pre_encode.py` reads: `load_model_state` takes it
or a training checkpoint.
"""

from __future__ import annotations

import os
import typing as tp

import torch


def save_training_state(path: str, wrapper, model_config: tp.Optional[dict] = None) -> None:
    """`wrapper`: a training wrapper (training/diffusion.py,
    training/autoencoders.py) with `model`, `optimizer`, `scheduler`, `ema`
    and `step`, and a `discriminator` for a GAN."""
    state = {
        "state_dict": wrapper.model.state_dict(),
        "optimizer": wrapper.optimizer.state_dict(),
        "scheduler": wrapper.scheduler.state_dict(),
        "ema": wrapper.ema,
        "step": wrapper.step,
        "model_config": model_config,
    }
    if getattr(wrapper, "discriminator", None) is not None:
        state.update(discriminator=wrapper.discriminator.state_dict(),
                     disc_optimizer=wrapper.disc_optimizer.state_dict(),
                     disc_scheduler=wrapper.disc_scheduler.state_dict())
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_training_state(path: str, wrapper) -> dict:
    """Restore `wrapper` in place from `path`; returns the loaded dict."""
    state = torch.load(path, map_location=wrapper.device, weights_only=True)
    wrapper.model.load_state_dict(state["state_dict"], strict=True)
    wrapper.optimizer.load_state_dict(state["optimizer"])
    wrapper.scheduler.load_state_dict(state["scheduler"])
    if getattr(wrapper, "discriminator", None) is not None:
        wrapper.discriminator.load_state_dict(state["discriminator"], strict=True)
        wrapper.disc_optimizer.load_state_dict(state["disc_optimizer"])
        wrapper.disc_scheduler.load_state_dict(state["disc_scheduler"])
    if wrapper.ema is not None:
        if state["ema"] is None:
            raise ValueError(f"{path} holds no EMA but the trainer keeps one")
        for name, value in state["ema"].items():
            wrapper.ema[name].copy_(value)
    wrapper.step = int(state["step"])
    return state


def save_model_state(path: str, model: torch.nn.Module,
                     model_config: tp.Optional[dict] = None) -> None:
    """`model`'s state_dict (and its config) alone, e.g. a diffusion model's
    pretransform for `pre_encode.py`."""
    tmp = f"{path}.tmp"
    torch.save({"state_dict": model.state_dict(), "model_config": model_config}, tmp)
    os.replace(tmp, path)


def load_model_state(path: str, model: torch.nn.Module) -> None:
    """Load the `state_dict` of a model or training checkpoint into `model`
    (strict: every name must match)."""
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["state_dict"], strict=True)
