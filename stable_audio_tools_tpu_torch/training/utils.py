"""Training utilities: LR schedules, the optimizer factory, logging;
counterpart of stable_audio_tools_tpu/training/utils.py (get_rank :20,
inverse_lr_schedule :30, create_optimizer_from_config :56,
create_schedule_from_config :81, build_optimizer :95, JSONLLogger :112).

The JAX package builds optax transformations; here the optimizer is a
`torch.optim` optimizer over the trainable parameters and the schedule a
`LambdaLR` evaluated at the number of updates so far, as optax evaluates it.
"""

from __future__ import annotations

import json
import math
import os
import typing as tp

import torch

Schedule = tp.Callable[[int], float]


def get_rank() -> int:
    """Process rank: SLURM's, else torch.distributed's launcher's, else 0."""
    for var in ("SLURM_PROCID", "RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def inverse_lr_schedule(base_lr: float, inv_gamma: float = 1.0e6, power: float = 1.0,
                        warmup: float = 0.0, final_lr: float = 0.0) -> Schedule:
    """k-diffusion InverseLR: lr * (1 + step / inv_gamma)^-power, floored at
    final_lr, times the warmup factor 1 - warmup^(step + 1)."""

    def schedule(step: int) -> float:
        lr = base_lr * max((1 + step / inv_gamma) ** -power, final_lr / base_lr)
        if warmup > 0:
            lr *= 1 - warmup ** (step + 1.0)
        return lr

    return schedule


def exponential_lr_schedule(base_lr: float, gamma: float) -> Schedule:
    return lambda step: base_lr * gamma ** step


def cosine_lr_schedule(base_lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule(base_lr, t_max, alpha=eta_min / base_lr)."""
    alpha = eta_min / base_lr

    def schedule(step: int) -> float:
        cos = 0.5 * (1 + math.cos(math.pi * min(step, t_max) / t_max))
        return base_lr * ((1 - alpha) * cos + alpha)

    return schedule


def create_schedule_from_config(scheduler_config: tp.Dict[str, tp.Any],
                                base_lr: float) -> Schedule:
    s_type = scheduler_config["type"]
    cfg = scheduler_config.get("config", {})
    if s_type == "InverseLR":
        return inverse_lr_schedule(base_lr, **cfg)
    if s_type == "ExponentialLR":
        return exponential_lr_schedule(base_lr, cfg.get("gamma", 1.0))
    if s_type == "CosineAnnealingLR":
        return cosine_lr_schedule(base_lr, cfg.get("T_max", 1000000), cfg.get("eta_min", 0.0))
    raise ValueError(f"Unknown scheduler type {s_type}")


def create_optimizer_from_config(optimizer_config: tp.Dict[str, tp.Any],
                                 params: tp.Iterable[torch.nn.Parameter]
                                 ) -> torch.optim.Optimizer:
    """Reference optimizer names -> torch.optim (FusedAdam is AdamW)."""
    opt_type = optimizer_config["type"]
    cfg = dict(optimizer_config.get("config", {}))
    lr = cfg.pop("lr", 1e-4)
    betas = tuple(cfg.pop("betas", (0.9, 0.999)))
    weight_decay = cfg.pop("weight_decay", 0.0)
    eps = cfg.pop("eps", 1e-8)
    name = opt_type.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if name in ("adamw", "fusedadam"):
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.pop("momentum", 0.0))
    raise ValueError(f"Unknown or unported optimizer type {opt_type}")


def build_optimizer(entry: tp.Dict[str, tp.Any], params: tp.Iterable[torch.nn.Parameter]
                    ) -> tp.Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """'{optimizer: {...}, scheduler: {...}}' -> (optimizer, scheduler); with
    no scheduler the learning rate stays constant."""
    opt_cfg = entry["optimizer"]
    base_lr = opt_cfg.get("config", {}).get("lr", 1e-4)
    optimizer = create_optimizer_from_config(opt_cfg, params)
    schedule = (create_schedule_from_config(entry["scheduler"], base_lr)
                if "scheduler" in entry else (lambda step: base_lr))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / base_lr)
    return optimizer, scheduler


class JSONLLogger:
    """One JSON object per `log_metrics` call, appended to `path`."""

    def __init__(self, path: str = "train_log.jsonl"):
        self.path = path

    def log_metrics(self, metrics: tp.Dict[str, tp.Any], step: tp.Optional[int] = None) -> None:
        rec = {k: float(v) if isinstance(v, (int, float, torch.Tensor)) else v
               for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
