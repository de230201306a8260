"""Exponential moving average of the trainable parameters; counterpart of
stable_audio_tools_tpu/training/ema.py.

decay(step) = min(beta, 1 - (1 + epoch / inv_gamma)^-power) with
epoch = max(step - update_after_step - 1, 0) and decay 0 while epoch is 0
(the ema-pytorch defaults of the reference: beta 0.9999, power 3/4). The EMA
is a dict of f32 copies, updated in place (`torch._foreach_lerp_`) where the
JAX package builds a new pytree.
"""

from __future__ import annotations

import typing as tp

import torch


def ema_decay(step: int, beta: float = 0.9999, inv_gamma: float = 1.0, power: float = 0.75,
              update_after_step: int = 1) -> float:
    epoch = max(step - update_after_step - 1, 0)
    if epoch <= 0:
        return 0.0
    return min(max(1.0 - (1.0 + epoch / inv_gamma) ** -power, 0.0), beta)


def ema_init(params: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
    """f32 copies of `params` ({name: tensor})."""
    return {name: p.detach().float().clone() for name, p in params.items()}


@torch.no_grad()
def ema_update(ema: tp.Dict[str, torch.Tensor], params: tp.Mapping[str, torch.Tensor],
               step: int, beta: float = 0.9999, power: float = 0.75, inv_gamma: float = 1.0,
               update_after_step: int = 1) -> None:
    """One EMA step in place: ema = d * ema + (1 - d) * params."""
    d = ema_decay(step, beta=beta, inv_gamma=inv_gamma, power=power,
                  update_after_step=update_after_step)
    names = list(ema)
    torch._foreach_lerp_([ema[n] for n in names],
                         [params[n].detach().to(ema[n].dtype) for n in names], 1.0 - d)
