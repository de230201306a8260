"""Loss modules; counterpart of stable_audio_tools_tpu/training/losses/losses.py
(LossModule :21, ValueLoss :40, _masked_mean :49, L1Loss :59, MSELoss :71,
LossWithTarget :83, AuralossLoss :97, MultiLoss :164).

A loss is a callable `loss(info, step) -> scalar tensor` over a dict of
named tensors; `MultiLoss` sums them and returns `(total, {name: value})`.
The stereo-image and MMD losses are later slices.
"""

from __future__ import annotations

import typing as tp

import torch


class LossModule:
    def __init__(self, name: str, weight: float = 1.0, decay: float = 1.0,
                 decay_logic: str = "exponential"):
        self.name = name
        self.weight = float(weight)
        self.decay = float(decay)
        self.decay_logic = decay_logic

    def effective_weight(self, step: int) -> float:
        if self.decay == 1.0 or self.decay_logic != "exponential":
            return self.weight
        return self.weight * self.decay ** step

    def __call__(self, info: tp.Dict[str, tp.Any], step: int = 0) -> torch.Tensor:
        raise NotImplementedError


class ValueLoss(LossModule):
    """weight * info[key] (a scalar the model computed, e.g. the VAE's KL)."""

    def __init__(self, key: str, name: str, weight: float = 1.0, **kwargs):
        super().__init__(name=name, weight=weight, **kwargs)
        self.key = key

    def __call__(self, info, step: int = 0) -> torch.Tensor:
        return self.effective_weight(step) * info[self.key]


def _masked_mean(err: torch.Tensor, mask: tp.Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of err over the positions where mask is nonzero; mask [B, ...]
    broadcasts from the left (a [B, T] mask over [B, C, T] errors)."""
    if mask is None:
        return err.mean()
    mask = mask.to(err.dtype)
    while mask.dim() < err.dim():
        mask = mask[:, None]
    mask = mask.expand_as(err)
    return (err * mask).sum() / mask.sum().clamp(min=1e-8)


class L1Loss(LossModule):
    def __init__(self, key_a: str, key_b: str, name: str, weight: float = 1.0,
                 mask_key: tp.Optional[str] = None, **kwargs):
        super().__init__(name=name, weight=weight, **kwargs)
        self.key_a, self.key_b, self.mask_key = key_a, key_b, mask_key

    def __call__(self, info, step: int = 0) -> torch.Tensor:
        err = torch.abs(info[self.key_a] - info[self.key_b])
        mask = info.get(self.mask_key) if self.mask_key else None
        return self.effective_weight(step) * _masked_mean(err, mask)


class MSELoss(LossModule):
    def __init__(self, key_a: str, key_b: str, name: str, weight: float = 1.0,
                 mask_key: tp.Optional[str] = None, **kwargs):
        super().__init__(name=name, weight=weight, **kwargs)
        self.key_a, self.key_b, self.mask_key = key_a, key_b, mask_key

    def __call__(self, info, step: int = 0) -> torch.Tensor:
        err = (info[self.key_a] - info[self.key_b]) ** 2
        mask = info.get(self.mask_key) if self.mask_key else None
        return self.effective_weight(step) * _masked_mean(err, mask)


class LossWithTarget(LossModule):
    """weight * loss_fn(info[input_key], info[target_key])."""

    def __init__(self, loss_fn, input_key: str, target_key: str, name: str,
                 weight: float = 1.0, **kwargs):
        super().__init__(name=name, weight=weight, **kwargs)
        self.loss_fn, self.input_key, self.target_key = loss_fn, input_key, target_key

    def __call__(self, info, step: int = 0) -> torch.Tensor:
        return self.effective_weight(step) * self.loss_fn(info[self.input_key],
                                                           info[self.target_key])


class AuralossLoss(LossWithTarget):
    """An STFT-family loss over (target, input): the reference swaps the
    arguments (its losses.py:111), and the JAX package keeps the swap."""

    def __call__(self, info, step: int = 0) -> torch.Tensor:
        return self.effective_weight(step) * self.loss_fn(info[self.target_key],
                                                           info[self.input_key])


class MultiLoss:
    def __init__(self, losses: tp.Sequence[LossModule]):
        self.losses = list(losses)

    def __call__(self, info, step: int = 0):
        total = 0.0
        values = {}
        for loss in self.losses:
            values[loss.name] = loss(info, step)
            total = total + values[loss.name]
        return total, values
