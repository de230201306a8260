"""LM training; counterpart of stable_audio_tools_tpu/training/lm.py
(`AudioLanguageModelTrainer` :20).

One train step: the frozen codec tokenizes the audio (no gradient; or the
batch holds codes already, `pre_tokenized`), the conditioner runs (the T5
tower under no_grad), the LM computes the pattern-shifted logits reverted to
[B, K, T, card] (`compute_logits`), and the loss is the JAX package's
per-codebook masked cross-entropy of the logits at frame t against the codes
at frame t + 1, averaged over the unmasked positions; `perplexity` = exp of
it, `ce_q{i}` per codebook. Then the backward (through the causal flash
attention's banded backward kernels on the card), AdamW (the JAX default:
betas (0.9, 0.95), weight decay 0.1 at the config's learning rate, constant)
and the EMA when `use_ema`.

Trainable: the LM (`requires_grad`: embeddings, backbone, heads). The JAX
step hands all of `params` to AdamW, whose decoupled weight decay then also
shrinks the frozen codec's weights every step although their gradient is
zero (tests/test_torch_lm.py pins it); the port steps only the LM, as its
diffusion trainer does. The JAX step ignores `accum_steps`; the port
refuses anything but 1.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from .ema import ema_init, ema_update
from .utils import build_optimizer

Tensor = torch.Tensor


def lm_loss(logits: Tensor, mask: Tensor, codes: Tensor) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
    """logits [B, K, T, card], mask [B, K, T], codes [B, K, T] -> (loss,
    {loss, perplexity, ce_q{i}}): the cross-entropy of the logits at t
    against the codes at t + 1 (JAX :81-99), in f32."""
    targets = codes[:, :, 1:]
    m = mask[:, :, 1:].float()
    ce = -torch.gather(F.log_softmax(logits[:, :, :-1].float(), dim=-1), -1,
                       targets[..., None])[..., 0]
    loss = (ce * m).sum() / m.sum().clamp_min(1)
    per_cb = (ce * m).sum(dim=(0, 2)) / m.sum(dim=(0, 2)).clamp_min(1)
    aux = {"loss": loss.detach(), "perplexity": torch.exp(loss.detach())}
    aux.update({f"ce_q{i}": c.detach() for i, c in enumerate(per_cb)})
    return loss, aux


class AudioLanguageModelTrainer:
    """Trains an AudioLanguageModelWrapper (models/lm.py) in place."""

    def __init__(self, model, lr: tp.Optional[float] = None, use_ema: bool = False,
                 optimizer_configs: tp.Optional[dict] = None, pre_tokenized: bool = False):
        if lr is None and optimizer_configs is None:
            raise ValueError("Must specify either lr or optimizer_configs in training config")
        self.model = model
        self.pre_tokenized = pre_tokenized
        if optimizer_configs is None:
            optimizer_configs = {"lm": {"optimizer": {"type": "AdamW", "config": {
                "lr": lr, "betas": (0.9, 0.95), "weight_decay": 0.1}}}}
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["lm"],
                                                         list(self.params.values()))
        self.ema = ema_init(self.params) if use_ema else None
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def learning_rates(self) -> tp.Dict[str, float]:
        return {"lr": self.optimizer.param_groups[0]["lr"]}

    def tokenize(self, batch: Tensor) -> Tensor:
        """Audio [B, C, T] -> codes [B, K, T / ratio] (long); with
        `pre_tokenized` the batch holds the codes."""
        if self.pre_tokenized:
            return batch.long()
        return self.model.pretransform_tokenize(batch).long()

    def condition(self, metadata: tp.Sequence[dict]):
        if self.model.conditioner is None:
            return None
        return self.model.conditioner(metadata, self.device)

    def loss(self, codes: Tensor, cond_tensors) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
        logits, mask = self.model.compute_logits(codes, cond_tensors=cond_tensors)
        return lm_loss(logits, mask, codes)

    def optimizer_step(self) -> None:
        self.optimizer.step()
        self.scheduler.step()

    def ema_step(self) -> None:
        if self.ema is not None:
            ema_update(self.ema, self.params, self.step)

    def train_step(self, batch: Tensor, metadata: tp.Sequence[dict],
                   accum_steps: int = 1) -> tp.Dict[str, Tensor]:
        """One optimizer step on a batch of audio [B, C, T] (codes [B, K, T]
        when `pre_tokenized`); returns the step's losses (device scalars)."""
        if accum_steps != 1:
            raise NotImplementedError("the LM trainer takes no gradient accumulation "
                                      "(the JAX step ignores accum_steps)")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        codes = self.tokenize(batch)
        loss, aux = self.loss(codes, self.condition(metadata))
        loss.backward()
        self.optimizer_step()
        self.ema_step()
        self.step += 1
        return aux
