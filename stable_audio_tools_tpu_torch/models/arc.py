"""ARC's discriminator heads; counterpart of
stable_audio_tools_tpu/models/arc.py (`get_relativistic_losses` :20,
`ConvDiscriminator` :27, `ConvNeXtDiscriminator` :57).

A head scores the discriminator DiT's hidden states, x [B, N, C] (the
prepended tokens included, as `exit_layer_ix` returns them). Flax infers a
layer's input width at init; here it is the head's `in_channels`, the width
of those hidden states: the DiT's io_channels at ARC's default exit layer -1
(after `project_out`), its embed_dim at a block's index (training/arc.py
works it out). `channels` sets only the head's own conv widths.

`ConvDiscriminator`: four convs (k = 4, stride 2, padding 1), each followed
by a GroupNorm of min(32, channels) groups (flax's epsilon 1e-6, in f32 and
f32 out, as flax promotes to its f32 parameters) and SiLU, then a 1-channel
conv (k = 4) with "same" padding, one zero ahead and two behind; scores [B,
N', 1]. `ConvNeXtDiscriminator`: a ConvNeXt encoder (models/convnext.py, at
the JAX head's defaults, which ARC never changes) over [B, C, N]; scores [B,
1, N']. The JAX heads' `loss` methods, `loss_type` and `soft_clip_scale` are
read by no trainer (ARC computes its relativistic losses itself) and are not
ported.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import GroupNorm
from .convnext import ConvNeXtEncoder


def get_relativistic_losses(score_real: torch.Tensor, score_fake: torch.Tensor
                            ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(discriminator loss, generator loss) of relativistic pairs."""
    diff = score_real - score_fake
    return F.softplus(-diff).mean(), F.softplus(diff).mean()


class ConvDiscriminator(nn.Module):
    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        widths = [in_channels] + [channels] * 4
        self.convs = nn.ModuleList([nn.Conv1d(widths[i], channels, 4, stride=2, padding=1)
                                    for i in range(4)])
        self.norms = nn.ModuleList([GroupNorm(min(32, channels), channels) for _ in range(4)])
        self.conv_out = nn.Conv1d(channels, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, C] -> scores [B, N', 1]."""
        x = x.transpose(1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = conv._conv_forward(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
            x = F.silu(norm(x.to(torch.promote_types(x.dtype, norm.weight.dtype))))
        x = F.conv1d(F.pad(x, (1, 2)), self.conv_out.weight, self.conv_out.bias)
        return x.transpose(1, 2)


class ConvNeXtDiscriminator(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.encoder = ConvNeXtEncoder(in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, C] -> scores [B, 1, N']."""
        return self.encoder(x.transpose(1, 2))
