"""The EnCodec multi-scale STFT discriminator; counterpart of
stable_audio_tools_tpu/models/discriminators.py (`get_hinge_losses` :28,
`DiscriminatorSTFT` :57, `MultiScaleSTFTDiscriminator` :174,
`EncodecDiscriminator` :201 with `loss` :227).

Layout: audio [B, C, T]; each scale's spectrogram is [B, 2C, frames, bins]
(channels [re_c0..re_cC-1, im_c0..im_cC-1], the reference order) and its
conv stack runs in [B, C, H, W] in `compute_dtype`, with leaky ReLU 0.2; the
STFT (centre-less, normalised by sqrt(sum window^2)) stays f32 and the logits
come back in f32. The TPU's W-pair lane packing is not ported: its numbers
are exact, so nothing changes without it. The Oobleck, DAC, BigVGAN and CQT
discriminators are later slices.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import WNConv2d
from ..ops.stft import stft_reim


def get_hinge_losses(score_real: torch.Tensor, score_fake: torch.Tensor):
    """(discriminator loss, generator loss) of the hinge GAN."""
    gen_loss = -score_fake.mean()
    dis_loss = F.relu(1 - score_real).mean() + F.relu(1 + score_fake).mean()
    return dis_loss, gen_loss


def get_relativistic_losses(score_real: torch.Tensor, score_fake: torch.Tensor):
    """(discriminator loss, generator loss) of the relativistic pairing GAN."""
    diff = score_real - score_fake
    return F.softplus(-diff).mean(), F.softplus(diff).mean()


def _pad2d(ks, dil=(1, 1)):
    return ((ks[0] - 1) * dil[0]) // 2, ((ks[1] - 1) * dil[1]) // 2


class DiscriminatorSTFT(nn.Module):
    """One scale: STFT, then conv_in, one conv per dilation (along frames),
    conv_pre_post and conv_post (`convs` holds all but conv_post)."""

    def __init__(self, filters: int, in_channels: int = 1, out_channels: int = 1,
                 n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                 max_filters: int = 1024, filters_scale: int = 1,
                 kernel_size: tp.Tuple[int, int] = (3, 9),
                 dilations: tp.Sequence[int] = (1, 2, 4), stride: tp.Tuple[int, int] = (1, 1),
                 normalized: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.normalized = normalized
        self.compute_dtype = compute_dtype
        convs = [WNConv2d(2 * in_channels, filters, kernel_size, padding=_pad2d(kernel_size))]
        in_chs = min(filters_scale * filters, max_filters)
        for i, dilation in enumerate(dilations):
            out_chs = min(filters_scale ** (i + 1) * filters, max_filters)
            convs.append(WNConv2d(in_chs, out_chs, kernel_size, stride=stride,
                                  dilation=(dilation, 1),
                                  padding=_pad2d(kernel_size, (dilation, 1))))
            in_chs = out_chs
        out_chs = min(filters_scale ** (len(dilations) + 1) * filters, max_filters)
        ks2 = (kernel_size[0], kernel_size[0])
        convs.append(WNConv2d(in_chs, out_chs, ks2, padding=_pad2d(ks2)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv2d(out_chs, out_channels, ks2, padding=_pad2d(ks2))

    def forward(self, x: torch.Tensor):
        """x [B, C, T] -> (logits f32 [B, out, frames, bins'], feature maps)."""
        B, C, T = x.shape
        z = stft_reim(x.reshape(B * C, T), self.n_fft, self.hop_length, self.win_length,
                      center=False, normalized=self.normalized)
        bins = self.n_fft // 2 + 1
        z = z.view(B, C, z.shape[-2], 2, bins).permute(0, 3, 1, 2, 4)
        z = z.reshape(B, 2 * C, z.shape[-2], bins).to(self.compute_dtype)
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z), 0.2)
            fmap.append(z)
        return self.conv_post(z).float(), fmap


class MultiScaleSTFTDiscriminator(nn.Module):
    def __init__(self, filters: int, in_channels: int = 1, out_channels: int = 1,
                 n_ffts: tp.Sequence[int] = (1024, 2048, 512),
                 hop_lengths: tp.Sequence[int] = (256, 512, 128),
                 win_lengths: tp.Sequence[int] = (1024, 2048, 512),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not len(n_ffts) == len(hop_lengths) == len(win_lengths):
            raise ValueError("n_ffts, hop_lengths and win_lengths differ in length")
        self.discriminators = nn.ModuleList([
            DiscriminatorSTFT(filters, in_channels=in_channels, out_channels=out_channels,
                              n_fft=n, hop_length=h, win_length=w,
                              compute_dtype=compute_dtype)
            for n, h, w in zip(n_ffts, hop_lengths, win_lengths)])

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for disc in self.discriminators:
            logit, fmap = disc(x)
            logits.append(logit)
            fmaps.append(fmap)
        return logits, fmaps


class EncodecDiscriminator(nn.Module):
    """The MS-STFT discriminator with hinge (or relativistic) losses and
    feature matching."""

    def __init__(self, filters: int = 32, in_channels: int = 1, out_channels: int = 1,
                 n_ffts: tp.Sequence[int] = (2048, 1024, 512, 256, 128),
                 hop_lengths: tp.Sequence[int] = (512, 256, 128, 64, 32),
                 win_lengths: tp.Sequence[int] = (2048, 1024, 512, 256, 128),
                 normalize_losses: bool = False, loss_type: str = "hinge",
                 compute_dtype: tp.Union[str, torch.dtype] = torch.float32):
        super().__init__()
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.normalize_losses = normalize_losses
        self.loss_type = loss_type
        self.discriminators = MultiScaleSTFTDiscriminator(
            filters, in_channels=in_channels, out_channels=out_channels, n_ffts=n_ffts,
            hop_lengths=hop_lengths, win_lengths=win_lengths, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor):
        return self.discriminators(x)

    def loss(self, reals: torch.Tensor, fakes: torch.Tensor):
        """(discriminator loss, adversarial loss, feature-matching distance),
        each the mean over scales, from one forward over [reals; fakes]
        stacked on the batch (every op is per sample: exact)."""
        B = reals.shape[0]
        logits, fmaps = self.discriminators(torch.cat([reals, fakes], dim=0))

        def fm(a, b):
            # |a - b| in the maps' dtype, reduced in f32 (as the JAX package)
            d = (a - b).abs().float().mean()
            if self.normalize_losses:
                d = d / (a.abs().float().mean() + 1e-3)
            return d

        losses = get_hinge_losses if self.loss_type == "hinge" else get_relativistic_losses
        dis_loss = adv_loss = feature_matching = 0.0
        for logit, fmap in zip(logits, fmaps):
            feature_matching = feature_matching + sum(fm(f[:B], f[B:]) for f in fmap) / len(fmap)
            d, a = losses(logit[:B], logit[B:])
            dis_loss, adv_loss = dis_loss + d, adv_loss + a
        n = len(logits)
        return dis_loss / n, adv_loss / n, feature_matching / n
