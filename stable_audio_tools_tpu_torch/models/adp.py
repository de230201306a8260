"""The ADP 1-D UNet (audio-diffusion-pytorch) that Stable Audio 1.0 runs;
counterpart of stable_audio_tools_tpu/models/adp.py (`_pad_conv1d` :30,
`ADPConv1d` :44, `ADPConvTranspose1d` :72, `ConvBlock1d` :101,
`ResnetBlock1d` :121, `Patcher` :151, `Unpatcher` :171, `ADPAttention` :190,
`ADPTransformerBlock` :229, `Transformer1d` :252, `TimePositionalEmbedding`
:273, the down / up / bottleneck blocks :300-421, `UNet1d` :509, `UNetCFG1d`
:733, `UNet1DUncondWrapper` :1017, `UNetCFG1DWrapper` :1034, `UNet1DCondWrapper` :1065,
`create_adp_cond_wrapper` :1079).

Layout: [B, C, T] (the JAX package runs [B, T, C] inside; its public layout
is this one), the transformers [B, T, C]. Module and parameter names follow
the reference torch layout that the JAX package's importer reads
(io/torch_mapping.py `import_adp_unet_cfg`): `UNetCFG1d` is a `UNet1d` with
`fixed_embedding` beside its `to_time`, `to_mapping`, `to_in`,
`downsamples.{i}`, `bottleneck`, `upsamples.{j}` and `to_out`.

The UNet computes in its input's dtype (f32 for SA-1.0, whose config names
no compute dtype, as the JAX module). The LayerNorms of the attention blocks
run the fused LayerNorm kernel (row 2) on the card; everything else is plain
PyTorch, as the JAX module's is plain XLA: cuDNN's convs, cuBLAS's products,
the attention as two products around an f32 softmax, GroupNorm as
ops/norms.py's `var_mean` + `addcmul`. Copied from the JAX module so the two
stay comparable: flax's epsilon 1e-6 in every GroupNorm and LayerNorm, the
exact GELU, masked context rows zeroed in k and v (no -inf bias), no outer
residual around `Transformer1d`, and the wrapper's `cfg_interval` accepted
and ignored.

Refused by name, where the JAX package has them: the spectral-domain UNet
(`use_stft`, `use_stft_context`), noise channel conditioning (`use_ncca`),
the time token in the context (`use_xattn_time`), the nearest-neighbour
upsampling (`use_nearest_upsample`; SA-1.0's is transposed), causal convs and
attention (the wrappers never set them) (ROADMAP.md queue 1).

The plain `UNet1d` also runs under `UNet1DCondWrapper` (model type
`adp_1d`, JAX :1065: `input_concat_cond` as its `channels_list`) and
`UNet1DUncondWrapper` (`adp_uncond_1d`, :1017), each holding it as `model`.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.norms import BiasedLayerNorm, GroupNorm
from .conditioners import LearnedPositionalEmbedding

Mapping = tp.Optional[torch.Tensor]

_REFUSED = {
    "use_stft": "the spectral-domain UNet (use_stft)",
    "use_stft_context": "the spectral-domain context (use_stft_context)",
    "use_ncca": "noise channel conditioning augmentation (use_ncca)",
    "use_xattn_time": "the time token in the cross-attention context (use_xattn_time)",
    "use_nearest_upsample": "the nearest-neighbour upsampling (use_nearest_upsample)",
}


def _refuse(**flags) -> None:
    for name, on in flags.items():
        if on:
            raise NotImplementedError(f"{_REFUSED[name]} is not ported yet "
                                      "(ROADMAP.md queue 1)")


def _stream_pads(T: int, k_eff: int, stride: int) -> tp.Tuple[int, int]:
    """(left, right) zero padding of the reference's asymmetric 'streaming'
    conv (JAX `_pad_conv1d`, non-causal): the right side also takes what the
    last frame lacks."""
    padding_total = k_eff - stride
    n_frames = (T - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - padding_total)
    extra = max(ideal - T, 0)
    pr = padding_total // 2
    return padding_total - pr, pr + extra


class ADPConv1d(nn.Conv1d):
    """A conv with the streaming padding, in x's dtype (cuDNN on the card)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = (self.kernel_size[0] - 1) * self.dilation[0] + 1
        pl, pr = _stream_pads(x.shape[-1], k_eff, self.stride[0])
        pad = pl
        if pl != pr:
            x, pad = F.pad(x, (pl, pr)), 0
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        pad, self.dilation)


class ADPConvTranspose1d(nn.ConvTranspose1d):
    """The full transposed conv (weight [in, out, k]), cropped by the
    streaming padding k - stride (the JAX module's flipped-kernel,
    input-dilated conv and crop compute the same)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding_total = self.kernel_size[0] - self.stride[0]
        pr = padding_total // 2
        pl = padding_total - pr
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if pl == pr:
            return F.conv_transpose1d(x, w, b, self.stride, pl)
        y = F.conv_transpose1d(x, w, b, self.stride)
        return y[..., pl:y.shape[-1] - pr]


class ConvBlock1d(nn.Module):
    """GroupNorm, then the mapping's scale and shift, SiLU, the conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, num_groups: int = 8,
                 use_norm: bool = True):
        super().__init__()
        self.groupnorm = GroupNorm(num_groups, in_channels) if use_norm else None
        self.project = ADPConv1d(in_channels, out_channels, kernel_size, stride, dilation)

    def forward(self, x: torch.Tensor,
                scale_shift: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        if self.groupnorm is not None:
            x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = torch.addcmul(shift, x, scale + 1)
        return self.project(F.silu(x))


class MappingToScaleShift(nn.Module):
    def __init__(self, features: int, channels: int):
        super().__init__()
        self.to_scale_shift = nn.Sequential(nn.SiLU(), nn.Linear(features, channels * 2))

    def forward(self, mapping: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        scale, shift = self.to_scale_shift(mapping)[:, :, None].chunk(2, dim=1)
        return scale, shift


class ResnetBlock1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, use_norm: bool = True,
                 num_groups: int = 8, context_mapping_features: tp.Optional[int] = None):
        super().__init__()
        self.block1 = ConvBlock1d(in_channels, out_channels, kernel_size, stride, dilation,
                                  num_groups, use_norm)
        self.to_scale_shift = (MappingToScaleShift(context_mapping_features, out_channels)
                               if context_mapping_features is not None else None)
        self.block2 = ConvBlock1d(out_channels, out_channels, num_groups=num_groups,
                                  use_norm=use_norm)
        self.to_out = (ADPConv1d(in_channels, out_channels, 1)
                       if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, mapping: Mapping = None) -> torch.Tensor:
        h = self.block1(x)
        scale_shift = None
        if self.to_scale_shift is not None:
            scale_shift = self.to_scale_shift(mapping)
        h = self.block2(h, scale_shift=scale_shift)
        return h + (x if self.to_out is None else self.to_out(x))


class Patcher(nn.Module):
    """A one-group resnet block to out_channels / p, then p time steps
    folded into the channels (channel c * p + j holds step t * p + j)."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 context_mapping_features: tp.Optional[int] = None):
        super().__init__()
        self.patch_size = patch_size
        self.block = ResnetBlock1d(in_channels, out_channels // patch_size, num_groups=1,
                                   context_mapping_features=context_mapping_features)

    def forward(self, x: torch.Tensor, mapping: Mapping = None) -> torch.Tensor:
        x = self.block(x, mapping)
        p = self.patch_size
        if p > 1:
            B, C, T = x.shape
            x = x.reshape(B, C, T // p, p).transpose(2, 3).reshape(B, C * p, T // p)
        return x


class Unpatcher(nn.Module):
    """The inverse fold, then a one-group resnet block to out_channels."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 context_mapping_features: tp.Optional[int] = None):
        super().__init__()
        self.patch_size = patch_size
        self.block = ResnetBlock1d(in_channels // patch_size, out_channels, num_groups=1,
                                   context_mapping_features=context_mapping_features)

    def forward(self, x: torch.Tensor, mapping: Mapping = None) -> torch.Tensor:
        p = self.patch_size
        if p > 1:
            B, CP, S = x.shape
            x = x.reshape(B, CP // p, p, S).transpose(2, 3).reshape(B, CP // p, S * p)
        return self.block(x, mapping)


class AttentionBase(nn.Module):
    """The reference's holder of the output projection (`attention.to_out`)."""

    def __init__(self, mid: int, features: int):
        super().__init__()
        self.to_out = nn.Linear(mid, features)


class ADPAttention(nn.Module):
    """Attention of x [B, N, features] over a context [B, M, context_features]
    (x itself when None): biased LayerNorms `norm` and `norm_context` (the
    latter in self-attention too), bias-free q and kv projections; masked
    context rows zero their k and v."""

    def __init__(self, features: int, head_features: int, num_heads: int,
                 context_features: tp.Optional[int] = None):
        super().__init__()
        mid = head_features * num_heads
        ctx = context_features if context_features is not None else features
        self.num_heads, self.head_features = num_heads, head_features
        self.norm = BiasedLayerNorm(features)
        self.norm_context = BiasedLayerNorm(ctx)
        self.to_q = nn.Linear(features, mid, bias=False)
        self.to_kv = nn.Linear(ctx, mid * 2, bias=False)
        self.attention = AttentionBase(mid, features)

    def forward(self, x: torch.Tensor, context: tp.Optional[torch.Tensor] = None,
                context_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        q = self.to_q(self.norm(x))
        k, v = self.to_kv(self.norm_context(ctx)).chunk(2, dim=-1)
        if context_mask is not None:
            m = context_mask.to(k.dtype)[:, :, None]
            k, v = k * m, v * m

        def heads(t):
            B, N, _ = t.shape
            return t.reshape(B, N, self.num_heads, self.head_features).transpose(1, 2)

        out = dot_product_attention(heads(q), heads(k), heads(v))
        B, H, N, D = out.shape
        return self.attention.to_out(out.transpose(1, 2).reshape(B, N, H * D))


class ADPTransformerBlock(nn.Module):
    def __init__(self, features: int, head_features: int, num_heads: int, multiplier: int,
                 context_features: tp.Optional[int] = None):
        super().__init__()
        self.attention = ADPAttention(features, head_features, num_heads)
        self.cross_attention = (ADPAttention(features, head_features, num_heads,
                                             context_features)
                                if context_features else None)
        self.feed_forward = nn.Sequential(nn.Linear(features, features * multiplier), nn.GELU(),
                                          nn.Linear(features * multiplier, features))

    def forward(self, x: torch.Tensor, context: tp.Optional[torch.Tensor] = None,
                context_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attention(x) + x
        if self.cross_attention is not None:
            x = self.cross_attention(x, context=context, context_mask=context_mask) + x
        return self.feed_forward(x) + x


class Transformer1d(nn.Module):
    """GroupNorm(32) and a 1 x 1 conv in, the blocks over [B, T, C], a 1 x 1
    conv out; no residual around the whole."""

    def __init__(self, channels: int, num_layers: int, num_heads: int, head_features: int,
                 multiplier: int, context_features: tp.Optional[int] = None):
        super().__init__()
        self.to_in = nn.Sequential(GroupNorm(32, channels), ADPConv1d(channels, channels, 1))
        self.blocks = nn.ModuleList(
            ADPTransformerBlock(channels, head_features, num_heads, multiplier,
                                context_features) for _ in range(num_layers))
        # index 0 is the reference's rearrange back to [B, C, T]
        self.to_out = nn.Sequential(nn.Identity(), ADPConv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor, context: tp.Optional[torch.Tensor] = None,
                context_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.to_in(x).transpose(1, 2)
        for block in self.blocks:
            h = block(h, context=context, context_mask=context_mask)
        return self.to_out[1](h.transpose(1, 2))


def time_positional_embedding(dim: int, out_features: int) -> nn.Sequential:
    """t [B] -> [B, out_features]: [t, sin, cos] of learned frequencies, a
    Linear."""
    return nn.Sequential(LearnedPositionalEmbedding(dim), nn.Linear(dim + 1, out_features))


def _transformer(channels, n_blocks, heads, feats, mult, ctx_feats) -> Transformer1d:
    if feats is None and heads is not None:
        feats = channels // heads
    if heads is None and feats is not None:
        heads = channels // feats
    return Transformer1d(channels, n_blocks, heads, feats, mult, ctx_feats)


class DownsampleBlock1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, factor: int, num_groups: int,
                 num_layers: int, kernel_multiplier: int = 2, context_channels: int = 0,
                 num_transformer_blocks: int = 0, attention_heads=None, attention_features=None,
                 attention_multiplier=None, context_mapping_features=None,
                 context_embedding_features=None):
        super().__init__()
        self.context_channels = context_channels
        self.downsample = ADPConv1d(in_channels, out_channels, factor * kernel_multiplier + 1,
                                    stride=factor)
        self.blocks = nn.ModuleList(
            ResnetBlock1d(out_channels + (context_channels if i == 0 else 0), out_channels,
                          num_groups=num_groups,
                          context_mapping_features=context_mapping_features)
            for i in range(num_layers))
        self.transformer = (_transformer(out_channels, num_transformer_blocks, attention_heads,
                                         attention_features, attention_multiplier,
                                         context_embedding_features)
                            if num_transformer_blocks > 0 else None)

    def forward(self, x, mapping=None, channels=None, embedding=None, embedding_mask=None):
        x = self.downsample(x)
        if self.context_channels > 0 and channels is not None:
            x = torch.cat([x, channels], dim=1)
        skips = []
        for block in self.blocks:
            x = block(x, mapping)
            skips.append(x)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask)
            skips.append(x)
        return x, skips


class UpsampleBlock1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, factor: int, num_layers: int,
                 num_groups: int, use_nearest: bool = False, skip_channels: int = 0,
                 use_skip_scale: bool = False, num_transformer_blocks: int = 0,
                 attention_heads=None, attention_features=None, attention_multiplier=None,
                 context_mapping_features=None, context_embedding_features=None):
        super().__init__()
        self.skip_scale = 2 ** -0.5 if use_skip_scale else 1.0
        self.blocks = nn.ModuleList(
            ResnetBlock1d(in_channels + skip_channels, in_channels, num_groups=num_groups,
                          context_mapping_features=context_mapping_features)
            for _ in range(num_layers))
        self.transformer = (_transformer(in_channels, num_transformer_blocks, attention_heads,
                                         attention_features, attention_multiplier,
                                         context_embedding_features)
                            if num_transformer_blocks > 0 else None)
        _refuse(use_nearest_upsample=use_nearest)
        if factor == 1:
            self.upsample = ADPConv1d(in_channels, out_channels, 3)
        else:
            self.upsample = ADPConvTranspose1d(in_channels, out_channels, factor * 2, factor)

    def forward(self, x, skips, mapping=None, embedding=None, embedding_mask=None):
        skips = list(skips)
        for block in self.blocks:
            x = block(torch.cat([x, skips.pop() * self.skip_scale], dim=1), mapping)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask)
        return self.upsample(x)


class BottleneckBlock1d(nn.Module):
    def __init__(self, channels: int, num_groups: int, num_transformer_blocks: int = 0,
                 attention_heads=None, attention_features=None, attention_multiplier=None,
                 context_mapping_features=None, context_embedding_features=None):
        super().__init__()
        self.pre_block = ResnetBlock1d(channels, channels, num_groups=num_groups,
                                       context_mapping_features=context_mapping_features)
        self.transformer = (_transformer(channels, num_transformer_blocks, attention_heads,
                                         attention_features, attention_multiplier,
                                         context_embedding_features)
                            if num_transformer_blocks > 0 else None)
        self.post_block = ResnetBlock1d(channels, channels, num_groups=num_groups,
                                        context_mapping_features=context_mapping_features)

    def forward(self, x, mapping=None, embedding=None, embedding_mask=None):
        x = self.pre_block(x, mapping)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask)
        return self.post_block(x, mapping)


class UNet1d(nn.Module):
    """forward(x [B, in_channels, T], time [B], features, channels_list,
    embedding [B, M, context_embedding_features], embedding_mask [B, M]) ->
    [B, out_channels or in_channels, T]; T a multiple of the factors'
    product times `patch_size`."""

    def __init__(self, in_channels: int, channels: int, multipliers: tp.Sequence[int],
                 factors: tp.Sequence[int], num_blocks: tp.Sequence[int],
                 attentions: tp.Sequence[int], patch_size: int = 1, resnet_groups: int = 8,
                 use_context_time: bool = True, kernel_multiplier_downsample: int = 2,
                 use_nearest_upsample: bool = False, use_skip_scale: bool = True,
                 out_channels: tp.Optional[int] = None,
                 context_features: tp.Optional[int] = None,
                 context_features_multiplier: int = 4,
                 context_channels: tp.Sequence[int] = (),
                 context_embedding_features: tp.Optional[int] = None,
                 attention_heads: tp.Optional[int] = None,
                 attention_features: tp.Optional[int] = None, attention_multiplier: int = 2,
                 use_stft: bool = False, use_stft_context: bool = False):
        super().__init__()
        _refuse(use_stft=use_stft, use_stft_context=use_stft_context)
        num_layers = len(multipliers) - 1
        self.context_channels = list(context_channels) + [0] * (
            num_layers + 1 - len(context_channels))
        self.chan_ids = {}
        for i, c in enumerate(self.context_channels):
            if c > 0:
                self.chan_ids[i] = len(self.chan_ids)
        mapping = None
        if use_context_time or context_features is not None:
            mapping = channels * context_features_multiplier
        self.to_time = (nn.Sequential(time_positional_embedding(channels, mapping), nn.GELU())
                        if use_context_time else None)
        self.to_features = (nn.Sequential(nn.Linear(context_features, mapping), nn.GELU())
                            if context_features is not None else None)
        self.to_mapping = (nn.Sequential(nn.Linear(mapping, mapping), nn.GELU(),
                                         nn.Linear(mapping, mapping), nn.GELU())
                           if mapping is not None else None)
        attn = dict(attention_heads=attention_heads, attention_features=attention_features,
                    attention_multiplier=attention_multiplier,
                    context_mapping_features=mapping,
                    context_embedding_features=context_embedding_features)
        self.to_in = Patcher(in_channels + self.context_channels[0],
                             channels * multipliers[0], patch_size, mapping)
        self.downsamples = nn.ModuleList(
            DownsampleBlock1d(channels * multipliers[i], channels * multipliers[i + 1],
                              factors[i], resnet_groups, num_blocks[i],
                              kernel_multiplier_downsample, self.context_channels[i + 1],
                              attentions[i], **attn)
            for i in range(num_layers))
        self.bottleneck = BottleneckBlock1d(channels * multipliers[-1], resnet_groups,
                                            attentions[num_layers], **attn)
        self.upsamples = nn.ModuleList(
            UpsampleBlock1d(channels * multipliers[i + 1], channels * multipliers[i], factors[i],
                            num_blocks[i] + (1 if attentions[i] else 0), resnet_groups,
                            use_nearest_upsample, channels * multipliers[i + 1],
                            use_skip_scale, attentions[i], **attn)
            for i in reversed(range(num_layers)))
        self.to_out = Unpatcher(channels * multipliers[0], out_channels or in_channels,
                                patch_size, mapping)

    def unet_forward(self, x: torch.Tensor, time: torch.Tensor,
                     features: tp.Optional[torch.Tensor] = None,
                     channels_list: tp.Optional[tp.Sequence[torch.Tensor]] = None,
                     embedding: tp.Optional[torch.Tensor] = None,
                     embedding_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        channels_list = list(channels_list) if channels_list else None

        def channels_at(i):
            if channels_list is None or i not in self.chan_ids:
                return None
            return channels_list[self.chan_ids[i]]

        if channels_at(0) is not None:
            x = torch.cat([x, channels_at(0)], dim=1)
        mapping = None
        if self.to_mapping is not None:
            items = []
            if self.to_time is not None:
                items.append(self.to_time(time))
            if self.to_features is not None:
                items.append(self.to_features(features))
            mapping = self.to_mapping(sum(items))

        x = self.to_in(x, mapping)
        skips_list = [x]
        for i, down in enumerate(self.downsamples):
            x, skips = down(x, mapping=mapping, channels=channels_at(i + 1), embedding=embedding,
                            embedding_mask=embedding_mask)
            skips_list.append(skips)
        x = self.bottleneck(x, mapping=mapping, embedding=embedding,
                            embedding_mask=embedding_mask)
        for up in self.upsamples:
            x = up(x, skips_list.pop(), mapping=mapping, embedding=embedding,
                   embedding_mask=embedding_mask)
        return self.to_out(x + skips_list.pop(), mapping)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return self.unet_forward(*args, **kwargs)


class FixedEmbedding(nn.Module):
    """The learned null context of classifier-free guidance."""

    def __init__(self, max_length: int, features: int):
        super().__init__()
        self.embedding = nn.Embedding(max_length, features)


class UNetCFG1d(UNet1d):
    """UNet1d with classifier-free guidance against the learned null context
    `fixed_embedding` (or a negative context): with `embedding_scale` != 1
    one forward at twice the batch, the conditional and the unconditional
    halves mixed as u + (c - u) * scale, optionally rescaled toward the
    conditional output's standard deviation (`rescale_cfg`, `scale_phi`)."""

    def __init__(self, *args, context_embedding_max_length: int = 79,
                 use_xattn_time: bool = False, use_ncca: bool = False, **kwargs):
        _refuse(use_ncca=use_ncca, use_xattn_time=use_xattn_time)
        super().__init__(*args, **kwargs)
        self.fixed_embedding = FixedEmbedding(context_embedding_max_length,
                                              kwargs["context_embedding_features"])

    def forward(self, x: torch.Tensor, time: torch.Tensor, embedding: torch.Tensor,
                embedding_mask: tp.Optional[torch.Tensor] = None,
                embedding_scale: float = 1.0, embedding_mask_proba: float = 0.0,
                batch_cfg: bool = True, rescale_cfg: bool = False, scale_phi: float = 0.4,
                negative_embedding: tp.Optional[torch.Tensor] = None,
                negative_embedding_mask: tp.Optional[torch.Tensor] = None,
                features: tp.Optional[torch.Tensor] = None,
                channels_list: tp.Optional[tp.Sequence[torch.Tensor]] = None,
                train: bool = False,
                generator: tp.Optional[torch.Generator] = None,
                embedding_drop_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """`batch_cfg` is accepted and ignored (the batch is always
        doubled), as in the JAX module. With `train` and
        `embedding_mask_proba` > 0 each item's context is swapped for the
        null context with that probability: a [B, 1, 1] Bernoulli draw from
        `generator`, or `embedding_drop_mask` [B] (True = drop) where given."""
        del batch_cfg
        B, L = embedding.shape[:2]
        table = self.fixed_embedding.embedding.weight
        if L > table.shape[0]:
            raise ValueError(f"context of {L} tokens exceeds context_embedding_max_length "
                             f"{table.shape[0]}")
        fixed = table[:L].to(embedding.dtype).expand(B, L, table.shape[1])
        if embedding_mask_proba > 0.0 and train:
            if embedding_drop_mask is None:
                drop = torch.rand((B, 1, 1), generator=generator,
                                  device=embedding.device) < embedding_mask_proba
            else:
                drop = embedding_drop_mask.to(device=embedding.device, dtype=torch.bool)
                drop = drop.reshape(B, 1, 1)
            embedding = torch.where(drop, fixed, embedding)
        if embedding_scale == 1.0:
            return self.unet_forward(x, time, features=features, channels_list=channels_list,
                                     embedding=embedding, embedding_mask=embedding_mask)

        def twice(t):
            return None if t is None else torch.cat([t, t], dim=0)

        if negative_embedding is not None:
            if negative_embedding_mask is not None:
                negative_embedding = torch.where(negative_embedding_mask.bool()[:, :, None],
                                                 negative_embedding, fixed)
            other = negative_embedding
        else:
            other = fixed
        out = self.unet_forward(
            twice(x), twice(time),
            features=twice(features) if self.to_features is not None else None,
            channels_list=[twice(c) for c in channels_list] if channels_list else None,
            embedding=torch.cat([embedding, other], dim=0),
            embedding_mask=twice(embedding_mask))
        cond, uncond = out.chunk(2, dim=0)
        out_cfg = uncond + (cond - uncond) * embedding_scale
        if not rescale_cfg:
            return out_cfg
        out_std = cond.std(dim=1, keepdim=True, correction=0)
        cfg_std = out_cfg.std(dim=1, keepdim=True, correction=0)
        return scale_phi * (out_cfg * (out_std / (cfg_std + 1e-12))) + (1 - scale_phi) * out_cfg


class UNetCFG1DWrapper(nn.Module):
    """The conditioned wrapper's model for `adp_cfg_1d`: the routed
    conditioning to the UNet's arguments. `prepend_cond`, `cfg_interval` and
    any other keyword are accepted and not used, as in the JAX wrapper;
    `scale_phi` != 0 turns the CFG rescale on. In `train()` mode
    `cfg_dropout_prob` is the UNet's context dropout, drawn from `generator`
    or given as `cfg_dropout_mask` [B] (True = drop), the diffusion
    trainer's arguments."""

    def __init__(self, model: UNetCFG1d):
        super().__init__()
        self.model = model

    def forward(self, x, t, cross_attn_cond=None, cross_attn_mask=None,
                negative_cross_attn_cond=None, negative_cross_attn_mask=None,
                input_concat_cond=None, global_cond=None, prepend_cond=None,
                prepend_cond_mask=None, cfg_scale: float = 1.0, cfg_dropout_prob: float = 0.0,
                batch_cfg: bool = True, rescale_cfg: bool = False, scale_phi: float = 0.0,
                generator=None, cfg_dropout_mask=None, **kwargs):
        del prepend_cond, prepend_cond_mask, rescale_cfg, kwargs
        return self.model(
            x, t, embedding=cross_attn_cond, embedding_mask=cross_attn_mask,
            embedding_scale=cfg_scale, embedding_mask_proba=cfg_dropout_prob,
            batch_cfg=batch_cfg, rescale_cfg=scale_phi != 0.0, scale_phi=scale_phi,
            negative_embedding=negative_cross_attn_cond,
            negative_embedding_mask=negative_cross_attn_mask, features=global_cond,
            channels_list=[input_concat_cond] if input_concat_cond is not None else None,
            train=self.training, generator=generator, embedding_drop_mask=cfg_dropout_mask)


class UNet1DCondWrapper(nn.Module):
    """The conditioned wrapper's model for `adp_1d` (JAX :1065): the plain
    `UNet1d` with `input_concat_cond` as its `channels_list`, `global_cond`
    as its `features`, the cross-attention context and mask as its
    `embedding`; every other keyword (the CFG arguments, which the plain
    UNet has no use for) is accepted and ignored, as in JAX."""

    def __init__(self, model: UNet1d):
        super().__init__()
        self.model = model

    def forward(self, x, t, input_concat_cond=None, global_cond=None, cross_attn_cond=None,
                cross_attn_mask=None, **kwargs):
        del kwargs
        return self.model(x, t, features=global_cond,
                          channels_list=[input_concat_cond] if input_concat_cond is not None
                          else None,
                          embedding=cross_attn_cond, embedding_mask=cross_attn_mask)


class UNet1DUncondWrapper(nn.Module):
    """The unconditional wrapper's model for `adp_uncond_1d` (JAX :1017):
    the plain `UNet1d` on (x, t), passing on the UNet's own keywords
    (`features`, `channels_list`, `embedding`, `embedding_mask`) and
    dropping the rest. The reference halves every parameter once at init; the
    JAX package does not, nor does the port."""

    def __init__(self, model: UNet1d):
        super().__init__()
        self.model = model

    def forward(self, x, t, **kwargs):
        return self.model(x, t, **{k: v for k, v in kwargs.items()
                                   if k in ("features", "channels_list", "embedding",
                                            "embedding_mask")})


# the keyword arguments of UNet1d and UNetCFG1d: the JAX factory's filter of
# the config (its `stft_*` keys go unused, since `use_stft` is refused)
UNET_FIELDS = (
    "in_channels", "channels", "multipliers", "factors", "num_blocks", "attentions",
    "patch_size", "resnet_groups", "use_context_time", "kernel_multiplier_downsample",
    "use_nearest_upsample", "use_skip_scale", "out_channels", "context_features",
    "context_features_multiplier", "context_channels", "context_embedding_features",
    "attention_heads", "attention_features", "attention_multiplier", "use_stft",
    "use_stft_context")
UNETCFG_FIELDS = UNET_FIELDS + ("context_embedding_max_length", "use_ncca", "use_xattn_time")


def create_adp_cond_wrapper(model_type: str, config: tp.Dict[str, tp.Any]
                            ) -> tp.Union[UNetCFG1DWrapper, UNet1DCondWrapper]:
    """`adp_cfg_1d` -> UNetCFG1DWrapper(UNetCFG1d(...)), `adp_1d` ->
    UNet1DCondWrapper(UNet1d(...)), from the config's keys the UNet takes
    (the JAX factory's filter)."""
    if model_type == "adp_cfg_1d":
        return UNetCFG1DWrapper(UNetCFG1d(**{k: v for k, v in config.items()
                                             if k in UNETCFG_FIELDS}))
    if model_type == "adp_1d":
        return UNet1DCondWrapper(UNet1d(**{k: v for k, v in config.items()
                                           if k in UNET_FIELDS}))
    raise ValueError(f"Unknown adp model type {model_type}")
