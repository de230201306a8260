"""Dance Diffusion's 1-D UNet (`DiffusionAttnUnet1D`, model type `DAU1d`);
counterpart of stable_audio_tools_tpu/models/dance_unet.py.

Layout: [B, C, T]. Blocks: `ResConvBlock` (k = 5 convs, ops/norms.py's
GroupNorm with one group and epsilon 1e-6 as flax's, tanh-approximated GELU
as `jax.nn.gelu`'s default), `SelfAttention1d` (max(C // 32, 1) heads, 1 x 1 projections), the cubic FIR
down- and upsamplers (depthwise, reflect padding), Fourier timestep planes
joined to the input, and the skip stack of the recursive reference net laid
out flat. The modules keep the JAX package's flat names (`timestep_embed`,
`head_*`, `down_{i}_{j}`, `down_attn_{i}_{j}`, `up_*`, `up_attn_*`,
`tail_*`), one parameter for each of its leaves (io/from_jax.py
`dance_unet_state_dict`).

Every conv of a block is a stride-1 `ops/conv.py` conv: cuDNN's forward and
input gradient, and the hand-written weight-gradient kernel (`conv1d_wgrad`)
on the card. The FIR resamplers are fixed depthwise filters (cuDNN, autograd).

`compute_dtype` runs every conv, norm, attention and resampler in that
dtype (the GroupNorm statistics in f32, cast back), with the parameters
cast at use. The JAX package's flax GroupNorm promotes to its f32
parameters, so there only the first block's first conv and skip run in the
compute dtype and the rest in f32: the port keeps the config's dtype
throughout, which is also the dtype the weight-gradient kernel takes.

Refused, where the JAX module takes them: conditioning (`cond_dim`,
`cond_noise_aug` and a `cond` input; the JAX factory never builds
`DAU1DCondWrapper`), `learned_resample` (the JAX module ignores it) and
strides other than 1 and 2 (the JAX module resamples only at 2).
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv1d
from ..ops.embeddings import FourierFeatures
from ..ops.norms import GroupNorm

_CUBIC = (-0.01171875, -0.03515625, 0.11328125, 0.43359375,
          0.43359375, 0.11328125, -0.03515625, -0.01171875)


class Conv1d(nn.Conv1d):
    """A stride-1 torch Conv1d (its layout and default init, as the JAX
    package's `Conv1d`) run by `ops/conv.py::conv1d` in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv1d(x, self.weight.to(x.dtype), bias, padding=self.padding[0])


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class ResConvBlock(nn.Module):
    """conv -> norm -> GELU -> conv (-> norm -> GELU unless `is_last`) plus
    the input, through a bias-free k = 1 `skip` conv where the width changes."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, is_last: bool = False,
                 kernel_size: int = 5, conv_bias: bool = True):
        super().__init__()
        self.is_last = is_last
        self.skip = Conv1d(c_in, c_out, 1, bias=False) if c_in != c_out else None
        self.conv1 = Conv1d(c_in, c_mid, kernel_size, bias=conv_bias)
        self.norm1 = GroupNorm(1, c_mid)
        self.conv2 = Conv1d(c_mid, c_out, kernel_size, bias=conv_bias)
        self.norm2 = None if is_last else GroupNorm(1, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.skip is None else self.skip(x)
        h = self.conv2(gelu(self.norm1(self.conv1(x))))
        if not self.is_last:
            h = gelu(self.norm2(h))
        return h + skip


class SelfAttention1d(nn.Module):
    """x + out_proj(attention(qkv_proj(norm(x)))): q . k in f32 with scale
    d^-0.5, the softmax in f32, its weights cast to x's dtype before the
    product with v (the JAX module computes it as a plain einsum)."""

    def __init__(self, channels: int, n_head: int = 1):
        super().__init__()
        self.n_head = n_head
        self.norm = GroupNorm(1, channels)
        self.qkv_proj = Conv1d(channels, 3 * channels, 1)
        self.out_proj = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        H = self.n_head
        qkv = self.qkv_proj(self.norm(x)).view(B, 3, H, C // H, T).transpose(-1, -2)
        q, k, v = qkv.unbind(1)  # [B, H, T, D] each
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (C // H) ** -0.5
        att = torch.softmax(scores, dim=-1).to(x.dtype)
        y = torch.matmul(att, v).transpose(-1, -2).reshape(B, C, T)
        return x + self.out_proj(y)


def cubic_taps(device=None) -> torch.Tensor:
    """The cubic resampling filter's 8 taps, f32."""
    return torch.tensor(_CUBIC, device=device)


def _depthwise(taps: torch.Tensor, x: torch.Tensor, gain: float) -> torch.Tensor:
    return (taps * gain).to(x.dtype).expand(x.shape[1], 1, len(_CUBIC))


def fir_downsample(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, T / 2]: `taps` (`cubic_taps`, on x's device),
    depthwise, stride 2, after reflect padding of 3 (JAX dance_unet.py:79)."""
    pad = len(_CUBIC) // 2 - 1
    return F.conv1d(F.pad(x, (pad, pad), mode="reflect"), _depthwise(taps, x, 1.0), stride=2,
                    groups=x.shape[1])


def fir_upsample(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C, 2 T]: the transposed depthwise conv of `taps` x 2,
    stride 2, after reflect padding of 2 (JAX dance_unet.py:92)."""
    pad = len(_CUBIC) // 2 - 1
    xp = F.pad(x, ((pad + 1) // 2,) * 2, mode="reflect")
    return F.conv_transpose1d(xp, _depthwise(taps, x, 2.0), stride=2, padding=2 * pad + 1,
                              groups=x.shape[1])


class DiffusionAttnUnet1D(nn.Module):
    """The v-model: forward(x [B, io_channels, T], t [B]) -> [B, io_channels,
    T] in x's dtype; T a multiple of the product of the strides."""

    def __init__(self, io_channels: int = 2, depth: int = 14, n_attn_layers: int = 6,
                 channels: tp.Sequence[int] = (128, 128, 256, 256) + (512,) * 10,
                 cond_dim: int = 0, cond_noise_aug: bool = False, kernel_size: int = 5,
                 learned_resample: bool = False, strides: tp.Sequence[int] = (2,) * 13,
                 conv_bias: bool = True, compute_dtype: tp.Optional[str] = None):
        super().__init__()
        if cond_dim or cond_noise_aug:
            raise NotImplementedError("DAU1d conditioning (cond_dim, cond_noise_aug) is not "
                                      "ported: the unconditional model only")
        if learned_resample:
            raise NotImplementedError("DAU1d learned_resample is not ported (the JAX module "
                                      "ignores it and resamples with the cubic filter)")
        channels, strides = list(channels), [1] + list(strides)
        if any(s not in (1, 2) for s in strides[1:depth]):
            raise NotImplementedError(f"DAU1d strides {strides[1:depth]}: only 1 and 2 are "
                                      "ported (the JAX module resamples only at 2)")
        self.io_channels = io_channels
        self.depth = depth
        self.n_attn_layers = n_attn_layers
        self.channels = channels
        self.strides = strides[1:]
        self.compute_dtype = None if compute_dtype is None else getattr(torch, compute_dtype)
        attn_layer = depth - n_attn_layers

        def conv(name, c_in, c_mid, c_out, is_last=False):
            self.add_module(name, ResConvBlock(c_in, c_mid, c_out, is_last, kernel_size,
                                               conv_bias))

        def maybe_attn(name, c, i):
            if i >= attn_layer and n_attn_layers > 0:
                self.add_module(name, SelfAttention1d(c, max(c // 32, 1)))

        self.timestep_embed = FourierFeatures(1, 16)
        # kept on the model's device: a tensor made from the list at each call
        # is a host-to-device copy that waits for the card
        self.register_buffer("fir_taps", cubic_taps(), persistent=False)
        # the forward program: (kind, module name or None) in order
        self._program: tp.List[tp.Tuple[str, tp.Optional[str]]] = []
        c0 = channels[0]
        c_in = io_channels + 16
        for j in range(3):
            conv(f"head_{j}", c_in, c0, c0)
            self._program.append(("block", f"head_{j}"))
            c_in = c0
        self._program.append(("push", None))
        for i in range(2, depth + 1):
            c = channels[i - 1]
            if strides[i - 1] == 2:
                self._program.append(("down", None))
            for j in range(3):
                conv(f"down_{i}_{j}", c_in, c, c)
                maybe_attn(f"down_attn_{i}_{j}", c, i)
                self._program += [("block", f"down_{i}_{j}"), ("block", f"down_attn_{i}_{j}")]
                c_in = c
            if i < depth:
                self._program.append(("push", None))
        for i in range(depth, 1, -1):
            c, c_prev = channels[i - 1], channels[i - 2]
            if i < depth:
                self._program.append(("pop", None))
                c_in = 2 * c
            for j, c_out in enumerate((c, c, c_prev)):
                conv(f"up_{i}_{j}", c_in, c, c_out)
                maybe_attn(f"up_attn_{i}_{j}", c_out, i)
                self._program += [("block", f"up_{i}_{j}"), ("block", f"up_attn_{i}_{j}")]
                c_in = c_out
            if strides[i - 1] == 2:
                self._program.append(("up", None))
        self._program.append(("pop", None))
        for j, c_out in enumerate((c0, c0, io_channels)):
            conv(f"tail_{j}", 2 * c0 if j == 0 else c0, c0, c_out, is_last=j == 2)
            self._program.append(("block", f"tail_{j}"))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is not None:
            raise NotImplementedError("DAU1d conditioning is not ported")
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        B, _, T = x.shape
        temb = self.timestep_embed(t.float()[:, None])
        h = torch.cat([x, temb[:, :, None].expand(B, 16, T).to(x.dtype)], dim=1)
        skips = []
        for kind, name in self._program:
            if kind == "block":
                if name in self._modules:
                    h = self._modules[name](h)
            elif kind == "push":
                skips.append(h)
            elif kind == "pop":
                h = torch.cat([h, skips.pop()], dim=1)
            elif kind == "down":
                h = fir_downsample(h, self.fir_taps)
            else:
                h = fir_upsample(h, self.fir_taps)
        return h.to(in_dtype)

    def conv_sites(self) -> int:
        """The stride-1 convs one forward runs (each a `conv1d` call, whose
        backward launches `conv1d_wgrad` once on the card)."""
        return sum(1 for m in self.modules() if isinstance(m, Conv1d))
