"""T5 encoder in plain PyTorch (the machine with the card has no
`transformers`).

The same function as Hugging Face's `T5EncoderModel`, which the JAX package
runs as `FlaxT5EncoderModel` (models/conditioners.py `T5Conditioner`):

- token embedding `shared`, no scaling;
- pre-norm blocks with T5's RMS layer norm (no mean, no bias, eps 1e-6);
- self-attention with no 1/sqrt(d) scale and a bucketed bidirectional
  relative position bias (32 buckets, max distance 128), computed by block 0
  and shared by every block; padding keys masked out;
- a ReLU feed-forward (t5-*) or a gated tanh-GELU one (v1.1 / flan);
- a final RMS norm.

`compute_dtype` (None: the parameters' dtype, f32) is the dtype of the
activations, as `FlaxT5EncoderModel(config, dtype=...)`: f32 master weights
are cast at use, the RMS norms compute in f32 and round once on their way
into the next projection, and the final norm's output stays f32. The JAX
package runs its T5 conditioners in bf16 (models/conditioners.py:427, :486);
so does `T5Conditioner`.

Parameter names follow Hugging Face's (`shared.weight`,
`encoder.block.{i}.layer.0.SelfAttention.q.weight`, ...), so a reference
checkpoint's `conditioner.conditioners.<id>.model.*` tensors load by name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import Linear


@dataclass(frozen=True)
class T5Arch:
    d_model: int
    d_ff: int
    num_layers: int
    num_heads: int
    d_kv: int
    gated: bool
    vocab_size: int = 32128
    num_buckets: int = 32
    max_distance: int = 128
    eps: float = 1e-6


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """f32 out (the Flax T5's norm: f32 statistics, weight * x / rms)."""
        xf = x.float()
        var = xf.pow(2).mean(-1, keepdim=True)
        return self.weight * (xf * torch.rsqrt(var + self.eps))


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing of key - query offsets."""
    num_buckets //= 2
    buckets = (rel > 0).long() * num_buckets
    rel = rel.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


class T5Attention(nn.Module):
    def __init__(self, arch: T5Arch, has_relative_bias: bool):
        super().__init__()
        inner = arch.num_heads * arch.d_kv
        self.arch = arch
        self.q = Linear(arch.d_model, inner, bias=False)
        self.k = Linear(arch.d_model, inner, bias=False)
        self.v = Linear(arch.d_model, inner, bias=False)
        self.o = Linear(inner, arch.d_model, bias=False)
        self.relative_attention_bias = (nn.Embedding(arch.num_buckets, arch.num_heads)
                                        if has_relative_bias else None)

    def position_bias(self, n: int, device) -> torch.Tensor:
        pos = torch.arange(n, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.arch.num_buckets, self.arch.max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]  # [1,H,n,n]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.arch.num_heads, self.arch.d_kv
        q, k, v = (t(x).view(b, n, h, d).transpose(1, 2) for t in (self.q, self.k, self.v))
        scores = torch.matmul(q, k.transpose(-1, -2)) + bias
        # softmax in the compute dtype, as jax.nn.softmax on the Flax T5's
        # bf16 scores: the shifted exponentials rounded to it, their sum
        # accumulated in f32 and rounded, then the quotient
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        weights = e / e.float().sum(dim=-1, keepdim=True).to(e.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, h * d)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, arch: T5Arch, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(arch, has_relative_bias)
        self.layer_norm = T5LayerNorm(arch.d_model, arch.eps)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x).to(x.dtype), bias)


class T5DenseReluDense(nn.Module):
    def __init__(self, arch: T5Arch):
        super().__init__()
        self.wi = Linear(arch.d_model, arch.d_ff, bias=False)
        self.wo = Linear(arch.d_ff, arch.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.relu(self.wi(x)))


class T5DenseGatedGelu(nn.Module):
    def __init__(self, arch: T5Arch):
        super().__init__()
        self.wi_0 = Linear(arch.d_model, arch.d_ff, bias=False)
        self.wi_1 = Linear(arch.d_model, arch.d_ff, bias=False)
        self.wo = Linear(arch.d_ff, arch.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, arch: T5Arch):
        super().__init__()
        self.DenseReluDense = T5DenseGatedGelu(arch) if arch.gated else T5DenseReluDense(arch)
        self.layer_norm = T5LayerNorm(arch.d_model, arch.eps)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x).to(x.dtype))


class T5Block(nn.Module):
    def __init__(self, arch: T5Arch, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(arch, has_relative_bias),
                                    T5LayerFF(arch)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, arch: T5Arch):
        super().__init__()
        self.block = nn.ModuleList([T5Block(arch, i == 0) for i in range(arch.num_layers)])
        self.final_layer_norm = T5LayerNorm(arch.d_model, arch.eps)


class T5EncoderModel(nn.Module):
    def __init__(self, arch: T5Arch, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.arch = arch
        self.compute_dtype = compute_dtype
        self.shared = nn.Embedding(arch.vocab_size, arch.d_model)
        self.encoder = T5Stack(arch)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """input_ids, attention_mask [B, n] -> last hidden state [B, n, d_model]
        (f32: the final norm's output)."""
        cdt = self.compute_dtype or self.shared.weight.dtype
        x = self.shared(input_ids).to(cdt)
        n = input_ids.shape[1]
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(n, x.device).to(cdt)
        neg = torch.finfo(cdt).min
        mask = torch.where(attention_mask[:, None, None, :].bool(), 0.0, neg).to(cdt)
        bias = bias + mask
        for block in blocks:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
