"""RoBERTa encoder in plain PyTorch (the machine with the card has no
`transformers`): the text tower of CLAP.

The same function as Hugging Face's `RobertaModel`, which the JAX package
runs as `FlaxRobertaModel` (models/conditioners.py `CLAPTextConditioner.
_build_roberta`):

- embeddings: word + position + token-type (all zeros), then a LayerNorm.
  Position ids are what the Hugging Face model computes from the input ids:
  the running count of tokens that differ from `padding_idx` (1), zero at the
  tokens equal to it, offset by `padding_idx`. They follow the ids, not the
  attention mask: a tokenizer that pads with another id (the fallback
  tokenizer pads with 0 and ends each text with id 1) gets positions that go
  on counting through its padding, as in the JAX package;
- post-LayerNorm encoder layers: self-attention with biased q/k/v/output
  projections and an additive key mask, then a GELU (erf) feed-forward, each
  followed by a residual add and a LayerNorm;
- `hidden_states`: the embedding output and every layer's output;
- a pooler: tanh(dense(first token)).

Parameter names follow Hugging Face's (`embeddings.word_embeddings.weight`,
`encoder.layer.{i}.attention.self.query.weight`, ...), so the `text_branch.*`
tensors of a CLAP checkpoint load by name. The dimensions are read from such
a state dict's shapes (`RobertaArch.from_state_dict`), heads of 64, and the
LayerNorm epsilon is `RobertaConfig`'s default (1e-12), as the JAX package
builds it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

PADDING_IDX = 1


@dataclass(frozen=True)
class RobertaArch:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 514
    type_vocab_size: int = 1
    eps: float = 1e-12

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor]) -> "RobertaArch":
        """The architecture a Hugging Face RoBERTa state dict was saved from."""
        emb = sd["embeddings.word_embeddings.weight"]
        layers = [int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer.")]
        return cls(
            vocab_size=emb.shape[0], hidden_size=emb.shape[1], num_layers=max(layers) + 1,
            num_heads=emb.shape[1] // 64,
            intermediate_size=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
            max_positions=sd["embeddings.position_embeddings.weight"].shape[0],
            type_vocab_size=sd["embeddings.token_type_embeddings.weight"].shape[0])


def position_ids_from_input_ids(input_ids: torch.Tensor) -> torch.Tensor:
    keep = (input_ids != PADDING_IDX).long()
    return torch.cumsum(keep, dim=1) * keep + PADDING_IDX


class RobertaEmbeddings(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.word_embeddings = nn.Embedding(arch.vocab_size, arch.hidden_size)
        self.position_embeddings = nn.Embedding(arch.max_positions, arch.hidden_size)
        self.token_type_embeddings = nn.Embedding(arch.type_vocab_size, arch.hidden_size)
        self.LayerNorm = nn.LayerNorm(arch.hidden_size, eps=arch.eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids_from_input_ids(input_ids))
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class RobertaSelfAttention(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.num_heads = arch.num_heads
        self.query = nn.Linear(arch.hidden_size, arch.hidden_size)
        self.key = nn.Linear(arch.hidden_size, arch.hidden_size)
        self.value = nn.Linear(arch.hidden_size, arch.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (proj(x).view(b, n, self.num_heads, -1).transpose(1, 2)
                   for proj in (self.query, self.key, self.value))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]) + bias
        return torch.matmul(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, n, d)


class RobertaOutput(nn.Module):
    """dense -> residual add -> LayerNorm (`attention.output` and `output`)."""

    def __init__(self, dim_in: int, arch: RobertaArch):
        super().__init__()
        self.dense = nn.Linear(dim_in, arch.hidden_size)
        self.LayerNorm = nn.LayerNorm(arch.hidden_size, eps=arch.eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class RobertaAttention(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.self = RobertaSelfAttention(arch)
        self.output = RobertaOutput(arch.hidden_size, arch)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class RobertaIntermediate(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.dense = nn.Linear(arch.hidden_size, arch.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))


class RobertaLayer(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.attention = RobertaAttention(arch)
        self.intermediate = RobertaIntermediate(arch)
        self.output = RobertaOutput(arch.intermediate_size, arch)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class RobertaEncoder(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.layer = nn.ModuleList([RobertaLayer(arch) for _ in range(arch.num_layers)])


class RobertaPooler(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.dense = nn.Linear(arch.hidden_size, arch.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))


class RobertaModel(nn.Module):
    def __init__(self, arch: RobertaArch):
        super().__init__()
        self.arch = arch
        self.embeddings = RobertaEmbeddings(arch)
        self.encoder = RobertaEncoder(arch)
        self.pooler = RobertaPooler(arch)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """input_ids, attention_mask [B, L] -> (hidden_states: the embedding
        output then each layer's output, each [B, L, hidden]; pooler_output
        [B, hidden]). f32 throughout."""
        x = self.embeddings(input_ids)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(x.dtype).min).to(x.dtype)
        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x, bias)
            hidden_states.append(x)
        return hidden_states, self.pooler(x)
