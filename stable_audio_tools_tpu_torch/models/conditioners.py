"""Conditioners: metadata -> conditioning tensors; counterpart of
stable_audio_tools_tpu/models/conditioners.py (NumberConditioner :214,
T5Conditioner :323, _FallbackTokenizer :517, MultiConditioner :874).

Unlike the JAX package, which splits each conditioner into a host half and a
flax half, each conditioner here is one `nn.Module` whose
`forward(values, device)` returns `(tensor [B, n, D], mask [B, n])`, and
`MultiConditioner` holds them in an `nn.ModuleDict` named `conditioners`
(the reference's state-dict names).

The T5 tower is the port's own (models/t5.py), at the published architecture
of `t5_model_name`; its weights are random unless loaded (the card has no
`transformers` and no network), which is what `allow_random_init` accepts.
This slice covers the `t5` and `number` conditioner types (SA-Open's).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from .t5 import T5Arch, T5EncoderModel

# (d_model, d_ff, num_layers, num_heads, d_kv, gated): the published T5
# architectures (the JAX package's T5Conditioner.T5_ARCHS)
T5_ARCHS = {
    "t5-small": (512, 2048, 6, 8, 64, False),
    "t5-base": (768, 3072, 12, 12, 64, False),
    "t5-large": (1024, 4096, 24, 16, 64, False),
    "t5-3b": (1024, 16384, 24, 32, 128, False),
    "t5-11b": (1024, 65536, 24, 128, 128, False),
    "google/t5-v1_1-xl": (2048, 5120, 24, 32, 64, True),
    "google/t5-v1_1-xxl": (4096, 10240, 24, 64, 64, True),
    "google/flan-t5-small": (512, 1024, 8, 6, 64, True),
    "google/flan-t5-base": (768, 2048, 12, 12, 64, True),
    "google/flan-t5-large": (1024, 2816, 24, 16, 64, True),
    "google/flan-t5-3b": (1024, 16384, 24, 32, 128, False),
    "google/flan-t5-11b": (1024, 65536, 24, 128, 128, False),
    "google/flan-t5-xl": (2048, 5120, 24, 32, 64, True),
    "google/flan-t5-xxl": (4096, 10240, 24, 64, 64, True),
}


class FallbackTokenizer:
    """Word-hash tokenizer for when no SentencePiece vocabulary is available:
    ids are word_hash(word) % 32000 + 2, then EOS (1), zero-padded to
    max_length.

    The default `word_hash` is Python's `hash`, as the JAX package's
    `_FallbackTokenizer`'s. A str's `hash` is salted per process
    (PYTHONHASHSEED), so those ids change from process to process unless the
    seed is fixed; pass a salt-free hash (e.g. CRC-32 of the UTF-8 bytes) for
    ids that do not."""

    def __init__(self, max_length: int, word_hash: tp.Callable[[str], int] = hash):
        self.max_length = max_length
        self.word_hash = word_hash

    def __call__(self, texts: tp.Sequence[str]) -> tp.Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), self.max_length), np.int64)
        mask = np.zeros((len(texts), self.max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [self.word_hash(w) % 32000 + 2 for w in t.split()][: self.max_length - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


class T5Conditioner(nn.Module):
    """Frozen T5 encoder + optional projection; out = proj(T5(text)) * mask.
    The tower runs under no_grad; only the projection can train."""

    def __init__(self, output_dim: int, t5_model_name: str = "t5-base",
                 max_length: int = 128, project_out: bool = False,
                 allow_random_init: bool = False, arch: tp.Optional[tp.Sequence] = None):
        """`arch` = (d_model, d_ff, num_layers, num_heads, d_kv, gated)
        overrides the published architecture of `t5_model_name`. The tower
        computes in bf16 over f32 weights, as the JAX package's
        `FlaxT5EncoderModel(..., dtype=jnp.bfloat16)`."""
        super().__init__()
        if not allow_random_init:
            raise RuntimeError(
                f"T5 weights for {t5_model_name} are not bundled: set "
                "allow_random_init=True and load weights into `.model` "
                "(a state dict with Hugging Face names) if wanted")
        arch = T5Arch(*(arch if arch is not None else T5_ARCHS[t5_model_name]))
        self.dim = arch.d_model
        self.model = T5EncoderModel(arch, compute_dtype=torch.bfloat16)
        self.model.requires_grad_(False)  # frozen, as in the reference and the JAX package
        self.tokenizer = FallbackTokenizer(max_length)
        self.proj_out = (nn.Linear(self.dim, output_dim)
                         if self.dim != output_dim or project_out else None)

    def forward(self, texts: tp.Sequence[str], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer(list(texts))
        ids = torch.from_numpy(ids).to(device)
        mask = torch.from_numpy(mask).to(device)
        with torch.no_grad():
            emb = self.model(ids, mask).float()
        if self.proj_out is not None:
            emb = self.proj_out(emb)
        return emb * mask[..., None].float(), mask.bool()


class NumberEmbedder(nn.Module):
    """Learned Fourier features of a scalar + Linear (reference
    NumberEmbedder: `embedding.0.weights`, `embedding.1`)."""

    def __init__(self, features: int, dim: int = 256):
        super().__init__()
        self.embedding = nn.Sequential(LearnedPositionalEmbedding(dim),
                                       nn.Linear(dim + 1, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding(x)


class LearnedPositionalEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None].float()
        freqs = x * self.weights[None, :] * 2 * math.pi
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class NumberConditioner(nn.Module):
    def __init__(self, output_dim: int, min_val: float = 0.0, max_val: float = 1.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val
        self.embedder = NumberEmbedder(output_dim)

    def forward(self, values: tp.Sequence[float], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        floats = torch.tensor([float(v) for v in values], dtype=torch.float32, device=device)
        floats = floats.clamp(self.min_val, self.max_val)
        normalized = (floats - self.min_val) / (self.max_val - self.min_val)
        emb = self.embedder(normalized)[:, None, :]
        return emb, torch.ones(emb.shape[:2], dtype=torch.bool, device=device)


class MultiConditioner(nn.Module):
    """batch metadata (a list of dicts) -> {key: (tensor, mask)}."""

    def __init__(self, conditioners: tp.Dict[str, nn.Module],
                 default_keys: tp.Optional[tp.Dict[str, str]] = None):
        super().__init__()
        self.conditioners = nn.ModuleDict(conditioners)
        self.default_keys = dict(default_keys or {})

    def forward(self, batch_metadata: tp.List[tp.Dict[str, tp.Any]], device):
        out = {}
        for key, conditioner in self.conditioners.items():
            values = []
            for item in batch_metadata:
                k = key if key in item else self.default_keys.get(key)
                if k is None or k not in item:
                    raise ValueError(f"Conditioner key {key} not found in batch metadata")
                v = item[k]
                if isinstance(v, (list, tuple)) and len(v) == 1:
                    v = v[0]
                values.append(v)
            out[key] = conditioner(values, device)
        return out


def create_multi_conditioner_from_conditioning_config(config: tp.Dict[str, tp.Any]) -> MultiConditioner:
    conditioners = {}
    for info in config["configs"]:
        ccfg = {"output_dim": config["cond_dim"], **info.get("config", {})}
        if info["type"] == "t5":
            conditioners[info["id"]] = T5Conditioner(**ccfg)
        elif info["type"] == "number":
            conditioners[info["id"]] = NumberConditioner(**ccfg)
        else:
            raise NotImplementedError(f"conditioner type {info['type']} is not ported yet")
    return MultiConditioner(conditioners, config.get("default_keys"))
