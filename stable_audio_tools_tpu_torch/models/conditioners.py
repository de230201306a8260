"""Conditioners: metadata -> conditioning tensors; counterpart of
stable_audio_tools_tpu/models/conditioners.py (IntConditioner :202,
NumberConditioner :214, T5Conditioner :323, _FallbackTokenizer :517, CLAPTextConditioner :551 with
CLAPProjModule :148, MultiConditioner :874).

Unlike the JAX package, which splits each conditioner into a host half and a
flax half, each conditioner here is one `nn.Module` whose
`forward(values, device)` returns `(tensor [B, n, D], mask [B, n])`, and
`MultiConditioner` holds them in an `nn.ModuleDict` named `conditioners`
(the reference's state-dict names).

The T5 tower is the port's own (models/t5.py), at the published architecture
of `t5_model_name`; its weights are random unless loaded (the card has no
`transformers` and no network), which is what `allow_random_init` accepts.
The CLAP text tower is the port's own RoBERTa (models/roberta.py), loaded from
the `text_branch.*` tensors of a CLAP checkpoint. Covered: the `t5`, `number`
(SA-Open's), `clap_text` (SA-2.0's and SA-1.0's) and `int` (SA-1.0's)
conditioner types; the CLAP audio branch (HTSAT) and the other types are
later slices.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from .roberta import RobertaArch, RobertaModel
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


def load_clap_state_dict(ckpt_path: str) -> tp.Dict[str, torch.Tensor]:
    """A laion-clap checkpoint's tensors with the lightning wrapper
    (`state_dict`) and the `module.` prefixes stripped and the position-id
    buffer dropped (JAX `_load_clap_state_dict` :535)."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k != "text_branch.embeddings.position_ids":
            out[k] = v.float()
    return out


class CLAPTextConditioner(nn.Module):
    """CLAP text branch: a frozen RoBERTa tower in f32, then either its
    hidden states at `feature_layer_ix` (`use_text_features`, 768 wide; what
    SA-2.0 cross-attends to) or the 512-wide joint-space embedding
    relu(pooler @ W1 + b1) @ W2 + b2 (`text_projection`), then the learnable
    `proj_out` when the widths differ. The mask is all ones, as in the JAX
    package: CLAP features are not masked.

    The tower comes from `clap_ckpt_path` (dimensions read from the tensors'
    shapes). Without a checkpoint it is an error unless `allow_random_init`
    (a 2-layer 768-wide tower as the JAX package's, random weights).
    `set_embed_fn(fn)` replaces the tower with precomputed features:
    fn(texts) -> [B, dim] or [B, n, dim].

    Texts are tokenized by `FallbackTokenizer(77)`: the card's machine has no
    `transformers`, so no BPE vocabulary. With real CLAP weights the
    embeddings are only meaningful through a RoBERTa tokenizer set as
    `.tokenizer` (texts -> (ids, mask) numpy arrays)."""

    MAX_LENGTH = 77

    def __init__(self, output_dim: int, clap_ckpt_path: tp.Optional[str] = None,
                 use_text_features: bool = False, feature_layer_ix: int = -1,
                 audio_model_type: str = "HTSAT-base", enable_fusion: bool = True,
                 project_out: bool = False, finetune: bool = False,
                 allow_random_init: bool = False):
        super().__init__()
        del audio_model_type, enable_fusion  # the audio branch's; the text tower ignores them
        if finetune:
            raise NotImplementedError("finetune=True: the CLAP tower is frozen in this port")
        self.use_text_features = use_text_features
        self.feature_layer_ix = feature_layer_ix
        self.dim = 768 if use_text_features else 512
        self._embed_fn = None
        self.tokenizer = FallbackTokenizer(self.MAX_LENGTH)
        proj = None
        if clap_ckpt_path:
            sd = load_clap_state_dict(clap_ckpt_path)
            tower = {k[len("text_branch."):]: v for k, v in sd.items()
                     if k.startswith("text_branch.")}
            # buffers newer Hugging Face versions save beside the parameters
            tower = {k: v for k, v in tower.items()
                     if not k.endswith(("position_ids", "token_type_ids"))}
            self.model = RobertaModel(RobertaArch.from_state_dict(tower))
            if self.model.pooler.dense.weight.device.type != "meta":  # meta: shapes only
                self.model.load_state_dict(tower, strict=True)
            for stem in ("text_projection", "text_branch_projection"):
                if f"{stem}.0.weight" in sd:
                    proj = [sd[f"{stem}.{i}.{n}"] if f"{stem}.{i}.{n}" in sd else None
                            for i in (0, 2) for n in ("weight", "bias")]
                    break
            if proj is None and not allow_random_init:
                raise RuntimeError(
                    f"CLAP checkpoint {clap_ckpt_path} has no text_projection.* / "
                    "text_branch_projection.* keys; refusing to random-init the projection "
                    "(set allow_random_init=True to override)")
        elif allow_random_init:
            self.model = RobertaModel(RobertaArch(num_layers=2, intermediate_size=1536,
                                                  max_positions=512, type_vocab_size=2))
        else:
            raise RuntimeError(
                "CLAPTextConditioner has no clap_ckpt_path and allow_random_init is False: "
                "give a local CLAP checkpoint or set allow_random_init=True to accept "
                "random weights")
        hid = self.model.arch.hidden_size
        if proj is None:  # the JAX package's seeded random projection
            rng = np.random.RandomState(0)
            w1 = (rng.randn(hid, 512) / np.sqrt(hid)).astype(np.float32)
            w2 = (rng.randn(512, 512) / np.sqrt(512)).astype(np.float32)
            proj = [torch.from_numpy(w1.T.copy()), None, torch.from_numpy(w2.T.copy()), None]
        w1, b1, w2, b2 = proj
        self.text_projection = nn.Sequential(nn.Linear(w1.shape[1], w1.shape[0]), nn.ReLU(),
                                             nn.Linear(w2.shape[1], w2.shape[0]))
        with torch.no_grad():
            for lin, w, b in ((self.text_projection[0], w1, b1), (self.text_projection[2], w2, b2)):
                lin.weight.copy_(w)
                lin.bias.zero_() if b is None else lin.bias.copy_(b)
        self.model.requires_grad_(False)
        self.text_projection.requires_grad_(False)
        # whether to project follows the nominal width (768 / 512), as the JAX
        # package; the layer's input is the width the tower really gives
        feat_dim = hid if use_text_features else w2.shape[0]
        self.proj_out = (nn.Linear(feat_dim, output_dim)
                         if self.dim != output_dim or project_out else None)

    def set_embed_fn(self, fn: tp.Optional[tp.Callable]) -> None:
        self._embed_fn = fn

    @torch.no_grad()
    def features(self, texts: tp.Sequence[str], device) -> torch.Tensor:
        if self._embed_fn is not None:
            return torch.as_tensor(np.asarray(self._embed_fn(list(texts)), np.float32),
                                   device=device)
        ids, mask = self.tokenizer(list(texts))
        ids, mask = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
        hidden_states, pooled = self.model(ids, mask)
        if self.use_text_features:
            return hidden_states[self.feature_layer_ix]
        return self.text_projection(pooled)

    def forward(self, texts: tp.Sequence[str], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        feats = self.features(texts, device)
        if feats.dim() == 2:
            feats = feats[:, None, :]
        if self.proj_out is not None:
            feats = self.proj_out(feats)
        return feats, torch.ones(feats.shape[:2], dtype=torch.bool, device=device)


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


class IntConditioner(nn.Module):
    """An embedding of ints clipped to [min_val, max_val] (JAX
    `IntConditionerModule` :46; the reference's `int_embedder`): one
    [B, 1, output_dim] token a value and an all-true mask."""

    def __init__(self, output_dim: int, min_val: int = 0, max_val: int = 512):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val
        self.int_embedder = nn.Embedding(max_val - min_val + 1, output_dim)

    def forward(self, values: tp.Sequence[int], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        ints = torch.tensor([int(v) for v in values], dtype=torch.long, device=device)
        emb = self.int_embedder(ints.clamp(self.min_val, self.max_val) - self.min_val)[:, None]
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
        elif info["type"] == "clap_text":
            conditioners[info["id"]] = CLAPTextConditioner(**ccfg)
        elif info["type"] == "int":
            conditioners[info["id"]] = IntConditioner(**ccfg)
        else:
            raise NotImplementedError(f"conditioner type {info['type']} is not ported yet")
    return MultiConditioner(conditioners, config.get("default_keys"))
