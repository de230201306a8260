"""Conditioners: metadata -> conditioning tensors; counterpart of
stable_audio_tools_tpu/models/conditioners.py (IntConditioner :202,
NumberConditioner :214, ListConditioner :226, PhonemeConditioner :267,
T5Conditioner :323, _FallbackTokenizer :517, CLAPTextConditioner :551 with
CLAPProjModule :148, CLAPAudioConditioner :725, SourceMixConditioner :807,
PretransformConditioner :858, MultiConditioner :874 with its
`pre_encoded_keys`).

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
conditioner types, `list` and `phoneme` (learned embedding tables), `clap_audio`
(the port's HTSAT, models/htsat.py, and CLAP's `audio_projection`),
`pretransform` and `source_mix` (a frozen pretransform's encode of audio in
the metadata, then a trainable projection; `use_model_pretransform` takes
the model's own pretransform, which then stays out of the conditioner's
state dict, as the reference's `save_pretransform=False`). `lut` needs a
Hugging Face tokenizer and is refused by name.
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


class ListConditioner(nn.Module):
    """One of `options` -> its embedding (index + 1; a value not among the
    options takes row 0): a [B, 1, output_dim] token and an all-true mask
    (JAX :95, :226)."""

    def __init__(self, output_dim: int, options: tp.Sequence[str]):
        super().__init__()
        self.options = list(options)
        self.embedder = nn.Embedding(len(self.options) + 1, output_dim)

    def forward(self, values: tp.Sequence[str], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        ints = [self.options.index(v) + 1 if v in self.options else 0 for v in values]
        emb = self.embedder(torch.tensor(ints, dtype=torch.long, device=device))[:, None]
        return emb, torch.ones(emb.shape[:2], dtype=torch.bool, device=device)


class PhonemeConditioner(nn.Module):
    """Text -> one embedding a character (JAX :121, :267): the character
    table the JAX package takes when `g2p_en` is missing (ids min(ord, 127)
    + 2, at most `max_length`, zero-padded to the batch's longest; vocab
    130), then `proj_out` with `project_out`. The mask is all true, the
    padding too, as in the JAX package. `g2p_en` is on neither machine; where
    it imports, the JAX package would take its phoneme branch, which the port
    has not ported, so it raises."""

    VOCAB = 130

    def __init__(self, output_dim: int, max_length: int = 1024, project_out: bool = False):
        super().__init__()
        try:
            import g2p_en  # noqa: F401
        except ImportError:
            pass
        else:
            raise NotImplementedError(
                "phoneme conditioner: g2p_en is installed, and its phoneme table is not "
                "ported (the port builds the character table the JAX package uses without it)")
        self.max_length = max_length
        self.phoneme_embedder = nn.Embedding(self.VOCAB, output_dim)
        self.proj_out = nn.Linear(output_dim, output_dim) if project_out else None

    def forward(self, texts: tp.Sequence[str], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        ids = [[min(ord(c), 127) + 2 for c in t[: self.max_length]] for t in texts]
        longest = max(len(i) for i in ids)
        ids = torch.tensor([i + [0] * (longest - len(i)) for i in ids], dtype=torch.long,
                           device=device)
        emb = self.phoneme_embedder(ids)
        if self.proj_out is not None:
            emb = self.proj_out(emb)
        return emb, torch.ones(ids.shape, dtype=torch.bool, device=device)


class _EncodeConditioner(nn.Module):
    """Audio through a frozen pretransform under `no_grad` (the JAX
    package's `stop_gradient`). With `own_pretransform` the pretransform is
    this module's child (`pretransform.*`); else it is the model's, held
    outside the module tree so that its weights live once, under the model's
    `pretransform`."""

    def __init__(self, pretransform: nn.Module, own_pretransform: bool):
        super().__init__()
        if own_pretransform:
            self.pretransform = pretransform
        else:
            self.__dict__["pretransform"] = pretransform

    def encode(self, audio: tp.Sequence[tp.Any], device) -> torch.Tensor:
        """Clips [C, T] (numpy or tensors, one length) -> latents [B, C', S], f32."""
        audio = torch.stack([torch.as_tensor(np.asarray(v, np.float32)) for v in audio])
        audio = audio.to(device)
        with torch.no_grad():
            return self.pretransform.encode(audio[:, None] if audio.dim() == 2 else audio).float()


class PretransformConditioner(_EncodeConditioner):
    """Audio -> the frozen pretransform's latents, then `proj_out` where
    the latent width is not `output_dim`: a [B, output_dim, S] tensor
    (channels first, what `input_concat_ids` concatenates) and an all-true
    [B, S] mask (JAX :164, :858)."""

    def __init__(self, pretransform: nn.Module, output_dim: int, own_pretransform: bool = False):
        super().__init__(pretransform, own_pretransform)
        latent = pretransform.encoded_channels
        self.proj_out = nn.Linear(latent, output_dim) if latent != output_dim else None

    def forward(self, values: tp.Sequence[tp.Any], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        latents = self.encode(values, device).transpose(1, 2)
        if self.proj_out is not None:
            latents = self.proj_out(latents)
        return latents.transpose(1, 2), torch.ones(latents.shape[:2], dtype=torch.bool,
                                                   device=device)


class SourceMixConditioner(_EncodeConditioner):
    """Stems -> their sum, encoded by the frozen pretransform, then the
    trainable `proj` (always built): [B, output_dim, S] and an all-true mask
    (JAX :807-856). A value is a dict of stems by `source_keys` (a missing
    stem is left out; with none present, `source_length` zeros in one
    channel) or one clip; the sum is taken on the host in f32."""

    def __init__(self, pretransform: nn.Module, output_dim: int,
                 source_keys: tp.Sequence[str] = ("source",),
                 source_length: tp.Optional[int] = None, own_pretransform: bool = False):
        super().__init__(pretransform, own_pretransform)
        self.source_keys, self.source_length = tuple(source_keys), source_length
        self.proj = nn.Linear(pretransform.encoded_channels, output_dim)

    def mix(self, value: tp.Any) -> np.ndarray:
        if not isinstance(value, dict):
            mix = np.asarray(value, np.float32)
        else:
            stems = [np.asarray(value[k], np.float32) for k in self.source_keys if k in value]
            if not stems and self.source_length:
                stems = [np.zeros((1, self.source_length), np.float32)]
            mix = sum(stems)
        return mix[None] if mix.ndim == 1 else mix

    def forward(self, values: tp.Sequence[tp.Any], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        out = self.proj(self.encode([self.mix(v) for v in values], device).transpose(1, 2))
        return out.transpose(1, 2), torch.ones(out.shape[:2], dtype=torch.bool, device=device)


class CLAPAudioConditioner(nn.Module):
    """CLAP's audio branch (JAX :725-805): each clip mixed down to mono,
    repeat-padded or centre-cut to 10 s (`prepare_clap_audio`; the values
    are taken as 48 kHz, unresampled, as in the JAX package), `clap_logmel`,
    the HTSAT tower (models/htsat.py, widths from `HTSAT_DIMS`) and CLAP's
    `audio_projection` relu(e W1 + b1) W2 + b2 to the 512-wide joint space;
    then the trainable `proj_out` where 512 is not `output_dim` or
    `project_out`. Out: [B, 1, output_dim] and an all-true mask.

    The tower and projection come from `clap_ckpt_path` (laion-clap's
    `audio_branch.*` and `audio_projection.*`) and are frozen; without a
    checkpoint it is an error unless `allow_random_init` (the tower as
    built, the projection the JAX package's seeded one).
    `set_embed_fn(fn)` replaces the tower: fn(clips) -> [B, 512]."""

    HTSAT_DIMS = {"HTSAT-tiny": 96, "HTSAT-base": 128, "HTSAT-large": 256}

    def __init__(self, output_dim: int, clap_ckpt_path: tp.Optional[str] = None,
                 audio_model_type: str = "HTSAT-base", enable_fusion: bool = True,
                 project_out: bool = False, allow_random_init: bool = False,
                 use_text_features: bool = False, feature_layer_ix: int = -1,
                 finetune: bool = False):
        super().__init__()
        del use_text_features, feature_layer_ix  # the text branch's
        if finetune:
            raise NotImplementedError("finetune=True: the CLAP tower is frozen in this port")
        from .htsat import HTSAT

        self.dim = 512
        self._embed_fn = None
        self.audio_branch = HTSAT(embed_dim=self.HTSAT_DIMS[audio_model_type],
                                  enable_fusion=enable_fusion)
        n = self.audio_branch.num_features
        self.audio_projection = nn.Sequential(nn.Linear(n, 512), nn.ReLU(), nn.Linear(512, 512))
        if clap_ckpt_path:
            sd = load_clap_state_dict(clap_ckpt_path)
            own = list(self.state_dict())
            missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
            if missing:
                raise RuntimeError(f"CLAP checkpoint {clap_ckpt_path} lacks {len(missing)} "
                                   f"tensors of the audio branch ({missing[:5]})")
            if self.audio_projection[0].weight.device.type != "meta":  # meta: shapes only
                self.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)
        elif allow_random_init:
            rng = np.random.RandomState(0)  # the JAX package's seeded projection
            w1 = (rng.randn(n, 512) / np.sqrt(n)).astype(np.float32)
            w2 = (rng.randn(512, 512) / np.sqrt(512)).astype(np.float32)
            with torch.no_grad():
                for lin, w in ((self.audio_projection[0], w1), (self.audio_projection[2], w2)):
                    lin.weight.copy_(torch.from_numpy(w.T.copy()))
                    lin.bias.zero_()
        else:
            raise RuntimeError(
                "CLAPAudioConditioner has no clap_ckpt_path and allow_random_init is False: "
                "give a local CLAP checkpoint or set allow_random_init=True to accept "
                "random weights")
        self.audio_branch.requires_grad_(False)
        self.audio_projection.requires_grad_(False)
        self.proj_out = (nn.Linear(self.dim, output_dim)
                         if self.dim != output_dim or project_out else None)

    def set_embed_fn(self, fn: tp.Optional[tp.Callable]) -> None:
        self._embed_fn = fn

    @torch.no_grad()
    def features(self, values: tp.Sequence[tp.Any], device) -> torch.Tensor:
        """Clips -> the 512-wide CLAP embeddings [B, 512], f32."""
        if self._embed_fn is not None:
            return torch.as_tensor(np.asarray(self._embed_fn(values), np.float32), device=device)
        from .htsat import clap_logmel, prepare_clap_audio

        batch = np.stack([prepare_clap_audio(np.asarray(v, np.float32).mean(axis=0)
                                             if np.asarray(v).ndim > 1 else v) for v in values])
        emb = self.audio_branch(clap_logmel(torch.from_numpy(batch).to(device)))
        return self.audio_projection(emb)

    def forward(self, values: tp.Sequence[tp.Any], device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        feats = self.features(values, device)[:, None, :]
        if self.proj_out is not None:
            feats = self.proj_out(feats)
        return feats, torch.ones(feats.shape[:2], dtype=torch.bool, device=device)


class MultiConditioner(nn.Module):
    """batch metadata (a list of dicts) -> {key: (tensor, mask)}. A key of
    `pre_encoded_keys` has no module: its values, already embeddings, are
    stacked as f32 and passed through with mask None (JAX
    `MultiConditioner.gather_inputs` :884, `ConditionerBank` :924)."""

    def __init__(self, conditioners: tp.Dict[str, nn.Module],
                 default_keys: tp.Optional[tp.Dict[str, str]] = None,
                 pre_encoded_keys: tp.Sequence[str] = ()):
        super().__init__()
        self.conditioners = nn.ModuleDict(conditioners)
        self.default_keys = dict(default_keys or {})
        self.pre_encoded_keys = list(pre_encoded_keys)

    def _values(self, key: str, batch_metadata: tp.List[tp.Dict[str, tp.Any]]) -> list:
        values = []
        for item in batch_metadata:
            k = key if key in item else self.default_keys.get(key)
            if k is None or k not in item:
                raise ValueError(f"Conditioner key {key} not found in batch metadata")
            v = item[k]
            if isinstance(v, (list, tuple)) and len(v) == 1:
                v = v[0]
            values.append(v)
        return values

    def forward(self, batch_metadata: tp.List[tp.Dict[str, tp.Any]], device):
        out = {}
        for key in self.pre_encoded_keys:
            values = self._values(key, batch_metadata)
            out[key] = (torch.as_tensor(np.stack([np.asarray(v, np.float32) for v in values]),
                                        device=device), None)
        for key, conditioner in self.conditioners.items():
            out[key] = conditioner(self._values(key, batch_metadata), device)
        return out


def _conditioner_pretransform(ccfg: tp.Dict[str, tp.Any], pretransform, device, ctype: str):
    """Pop the pretransform keys of a `pretransform` / `source_mix` config
    (JAX :975-999): (the pretransform, whether the conditioner owns it)."""
    from .factory import create_pretransform_from_config

    sample_rate = ccfg.pop("sample_rate", None)
    if sample_rate is None:
        raise ValueError(f"Sample rate must be specified for {ctype} conditioners")
    use_model_pretransform = ccfg.pop("use_model_pretransform", False)
    pretransform_config = ccfg.pop("pretransform_config", None)
    ccfg.pop("pretransform_ckpt_path", None)  # read nowhere in the JAX package either
    if use_model_pretransform:
        if pretransform is None:
            raise ValueError(f"{ctype} conditioner: use_model_pretransform, but the model "
                             "has no pretransform")
        return pretransform, False
    own = create_pretransform_from_config(pretransform_config, sample_rate, device)
    own.requires_grad_(False)
    return own, True


def create_multi_conditioner_from_conditioning_config(
        config: tp.Dict[str, tp.Any], pretransform: tp.Optional[nn.Module] = None,
        device=None) -> MultiConditioner:
    """The conditioning config (JAX :952-1021) -> the MultiConditioner. The
    `pretransform` / `source_mix` conditioners with `use_model_pretransform`
    take `pretransform` (the model's); their own pretransforms are built on
    `device` (default: torch's default device, which the model factories set).
    A key of `pre_encoded_keys` builds no module."""
    device = torch.get_default_device() if device is None else device
    pre_encoded = list(config.get("pre_encoded_keys", []))
    conditioners = {}
    for info in config["configs"]:
        cid, ctype = info["id"], info["type"]
        if cid in pre_encoded:
            continue
        ccfg = {"output_dim": config["cond_dim"], **info.get("config", {})}
        if ctype == "t5":
            conditioners[cid] = T5Conditioner(**ccfg)
        elif ctype == "number":
            conditioners[cid] = NumberConditioner(**ccfg)
        elif ctype == "clap_text":
            conditioners[cid] = CLAPTextConditioner(**ccfg)
        elif ctype == "clap_audio":
            conditioners[cid] = CLAPAudioConditioner(**ccfg)
        elif ctype == "int":
            conditioners[cid] = IntConditioner(**ccfg)
        elif ctype == "list":
            conditioners[cid] = ListConditioner(ccfg["output_dim"], ccfg["options"])
        elif ctype == "phoneme":
            conditioners[cid] = PhonemeConditioner(**ccfg)
        elif ctype in ("pretransform", "source_mix"):
            pt, own = _conditioner_pretransform(ccfg, pretransform, device, ctype)
            cls = PretransformConditioner if ctype == "pretransform" else SourceMixConditioner
            conditioners[cid] = cls(pt, own_pretransform=own, **ccfg)
        elif ctype == "lut":
            raise NotImplementedError(
                "the lut conditioner is not ported: it needs transformers' AutoTokenizer and a "
                "downloaded tokenizer, which the card's machine has neither of")
        else:
            raise ValueError(f"Unknown conditioner type: {ctype}")
    return MultiConditioner(conditioners, config.get("default_keys"), pre_encoded)
