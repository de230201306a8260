"""Multi-codebook audio language model (MusicGen-style); counterpart of
stable_audio_tools_tpu/models/lm.py.

`AudioLanguageModel`: K codebook embeddings summed into the causal backbone,
K quantizer heads out (`embeds.{i}`, `quantizer_heads.{i}`).
`AudioLanguageModelWrapper`: the conditioner, the frozen discrete codec
(tokenize / decode tokens), the codebook pattern (`compute_logits`: the
pattern-shifted sequence in, the logits reverted to [B, K, T, card]).

Generation, both over the pattern sequence of `max_gen_len` frames, each
step sampling one token per codebook from the logits of the step before, with
CFG (the batch doubled with a zeroed condition), temperature, top-k / top-p:
- `lm_generate` (JAX :502): the full forward over the whole sequence at
  every step, as the JAX package's scan does (the backbone's self-attention
  launches `flash_attention` on the card);
- `lm_generate_cached` (JAX :308): one token per step through the per-layer
  KV caches, the cross-attention K/V projected once, the K embeddings summed
  and the K heads applied as one product, in the backbone's compute dtype
  (plain attention over the cache, as the JAX package leaves it to XLA). It
  falls back to `lm_generate` on prepend conditioning, as JAX :346-351.
  The backbone's f32 linear weights are cast to the compute dtype once per
  request, before the step loop (JAX `prepare` :383-400; `decode_weights`),
  and the model's own f32 parameters are back in place when the request
  ends. The JAX package also casts the LayerNorm scales to that dtype; the
  port keeps them f32.
- `lm_generate_audio` (JAX :599): either, then the codec's decode.
The two paths compute different functions when the context has more than one
token: the full forward's cross-attention is causal, the cached one's is not
(ops/attention.py says why); the port copies both.

Where the JAX package compiles each generation into one program with an
explicit PRNG key, the port steps a Python loop and draws from a
`torch.Generator`. `weight_quant="int8"` (a TPU bandwidth option of the
cached path) is not ported and raises. The JAX package stores the fused
projections interleaved and permutes them once per decode call
(`permute_fused_kernels_to_concat`); the port stores the concat layout.
"""

from __future__ import annotations

import contextlib
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import Linear, init_kv_cache
from .codebook_patterns import CodebooksPatternProvider, pattern_provider_from_config
from .lm_backbone import ContinuousTransformerAudioLMBackbone
from .utils import multinomial, sample_top_k, sample_top_p

Tensor = torch.Tensor


class AudioLanguageModel(nn.Module):
    def __init__(self, backbone: ContinuousTransformerAudioLMBackbone, num_quantizers: int,
                 codebook_size: int):
        super().__init__()
        self.backbone = backbone
        self.num_quantizers, self.codebook_size = num_quantizers, codebook_size
        dim = backbone.embed_dim
        self.embeds = nn.ModuleList([nn.Embedding(codebook_size + 1, dim)
                                     for _ in range(num_quantizers)])
        self.quantizer_heads = nn.ModuleList([Linear(dim, codebook_size)
                                              for _ in range(num_quantizers)])

    @property
    def masked_token_id(self) -> int:
        return self.codebook_size

    def forward(self, sequence: Tensor, prepend_cond: tp.Optional[Tensor] = None,
                prepend_cond_mask: tp.Optional[Tensor] = None,
                cross_attn_cond: tp.Optional[Tensor] = None) -> Tensor:
        """sequence [B, K, S] -> logits [B, K, S, card]."""
        if sequence.shape[1] != self.num_quantizers:
            raise ValueError(f"sequence has {sequence.shape[1]} codebooks, the model "
                             f"{self.num_quantizers}")
        x = sum(emb(sequence[:, i]) for i, emb in enumerate(self.embeds))
        out = self.backbone(x, cross_attn_cond=cross_attn_cond, prepend_cond=prepend_cond,
                            prepend_cond_mask=prepend_cond_mask)
        return torch.stack([head(out) for head in self.quantizer_heads], dim=1)


class AudioLanguageModelWrapper(nn.Module):
    def __init__(self, lm: AudioLanguageModel, conditioner: tp.Optional[nn.Module],
                 pretransform: tp.Optional[nn.Module], min_input_length: int,
                 sample_rate: int, pattern_provider: CodebooksPatternProvider,
                 cross_attn_cond_ids: tp.Sequence[str] = (),
                 prepend_cond_ids: tp.Sequence[str] = (),
                 global_cond_ids: tp.Sequence[str] = ()):
        super().__init__()
        self.lm = lm
        self.conditioner = conditioner
        self.pretransform = pretransform
        self.min_input_length = min_input_length
        self.sample_rate = sample_rate
        self.pattern_provider = pattern_provider
        self.cross_attn_cond_ids = tuple(cross_attn_cond_ids)
        self.prepend_cond_ids = tuple(prepend_cond_ids)
        self.global_cond_ids = tuple(global_cond_ids)

    @property
    def num_quantizers(self) -> int:
        return self.lm.num_quantizers

    @property
    def codebook_size(self) -> int:
        return self.lm.codebook_size

    def get_conditioning_inputs(self, conditioning_tensors: tp.Dict[str, tp.Tuple[Tensor, Tensor]]
                                ) -> tp.Dict[str, tp.Optional[Tensor]]:
        """{key: (tensor, mask)} -> the LM's keyword arguments (JAX :126): the
        cross-attention tokens concatenated along the sequence (their masks
        are not used, as in the JAX package), the prepend tokens and masks."""
        cross = prepend = prepend_mask = None
        if self.cross_attn_cond_ids:
            ins = []
            for key in self.cross_attn_cond_ids:
                c = conditioning_tensors[key][0]
                ins.append(c[:, None, :] if c.dim() == 2 else c)
            cross = torch.cat(ins, dim=1)
        if self.prepend_cond_ids:
            conds, masks = [], []
            for key in self.prepend_cond_ids:
                c, m = conditioning_tensors[key]
                conds.append(c)
                masks.append(torch.ones(c.shape[:2], dtype=torch.bool, device=c.device)
                             if m is None else m)
            prepend, prepend_mask = torch.cat(conds, dim=1), torch.cat(masks, dim=1)
        return {"cross_attn_cond": cross, "prepend_cond": prepend,
                "prepend_cond_mask": prepend_mask}

    def forward(self, sequence: Tensor, cond_tensors=None, **kwargs) -> Tensor:
        cond = self.get_conditioning_inputs(cond_tensors) if cond_tensors else {}
        return self.lm(sequence, **cond, **kwargs)

    def compute_logits(self, codes: Tensor, cond_tensors=None) -> tp.Tuple[Tensor, Tensor]:
        """Training logits (JAX :162): codes [B, K, T] -> the first T steps of
        their pattern sequence through the LM, the logits padded back to the
        pattern's S steps and reverted: ([B, K, T, card], mask [B, K, T])."""
        pattern = self.pattern_provider.get_pattern(codes.shape[-1])
        shifted, _, _ = pattern.build_pattern_sequence(codes, self.lm.masked_token_id)
        shifted = shifted[..., :min(shifted.shape[-1], codes.shape[-1])]
        logits = self(shifted, cond_tensors=cond_tensors)  # [B, K, S', card]
        logits = F.pad(logits, (0, 0, 0, pattern.S - logits.shape[2]))
        reverted = pattern.revert_pattern_logits(logits.permute(0, 3, 1, 2), 0.0)
        reverted = reverted.permute(0, 2, 3, 1)  # [B, K, T, card]
        mask = torch.from_numpy(pattern.reverse_map >= 0).to(codes.device)
        return reverted, mask[None].expand(reverted.shape[:3])

    @torch.no_grad()
    def pretransform_tokenize(self, audio: Tensor) -> Tensor:
        """Audio [B, C, T] -> codes [B, K, T / ratio] (the frozen codec)."""
        return self.pretransform.tokenize(audio)

    @torch.no_grad()
    def pretransform_decode_tokens(self, tokens: Tensor) -> Tensor:
        return self.pretransform.decode_tokens(tokens)


def _sample(logits: Tensor, temp: float, top_k: int, top_p: float,
            generator: tp.Optional[torch.Generator]) -> Tensor:
    """[B, K, card] f32 logits -> tokens [B, K] (JAX's order of choices)."""
    probs = torch.softmax(logits / max(temp, 1e-5), dim=-1)
    if top_p > 0.0:
        return sample_top_p(probs, top_p, generator)[..., 0]
    if top_k > 0:
        return sample_top_k(probs, top_k, generator)[..., 0]
    return multinomial(probs, 1, generator)[..., 0]


def _start(model: AudioLanguageModelWrapper, max_gen_len: int, batch_size: int,
           init_codes: tp.Optional[Tensor], device):
    pattern = model.pattern_provider.get_pattern(max_gen_len)
    masked = model.codebook_size
    codes = torch.full((batch_size, model.num_quantizers, max_gen_len), masked,
                       dtype=torch.long, device=device)
    if init_codes is not None:
        codes[:, :, :init_codes.shape[-1]] = init_codes.to(device)
    seq, _, _ = pattern.build_pattern_sequence(codes, masked)
    return pattern, seq


def _fill(seq: Tensor, offset: int, tokens: Tensor, masked: int) -> None:
    """Write the step's tokens where the sequence still holds the mask."""
    current = seq[:, :, offset]
    seq[:, :, offset] = torch.where(current == masked, tokens, current)


def _finish(model: AudioLanguageModelWrapper, pattern, seq: Tensor) -> Tensor:
    codes, _, _ = pattern.revert_pattern_sequence(seq, model.codebook_size)
    return codes.clamp(0, model.codebook_size - 1)


@torch.no_grad()
def lm_generate(model: AudioLanguageModelWrapper, conditioning_tensors=None,
                max_gen_len: int = 256, batch_size: int = 1, temp: float = 1.0,
                top_k: int = 250, top_p: float = 0.0, cfg_scale: tp.Optional[float] = None,
                generator: tp.Optional[torch.Generator] = None,
                init_codes: tp.Optional[Tensor] = None) -> Tensor:
    """Autoregressive generation by the full forward at every step (JAX
    :502). Returns codes [B, K, max_gen_len]."""
    device = next(model.lm.parameters()).device
    masked = model.codebook_size
    pattern, seq = _start(model, max_gen_len, batch_size, init_codes, device)
    cond = model.get_conditioning_inputs(conditioning_tensors) if conditioning_tensors else {}
    cond = {k: v for k, v in cond.items() if v is not None}
    use_cfg = cfg_scale is not None and cfg_scale != 1.0
    if use_cfg:
        cond = {k: torch.cat([v, v if k.endswith("_mask") else torch.zeros_like(v)])
                for k, v in cond.items()}
    start = init_codes.shape[-1] if init_codes is not None else 0
    for offset in range(max(start, 1), pattern.S):
        logits = model.lm(torch.cat([seq, seq]) if use_cfg else seq, **cond)
        step = logits[:, :, offset - 1].float()
        if use_cfg:
            cond_l, uncond_l = step.chunk(2)
            step = uncond_l + (cond_l - uncond_l) * cfg_scale
        _fill(seq, offset, _sample(step, temp, top_k, top_p, generator), masked)
    return _finish(model, pattern, seq)


@contextlib.contextmanager
def decode_weights(module: nn.Module, dtype: tp.Optional[torch.dtype]):
    """For the length of the block, the f32 weights and biases of every
    `nn.Linear` under `module` hold copies in `dtype` (their `.data` is
    swapped), so that `Linear.forward` casts nothing per step; the f32
    tensors are put back on exit. LayerNorm scales and other parameters stay
    as they are."""
    swapped = []
    if dtype is not None and dtype != torch.float32:
        for m in module.modules():
            if isinstance(m, nn.Linear):
                for p in (m.weight, m.bias):
                    if p is not None and p.dtype == torch.float32:
                        swapped.append((p, p.data))
                        p.data = p.data.to(dtype)
    try:
        yield
    finally:
        for p, data in swapped:
            p.data = data


@torch.no_grad()
def lm_generate_cached(model: AudioLanguageModelWrapper, conditioning_tensors=None,
                       max_gen_len: int = 256, batch_size: int = 1, temp: float = 1.0,
                       top_k: int = 250, top_p: float = 0.0,
                       cfg_scale: tp.Optional[float] = None,
                       generator: tp.Optional[torch.Generator] = None,
                       init_codes: tp.Optional[Tensor] = None,
                       weight_quant: tp.Optional[str] = None) -> Tensor:
    """KV-cached autoregressive generation (JAX :308): one token per step.
    Returns codes [B, K, max_gen_len]."""
    if weight_quant is not None:
        raise NotImplementedError(f"weight_quant={weight_quant!r} (the TPU's int8 decode "
                                  "weights) is not ported")
    cond = model.get_conditioning_inputs(conditioning_tensors) if conditioning_tensors else {}
    if cond.get("prepend_cond") is not None:
        # the cached decode takes no prepend conditioning; fall back (JAX :346)
        return lm_generate(model, conditioning_tensors, max_gen_len, batch_size, temp, top_k,
                           top_p, cfg_scale, generator, init_codes)
    lm, backbone = model.lm, model.lm.backbone
    device = next(lm.parameters()).device
    K, card, masked = model.num_quantizers, model.codebook_size, model.codebook_size
    pattern, seq = _start(model, max_gen_len, batch_size, init_codes, device)
    use_cfg = cfg_scale is not None and cfg_scale != 1.0
    cross = cond.get("cross_attn_cond")
    if use_cfg and cross is not None:
        cross = torch.cat([cross, torch.zeros_like(cross)])
    dtype = backbone.compute_dtype or torch.float32
    caches = [init_kv_cache(batch_size * (2 if use_cfg else 1), backbone.num_heads, pattern.S,
                            backbone.embed_dim // backbone.num_heads, dtype, device)
              for _ in range(backbone.depth)]
    with decode_weights(backbone, dtype):
        # once per request: the cross-attention K/V of the constant context,
        # the K embedding tables stacked, the K heads as one product
        cross_kvs = backbone.compute_cross_kv(cross) if cross is not None else None
        tables = torch.stack([e.weight for e in lm.embeds]).to(dtype)  # [K, card+1, D]
        head_w = torch.cat([h.weight for h in lm.quantizer_heads]).to(dtype)  # [K*card, D]
        head_b = torch.cat([h.bias for h in lm.quantizer_heads]).to(dtype)
        books = torch.arange(K, device=device)
        for offset in range(1, pattern.S):
            prev = offset - 1
            x = tables[books[None], seq[:, :, prev]].sum(dim=1, keepdim=True)  # [B, 1, D]
            if use_cfg:
                x = torch.cat([x, x])
            h = backbone(x, caches=caches, cache_index=prev, cross_kvs=cross_kvs)[:, 0]
            logits = F.linear(h, head_w, head_b).view(-1, K, card).float()
            if use_cfg:
                cond_l, uncond_l = logits.chunk(2)
                logits = uncond_l + (cond_l - uncond_l) * cfg_scale
            _fill(seq, offset, _sample(logits, temp, top_k, top_p, generator), masked)
    return _finish(model, pattern, seq)


def lm_generate_audio(model: AudioLanguageModelWrapper, conditioning_tensors=None,
                      use_cache: bool = True, **kwargs) -> Tensor:
    """Generate codes (KV-cached by default) and decode them with the codec
    (JAX :599): audio [B, C, max_gen_len * ratio]."""
    if use_cache:
        codes = lm_generate_cached(model, conditioning_tensors, **kwargs)
    else:
        kwargs.pop("weight_quant", None)  # a cached-path option
        codes = lm_generate(model, conditioning_tensors, **kwargs)
    return model.pretransform_decode_tokens(codes)


# keys of the reference's x-transformers backbone config and the values the
# in-repo backbone implements (JAX :662)
_XT_EQUIV = {"attn_flash": True, "use_abs_pos_emb": False, "rotary_pos_emb": True,
             "ff_swish": True, "ff_glu": True, "zero_init_branch_output": True,
             "max_seq_len": 0}
_XT_RENAMES = {"dim": "embed_dim", "embed_dim": "embed_dim", "depth": "depth",
               "heads": "num_heads", "num_heads": "num_heads",
               "cross_attn_cond_dim": "cross_attn_cond_dim",
               "prepend_cond_dim": "prepend_cond_dim", "ff_mult": "ff_mult",
               "use_checkpointing": "use_checkpointing", "compute_dtype": "compute_dtype"}


def _x_transformers_config(cfg: tp.Dict[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """The reference's x-transformers Decoder options mapped onto the
    in-repo backbone (JAX :651-697): an option whose value the backbone does
    not implement is a hard error."""
    mapped = {}
    for k, v in cfg.items():
        if k in _XT_RENAMES:
            mapped[_XT_RENAMES[k]] = v
        elif k in _XT_EQUIV:
            if v != _XT_EQUIV[k]:
                raise NotImplementedError(f"x-transformers backbone option {k}={v!r} differs "
                                          f"from the supported value {_XT_EQUIV[k]!r}")
        elif k in ("attn_dropout", "ff_dropout", "emb_dropout") and not v:
            pass  # zero dropout is the dropout-free backbone
        else:
            raise NotImplementedError(f"x-transformers backbone option {k!r} is not supported")
    return mapped


def create_audio_lm_from_config(config: tp.Dict[str, tp.Any], device=None
                                ) -> AudioLanguageModelWrapper:
    """`lm` configs -> the wrapper, its parameters on `device` (default: the
    current CUDA card). The codec and the T5 tower are frozen."""
    from .conditioners import create_multi_conditioner_from_conditioning_config
    from .factory import create_pretransform_from_config, resolve_device

    device = resolve_device(device)
    model_config = config["model"]
    sample_rate = config.get("sample_rate")
    if sample_rate is None:
        raise ValueError("Must specify sample_rate in config")
    lm_config = model_config["lm"]
    pretransform = model_config.get("pretransform")
    if pretransform is not None:
        pretransform = create_pretransform_from_config(pretransform, sample_rate, device)
        if not pretransform.is_discrete:
            raise ValueError("LM requires a discrete pretransform")
        pretransform.requires_grad_(False)
        bottleneck = pretransform.model.bottleneck
        num_quantizers, codebook_size = bottleneck.num_quantizers, bottleneck.codebook_size
        min_input_length = pretransform.downsampling_ratio
    else:
        num_quantizers, codebook_size = lm_config["num_quantizers"], lm_config["codebook_size"]
        min_input_length = 1
    pattern_provider = pattern_provider_from_config(
        lm_config.get("codebook_pattern", {"type": "delay"}), num_quantizers)
    backbone_cfg = dict(lm_config.get("config", {}))
    backbone_type = lm_config.get("type", "continuous_transformer")
    if backbone_type == "x-transformers":
        backbone_cfg = _x_transformers_config(backbone_cfg)
    elif backbone_type != "continuous_transformer":
        raise NotImplementedError(f"Unknown backbone type {backbone_type}")
    conditioning = model_config.get("conditioning")
    with device:
        backbone = ContinuousTransformerAudioLMBackbone(
            embed_dim=backbone_cfg.get("embed_dim", 768), depth=backbone_cfg.get("depth", 12),
            num_heads=backbone_cfg.get("num_heads", 8),
            cross_attn_cond_dim=backbone_cfg.get("cross_attn_cond_dim", 0),
            prepend_cond_dim=backbone_cfg.get("prepend_cond_dim", 0),
            use_checkpointing=backbone_cfg.get("use_checkpointing", True),
            ff_mult=backbone_cfg.get("ff_mult", 4),
            compute_dtype=backbone_cfg.get("compute_dtype"))
        lm = AudioLanguageModel(backbone, num_quantizers, codebook_size)
        conditioner = (create_multi_conditioner_from_conditioning_config(
            conditioning, pretransform=pretransform, device=device)
                       if conditioning is not None else None)
    return AudioLanguageModelWrapper(
        lm, conditioner, pretransform, min_input_length=min_input_length,
        sample_rate=sample_rate, pattern_provider=pattern_provider,
        cross_attn_cond_ids=lm_config.get("cross_attention_cond_ids", []),
        prepend_cond_ids=lm_config.get("prepend_cond_ids", []),
        global_cond_ids=lm_config.get("global_cond_ids", []))
