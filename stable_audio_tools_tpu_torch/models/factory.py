"""Config-driven factories; counterpart of stable_audio_tools_tpu/models/factory.py.

The JSON model config is the public API: the shipped
`stable_audio_open_1_0.json`, `stable_audio_2_0.json`,
`autoencoders/stable_audio_2_0_vae.json`, `autoencoders/encodec_musicgen_rvq.json`
`lm/musicgen_small_rvq.json`, the four `dance_diffusion/*.json`,
`txt2audio/stable_audio_1_0.json`, `autoencoders/stable_audio_1_0_vae.json`
and `autoencoders/dac_2048_32_vae.json` build unchanged.
Built: `diffusion_cond` and `diffusion_cond_inpaint` (DiT; `diffusion_cond`
also on the ADP `UNetCFG1d` and `UNet1d`, models/adp.py), `diffusion_uncond`
(Dance Diffusion's DAU1d, the ADP `UNet1d`, the DiT), `diffusion_autoencoder`
(models/diffusion_ae.py), `lm` (the MusicGen-style token LM, models/lm.py),
`autoencoder` (Oobleck with the snake or ELU, TAAE, SEANet or DAC encoder
and decoder; every bottleneck of the JAX factory: VAE, RVQ, RVQ-VAE, DAC
RVQ, DAC RVQ-VAE, tanh, softnorm, Wasserstein, L2, FSQ and dithered FSQ)
and every pretransform of the JAX factory: `autoencoder`, the public codecs
`dac_pretrained` (DAC 44 / 24 / 16 kHz or a custom DAC) and
`audiocraft_pretrained` (EnCodec 32 kHz or a custom SEANet codec), from a
local `ckpt_path` or seeded random, and the signal-domain `patched`,
`wavelet` and `pqmf`. Other types (the `local_attn` towers) raise
NotImplementedError, and so do the Oobleck's `antialias_activation` and
`use_nearest_upsample`, which the JAX factory reads and the port does not
build yet.

Every factory takes the `device` the parameters are created on. The default
is the current CUDA card, and without one the call raises: a model lands on
the CPU (or on `meta`, for shapes only) only when the caller names it.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from . import bottleneck as B
from .autoencoders import (AudioAutoencoder, OobleckDecoder, OobleckEncoder, TAAEDecoder,
                           TAAEEncoder)
from .dac import DACDecoderWrapper, DACEncoderWrapper, Snake1d
from .pretransforms import (AutoencoderPretransform, PatchedPretransform,
                            PQMFPretransform, PretrainedCodecPretransform, WaveletPretransform)
from .seanet import SEANetDecoder, SEANetEncoder

_OOBLECK_KEYS = ("channels", "latent_dim", "c_mults", "strides", "use_snake")
# Oobleck options the JAX factory builds (models/factory.py:71, :103) and the
# port does not yet: refused by name when set (ROADMAP queue 1 item 5)
_OOBLECK_UNPORTED = ("antialias_activation", "use_nearest_upsample")
_SEANET_KEYS = ("channels", "dimension", "n_filters", "ratios", "n_residual_layers",
                "dilation_base", "norm", "lstm", "kernel_size", "last_kernel_size",
                "residual_kernel_size", "causal", "pad_mode", "true_skip", "compress")
# the JAX factory's DAC keyword arguments (models/factory.py:75, :107), the
# decoder's under their reference names
_DAC_ENCODER_KEYS = ("d_model", "strides", "d_latent", "latent_dim", "in_channels")
_DAC_DECODER_KEYS = {"latent_dim": "input_channel", "channels": "channels", "rates": "rates",
                     "out_channels": "d_out", "final_tanh": "final_tanh"}
# the JAX factory's TAAE keyword arguments (`_filter_kwargs` of
# models/autoencoders.py:299, :332)
_TAAE_KEYS = ("channels", "latent_dim", "c_mults", "strides", "transformer_depths",
              "use_snake", "sliding_window")
_DAC_RVQ_KEYS = ("input_dim", "n_codebooks", "codebook_size", "codebook_dim",
                 "quantize_on_decode")
# bottleneck type -> (class, the JAX factory's config keys) (JAX :131-151)
_BOTTLENECKS = {
    "vae": (B.VAEBottleneck, ()),
    "rvq": (B.RVQBottleneck, None),
    "rvq_vae": (B.RVQVAEBottleneck, ("dim", "codebook_size", "num_quantizers", "kmeans_init",
                                     "kmeans_iters", "decay", "threshold_ema_dead_code")),
    "dac_rvq": (B.DACRVQBottleneck, _DAC_RVQ_KEYS + ("noise_augment_dim",)),
    "dac_rvq_vae": (B.DACRVQVAEBottleneck, _DAC_RVQ_KEYS),
    "tanh": (B.TanhBottleneck, ("scale",)),
    "l2_norm": (B.L2Bottleneck, ()),
    "softnorm": (B.SoftNormBottleneck, ("dim", "noise_augment_dim", "noise_regularize")),
    "wasserstein": (B.WassersteinBottleneck, ("noise_augment_dim", "bypass_mmd", "use_tanh",
                                              "tanh_scale")),
    "fsq": (B.FSQBottleneck, ("levels", "num_codebooks", "noise_augment_dim")),
    "dithered_fsq": (B.DitheredFSQBottleneck, ("dim", "levels", "num_codebooks",
                                               "dither_inference", "noise_dropout")),
}
Device = Optional[Union[str, torch.device]]


def resolve_device(device: Device = None) -> torch.device:
    """`device`, or the current CUDA card when it is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the port builds its models on the GPU unless "
                           "asked otherwise; pass device=\"cpu\" to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def create_model_from_config(model_config: Dict[str, Any], device: Device = None) -> nn.Module:
    model_type = model_config.get("model_type")
    if model_type == "autoencoder":
        return create_autoencoder_from_config(model_config, device)
    if model_type in ("diffusion_cond", "diffusion_cond_inpaint"):
        from .diffusion import create_diffusion_cond_from_config

        return create_diffusion_cond_from_config(model_config, device)
    if model_type == "diffusion_uncond":
        from .diffusion import create_diffusion_uncond_from_config

        return create_diffusion_uncond_from_config(model_config, device)
    if model_type == "lm":
        from .lm import create_audio_lm_from_config

        return create_audio_lm_from_config(model_config, device)
    if model_type == "diffusion_autoencoder":
        from .diffusion_ae import create_diffAE_from_config

        return create_diffAE_from_config(model_config, device)
    raise NotImplementedError(f"model type {model_type} is not ported yet")


def create_model_from_config_path(path: str, device: Device = None) -> nn.Module:
    with open(path) as f:
        return create_model_from_config(json.load(f), device)


def _oobleck(section: Dict[str, Any], io_key: str, cls):
    cfg = section.get("config", {})
    for key in _OOBLECK_UNPORTED:
        if cfg.get(key):
            raise NotImplementedError(
                f"the Oobleck's {key} is not ported yet (ROADMAP queue 1 item 5); "
                "without it the port would build a different model")
    kwargs = {k: cfg[k] for k in _OOBLECK_KEYS if k in cfg}
    if io_key in cfg:
        kwargs[io_key] = cfg[io_key]
    if cls is OobleckDecoder and "final_tanh" in cfg:
        kwargs["final_tanh"] = cfg["final_tanh"]
    return cls(**kwargs)


def _seanet(section: Dict[str, Any], cls):
    """The JAX factory's keys (reference names); the ratios go through in
    config order (models/seanet.py)."""
    cfg = section.get("config", {})
    keys = _SEANET_KEYS + (("trim_right_ratio", "final_tanh") if cls is SEANetDecoder else ())
    return cls(**{k: cfg[k] for k in keys if k in cfg})


def _dac(section: Dict[str, Any], cls):
    """The JAX factory's renames: the decoder's `latent_dim` is its
    `input_channel` and `out_channels` its `d_out`; the encoder's
    `latent_dim` sizes `proj_out`."""
    cfg = section.get("config", {})
    if cls is DACEncoderWrapper:
        return cls(**{k: cfg[k] for k in _DAC_ENCODER_KEYS if k in cfg})
    return cls(**{new: cfg[old] for old, new in _DAC_DECODER_KEYS.items() if old in cfg})


def _taae(section: Dict[str, Any], io_key: str, cls):
    cfg = section.get("config", {})
    keys = _TAAE_KEYS + (io_key,) + (("final_tanh",) if cls is TAAEDecoder else ())
    return cls(**{k: cfg[k] for k in keys if k in cfg})


def _tower(section: Dict[str, Any], io_key: str, oobleck, seanet, dac):
    if section["type"] == "oobleck":
        return _oobleck(section, io_key, oobleck)
    if section["type"] == "taae":
        return _taae(section, io_key, TAAEEncoder if oobleck is OobleckEncoder else TAAEDecoder)
    if section["type"] == "seanet":
        return _seanet(section, seanet)
    if section["type"] == "dac":
        return _dac(section, dac)
    raise NotImplementedError(f"{section['type']} encoder/decoder is not ported yet")


def _bottleneck(section: Optional[Dict[str, Any]]):
    if section is None:
        return None
    if section["type"] not in _BOTTLENECKS:
        raise NotImplementedError(f"{section['type']} bottleneck is not ported yet")
    cls, keys = _BOTTLENECKS[section["type"]]
    cfg = section.get("config", {})
    return cls(**{k: v for k, v in cfg.items() if keys is None or k in keys})


def create_autoencoder_from_config(config: Dict[str, Any], device: Device = None
                                   ) -> AudioAutoencoder:
    with resolve_device(device):
        return _autoencoder(config)


def _autoencoder(config: Dict[str, Any]) -> AudioAutoencoder:
    ae = config["model"]
    return AudioAutoencoder(
        encoder=(_tower(ae["encoder"], "in_channels", OobleckEncoder, SEANetEncoder,
                        DACEncoderWrapper) if "encoder" in ae else None),
        decoder=_tower(ae["decoder"], "out_channels", OobleckDecoder, SEANetDecoder,
                       DACDecoderWrapper),
        latent_dim=ae["latent_dim"],
        downsampling_ratio=ae["downsampling_ratio"],
        sample_rate=config["sample_rate"],
        io_channels=ae["io_channels"],
        bottleneck=_bottleneck(ae.get("bottleneck")),
        soft_clip=ae.get("soft_clip", False),
    )


# the public DAC architectures (JAX models/factory.py:215-222)
_DAC_ARCHS = {
    "44khz": dict(strides=[2, 4, 8, 8], dec_rates=[8, 8, 4, 2], n_codebooks=9, ratio=512),
    "24khz": dict(strides=[2, 4, 5, 8], dec_rates=[8, 5, 4, 2], n_codebooks=32, ratio=320),
    "16khz": dict(strides=[2, 4, 5, 8], dec_rates=[8, 5, 4, 2], n_codebooks=12, ratio=320),
}
# MusicGen's EnCodec (JAX :275-279)
_ENCODEC_ARCHS = {
    "facebook/encodec_32khz": dict(ratios=[8, 5, 4, 4], n_filters=64, dimension=128,
                                   num_quantizers=4, codebook_size=2048, channels=1),
}


def _dac_pretrained(cfg: Dict[str, Any], sample_rate: int,
                    on_card: bool) -> PretrainedCodecPretransform:
    """descript-audio-codec's DAC (JAX :207-265): the DAC towers and the DAC
    RVQ, `quantize_on_decode` and `chunked` on unless the config says not.
    `on_card`: it runs in bf16, as the card's snake kernels take bf16 alone
    (the JAX package runs it in f32; models/pretransforms.py)."""
    model_type = cfg.get("model_type", "44khz")
    if model_type in _DAC_ARCHS:
        arch = _DAC_ARCHS[model_type]
    elif "strides" in cfg:
        strides = list(cfg["strides"])
        arch = dict(strides=strides, dec_rates=cfg.get("dec_rates", strides[::-1]),
                    n_codebooks=cfg.get("n_codebooks", 9), ratio=math.prod(strides))
    else:
        raise ValueError(f"dac_pretrained model_type {model_type!r} is not one of "
                         f"{sorted(_DAC_ARCHS)}; for a custom DAC pass strides/dec_rates/"
                         "n_codebooks in the config instead")
    latent = cfg.get("latent_dim", 1024)
    n_codebooks = cfg.get("n_codebooks", arch["n_codebooks"])
    codebook_size = cfg.get("codebook_size", 1024)
    ae = _autoencoder({"sample_rate": sample_rate, "model": {
        "encoder": {"type": "dac", "config": {"in_channels": 1, "d_model": cfg.get("d_model", 64),
                                              "strides": arch["strides"]}},
        "decoder": {"type": "dac", "config": {"latent_dim": latent,
                                              "channels": cfg.get("channels", 1536),
                                              "rates": arch["dec_rates"], "out_channels": 1}},
        "bottleneck": {"type": "dac_rvq", "config": {
            "input_dim": latent, "n_codebooks": n_codebooks, "codebook_size": codebook_size,
            "codebook_dim": cfg.get("codebook_dim", 8),
            "quantize_on_decode": cfg.get("quantize_on_decode", True)}},
        "latent_dim": latent, "downsampling_ratio": arch["ratio"], "io_channels": 1}})
    return PretrainedCodecPretransform(ae, n_codebooks, codebook_size, cfg.get("ckpt_path"),
                                       scale=cfg.get("scale", 1.0),
                                       chunked=cfg.get("chunked", True), model_half=on_card)


def _audiocraft_pretrained(cfg: Dict[str, Any], sample_rate: int) -> PretrainedCodecPretransform:
    """MusicGen's EnCodec (JAX :266-327): SEANet towers (identity skips
    unless `true_skip` is false, `causal` as set) and the EMA RVQ; the
    encoder takes the ratios reversed."""
    model_type = cfg.get("model_type", "facebook/encodec_32khz")
    arch = _ENCODEC_ARCHS.get(model_type, dict(
        ratios=cfg.get("ratios", [8, 5, 4, 4]), n_filters=cfg.get("n_filters", 64),
        dimension=cfg.get("dimension", 128), num_quantizers=cfg.get("num_quantizers", 4),
        codebook_size=cfg.get("codebook_size", 2048), channels=cfg.get("channels", 1)))
    ratios = list(arch["ratios"])
    common = {"channels": arch["channels"], "dimension": arch["dimension"],
              "n_filters": arch["n_filters"], "n_residual_layers": 1, "dilation_base": 2,
              "lstm": 2, "norm": "weight_norm", "true_skip": cfg.get("true_skip", True),
              "causal": cfg.get("causal", False)}
    ae = _autoencoder({"sample_rate": sample_rate, "model": {
        "encoder": {"type": "seanet", "config": {**common, "ratios": ratios[::-1]}},
        "decoder": {"type": "seanet", "config": {**common, "ratios": ratios}},
        "bottleneck": {"type": "rvq", "config": {"dim": arch["dimension"],
                                                 "num_quantizers": arch["num_quantizers"],
                                                 "codebook_size": arch["codebook_size"]}},
        "latent_dim": arch["dimension"], "downsampling_ratio": math.prod(ratios),
        "io_channels": arch["channels"]}})
    return PretrainedCodecPretransform(ae, arch["num_quantizers"], arch["codebook_size"],
                                       cfg.get("ckpt_path"), scale=cfg.get("scale", 1.0))


def create_pretransform_from_config(config: Dict[str, Any], sample_rate: int,
                                    device: Device = None) -> nn.Module:
    """A pretransform config (JAX :154-341) -> the module, its parameters
    (the autoencoders' and codecs') on `device`."""
    p_type = config.get("type")
    enable_grad = config.get("enable_grad", False)
    device = resolve_device(device)
    with device:
        if p_type == "autoencoder":
            ae = _autoencoder({"model": config["config"], "sample_rate": sample_rate})
            return AutoencoderPretransform(ae, scale=config.get("scale", 1.0),
                                           model_half=config.get("model_half", False),
                                           chunked=config.get("chunked", False),
                                           iterate_batch=config.get("iterate_batch", False))
        if p_type == "dac_pretrained":
            return _dac_pretrained(config.get("config", {}), sample_rate,
                                   on_card=device.type == "cuda")
        if p_type == "audiocraft_pretrained":
            return _audiocraft_pretrained(config.get("config", {}), sample_rate)
    cfg = config.get("config", {})
    if p_type == "patched":
        return PatchedPretransform(cfg.get("patch_size", 1), cfg.get("io_channels", 2),
                                   enable_grad)
    if p_type == "wavelet":
        return WaveletPretransform(cfg["channels"], cfg["levels"], cfg["wavelet"], enable_grad)
    if p_type == "pqmf":
        return PQMFPretransform(**{k: cfg[k] for k in ("attenuation", "num_bands", "io_channels",
                                                       "encoded_channels") if k in cfg},
                                enable_grad=enable_grad)
    raise NotImplementedError(f"Unknown pretransform type: {p_type}")


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator,
                 skip: Sequence[nn.Module] = ()) -> nn.Module:
    """Re-draw every parameter from `generator`, but for the modules in
    `skip` and their children, e.g. a tower loaded from a checkpoint
    (deterministic random init for benchmarks and smoke runs; real weights
    are loaded instead):
    Linear / conv weights ~ N(0, 1/fan_in) (a transposed conv's fan-in: its
    input channels x taps / stride), biases 0, embeddings ~ N(0, 1), norm
    scales 1 (GroupNorm and the ADP LayerNorm biases 0), log-scale snake
    parameters 0, DAC's snake alpha 1,
    Fourier weights ~ N(0, 1), weight-norm g = ||v||, LSTM weights ~
    N(0, 1/fan_in) with zero biases, RVQ codebooks ~ N(0, 1) (and their EMA sums),
    LayerScale 1e-5, DynamicTanh alpha 10, gamma 1, beta 0, adaLN's
    scale / shift / gate ~ N(0, 1/dim) and memory tokens ~ N(0, 1); the
    HTSAT's 2-D convs ~ N(0, 1/fan_in), LayerNorms and BatchNorms 1 / 0
    (running mean 0, variance 1) and relative position tables ~ N(0, 0.02);
    as the JAX package initialises them."""
    from ..ops.activations import SnakeBeta
    from ..ops.conv import WNConv1d, WNConv2d, WNConvTranspose1d
    from ..ops.embeddings import FourierFeatures
    from ..ops.norms import BiasedLayerNorm, DynamicTanh, LayerNorm, LayerScale
    from ..ops.transformer import ContinuousTransformer, TransformerBlock
    from .bottleneck import ResidualVQ
    from .conditioners import LearnedPositionalEmbedding
    from .htsat import WindowAttention
    from .t5 import T5LayerNorm

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype,
                            device=generator.device) * std)

    kept = {id(c) for m in skip for c in m.modules()}
    for m in model.modules():
        if id(m) in kept:
            continue
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.ConvTranspose1d):
            normal_(m.weight, 1.0 / math.sqrt(m.weight.shape[0] * m.weight.shape[2]
                                              / m.stride[0]))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (WNConv1d, WNConvTranspose1d, WNConv2d)):
            normal_(m.weight_v, 1.0 / math.sqrt(m.weight_v[0].numel()))
            m.weight_g.copy_(torch.linalg.vector_norm(
                m.weight_v, dim=tuple(range(1, m.weight_v.dim())), keepdim=True))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.Embedding, FourierFeatures)):
            normal_(m.weight, 1.0)
        elif isinstance(m, LearnedPositionalEmbedding):
            normal_(m.weights, 1.0)
        elif isinstance(m, LayerNorm):
            m.gamma.fill_(1.0)
        elif isinstance(m, BiasedLayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Snake1d):
            m.alpha.fill_(1.0)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, WindowAttention):
            normal_(m.relative_position_bias_table, 0.02)
        elif isinstance(m, T5LayerNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, SnakeBeta):
            m.alpha.zero_()
            m.beta.zero_()
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("weight"):
                    normal_(p, 1.0 / math.sqrt(p.shape[1]))
                else:
                    p.zero_()
        elif isinstance(m, LayerScale):
            m.scale.fill_(1e-5)
        elif isinstance(m, DynamicTanh):
            m.alpha.fill_(10.0)
            m.gamma.fill_(1.0)
            m.beta.zero_()
        elif isinstance(m, TransformerBlock) and m.to_scale_shift_gate is not None:
            normal_(m.to_scale_shift_gate, m.to_scale_shift_gate.shape[0] ** -0.5 * 6 ** 0.5)
        elif isinstance(m, ContinuousTransformer) and m.num_memory_tokens:
            normal_(m.memory_tokens, 1.0)
        elif isinstance(m, ResidualVQ):
            normal_(m.codebooks, 1.0)
            m.ema_sums.copy_(m.codebooks)  # the trackers start from the codebook, as JAX's
    return model
