"""Config-driven factories; counterpart of stable_audio_tools_tpu/models/factory.py.

The JSON model config is the public API: the shipped
`stable_audio_open_1_0.json`, `stable_audio_2_0.json`,
`autoencoders/stable_audio_2_0_vae.json`, `autoencoders/encodec_musicgen_rvq.json`
`lm/musicgen_small_rvq.json`, the four `dance_diffusion/*.json`,
`txt2audio/stable_audio_1_0.json`, `autoencoders/stable_audio_1_0_vae.json`
and `autoencoders/dac_2048_32_vae.json` build unchanged.
Built: `diffusion_cond` and `diffusion_cond_inpaint` (DiT; `diffusion_cond`
also on the ADP `UNetCFG1d`, models/adp.py), `diffusion_uncond` (Dance
Diffusion's DAU1d), `lm` (the MusicGen-style token LM, models/lm.py),
`autoencoder` (Oobleck, SEANet or DAC encoder and decoder; VAE or RVQ
bottleneck) and the `autoencoder` pretransform; other types raise
NotImplementedError.

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

from .autoencoders import AudioAutoencoder, OobleckDecoder, OobleckEncoder
from .bottleneck import RVQBottleneck, VAEBottleneck
from .dac import DACDecoderWrapper, DACEncoderWrapper, Snake1d
from .pretransforms import AutoencoderPretransform
from .seanet import SEANetDecoder, SEANetEncoder

_OOBLECK_KEYS = ("channels", "latent_dim", "c_mults", "strides", "use_snake")
_SEANET_KEYS = ("channels", "dimension", "n_filters", "ratios", "n_residual_layers",
                "dilation_base", "norm", "lstm", "kernel_size", "last_kernel_size",
                "residual_kernel_size", "causal", "pad_mode", "true_skip", "compress")
# the JAX factory's DAC keyword arguments (models/factory.py:75, :107), the
# decoder's under their reference names
_DAC_ENCODER_KEYS = ("d_model", "strides", "d_latent", "latent_dim", "in_channels")
_DAC_DECODER_KEYS = {"latent_dim": "input_channel", "channels": "channels", "rates": "rates",
                     "out_channels": "d_out", "final_tanh": "final_tanh"}
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
    raise NotImplementedError(f"model type {model_type} is not ported yet")


def create_model_from_config_path(path: str, device: Device = None) -> nn.Module:
    with open(path) as f:
        return create_model_from_config(json.load(f), device)


def _oobleck(section: Dict[str, Any], io_key: str, cls):
    cfg = section.get("config", {})
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


def _tower(section: Dict[str, Any], io_key: str, oobleck, seanet, dac):
    if section["type"] == "oobleck":
        return _oobleck(section, io_key, oobleck)
    if section["type"] == "seanet":
        return _seanet(section, seanet)
    if section["type"] == "dac":
        return _dac(section, dac)
    raise NotImplementedError(f"{section['type']} encoder/decoder is not ported yet")


def _bottleneck(section: Optional[Dict[str, Any]]):
    if section is None:
        return None
    if section["type"] == "vae":
        return VAEBottleneck()
    if section["type"] == "rvq":
        return RVQBottleneck(**section.get("config", {}))
    raise NotImplementedError(f"{section['type']} bottleneck is not ported yet")


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


def create_pretransform_from_config(config: Dict[str, Any], sample_rate: int,
                                    device: Device = None) -> AutoencoderPretransform:
    if config["type"] != "autoencoder":
        raise NotImplementedError(f"{config['type']} pretransform is not ported yet")
    ae = create_autoencoder_from_config({"model": config["config"], "sample_rate": sample_rate},
                                        device)
    return AutoencoderPretransform(ae, scale=config.get("scale", 1.0),
                                   model_half=config.get("model_half", False),
                                   chunked=config.get("chunked", False),
                                   iterate_batch=config.get("iterate_batch", False))


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
    N(0, 1/fan_in) with zero biases, RVQ codebooks ~ N(0, 1) (and their EMA sums)."""
    from ..ops.activations import SnakeBeta
    from ..ops.conv import WNConv1d, WNConv2d, WNConvTranspose1d
    from ..ops.embeddings import FourierFeatures
    from ..ops.norms import BiasedLayerNorm, LayerNorm
    from .bottleneck import ResidualVQ
    from .conditioners import LearnedPositionalEmbedding
    from .t5 import T5LayerNorm

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype,
                            device=generator.device) * std)

    kept = {id(c) for m in skip for c in m.modules()}
    for m in model.modules():
        if id(m) in kept:
            continue
        if isinstance(m, (nn.Linear, nn.Conv1d)):
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
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
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
        elif isinstance(m, ResidualVQ):
            normal_(m.codebooks, 1.0)
            m.ema_sums.copy_(m.codebooks)  # the trackers start from the codebook, as JAX's
    return model
