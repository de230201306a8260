"""JAX-package parameters -> the port's state_dict (numpy only).

Inputs are the JAX package's flax parameters as nested dicts of numpy arrays:
the `params` collection of a `ConditionedDiffusionModelWrapper` (a DiT,
SA-1.0's ADP `UNetCFG1d` or the plain `UNet1d`), of a
`DiffusionModelWrapper` (Dance Diffusion's DAU1d, whose port keeps the JAX
package's flat module names, the `UNet1d` or the DiT), of a
`DiffusionAutoencoder`, of an
`AudioLanguageModelWrapper` (with its codec's `quantizer_state` collection,
where the RVQ codebooks live), of an `AudioAutoencoder` or of an
`EncodecDiscriminator`, of ARC's discriminator heads and trainer state, of
the conditioners (`conditioner_state_dict`: the number, int, list and
phoneme tables, the projections, a conditioner's own pretransform), of the
HTSAT audio tower (`htsat_state_dict`, params and batch statistics), and
the frozen T5 tower's own params
(`T5Conditioner._t5.params`), which live outside it. The output is a flat
{name: numpy array} in the port's names, which are
the reference torch state-dict names (those io/torch_mapping.py and
io/checkpoints.py of the JAX package import), ready for
`model.load_state_dict({k: torch.from_numpy(v) ...})`.

Transforms:
- dense kernels [in, out] -> torch [out, in];
- WIO conv kernels [k, in, out] -> [out, in, k]; transposed-conv kernels
  [k, in, out] -> [in, out, k]; HWIO 2-D kernels [kh, kw, in, out] ->
  [out, in, kh, kw];
- weight norm: v as above, g -> [out, 1, 1] (transposed: [in, 1, 1]); the
  DAC quantizers' Dense projections become weight-norm 1 x 1 convs, v the
  kernel transposed and g = ||v|| per output channel;
- log-scale snake alpha / beta as they are, DAC's snake alpha [C] ->
  [1, C, 1]; GroupNorm and LayerNorm scale / bias -> weight / bias;
  embedding tables as they are;
- fused projections de-interleaved: the JAX package stores to_qkv / to_kv
  head-major ([h][q|k|v][dh]) and the GLU pairwise (x_0, g_0, x_1, ...);
  torch concatenates ([q|k|v], [x|gate]);
- flax `OptimizedLSTMCell`s (separate i / f / g / o kernels, the bias on the
  hidden side only) -> one `nn.LSTM` layer each: `weight_ih_l{n}` /
  `weight_hh_l{n}` stack the gates in torch's order i, f, g, o, `bias_hh_l{n}`
  takes the bias and `bias_ih_l{n}` is zero.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

StateDict = Dict[str, np.ndarray]


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def deinterleave_fused(kernel: np.ndarray, n_fused: int, dim_heads: int) -> np.ndarray:
    """[in, H*n*dh] head-major interleave -> [in, n*H*dh] concat."""
    din, dout = kernel.shape
    heads = dout // (n_fused * dim_heads)
    return kernel.reshape(din, heads, n_fused, dim_heads).transpose(0, 2, 1, 3).reshape(din, dout)


def deinterleave_glu(arr: np.ndarray) -> np.ndarray:
    """pairwise (x_0, g_0, x_1, g_1, ...) -> [x | gate] along the last axis."""
    inner = arr.shape[-1] // 2
    return arr.reshape(*arr.shape[:-1], inner, 2).swapaxes(-1, -2).reshape(*arr.shape[:-1], 2 * inner)


def dense(out: StateDict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _leaves(out: StateDict, name: str, p: Mapping) -> None:
    """Every leaf of p under `name` as it is (LayerNorm gamma, DynamicTanh,
    LayerScale)."""
    for key, value in p.items():
        out[f"{name}.{key}"] = _np(value)


def _glu(out: StateDict, name: str, proj: Mapping) -> None:
    out[f"{name}.proj.weight"] = deinterleave_glu(_np(proj["kernel"])).T
    if "bias" in proj:
        out[f"{name}.proj.bias"] = deinterleave_glu(_np(proj["bias"]))


def attention_state_dict(out: StateDict, name: str, p: Mapping, dim_heads: int) -> None:
    """A JAX `Attention`: the fused projections de-interleaved (a
    differential one's concat layout as it is), flax LayerNorm qk-norms'
    scale / bias -> weight / bias, DynamicTanh and feat_scale leaves as they
    are."""
    if "to_qkv" in p:
        k = _np(p["to_qkv"]["kernel"])
        differential = k.shape[1] == 5 * k.shape[0]
        out[f"{name}.to_qkv.weight"] = (k if differential else deinterleave_fused(k, 3, dim_heads)).T
    else:
        dense(out, f"{name}.to_q", p["to_q"])
        k = _np(p["to_kv"]["kernel"])
        differential = _np(p["to_q"]["kernel"]).shape[1] == 2 * _np(p["to_q"]["kernel"]).shape[0]
        out[f"{name}.to_kv.weight"] = (k if differential else deinterleave_fused(k, 2, dim_heads)).T
    dense(out, f"{name}.to_out", p["to_out"])
    for norm in ("q_norm", "k_norm"):
        if norm in p:
            if "scale" in p[norm]:
                _affine(out, f"{name}.{norm}", p[norm])
            else:
                _leaves(out, f"{name}.{norm}", p[norm])
    for key in ("lambda_dc", "lambda_hf"):
        if key in p:
            out[f"{name}.{key}"] = _np(p[key])


def transformer_block_state_dict(p: Mapping, prefix: str, dim_heads: int) -> StateDict:
    """A JAX `TransformerBlock` with any of its options (DynamicTanh norms,
    LayerScale, the conformer, qk-norm, the feed-forward's bias, adaLN's
    `to_scale_shift_gate`)."""
    out: StateDict = {}
    for name in ("pre_norm", "ff_norm", "cross_attend_norm", "self_attn_scale",
                 "cross_attn_scale", "conformer_scale", "ff_scale"):
        if name in p:
            _leaves(out, f"{prefix}.{name}", p[name])
    attention_state_dict(out, f"{prefix}.self_attn", p["self_attn"], dim_heads)
    if "cross_attn" in p:
        attention_state_dict(out, f"{prefix}.cross_attn", p["cross_attn"], dim_heads)
    _glu(out, f"{prefix}.ff.ff.0", p["ff"]["linear_in"]["proj"])
    dense(out, f"{prefix}.ff.ff.2", p["ff"]["linear_out"])
    if "conformer" in p:
        c, name = p["conformer"], f"{prefix}.conformer"
        _leaves(out, f"{name}.in_norm", c["in_norm"])
        _leaves(out, f"{name}.mid_norm", c["mid_norm"])
        dense(out, f"{name}.pointwise_conv", c["pointwise_conv"])
        dense(out, f"{name}.pointwise_conv_2", c["pointwise_conv_2"])
        _glu(out, f"{name}.glu", c["glu"]["proj"])
        out[f"{name}.depthwise_conv.weight"] = _np(c["depthwise_kernel"]).transpose(2, 1, 0)
    if "to_scale_shift_gate" in p:
        out[f"{prefix}.to_scale_shift_gate"] = _np(p["to_scale_shift_gate"])
    return out


def dit_state_dict(p: Mapping, dim_heads: int, prefix: str = "") -> StateDict:
    """DiffusionTransformer params -> port names (with `prefix`)."""
    out: StateDict = {f"{prefix}timestep_features.weight": _np(p["timestep_features"]["weight"])}
    dense(out, f"{prefix}to_timestep_embed.0", p["to_timestep_embed_0"])
    dense(out, f"{prefix}to_timestep_embed.2", p["to_timestep_embed_2"])
    for name in ("to_cond_embed", "to_global_embed", "to_prepend_embed"):
        if name in p:
            dense(out, f"{prefix}{name}.0", p[name]["0"])
            dense(out, f"{prefix}{name}.2", p[name]["2"])
    for name in ("preprocess_conv", "postprocess_conv"):
        out[f"{prefix}{name}.weight"] = _np(p[name]["kernel"]).transpose(2, 1, 0)
    tr = p["transformer"]
    for name in ("project_in", "project_out"):
        if name in tr:
            dense(out, f"{prefix}transformer.{name}", tr[name])
    if "memory_tokens" in tr:
        out[f"{prefix}transformer.memory_tokens"] = _np(tr["memory_tokens"])
    if "global_embed_0" in tr:  # adaLN's projection of the global condition
        dense(out, f"{prefix}transformer.global_embed.0", tr["global_embed_0"])
        dense(out, f"{prefix}transformer.global_embed.2", tr["global_embed_1"])
    i = 0
    while f"layers_{i}" in tr:
        out.update(transformer_block_state_dict(
            tr[f"layers_{i}"], f"{prefix}transformer.layers.{i}", dim_heads))
        i += 1
    return out


def wn_conv(out: StateDict, name: str, p: Mapping, transposed: bool = False) -> None:
    v = _np(p["v"])  # [k, in, out]
    out[f"{name}.weight_v"] = v.transpose(1, 2, 0) if transposed else v.transpose(2, 1, 0)
    out[f"{name}.weight_g"] = _np(p["g"]).reshape(-1, 1, 1)
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def snake(out: StateDict, name: str, p: Mapping) -> None:
    out[f"{name}.alpha"] = _np(p["alpha"])
    out[f"{name}.beta"] = _np(p["beta"])


def residual_unit(out: StateDict, name: str, p: Mapping) -> None:
    if "SnakeBeta_0" in p:  # an ELU unit has no activation parameters
        snake(out, f"{name}.layers.0", p["SnakeBeta_0"])
        snake(out, f"{name}.layers.2", p["SnakeBeta_1"])
    wn_conv(out, f"{name}.layers.1", p["conv1"])
    wn_conv(out, f"{name}.layers.3", p["conv2"])


def _n_blocks(p: Mapping) -> int:
    return sum(1 for k in p if k.startswith("block_"))


def _snake_if(out: StateDict, name: str, p: Mapping) -> None:
    if "SnakeBeta_0" in p:
        snake(out, name, p["SnakeBeta_0"])


def oobleck_decoder_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    out: StateDict = {}
    n = _n_blocks(p)
    wn_conv(out, f"{prefix}layers.0", p["conv_in"])
    for j in range(n):
        blk, name = p[f"block_{j}"], f"{prefix}layers.{j + 1}"
        _snake_if(out, f"{name}.layers.0", blk)
        wn_conv(out, f"{name}.layers.1", blk["up"], transposed=True)
        for i in range(3):
            residual_unit(out, f"{name}.layers.{i + 2}", blk[f"res_{i}"])
    _snake_if(out, f"{prefix}layers.{n + 1}", p)
    wn_conv(out, f"{prefix}layers.{n + 2}", p["conv_out"])
    return out


def oobleck_encoder_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    out: StateDict = {}
    n = _n_blocks(p)
    wn_conv(out, f"{prefix}layers.0", p["conv_in"])
    for j in range(n):
        blk, name = p[f"block_{j}"], f"{prefix}layers.{j + 1}"
        for i in range(3):
            residual_unit(out, f"{name}.layers.{i}", blk[f"res_{i}"])
        _snake_if(out, f"{name}.layers.3", blk)
        wn_conv(out, f"{name}.layers.4", blk["down"])
    _snake_if(out, f"{prefix}layers.{n + 1}", p)
    wn_conv(out, f"{prefix}layers.{n + 2}", p["conv_out"])
    return out


def taae_state_dict(p: Mapping, prefix: str = "", decoder: bool = False) -> StateDict:
    """A TAAEEncoder's or TAAEDecoder's params -> the port's (named after the
    JAX tree, models/autoencoders.py): block_{i} -> blocks.{i}, its
    transformer_{j} -> transformers.{j} (heads of min(128, width)), a
    decoder block's conv transposed; the snake, where `use_snake`, -> act."""
    out: StateDict = {}
    wn_conv(out, f"{prefix}conv_in", p["conv_in"])
    wn_conv(out, f"{prefix}conv_out", p["conv_out"])
    _snake_if(out, f"{prefix}act", p)
    for i in range(_n_blocks(p)):
        blk, name = p[f"block_{i}"], f"{prefix}blocks.{i}"
        j = 0
        while f"transformer_{j}" in blk:
            t = blk[f"transformer_{j}"]
            width = _np(t["pre_norm"]["gamma"]).shape[0]
            out.update(transformer_block_state_dict(t, f"{name}.transformers.{j}",
                                                    min(128, width)))
            j += 1
        wn_conv(out, f"{name}.conv", blk["conv"], transposed=decoder)
    return out


def lstm_state_dict(out: StateDict, name: str, p: Mapping) -> None:
    """SEANetLSTM params {lstm_0: cell, lstm_1: ...} -> `name`.weight_ih_l0 ..."""
    n = 0
    while f"lstm_{n}" in p:
        cell = p[f"lstm_{n}"]
        out[f"{name}.weight_ih_l{n}"] = np.concatenate(
            [_np(cell[g]["kernel"]).T for g in ("ii", "if", "ig", "io")])
        out[f"{name}.weight_hh_l{n}"] = np.concatenate(
            [_np(cell[g]["kernel"]).T for g in ("hi", "hf", "hg", "ho")])
        out[f"{name}.bias_hh_l{n}"] = np.concatenate(
            [_np(cell[g]["bias"]) for g in ("hi", "hf", "hg", "ho")])
        out[f"{name}.bias_ih_l{n}"] = np.zeros_like(out[f"{name}.bias_hh_l{n}"])
        n += 1


def _seanet_res(out: StateDict, name: str, p: Mapping) -> None:
    for conv in ("conv1", "conv2", "shortcut"):
        if conv in p:
            wn_conv(out, f"{name}.{conv}.conv", p[conv]["conv"])


def seanet_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """SEANetEncoder or SEANetDecoder params -> the port's (models/seanet.py)."""
    out: StateDict = {}
    wn_conv(out, f"{prefix}conv_in.conv", p["conv_in"]["conv"])
    wn_conv(out, f"{prefix}conv_out.conv", p["conv_out"]["conv"])
    if "lstm" in p:
        lstm_state_dict(out, f"{prefix}lstm.lstm", p["lstm"])
    i = 0
    while f"down_{i}" in p or f"up_{i}" in p:
        name = f"{prefix}blocks.{i}"
        if f"down_{i}" in p:
            wn_conv(out, f"{name}.down.conv", p[f"down_{i}"]["conv"])
        else:
            wn_conv(out, f"{name}.up.conv", p[f"up_{i}"]["conv"], transposed=True)
        j = 0
        while f"res_{i}_{j}" in p:
            _seanet_res(out, f"{name}.res.{j}", p[f"res_{i}_{j}"])
            j += 1
        i += 1
    return out


def _dac_unit(out: StateDict, name: str, p: Mapping) -> None:
    out[f"{name}.block.0.alpha"] = _np(p["Snake1d_0"]["alpha"]).reshape(1, -1, 1)
    wn_conv(out, f"{name}.block.1", p["conv1"])
    out[f"{name}.block.2.alpha"] = _np(p["Snake1d_1"]["alpha"]).reshape(1, -1, 1)
    wn_conv(out, f"{name}.block.3", p["conv2"])


def dac_encoder_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """JAX DACEncoder params -> the port's DACEncoderWrapper (models/dac.py):
    the tower under `encoder.block.*`, the Dense `proj_out` as a k = 1 conv."""
    out: StateDict = {}
    n = _n_blocks(p)
    tower = f"{prefix}encoder.block"
    wn_conv(out, f"{tower}.0", p["conv_in"])
    for j in range(n):
        blk, name = p[f"block_{j}"], f"{tower}.{j + 1}.block"
        for i in range(3):
            _dac_unit(out, f"{name}.{i}", blk[f"res_{i}"])
        out[f"{name}.3.alpha"] = _np(blk["Snake1d_0"]["alpha"]).reshape(1, -1, 1)
        wn_conv(out, f"{name}.4", blk["down"])
    out[f"{tower}.{n + 1}.alpha"] = _np(p["Snake1d_0"]["alpha"]).reshape(1, -1, 1)
    wn_conv(out, f"{tower}.{n + 2}", p["conv_out"])
    if "proj_out" in p:
        out[f"{prefix}proj_out.weight"] = _np(p["proj_out"]["kernel"]).T[:, :, None]
        out[f"{prefix}proj_out.bias"] = _np(p["proj_out"]["bias"])
    return out


def dac_decoder_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """JAX DACDecoder params -> the port's DACDecoderWrapper (`decoder.model.*`)."""
    out: StateDict = {}
    n = _n_blocks(p)
    tower = f"{prefix}decoder.model"
    wn_conv(out, f"{tower}.0", p["conv_in"])
    for j in range(n):
        blk, name = p[f"block_{j}"], f"{tower}.{j + 1}.block"
        out[f"{name}.0.alpha"] = _np(blk["Snake1d_0"]["alpha"]).reshape(1, -1, 1)
        wn_conv(out, f"{name}.1", blk["up"], transposed=True)
        for i in range(3):
            _dac_unit(out, f"{name}.{i + 2}", blk[f"res_{i}"])
    out[f"{tower}.{n + 1}.alpha"] = _np(p["Snake1d_0"]["alpha"]).reshape(1, -1, 1)
    wn_conv(out, f"{tower}.{n + 2}", p["conv_out"])
    return out


def _tower_state_dict(p: Mapping, prefix: str, oobleck, dac) -> StateDict:
    if "res_0_0" in p:
        return seanet_state_dict(p, prefix)
    if "conv" in p.get("block_0", {}):
        return taae_state_dict(p, prefix, decoder=oobleck is oobleck_decoder_state_dict)
    return dac(p, prefix) if "Snake1d_0" in p else oobleck(p, prefix)


def autoencoder_state_dict(p: Mapping, prefix: str = "",
                           quantizer_state: Optional[Mapping] = None) -> StateDict:
    """An AudioAutoencoder's params (Oobleck, TAAE, SEANet or DAC towers; a
    bottleneck's own parameters) -> the port's; `quantizer_state` (the
    autoencoder's collection of that name) brings the RVQ's state:
    `codebooks`, `ema_counts`, `ema_sums`, `initted`."""
    out: StateDict = {}
    if "encoder" in p:
        out.update(_tower_state_dict(p["encoder"], f"{prefix}encoder.",
                                     oobleck_encoder_state_dict, dac_encoder_state_dict))
    if "decoder" in p:
        out.update(_tower_state_dict(p["decoder"], f"{prefix}decoder.",
                                     oobleck_decoder_state_dict, dac_decoder_state_dict))
    if "bottleneck" in p:
        bottleneck_state_dict(out, f"{prefix}bottleneck", p["bottleneck"])
    if quantizer_state is not None:
        for name, value in quantizer_state["bottleneck"]["quantizer"].items():
            out[f"{prefix}bottleneck.quantizer.{name}"] = _np(value)
    return out


def dense_as_wn_conv(out: StateDict, name: str, p: Mapping) -> None:
    """A flax Dense [in, out] -> a weight-norm 1 x 1 conv: v [out, in, 1]
    (the kernel transposed), g = ||v|| per output channel [out, 1, 1]."""
    v = _np(p["kernel"]).T[:, :, None]
    out[f"{name}.weight_v"] = v
    out[f"{name}.weight_g"] = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(1, 2),
                                                                      keepdims=True)).astype(
        np.float32)
    out[f"{name}.bias"] = _np(p["bias"])


def bottleneck_state_dict(out: StateDict, name: str, p: Mapping) -> None:
    """A bottleneck's own parameters: the DAC RVQs' stages
    (`quantizer.quantizers_{i}`: in_proj / out_proj Dense -> weight-norm
    1 x 1 convs, the codebook -> `codebook.weight`); SoftNorm's
    scaling_factor, bias and noise_scaling_factor as they are."""
    stages = p.get("quantizer", {})
    if not stages:
        _leaves(out, name, p)
        return
    i = 0
    while f"quantizers_{i}" in stages:
        q, qn = stages[f"quantizers_{i}"], f"{name}.quantizer.quantizers.{i}"
        dense_as_wn_conv(out, f"{qn}.in_proj", q["in_proj"])
        dense_as_wn_conv(out, f"{qn}.out_proj", q["out_proj"])
        out[f"{qn}.codebook.weight"] = _np(q["codebook"])
        i += 1


def wn_conv2d(out: StateDict, name: str, p: Mapping) -> None:
    """JAX WNConv2d (v HWIO [kh, kw, in, out], g [out]) -> [out, in, kh, kw]."""
    out[f"{name}.weight_v"] = _np(p["v"]).transpose(3, 2, 0, 1)
    out[f"{name}.weight_g"] = _np(p["g"]).reshape(-1, 1, 1, 1)
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def encodec_discriminator_state_dict(params: Mapping, prefix: str = "") -> StateDict:
    """`params` of the JAX EncodecDiscriminator -> the port's
    (models/discriminators.py): scale i's conv_in, conv_0.., conv_pre_post
    become `convs.0..`, conv_post stays."""
    out: StateDict = {}
    scales = params["discriminators"]
    for i in range(sum(1 for k in scales if k.startswith("disc_"))):
        p, name = scales[f"disc_{i}"], f"{prefix}discriminators.discriminators.{i}"
        n_dil = sum(1 for k in p if k.startswith("conv_") and k[5:].isdigit())
        order = ["conv_in"] + [f"conv_{j}" for j in range(n_dil)] + ["conv_pre_post"]
        for j, key in enumerate(order):
            wn_conv2d(out, f"{name}.convs.{j}", p[key])
        wn_conv2d(out, f"{name}.conv_post", p["conv_post"])
    return out


def t5_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """Flax T5 encoder params -> Hugging Face torch names."""
    out: StateDict = {f"{prefix}shared.weight": _np(p["shared"]["embedding"])}
    enc = p["encoder"]
    for i, blk in sorted(((int(k), v) for k, v in enc["block"].items())):
        name = f"{prefix}encoder.block.{i}.layer"
        attn, ff = blk["layer"]["0"], blk["layer"]["1"]
        out[f"{name}.0.layer_norm.weight"] = _np(attn["layer_norm"]["weight"])
        for w in ("q", "k", "v", "o"):
            out[f"{name}.0.SelfAttention.{w}.weight"] = _np(attn["SelfAttention"][w]["kernel"]).T
        if "relative_attention_bias" in attn["SelfAttention"]:
            out[f"{name}.0.SelfAttention.relative_attention_bias.weight"] = _np(
                attn["SelfAttention"]["relative_attention_bias"]["embedding"])
        out[f"{name}.1.layer_norm.weight"] = _np(ff["layer_norm"]["weight"])
        for w, v in ff["DenseReluDense"].items():
            out[f"{name}.1.DenseReluDense.{w}.weight"] = _np(v["kernel"]).T
    out[f"{prefix}encoder.final_layer_norm.weight"] = _np(enc["final_layer_norm"]["weight"])
    return out


def roberta_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """Flax RoBERTa params (`FlaxRobertaModel.params`, the JAX package's CLAP
    text tower) -> Hugging Face torch names, which models/roberta.py uses:
    the tree's paths joined with dots, `kernel` -> `weight` transposed,
    `embedding` and LayerNorm `scale` -> `weight`."""
    out: StateDict = {}

    def walk(node: Mapping, path: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{path}{key}.")
            elif key == "kernel":
                out[f"{path}weight"] = _np(value).T
            else:
                out[f"{path}{'bias' if key == 'bias' else 'weight'}"] = _np(value)

    walk(p, prefix)
    return out


def _adp_conv(out: StateDict, name: str, p: Mapping, transposed: bool = False) -> None:
    k = _np(p["kernel"])  # [k, in, out]
    out[f"{name}.weight"] = k.transpose(1, 2, 0) if transposed else k.transpose(2, 1, 0)
    out[f"{name}.bias"] = _np(p["bias"])


def _affine(out: StateDict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])


def _adp_resnet(out: StateDict, name: str, p: Mapping) -> None:
    for blk in ("block1", "block2"):
        if "groupnorm" in p[blk]:
            _affine(out, f"{name}.{blk}.groupnorm", p[blk]["groupnorm"])
        _adp_conv(out, f"{name}.{blk}.project", p[blk]["project"])
    if "to_scale_shift" in p:
        dense(out, f"{name}.to_scale_shift.to_scale_shift.1", p["to_scale_shift"])
    if "to_out" in p:
        _adp_conv(out, f"{name}.to_out", p["to_out"])


def _adp_attention(out: StateDict, name: str, p: Mapping) -> None:
    _affine(out, f"{name}.norm", p["norm"])
    _affine(out, f"{name}.norm_context", p["norm_context"])
    dense(out, f"{name}.to_q", p["to_q"])
    dense(out, f"{name}.to_kv", p["to_kv"])
    dense(out, f"{name}.attention.to_out", p["to_out"])


def _adp_transformer(out: StateDict, name: str, p: Mapping) -> None:
    _affine(out, f"{name}.to_in.0", p["norm_in"])
    _adp_conv(out, f"{name}.to_in.1", p["conv_in"])
    _adp_conv(out, f"{name}.to_out.1", p["conv_out"])
    i = 0
    while f"block_{i}" in p:
        blk, bname = p[f"block_{i}"], f"{name}.blocks.{i}"
        _adp_attention(out, f"{bname}.attention", blk["attention"])
        if "cross_attention" in blk:
            _adp_attention(out, f"{bname}.cross_attention", blk["cross_attention"])
        dense(out, f"{bname}.feed_forward.0", blk["ff1"])
        dense(out, f"{bname}.feed_forward.2", blk["ff2"])
        i += 1


def _adp_tpe(out: StateDict, name: str, p: Mapping) -> None:
    out[f"{name}.0.weights"] = _np(p["weights"])
    dense(out, f"{name}.1", p["to_out"])


def adp_unet_state_dict(u: Mapping, prefix: str = "") -> StateDict:
    """`params` of the JAX UNet1d -> the port's UNet1d (models/adp.py), the
    reference layout: conv kernels [k, in, out] -> [out, in, k] (transposed
    convs [in, out, k])."""
    out: StateDict = {}
    if "to_time" in u:
        _adp_tpe(out, f"{prefix}to_time.0", u["to_time"])
    if "to_features" in u:
        dense(out, f"{prefix}to_features.0", u["to_features"])
    if "to_mapping_0" in u:
        dense(out, f"{prefix}to_mapping.0", u["to_mapping_0"])
        dense(out, f"{prefix}to_mapping.2", u["to_mapping_2"])
    _adp_resnet(out, f"{prefix}to_in.block", u["to_in"]["block"])
    _adp_resnet(out, f"{prefix}to_out.block", u["to_out"]["block"])
    for stack in ("downsamples", "upsamples"):
        i = 0
        while f"{stack}_{i}" in u:
            blk, name = u[f"{stack}_{i}"], f"{prefix}{stack}.{i}"
            j = 0
            while f"block_{j}" in blk:
                _adp_resnet(out, f"{name}.blocks.{j}", blk[f"block_{j}"])
                j += 1
            if "transformer" in blk:
                _adp_transformer(out, f"{name}.transformer", blk["transformer"])
            if "downsample" in blk:
                _adp_conv(out, f"{name}.downsample", blk["downsample"])
            if "upsample" in blk:
                # transposed (k = 2 x factor) but at factor 1, a k = 3 conv
                # (the port refuses the nearest-neighbour upsampling)
                up = blk["upsample"]
                _adp_conv(out, f"{name}.upsample", up,
                          transposed=_np(up["kernel"]).shape[0] % 2 == 0)
            i += 1
    bott = u["bottleneck"]
    _adp_resnet(out, f"{prefix}bottleneck.pre_block", bott["pre_block"])
    _adp_resnet(out, f"{prefix}bottleneck.post_block", bott["post_block"])
    if "transformer" in bott:
        _adp_transformer(out, f"{prefix}bottleneck.transformer", bott["transformer"])
    return out


def adp_unet_cfg_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """`params` of the JAX UNetCFG1d ({"unet": UNet1d, "fixed_embedding"})
    -> the port's UNetCFG1d: `adp_unet_state_dict` and the null context."""
    out = adp_unet_state_dict(p["unet"], prefix)
    out[f"{prefix}fixed_embedding.embedding.weight"] = _np(p["fixed_embedding"])
    return out


def conditioner_state_dict(mod: Mapping, prefix: str, own_pretransform: bool = False
                           ) -> StateDict:
    """One conditioner's flax params (`modules_<id>` of the JAX bank) -> the
    port's under `prefix`: the number embedder, the int / list / phoneme
    tables, the T5 / CLAP / phoneme / pretransform `proj_out`, the source
    mix's `proj`, and with `own_pretransform` the conditioner's own
    pretransform (`pretransform.model.*`; a conditioner on the model's
    pretransform holds none, and the JAX package's copy of it is dropped)."""
    out: StateDict = {}
    emb = mod.get("embedder")
    if emb is not None and "weights" in emb:  # NumberConditioner
        out[f"{prefix}embedder.embedding.0.weights"] = _np(emb["weights"])
        dense(out, f"{prefix}embedder.embedding.1", emb["to_out"])
    elif emb is not None:  # ListConditioner
        out[f"{prefix}embedder.weight"] = _np(emb["embedding"])
    for table in ("int_embedder", "phoneme_embedder"):
        if table in mod:
            out[f"{prefix}{table}.weight"] = _np(mod[table]["embedding"])
    proj = mod.get("proj")
    if proj is not None and "proj_out" in proj:
        dense(out, f"{prefix}proj_out", proj["proj_out"])
    elif proj is not None:  # SourceMixConditioner's Dense
        dense(out, f"{prefix}proj", proj)
    if own_pretransform and "pretransform" in mod:
        out.update(autoencoder_state_dict(mod["pretransform"]["model"],
                                          f"{prefix}pretransform.model."))
    return out


def htsat_state_dict(variables: Mapping, prefix: str = "") -> StateDict:
    """The JAX HTSAT's variables (`params` and `batch_stats`) -> laion-clap's
    names under `prefix` (the inverse of JAX `import_htsat`,
    models/htsat.py:438): LayerNorm scale -> weight, Dense and 2-D conv
    kernels transposed, BatchNorm mean / var -> running_mean / running_var."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: StateDict = {}

    def bn(name: str, p: Mapping, st: Mapping) -> None:
        out[f"{name}.weight"], out[f"{name}.bias"] = _np(p["scale"]), _np(p["bias"])
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = _np(st["mean"]), _np(st["var"])

    def conv2d(name: str, p: Mapping) -> None:
        out[f"{name}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
        out[f"{name}.bias"] = _np(p["bias"])

    bn(f"{prefix}bn0", params["bn0"], stats["bn0"])
    pe = params["patch_embed"]
    conv2d(f"{prefix}patch_embed.proj", pe["proj"])
    _affine(out, f"{prefix}patch_embed.norm", pe["norm"])
    if "mel_conv2d" in pe:
        conv2d(f"{prefix}patch_embed.mel_conv2d", pe["mel_conv2d"])
        fm, fst = pe["fusion_model"], stats["patch_embed"]["fusion_model"]
        for ours, theirs, off in (("local", "local_att", 0), ("global", "global_att", 1)):
            name = f"{prefix}patch_embed.fusion_model.{theirs}"
            conv2d(f"{name}.{off}", fm[f"{ours}_conv1"])
            bn(f"{name}.{off + 1}", fm[f"{ours}_bn1"], fst[f"{ours}_bn1"])
            conv2d(f"{name}.{off + 3}", fm[f"{ours}_conv2"])
            bn(f"{name}.{off + 4}", fm[f"{ours}_bn2"], fst[f"{ours}_bn2"])
    i = 0
    while f"layers_{i}" in params:
        layer, name = params[f"layers_{i}"], f"{prefix}layers.{i}"
        j = 0
        while f"blocks_{j}" in layer:
            b, bname = layer[f"blocks_{j}"], f"{name}.blocks.{j}"
            _affine(out, f"{bname}.norm1", b["norm1"])
            _affine(out, f"{bname}.norm2", b["norm2"])
            dense(out, f"{bname}.attn.qkv", b["attn"]["qkv"])
            dense(out, f"{bname}.attn.proj", b["attn"]["proj"])
            out[f"{bname}.attn.relative_position_bias_table"] = _np(
                b["attn"]["relative_position_bias_table"])
            dense(out, f"{bname}.mlp.fc1", b["mlp"]["fc1"])
            dense(out, f"{bname}.mlp.fc2", b["mlp"]["fc2"])
            j += 1
        if "downsample" in layer:
            _affine(out, f"{name}.downsample.norm", layer["downsample"]["norm"])
            dense(out, f"{name}.downsample.reduction", layer["downsample"]["reduction"])
        i += 1
    _affine(out, f"{prefix}norm", params["norm"])
    return out


def diffusion_cond_state_dict(params: Mapping, dim_heads: int = 64,
                              t5_params: Optional[Mapping[str, Mapping]] = None,
                              roberta_params: Optional[Mapping[str, Mapping]] = None,
                              htsat_variables: Optional[Mapping[str, Mapping]] = None,
                              own_pretransform_ids: tuple = ()) -> StateDict:
    """`params` of a ConditionedDiffusionModelWrapper (a DiT with heads of
    `dim_heads`, or an ADP UNetCFG1d) -> the port's
    ConditionedDiffusionModelWrapper state_dict. `t5_params` maps a T5
    conditioner id to its tower's flax params, `roberta_params` a CLAP text
    conditioner id to its RoBERTa tower's, `htsat_variables` a CLAP audio
    conditioner id to its HTSAT's variables; the CLAP joint-space
    projections (`text_projection`, `audio_projection`) are part of none and
    keep what the port's conditioner loaded from the CLAP checkpoint. The
    pretransform / source-mix conditioners in `own_pretransform_ids` carry
    their own pretransform (`conditioner_state_dict`). The others share the
    model's: flax binds the one pretransform module to the conditioner bank
    that meets it first, so its params may lie there and not under
    `pretransform`; they become the port's `pretransform.model.*` either
    way."""
    out = diffusion_model_state_dict(params["model"], dim_heads, "model.model.")
    shared = params.get("pretransform")
    for key, mod in params.get("conditioner", {}).items():
        cid = key[len("modules_"):]
        out.update(conditioner_state_dict(mod, f"conditioner.conditioners.{cid}.",
                                          cid in own_pretransform_ids))
        if cid not in own_pretransform_ids and shared is None:
            shared = mod.get("pretransform")
    if shared is not None:
        out.update(autoencoder_state_dict(shared["model"], "pretransform.model."))
    for cid, p in (t5_params or {}).items():
        out.update(t5_state_dict(p, f"conditioner.conditioners.{cid}.model."))
    for cid, p in (roberta_params or {}).items():
        out.update(roberta_state_dict(p, f"conditioner.conditioners.{cid}.model."))
    for cid, v in (htsat_variables or {}).items():
        out.update(htsat_state_dict(v, f"conditioner.conditioners.{cid}.audio_branch."))
    return out


def diffusion_model_state_dict(inner: Mapping, dim_heads: int = 64,
                               prefix: str = "model.model.") -> StateDict:
    """A wrapper's diffusion model (`{"dit": ...}`, `{"unet": UNetCFG1d}`,
    `{"unet": UNet1d}` or `{"unet": DiffusionAttnUnet1D}`) -> the port's
    names under `prefix`."""
    if "dit" in inner:
        return dit_state_dict(inner["dit"], dim_heads, prefix=prefix)
    u = inner["unet"]
    if "fixed_embedding" in u:
        return adp_unet_cfg_state_dict(u, prefix)
    if "timestep_embed" in u:
        return dance_unet_state_dict(u, prefix)
    return adp_unet_state_dict(u, prefix)


def _pop_conv(out: StateDict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _np(p.pop("kernel")).transpose(2, 1, 0)
    if "bias" in p:
        out[f"{name}.bias"] = _np(p.pop("bias"))


def _pop_group_norm(out: StateDict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _np(p.pop("scale"))
    out[f"{name}.bias"] = _np(p.pop("bias"))


def dance_unet_state_dict(params: Mapping, prefix: str = "") -> StateDict:
    """`params` of a DiffusionAttnUnet1D -> the port's (the same module
    names): conv kernels [k, in, out] -> [out, in, k], GroupNorm scale ->
    weight, the Fourier timestep weight as it is. Every leaf is used once;
    a leaf the map does not know raises."""
    p = {name: {sub: dict(leaves) if isinstance(leaves, Mapping) else leaves
                for sub, leaves in mod.items()} for name, mod in params.items()}
    out: StateDict = {}
    for name, mod in p.items():
        pfx = f"{prefix}{name}"
        if name in ("timestep_embed", "aug_embed"):  # FourierFeatures
            out[f"{pfx}.weight"] = _np(mod.pop("weight"))
        elif "qkv_proj" in mod:  # SelfAttention1d
            _pop_group_norm(out, f"{pfx}.norm", mod["norm"])
            _pop_conv(out, f"{pfx}.qkv_proj", mod["qkv_proj"])
            _pop_conv(out, f"{pfx}.out_proj", mod["out_proj"])
        elif "conv1" in mod:  # ResConvBlock
            for conv in ("conv1", "conv2", "skip"):
                if conv in mod:
                    _pop_conv(out, f"{pfx}.{conv}", mod[conv])
            for norm in ("norm1", "norm2"):
                if norm in mod:
                    _pop_group_norm(out, f"{pfx}.{norm}", mod[norm])
    left = [f"{name}/{sub}/{leaf}" for name, mod in p.items() for sub, leaves in mod.items()
            for leaf in (leaves if isinstance(leaves, Mapping) else [sub])]
    if left:
        raise ValueError(f"DAU1d parameters the map does not use: {left}")
    return out


def diffusion_uncond_state_dict(params: Mapping, dim_heads: int = 64) -> StateDict:
    """`params` of a DiffusionModelWrapper (DAU1d; the ADP UNet1d under
    `UNet1DUncondWrapper`; the DiT under `DiTUncondWrapper`, heads of
    `dim_heads`; and its pretransform where it has one) -> the port's
    DiffusionModelWrapper state_dict."""
    model = params["model"]
    if "unet" in model or "dit" in model:
        out = diffusion_model_state_dict(model, dim_heads, "model.model.")
    else:
        out = dance_unet_state_dict(model, prefix="model.")
    if "pretransform" in params:
        out.update(autoencoder_state_dict(params["pretransform"]["model"], "pretransform.model."))
    return out


def diffusion_ae_state_dict(params: Mapping, dim_heads: int = 64) -> StateDict:
    """`params` of a DiffusionAutoencoder (its encoder / decoder towers,
    bottleneck, diffusion model and pretransform) -> the port's
    (models/diffusion_ae.py): `encoder.*`, `decoder.*`, `bottleneck.*`,
    `diffusion.model.*`, `pretransform.model.*`."""
    out = autoencoder_state_dict({k: v for k, v in params.items()
                                  if k in ("encoder", "decoder", "bottleneck")})
    out.update(diffusion_model_state_dict(params["diffusion"], dim_heads, "diffusion.model."))
    if "pretransform" in params:
        out.update(autoencoder_state_dict(params["pretransform"]["model"], "pretransform.model."))
    return out


def audio_lm_state_dict(params: Mapping, dim_heads: int,
                        quantizer_state: Optional[Mapping] = None,
                        t5_params: Optional[Mapping[str, Mapping]] = None) -> StateDict:
    """`params` of an AudioLanguageModelWrapper (and its `quantizer_state`
    collection) -> the port's AudioLanguageModelWrapper state_dict: the LM
    (`lm.embeds.{i}`, `lm.quantizer_heads.{i}`, `lm.backbone.*`), the codec
    (`pretransform.model.*`, its RVQ codebooks from `quantizer_state`) and,
    per T5 conditioner id in `t5_params`, its tower."""
    lm = params["lm"]
    out: StateDict = {}
    i = 0
    while f"embeds_{i}" in lm:
        out[f"lm.embeds.{i}.weight"] = _np(lm[f"embeds_{i}"]["embedding"])
        dense(out, f"lm.quantizer_heads.{i}", lm[f"quantizer_heads_{i}"])
        i += 1
    bb = lm["backbone"]
    for name in ("to_cross_attn_embed", "to_prepend_embed"):
        if name in bb:
            dense(out, f"lm.backbone.{name}", bb[name])
    tr = bb["transformer"]
    i = 0
    while f"layers_{i}" in tr:
        out.update(transformer_block_state_dict(
            tr[f"layers_{i}"], f"lm.backbone.transformer.layers.{i}", dim_heads))
        i += 1
    if "pretransform" in params:
        qs = quantizer_state["pretransform"]["model"] if quantizer_state is not None else None
        out.update(autoencoder_state_dict(params["pretransform"]["model"],
                                          "pretransform.model.", qs))
    for cid, p in (t5_params or {}).items():
        out.update(t5_state_dict(p, f"conditioner.conditioners.{cid}.model."))
    return out


def conv_discriminator_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """ARC's ConvDiscriminator head: conv_{i} / norm_{i} -> convs.{i} /
    norms.{i} (GroupNorm scale -> weight), conv_out as it is."""
    out: StateDict = {}
    for i in range(4):
        dense_conv = p[f"conv_{i}"]
        out[f"{prefix}convs.{i}.weight"] = _np(dense_conv["kernel"]).transpose(2, 1, 0)
        out[f"{prefix}convs.{i}.bias"] = _np(dense_conv["bias"])
        out[f"{prefix}norms.{i}.weight"] = _np(p[f"norm_{i}"]["scale"])
        out[f"{prefix}norms.{i}.bias"] = _np(p[f"norm_{i}"]["bias"])
    out[f"{prefix}conv_out.weight"] = _np(p["conv_out"]["kernel"]).transpose(2, 1, 0)
    out[f"{prefix}conv_out.bias"] = _np(p["conv_out"]["bias"])
    return out


def convnext_encoder_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """ConvNeXtEncoder: stage_{i}.block_{j} -> stages.{i}.blocks.{j}; the
    depthwise `dw_kernel` [k, 1, C] -> dw_conv [C, 1, k]; weight-normalised
    convs (g, v) and the plain proj_down as elsewhere."""
    out: StateDict = {}
    wn_conv(out, f"{prefix}conv_in", p["conv_in"])
    wn_conv(out, f"{prefix}conv_out", p["conv_out"])
    i = 0
    while f"stage_{i}" in p:
        stage, name = p[f"stage_{i}"], f"{prefix}stages.{i}"
        wn_conv(out, f"{name}.downsample", stage["downsample"])
        j = 0
        while f"block_{j}" in stage:
            block, bname = stage[f"block_{j}"], f"{name}.blocks.{j}"
            out[f"{bname}.dw_conv"] = _np(block["dw_kernel"]).transpose(2, 1, 0)
            wn_conv(out, f"{bname}.proj_up", block["proj_up"])
            out[f"{bname}.proj_down.weight"] = _np(block["proj_down"]["kernel"]).transpose(2, 1, 0)
            out[f"{bname}.proj_down.bias"] = _np(block["proj_down"]["bias"])
            j += 1
        i += 1
    return out


def arc_head_state_dict(p: Mapping) -> StateDict:
    """Either ARC head's params -> the port head's state_dict."""
    if "encoder" in p:
        return convnext_encoder_state_dict(p["encoder"], "encoder.")
    return conv_discriminator_state_dict(p)


def arc_state_dicts(state, dim_heads: int = 64) -> Dict[str, StateDict]:
    """A JAX `ARCTrainState` (or anything with its fields) -> the port
    trainer's {"model", "discriminator", "head", "ema"} state dicts (the EMA
    under the student's names)."""
    out = {"model": diffusion_cond_state_dict(state.gen_params, dim_heads),
           "discriminator": diffusion_cond_state_dict(state.disc_params, dim_heads),
           "head": arc_head_state_dict(state.head_params)}
    if getattr(state, "ema_params", None) is not None:
        out["ema"] = diffusion_cond_state_dict(state.ema_params, dim_heads)
    return out
