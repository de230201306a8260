"""JAX-package parameters -> the port's state_dict (numpy only).

Inputs are the JAX package's flax parameters as nested dicts of numpy arrays:
the `params` collection of a `ConditionedDiffusionModelWrapper` (a DiT or
SA-1.0's ADP `UNetCFG1d`), of a
`DiffusionModelWrapper` (Dance Diffusion's DAU1d, whose port keeps the JAX
package's flat module names), of an
`AudioLanguageModelWrapper` (with its codec's `quantizer_state` collection,
where the RVQ codebooks live), of an `AudioAutoencoder` or of an
`EncodecDiscriminator`, and the frozen T5 tower's own params
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
- weight norm: v as above, g -> [out, 1, 1] (transposed: [in, 1, 1]);
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


def transformer_block_state_dict(p: Mapping, prefix: str, dim_heads: int) -> StateDict:
    out: StateDict = {}
    out[f"{prefix}.pre_norm.gamma"] = _np(p["pre_norm"]["gamma"])
    out[f"{prefix}.ff_norm.gamma"] = _np(p["ff_norm"]["gamma"])
    out[f"{prefix}.self_attn.to_qkv.weight"] = deinterleave_fused(
        _np(p["self_attn"]["to_qkv"]["kernel"]), 3, dim_heads).T
    dense(out, f"{prefix}.self_attn.to_out", p["self_attn"]["to_out"])
    if "cross_attn" in p:
        out[f"{prefix}.cross_attend_norm.gamma"] = _np(p["cross_attend_norm"]["gamma"])
        dense(out, f"{prefix}.cross_attn.to_q", p["cross_attn"]["to_q"])
        out[f"{prefix}.cross_attn.to_kv.weight"] = deinterleave_fused(
            _np(p["cross_attn"]["to_kv"]["kernel"]), 2, dim_heads).T
        dense(out, f"{prefix}.cross_attn.to_out", p["cross_attn"]["to_out"])
    proj = p["ff"]["linear_in"]["proj"]
    out[f"{prefix}.ff.ff.0.proj.weight"] = deinterleave_glu(_np(proj["kernel"])).T
    if "bias" in proj:
        out[f"{prefix}.ff.ff.0.proj.bias"] = deinterleave_glu(_np(proj["bias"]))
    dense(out, f"{prefix}.ff.ff.2", p["ff"]["linear_out"])
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
    snake(out, f"{name}.layers.0", p["SnakeBeta_0"])
    wn_conv(out, f"{name}.layers.1", p["conv1"])
    snake(out, f"{name}.layers.2", p["SnakeBeta_1"])
    wn_conv(out, f"{name}.layers.3", p["conv2"])


def _n_blocks(p: Mapping) -> int:
    return sum(1 for k in p if k.startswith("block_"))


def oobleck_decoder_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    out: StateDict = {}
    n = _n_blocks(p)
    wn_conv(out, f"{prefix}layers.0", p["conv_in"])
    for j in range(n):
        blk, name = p[f"block_{j}"], f"{prefix}layers.{j + 1}"
        snake(out, f"{name}.layers.0", blk["SnakeBeta_0"])
        wn_conv(out, f"{name}.layers.1", blk["up"], transposed=True)
        for i in range(3):
            residual_unit(out, f"{name}.layers.{i + 2}", blk[f"res_{i}"])
    snake(out, f"{prefix}layers.{n + 1}", p["SnakeBeta_0"])
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
        snake(out, f"{name}.layers.3", blk["SnakeBeta_0"])
        wn_conv(out, f"{name}.layers.4", blk["down"])
    snake(out, f"{prefix}layers.{n + 1}", p["SnakeBeta_0"])
    wn_conv(out, f"{prefix}layers.{n + 2}", p["conv_out"])
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
    return dac(p, prefix) if "Snake1d_0" in p else oobleck(p, prefix)


def autoencoder_state_dict(p: Mapping, prefix: str = "",
                           quantizer_state: Optional[Mapping] = None) -> StateDict:
    """An AudioAutoencoder's params (Oobleck, SEANet or DAC towers) -> the port's;
    `quantizer_state` (the autoencoder's collection of that name) brings the
    RVQ's state: `codebooks`, `ema_counts`, `ema_sums`, `initted`."""
    out: StateDict = {}
    if "encoder" in p:
        out.update(_tower_state_dict(p["encoder"], f"{prefix}encoder.",
                                     oobleck_encoder_state_dict, dac_encoder_state_dict))
    if "decoder" in p:
        out.update(_tower_state_dict(p["decoder"], f"{prefix}decoder.",
                                     oobleck_decoder_state_dict, dac_decoder_state_dict))
    if quantizer_state is not None:
        for name, value in quantizer_state["bottleneck"]["quantizer"].items():
            out[f"{prefix}bottleneck.quantizer.{name}"] = _np(value)
    return out


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


def adp_unet_cfg_state_dict(p: Mapping, prefix: str = "") -> StateDict:
    """`params` of the JAX UNetCFG1d ({"unet": UNet1d, "fixed_embedding"})
    -> the port's UNetCFG1d (models/adp.py), the reference layout: conv
    kernels [k, in, out] -> [out, in, k] (transposed convs [in, out, k])."""
    out: StateDict = {f"{prefix}fixed_embedding.embedding.weight": _np(p["fixed_embedding"])}
    u = p["unet"]
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


def diffusion_cond_state_dict(params: Mapping, dim_heads: int = 64,
                              t5_params: Optional[Mapping[str, Mapping]] = None,
                              roberta_params: Optional[Mapping[str, Mapping]] = None
                              ) -> StateDict:
    """`params` of a ConditionedDiffusionModelWrapper (a DiT with heads of
    `dim_heads`, or an ADP UNetCFG1d) -> the port's
    ConditionedDiffusionModelWrapper state_dict. `t5_params` maps a T5
    conditioner id to its tower's flax params, `roberta_params` a CLAP text
    conditioner id to its RoBERTa tower's; the CLAP joint-space projection
    (`text_projection`) is not part of either and keeps what the port's
    conditioner loaded from the CLAP checkpoint."""
    inner = params["model"]
    out = (dit_state_dict(inner["dit"], dim_heads, prefix="model.model.") if "dit" in inner
           else adp_unet_cfg_state_dict(inner["unet"], prefix="model.model."))
    if "pretransform" in params:
        out.update(autoencoder_state_dict(params["pretransform"]["model"], "pretransform.model."))
    for key, mod in params.get("conditioner", {}).items():
        cid = key[len("modules_"):]
        pfx = f"conditioner.conditioners.{cid}."
        if "embedder" in mod:  # NumberConditioner
            out[f"{pfx}embedder.embedding.0.weights"] = _np(mod["embedder"]["weights"])
            dense(out, f"{pfx}embedder.embedding.1", mod["embedder"]["to_out"])
        if "int_embedder" in mod:  # IntConditioner
            out[f"{pfx}int_embedder.weight"] = _np(mod["int_embedder"]["embedding"])
        if "proj" in mod:  # T5 / CLAP projection
            dense(out, f"{pfx}proj_out", mod["proj"]["proj_out"])
    for cid, p in (t5_params or {}).items():
        out.update(t5_state_dict(p, f"conditioner.conditioners.{cid}.model."))
    for cid, p in (roberta_params or {}).items():
        out.update(roberta_state_dict(p, f"conditioner.conditioners.{cid}.model."))
    return out


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
        if name == "timestep_embed":  # FourierFeatures
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


def diffusion_uncond_state_dict(params: Mapping) -> StateDict:
    """`params` of a DiffusionModelWrapper (DAU1d, and its pretransform where
    it has one) -> the port's DiffusionModelWrapper state_dict."""
    out = dance_unet_state_dict(params["model"], prefix="model.")
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
