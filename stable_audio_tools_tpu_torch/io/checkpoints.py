"""Training-state checkpoints of the port (`torch.save` files).

A checkpoint holds the model's `state_dict` under the reference torch names
(the names the JAX package's importers read: io/torch_mapping.py
`import_diffusion_cond_state_dict`, io/checkpoints.py), the optimizer's and
the LR scheduler's state, the EMA of the trainable parameters, the step, and
the model config embedded, as the JAX trainer's checkpoint does
(training/trainer.py:149). An autoencoder GAN wrapper adds its
discriminator's state_dict, optimizer and scheduler (`discriminator`,
`disc_optimizer`, `disc_scheduler`); a diffusion checkpoint has none of them. Files are written to a temporary name and renamed,
so a cut run never leaves a truncated checkpoint under the final name.

A model checkpoint (`save_model_state`) holds a model's `state_dict` and its
config alone, the weights `pre_encode.py` reads: `load_model_state` takes it
or a training checkpoint.

State dicts of other origins (JAX io/checkpoints.py): `load_ckpt_state_dict`
(:29) reads a torch checkpoint or a `.safetensors` file (the format read and
written here, `load_safetensors` / `save_safetensors`); `copy_state_dict`
(:54) copies what matches by name and shape (`--pretrained-ckpt-path`);
`load_pretransform_state` loads an autoencoder's state dict into a model's
pretransform and refuses to leave any of its tensors random
(`--pretransform-ckpt-path`, JAX models/handle.py:93); and
`remove_weight_norm_from_model` (:542) re-normalises the weight-normalised
layers (`--remove-pretransform-weight-norm`).
"""

from __future__ import annotations

import os
import typing as tp

import torch

from ..ops.conv import weight_norm


def save_training_state(path: str, wrapper, model_config: tp.Optional[dict] = None) -> None:
    """`wrapper`: a training wrapper (training/diffusion.py,
    training/autoencoders.py) with `model`, `optimizer`, `scheduler`, `ema`
    and `step`, and a `discriminator` for a GAN."""
    state = {
        "state_dict": wrapper.model.state_dict(),
        "optimizer": wrapper.optimizer.state_dict(),
        "scheduler": wrapper.scheduler.state_dict(),
        "ema": wrapper.ema,
        "step": wrapper.step,
        "model_config": model_config,
    }
    if getattr(wrapper, "discriminator", None) is not None:
        state.update(discriminator=wrapper.discriminator.state_dict(),
                     disc_optimizer=wrapper.disc_optimizer.state_dict(),
                     disc_scheduler=wrapper.disc_scheduler.state_dict())
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_training_state(path: str, wrapper) -> dict:
    """Restore `wrapper` in place from `path`; returns the loaded dict."""
    # read to the host (mapped, not copied) and copied into the live tensors,
    # so the card never holds a second copy of the state
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    wrapper.model.load_state_dict(state["state_dict"], strict=True)
    wrapper.optimizer.load_state_dict(state["optimizer"])
    wrapper.scheduler.load_state_dict(state["scheduler"])
    if getattr(wrapper, "discriminator", None) is not None:
        wrapper.discriminator.load_state_dict(state["discriminator"], strict=True)
        wrapper.disc_optimizer.load_state_dict(state["disc_optimizer"])
        wrapper.disc_scheduler.load_state_dict(state["disc_scheduler"])
    if wrapper.ema is not None:
        if state["ema"] is None:
            raise ValueError(f"{path} holds no EMA but the trainer keeps one")
        for name, value in state["ema"].items():
            wrapper.ema[name].copy_(value)
    wrapper.step = int(state["step"])
    return state


def save_model_state(path: str, model: torch.nn.Module,
                     model_config: tp.Optional[dict] = None) -> None:
    """`model`'s state_dict (and its config) alone, e.g. a diffusion model's
    pretransform for `pre_encode.py`."""
    tmp = f"{path}.tmp"
    torch.save({"state_dict": model.state_dict(), "model_config": model_config}, tmp)
    os.replace(tmp, path)


def load_model_state(path: str, model: torch.nn.Module) -> None:
    """Load the `state_dict` of a model or training checkpoint into `model`
    (strict: every name must match)."""
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["state_dict"], strict=True)


# -- state dicts of other origins (JAX io/checkpoints.py :29-66, :542) ------

# safetensors dtype names <-> torch dtypes; the card's machine has no
# `safetensors` package, so the port reads and writes the format itself
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def save_safetensors(path: str, tensors: tp.Mapping[str, torch.Tensor],
                     metadata: tp.Optional[tp.Mapping[str, str]] = None) -> None:
    """Write `tensors` in the safetensors format: an 8-byte little-endian
    header length, a JSON header ({name: {dtype, shape, data_offsets}} and
    `__metadata__`), padded with spaces to 8 bytes, then each tensor's raw
    little-endian bytes in name order. Written to a temporary name and
    renamed."""
    import json
    import sys

    if sys.byteorder != "little":
        raise NotImplementedError("the safetensors writer assumes a little-endian host")
    header: tp.Dict[str, tp.Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)


def load_safetensors(path: str) -> tp.Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, each tensor in its stored dtype."""
    import json

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _ST_DTYPES:
            raise TypeError(f"{path}: {name} has the unsupported dtype {entry['dtype']}")
        begin, end = entry["data_offsets"]
        dtype = _ST_DTYPES[entry["dtype"]]
        flat = torch.frombuffer(bytearray(data[begin:end]), dtype=torch.uint8) if end > begin \
            else torch.empty(0, dtype=torch.uint8)
        out[name] = flat.view(dtype).reshape(entry["shape"])
    return out


def load_ckpt_state_dict(ckpt_path: str) -> tp.Dict[str, torch.Tensor]:
    """A state dict from a `.safetensors` file (each tensor in its stored
    dtype) or a torch checkpoint (its `state_dict` where it has one, else
    the whole dict; floating tensors as f32, the others as stored), on the
    CPU (JAX :29)."""
    if ckpt_path.endswith(".safetensors"):
        return load_safetensors(ckpt_path)
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


@torch.no_grad()
def copy_state_dict(model: torch.nn.Module, state_dict: tp.Mapping[str, torch.Tensor]
                    ) -> tp.Tuple[int, tp.List[str]]:
    """Copy into `model` every tensor of `state_dict` whose name (the
    reference torch names the port keeps) and shape match one of its
    parameters or buffers, cast to its dtype; returns (number loaded, names
    skipped) (JAX :54)."""
    own = dict(model.state_dict(keep_vars=True))
    loaded, skipped = 0, []
    for name, value in state_dict.items():
        target = own.get(name)
        if target is not None and tuple(target.shape) == tuple(value.shape):
            target.copy_(value)
            loaded += 1
        else:
            skipped.append(name)
    return loaded, skipped


def load_pretransform_state(model: torch.nn.Module, state_dict: tp.Mapping[str, torch.Tensor]
                            ) -> int:
    """Load an autoencoder's reference-layout state dict (`encoder.*`,
    `decoder.*`, `bottleneck.*`, what an unwrapped autoencoder holds; or a
    whole model's, whose `pretransform.model.*` tensors are taken) into
    `model.pretransform.model`. Every tensor of the pretransform must be in
    the file with its shape: a missing one is an error, never left random
    (JAX models/handle.py:93, io/checkpoints.py:502-541). Returns the number
    loaded."""
    pretransform = getattr(model, "pretransform", None)
    if pretransform is None:
        raise ValueError("the model has no pretransform to load a checkpoint into")
    prefix = "pretransform.model."
    if any(k.startswith(prefix) for k in state_dict):
        state_dict = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    own = pretransform.model.state_dict()
    missing = [n for n in own if n not in state_dict]
    wrong = [n for n in own
             if n in state_dict and tuple(state_dict[n].shape) != tuple(own[n].shape)]
    if missing or wrong:
        raise RuntimeError(f"the pretransform checkpoint lacks {len(missing)} tensors "
                           f"({missing[:5]}) and has {len(wrong)} of another shape "
                           f"({wrong[:5]}); refusing to leave them random")
    loaded, _ = copy_state_dict(pretransform.model, {n: state_dict[n] for n in own})
    return loaded


@torch.no_grad()
def remove_weight_norm_from_model(module: torch.nn.Module) -> int:
    """Re-normalise every weight-normalised layer under `module` (the port's
    `weight_v` / `weight_g`, norm over all but the first dimension): v := w
    = g v / ||v||, g := ||w||, which leaves each layer's weight as it was and
    restarts the reparameterisation from it (the reference's
    remove_weight_norm, JAX :542). Returns the number of layers."""
    n = 0
    for m in module.modules():
        v, g = getattr(m, "weight_v", None), getattr(m, "weight_g", None)
        if not isinstance(v, torch.Tensor) or not isinstance(g, torch.Tensor):
            continue
        w = weight_norm(v, g)
        v.copy_(w)
        g.copy_(torch.sqrt(torch.sum(w ** 2, dim=tuple(range(1, w.dim())), keepdim=True)))
        n += 1
    return n


def _seanet_layout(model: torch.nn.Module) -> tp.Dict[str, str]:
    """The port's SEANet module names -> encodec's / audiocraft's `model.{n}`
    Sequential names (what the JAX package's `import_seanet_encoder` /
    `_decoder` read, io/checkpoints.py:350-395), per tower of a SEANet
    `model` (empty for other towers):
    encoder conv_in, per ratio R resnet blocks, an ELU and the down conv,
    the LSTM, an ELU and conv_out; decoder conv_in, the LSTM, per ratio an
    ELU, the transposed conv and R resnet blocks, an ELU and conv_out. A
    resnet block's convs are `block.1` / `block.3`, every conv nested as
    `conv.conv` (`convtr.convtr`)."""
    from ..models.seanet import SEANetDecoder, SEANetEncoder

    names = {}
    if not (isinstance(model.encoder, SEANetEncoder) and isinstance(model.decoder, SEANetDecoder)):
        return names
    for tower, decoder in ((model.encoder, False), (model.decoder, True)):
        pre = "decoder." if decoder else "encoder."
        n_res = len(tower.blocks[0]["res"])
        lstm = tower.lstm is not None
        names[f"{pre}conv_in.conv"] = f"{pre}model.0.conv.conv"
        base = 1
        if decoder and lstm:
            names[f"{pre}lstm.lstm"] = f"{pre}model.1.lstm"
            base = 2
        for i in range(len(tower.blocks)):
            start = base + i * (n_res + 2)
            first_res = start + 2 if decoder else start
            for j in range(n_res):
                for ours, theirs in (("conv1", "block.1"), ("conv2", "block.3"),
                                     ("shortcut", "shortcut")):
                    names[f"{pre}blocks.{i}.res.{j}.{ours}.conv"] = (
                        f"{pre}model.{first_res + j}.{theirs}.conv.conv")
            if decoder:
                names[f"{pre}blocks.{i}.up.conv"] = f"{pre}model.{start + 1}.convtr.convtr"
            else:
                names[f"{pre}blocks.{i}.down.conv"] = f"{pre}model.{start + n_res + 1}.conv.conv"
        end = base + len(tower.blocks) * (n_res + 2)
        if not decoder and lstm:
            names[f"{pre}lstm.lstm"] = f"{pre}model.{end}.lstm"
            end += 1
        names[f"{pre}conv_out.conv"] = f"{pre}model.{end + 1}.conv.conv"
    return names


def _codec_layout_to_port(model: torch.nn.Module, state_dict: tp.Mapping[str, torch.Tensor]
                          ) -> tp.Dict[str, torch.Tensor]:
    """A public codec's own layout -> the port's names (JAX
    io/checkpoints.py:502 `import_codec_variables`): descript's raw DAC
    (`encoder.block.*` for the reference wrapper's `encoder.encoder.block.*`,
    likewise the decoder; `quantizer.quantizers.*` for
    `bottleneck.quantizer.quantizers.*`), encodec's SEANet towers
    (`_seanet_layout`) and its RVQ
    (`quantizer.vq.layers.{i}._codebook.{embed, embed_avg, cluster_size}`,
    stacked into `bottleneck.quantizer.{codebooks, ema_sums, ema_counts}`;
    the sums default to embed x counts, the counts to 1). Names already the
    port's pass as they are."""
    own = model.state_dict()
    seanet = {theirs: ours for ours, theirs in _seanet_layout(model).items()}
    out: tp.Dict[str, torch.Tensor] = {}
    layers: tp.Dict[int, tp.Dict[str, torch.Tensor]] = {}
    for name, value in state_dict.items():
        if name.startswith("quantizer.vq.layers."):
            i, _, leaf = name[len("quantizer.vq.layers."):].split(".", 2)
            layers.setdefault(int(i), {})[leaf] = value
            continue
        if name.startswith("quantizer.quantizers."):
            name = "bottleneck." + name
        stem, _, leaf = name.rpartition(".")
        if stem in seanet:
            name = f"{seanet[stem]}.{leaf}"
        for tower in ("encoder", "decoder"):
            nested = f"{tower}.{tower}.{name[len(tower) + 1:]}"
            if name.startswith(tower + ".") and name not in own and nested in own:
                name = nested
        out[name] = value
    if layers:
        embeds = [layers[i]["embed"].float() for i in sorted(layers)]
        counts = [layers[i]["cluster_size"].float() if "cluster_size" in layers[i]
                  else torch.ones(e.shape[0]) for i, e in zip(sorted(layers), embeds)]
        sums = [layers[i]["embed_avg"].float() if "embed_avg" in layers[i] else e * c[:, None]
                for i, e, c in zip(sorted(layers), embeds, counts)]
        out["bottleneck.quantizer.codebooks"] = torch.stack(embeds)
        out["bottleneck.quantizer.ema_counts"] = torch.stack(counts)
        out["bottleneck.quantizer.ema_sums"] = torch.stack(sums)
        out["bottleneck.quantizer.initted"] = torch.tensor(True)
    return out


@torch.no_grad()
def load_codec_state(model: torch.nn.Module, state_dict: tp.Mapping[str, torch.Tensor]) -> int:
    """Load a codec checkpoint (descript's DAC, EnCodec / audiocraft, or the
    port's own names) into the codec autoencoder `model` of a
    `dac_pretrained` / `audiocraft_pretrained` pretransform. Every tensor of
    the codec must be in the file with its shape: the codebooks are never
    left random (JAX models/handle.py:93). Returns the number loaded."""
    own = model.state_dict()
    sd = _codec_layout_to_port(model, state_dict)
    missing = [n for n in own if n not in sd]
    wrong = [n for n in own if n in sd and tuple(sd[n].shape) != tuple(own[n].shape)]
    if missing or wrong:
        raise RuntimeError(f"the codec checkpoint lacks {len(missing)} tensors ({missing[:5]}) "
                           f"and has {len(wrong)} of another shape ({wrong[:5]})")
    loaded, _ = copy_state_dict(model, {n: sd[n] for n in own})
    return loaded


def codec_state_dict(model: torch.nn.Module) -> tp.Dict[str, torch.Tensor]:
    """The codec autoencoder's tensors in the codec's own layout: the DAC
    RVQ as `quantizer.quantizers.*`, the SEANet towers as encodec's
    `model.{n}` names and the EMA RVQ as `quantizer.vq.layers.{i}._codebook.*`
    (the layout `load_codec_state` and the JAX package's
    `import_codec_variables` read)."""
    seanet = _seanet_layout(model)
    out: tp.Dict[str, torch.Tensor] = {}
    for name, value in model.state_dict().items():
        stem, _, leaf = name.rpartition(".")
        if stem in seanet:
            out[f"{seanet[stem]}.{leaf}"] = value
        elif name.startswith("bottleneck.quantizer.quantizers."):
            out[name[len("bottleneck."):]] = value
        elif name in ("bottleneck.quantizer.codebooks", "bottleneck.quantizer.ema_counts",
                      "bottleneck.quantizer.ema_sums"):
            leaf = {"codebooks": "embed", "ema_counts": "cluster_size",
                    "ema_sums": "embed_avg"}[name.rsplit(".", 1)[1]]
            for i, v in enumerate(value):
                out[f"quantizer.vq.layers.{i}._codebook.{leaf}"] = v.clone()
        elif name != "bottleneck.quantizer.initted":
            out[name] = value
    return out
