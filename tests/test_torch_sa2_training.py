"""SA-2.0-style training of the port against the JAX package on the CPU: the
pre-encoded dataset, the pre-encode entry (each package reads the other's
files), the trainer's `pre_encoded` and `mask_padding` branches on a tiny
rotary DiT whose self-attention takes the fused-QKV entry, the training
factory's keys, and the train entry on pre-encoded latents.

Inputs are made from a seed with numpy (the datasets' crops from a seeded
`random`, as both packages draw them); JAX runs on the CPU. Each tolerance
is stated where it is used.
"""

import copy
import json
import math
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.data import dataset as jds
from stable_audio_tools_tpu.training.diffusion import DiffusionCondTrainer as JaxTrainer
from stable_audio_tools_tpu_torch import pre_encode as tpre
from stable_audio_tools_tpu_torch.data import dataset as tds
from stable_audio_tools_tpu_torch.data.wav import save_wav
from stable_audio_tools_tpu_torch.io.checkpoints import load_model_state, save_model_state
from stable_audio_tools_tpu_torch.io.from_jax import diffusion_cond_state_dict
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.ops import attention as tattn
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from test_torch_slice import CONFIG, META, _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs", "txt2audio",
                       "stable_audio_2_0.json")) as _f:
    SA2_TRAINING = json.load(_f)["training"]
SR = CONFIG["sample_rate"]
LATENTS = 64  # latents of the tiny model's sample_size (1024 samples, ratio 16)
B = 2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the pre-encoded dataset ---------------------------------------------------


def _write_latents(root, specs, seed=0):
    """.npy latents [C, T] (or [1, C, T]) with .json metadata beside them:
    spec = (name, T, valid or None for no mask, has_json, batch_axis)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name, T, valid, has_json, batch_axis in specs:
        lat = rng.standard_normal((1, 4, T) if batch_axis else (4, T)).astype(np.float32)
        np.save(os.path.join(root, f"{name}.npy"), lat)
        if has_json:
            meta = {"prompt": f"clip {name}", "seconds_start": 7}
            if valid is not None:
                meta["padding_mask"] = [1.0] * valid + [0.0] * (T - valid)
            if name == "r":
                meta["__replace__"] = {"prompt": "replaced", "seconds_total": 99}
            with open(os.path.join(root, f"{name}.json"), "w") as f:
                json.dump(meta, f)


SPECS = [("long", 300, 200, True, False), ("short", 40, 30, True, False),
         ("exact", LATENTS, None, True, True), ("bare", 150, None, False, False),
         ("r", 100, 100, True, False)]


@pytest.mark.parametrize("random_crop", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pre_encoded_dataset_matches_jax(tmp_path, random_crop, seed):
    # crops (padding-mask aware, from the same seeded `random`), padding,
    # the mask, the metadata defaults and `__replace__`: identical arrays and
    # metadata from both packages' datasets
    _write_latents(str(tmp_path), SPECS, seed)
    configs = [{"id": "x", "path": str(tmp_path)}]
    jd = jds.PreEncodedDataset(configs, sample_size=10 ** 6, random_crop=random_crop,
                               latent_crop_length=LATENTS)
    td = tds.PreEncodedDataset(configs, sample_size=10 ** 6, random_crop=random_crop,
                               latent_crop_length=LATENTS)
    assert sorted(jd.filenames) == sorted(td.filenames) and len(td) == len(SPECS)
    for i in range(len(td)):
        random.seed(100 * seed + i)
        want_lat, want_info = jd[i]
        random.seed(100 * seed + i)
        got_lat, got_info = td[i]
        assert got_lat.shape == (4, LATENTS) and got_lat.dtype == np.float32
        np.testing.assert_array_equal(got_lat, want_lat)
        np.testing.assert_array_equal(got_info.pop("padding_mask"),
                                      want_info.pop("padding_mask"))
        assert got_info == want_info
    names = [os.path.basename(f) for f in td.filenames]
    r = td[names.index("r.npy")][1]
    assert (r["prompt"], r["seconds_total"], r["seconds_start"]) == ("replaced", 99, 7)
    bare = td[names.index("bare.npy")][1]
    assert (bare["seconds_start"], bare["seconds_total"]) == (0, 0)
    np.testing.assert_array_equal(bare["padding_mask"], np.ones(LATENTS, np.float32))


def test_pre_encoded_dataset_reads_a_filelist_and_the_loader_batches(tmp_path):
    # filelist.txt names the files (others in the directory are not read);
    # the loader factory's `pre_encoded` branch crops to latent_crop_length
    # and stacks [B, C, L] f32, metadata a list
    _write_latents(str(tmp_path), SPECS)
    (tmp_path / "filelist.txt").write_text("long.npy\n\nshort.npy\n")
    configs = [{"id": "x", "path": str(tmp_path)}]
    td = tds.PreEncodedDataset(configs, latent_crop_length=LATENTS)
    jd = jds.PreEncodedDataset(configs, latent_crop_length=LATENTS)
    assert td.filenames == jd.filenames == [str(tmp_path / "long.npy"), str(tmp_path / "short.npy")]
    loader = tds.create_dataloader_from_config(
        {"dataset_type": "pre_encoded", "latent_crop_length": LATENTS, "datasets": configs},
        batch_size=2, sample_size=10 ** 6, sample_rate=SR, num_workers=0)
    (lat, meta), = list(loader)
    assert lat.dtype == torch.float32 and tuple(lat.shape) == (2, 4, LATENTS)
    assert [len(m["padding_mask"]) for m in meta] == [LATENTS, LATENTS]
    with pytest.raises(ValueError, match="no pre_encoded files"):
        tds.create_dataloader_from_config(
            {"dataset_type": "pre_encoded", "datasets": [{"id": "e", "path": str(tmp_path / "e")}]},
            batch_size=2, sample_size=64, sample_rate=SR, num_workers=0)


# -- pre-encoding ----------------------------------------------------------------

AE_CONFIG = {"model_type": "autoencoder", "sample_size": CONFIG["sample_size"],
             "sample_rate": SR, "audio_channels": 2,
             "model": copy.deepcopy(CONFIG["model"]["pretransform"]["config"])}


def _audio_dir(tmp_path, lengths=(700, 1024, 1500), seed=3):
    """WAVs of the given lengths (the first shorter than the sample size, so
    its padding mask has zeros) and a custom metadata module adding a prompt."""
    rng = np.random.default_rng(seed)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, n in enumerate(lengths):
        save_wav(str(wavs / f"{i}.wav"), 0.3 * rng.standard_normal((2, n)), SR, float32=True)
    (tmp_path / "meta.py").write_text(
        "def get_custom_metadata(info, audio):\n    return {'prompt': 'clip ' + info['relpath']}\n")
    config = {"dataset_type": "audio_dir", "random_crop": False, "augment_phase": False,
              "datasets": [{"id": "w", "path": str(wavs),
                            "custom_metadata_module": str(tmp_path / "meta.py")}]}
    (tmp_path / "data.json").write_text(json.dumps(config))
    (tmp_path / "ae.json").write_text(json.dumps(AE_CONFIG))
    return config


def _read_both(out_dir):
    """Every item of a pre-encoded directory through both packages' datasets
    (no crop: the files hold LATENTS latents)."""
    configs = [{"id": "p", "path": out_dir}]
    jd = jds.PreEncodedDataset(configs, latent_crop_length=LATENTS, random_crop=False)
    td = tds.PreEncodedDataset(configs, latent_crop_length=LATENTS, random_crop=False)
    assert sorted(jd.filenames) == sorted(td.filenames)
    return [(jd[i], td[td.filenames.index(f)]) for i, f in enumerate(jd.filenames)]


def test_port_pre_encode_writes_files_the_jax_dataset_reads(tmp_path):
    # `python -m stable_audio_tools_tpu_torch.pre_encode` on the CPU in f32,
    # weights from a port model checkpoint: {out}/0/{i}.npy latents [4, 64]
    # (the checkpoint's encoder with the VAE noise of generator seed i, batch
    # size 1), {i}.json with the custom metadata and the padding mask at the
    # latent rate; the JAX dataset reads what the port's reads
    _audio_dir(tmp_path)
    ae = create_model_from_config(AE_CONFIG, "cpu")
    save_model_state(str(tmp_path / "ae.ckpt"), ae, AE_CONFIG)
    result = tpre.main(["--model-config", str(tmp_path / "ae.json"), "--ckpt-path",
                        str(tmp_path / "ae.ckpt"), "--dataset-config", str(tmp_path / "data.json"),
                        "--output-path", str(tmp_path / "out"), "--batch-size", "1",
                        "--num-workers", "0", "--precision", "32", "--device", "cpu"])
    out = tmp_path / "out" / "0"
    assert result["items"] == 3 and result["out_dir"] == str(out)
    assert sorted(os.listdir(out)) == sorted(f"{i}.{e}" for i in range(3) for e in ("json", "npy"))
    loader = tds.create_dataloader_from_config(json.loads((tmp_path / "data.json").read_text()),
                                               1, AE_CONFIG["sample_size"], SR, num_workers=0,
                                               shuffle=False)
    for i, (audio, meta) in enumerate(loader):
        with torch.no_grad():
            want = ae.encode(audio, generator=torch.Generator().manual_seed(i))[0].numpy()
        np.testing.assert_array_equal(np.load(out / f"{i}.npy"), want)
        info = json.loads((out / f"{i}.json").read_text())
        assert info["prompt"] == meta[0]["prompt"] and "timestamps" not in info
        pm = meta[0]["padding_mask"]
        np.testing.assert_array_equal(info["padding_mask"],
                                      pm[np.floor(np.arange(LATENTS) * (len(pm) / LATENTS))
                                         .astype(int)])
    sums = [sum(json.loads((out / f"{i}.json").read_text())["padding_mask"]) for i in range(3)]
    assert sorted(sums)[0] == math.ceil(700 / 16) and sorted(sums)[1:] == [LATENTS] * 2
    for (jl, ji), (tl, ti) in _read_both(str(out)):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti.pop("padding_mask"), ji.pop("padding_mask"))
        assert ti == ji
    # --limit stops after that many items
    assert tpre.main(["--model-config", str(tmp_path / "ae.json"), "--dataset-config",
                      str(tmp_path / "data.json"), "--output-path", str(tmp_path / "lim"),
                      "--batch-size", "1", "--limit", "2", "--num-workers", "0",
                      "--precision", "32",
                      "--device", "cpu"])["items"] == 2


def test_jax_pre_encode_writes_files_the_port_dataset_reads(tmp_path, monkeypatch):
    # the JAX package's root pre_encode.py (random weights) on the same
    # dataset: the port's dataset reads its files as the JAX dataset does
    sys.path.insert(0, ROOT)
    import pre_encode as jpre

    _audio_dir(tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "pre_encode.py", "--model-config", str(tmp_path / "ae.json"), "--dataset-config",
        str(tmp_path / "data.json"), "--output-path", str(tmp_path / "out"),
        "--batch-size", "2"])
    jpre.main()
    items = _read_both(str(tmp_path / "out" / "0"))
    assert len(items) == 2  # one batch of 2; the incomplete last batch is dropped
    for (jl, ji), (tl, ti) in items:
        assert tl.shape == (4, LATENTS) and np.isfinite(tl).all()
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti.pop("padding_mask"), ji.pop("padding_mask"))
        assert ti == ji


def test_latent_padding_mask_samples_as_jax():
    pm = np.r_[np.ones(700), np.zeros(324)]
    got = tpre.latent_padding_mask(pm, LATENTS)
    assert got.shape == (LATENTS,) and got.sum() == math.ceil(700 / 16)
    np.testing.assert_array_equal(got, pm[(np.arange(LATENTS) * 16)])


def test_model_state_round_trip(tmp_path):
    ae = create_model_from_config(AE_CONFIG, "cpu")
    save_model_state(str(tmp_path / "m.ckpt"), ae)
    other = create_model_from_config(AE_CONFIG, "cpu")
    load_model_state(str(tmp_path / "m.ckpt"), other)
    for (n, a), b in zip(ae.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), n


# -- the trainer's branches ------------------------------------------------------


def _train_config(pre_encoded: bool):
    config = copy.deepcopy(CONFIG)
    config["model"]["pretransform"]["scale"] = 2.0
    config["model"]["diffusion"]["config"]["use_checkpointing"] = True
    config["training"] = dict(copy.deepcopy(SA2_TRAINING), pre_encoded=pre_encoded,
                              mask_padding=True, mask_padding_dropout=0.25,
                              cfg_dropout_prob=0.0)
    return config


@pytest.fixture(scope="module")
def pair():
    return _pair(_train_config(True))


def _fused_route(port, monkeypatch):
    """Send the tiny DiT's self-attention (64 latents + the global token) to
    the fused-QKV entry, as SA-2.0's 6144 latents are sent; count its calls."""
    for layer in port.model.model.transformer.layers:
        layer.self_attn.nhd_min_seq = 32
    calls = []
    real = tattn.flash_attention_fused_qkv
    monkeypatch.setattr(tattn, "flash_attention_fused_qkv",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    return calls


@pytest.mark.parametrize("pre_encoded", [True, False])
def test_masked_step_matches_jax_loss_and_info(pair, monkeypatch, pre_encoded):
    # one DiffusionCondTrainer step of the tiny rotary DiT (remat, the fused
    # entry in both passes of every block), the padding mask taking part in
    # the MSE, against jax.value_and_grad of the JAX trainer's
    # `_loss_and_info` with the same weights; t and the noise are the JAX
    # step's own draws from its key (uniform from fold_in(key, 2), normal
    # from fold_in(key, 4)), the VAE noise the JAX encoder's. Pre-encoded: the
    # batch is latents over the pretransform's scale; else the audio-rate
    # mask is sampled at the latent rate. f32 through two blocks: loss 1e-5,
    # each gradient 1e-4 of its largest entry.
    model, variables, port = pair
    port = copy.deepcopy(port)
    calls = _fused_route(port, monkeypatch)
    config = _train_config(pre_encoded)
    rng = np.random.default_rng(5)
    meta = [dict(META[0], seconds_start=3 + 5 * i) for i in range(B)]
    if pre_encoded:
        batch = rng.standard_normal((B, 4, LATENTS)).astype(np.float32) * 2.0
        masks = [np.r_[np.ones(40), np.zeros(LATENTS - 40)], np.ones(LATENTS)]
    else:
        batch = (0.5 * rng.standard_normal((B, 2, CONFIG["sample_size"]))).astype(np.float32)
        masks = [np.r_[np.ones(700), np.zeros(324)], np.ones(CONFIG["sample_size"])]
    for md, m in zip(meta, masks):
        md["padding_mask"] = m.astype(np.float32)
    key = jax.random.PRNGKey(9)
    jtrainer = JaxTrainer(model, optimizer_configs=config["training"]["optimizer_configs"],
                          mask_padding=True, pre_encoded=pre_encoded, cfg_dropout_prob=0.0)
    jbatch = {"audio": jnp.asarray(batch), "padding_mask": jnp.asarray(np.stack(masks)),
              "prepared_cond": jax.tree_util.tree_map(
                  jnp.asarray, model._multi_conditioner.gather_inputs(meta))}
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtrainer._loss_and_info(p, jbatch, key), has_aux=True)(variables["params"])
    t = np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (B,)))
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 4), (B, 4, LATENTS)))
    encode_noise = None
    if not pre_encoded:  # the noise the JAX VAE drew, recovered from its output
        z, info = model.apply(variables, jnp.asarray(batch), return_info=True,
                              rngs={"sample": jax.random.fold_in(key, 0)},
                              method=lambda m, a, **kw: m.pretransform.model.encode(a, **kw))
        mean, scale = np.split(np.asarray(info["pre_bottleneck_latents"]), 2, axis=1)
        encode_noise = _t((np.asarray(z) - mean) / (np.log1p(np.exp(scale)) + 1e-4))

    wrapper = create_training_wrapper_from_config(config, port)
    assert (wrapper.pre_encoded, wrapper.mask_padding) == (pre_encoded, True)
    got = wrapper.train_step(_t(batch), meta, t=_t(t), noise=_t(noise),
                             encode_noise=encode_noise,
                             cfg_dropout_mask=torch.zeros(B, dtype=torch.bool))
    assert len(calls) == 2 * 2  # 2 blocks, forward and its recompute
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got["std_data"]), float(aux["std_data"]), rtol=1e-5)
    want_g = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, grads), 64)
    for n, p in wrapper.params.items():
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, n
        assert _rel(p.grad.numpy(), want_g[n]) < 1e-4, n


def test_padding_mask_changes_the_loss(pair, monkeypatch):
    # the masked MSE averages over the valid latents only: an all-valid mask
    # gives the unmasked loss, a partial one another value
    _, _, port = pair
    wrapper = create_training_wrapper_from_config(_train_config(True), copy.deepcopy(port))
    rng = np.random.default_rng(6)
    lat = _t(rng.standard_normal((B, 4, LATENTS)))
    kw = dict(t=torch.full((B,), 0.5), noise=_t(rng.standard_normal((B, 4, LATENTS))),
              cfg_dropout_mask=torch.zeros(B, dtype=torch.bool))
    losses = []
    for valid in (LATENTS, 20):
        meta = [dict(META[0], padding_mask=np.r_[np.ones(valid), np.zeros(LATENTS - valid)])
                for _ in range(B)]
        w = copy.deepcopy(wrapper)
        losses.append(float(w.train_step(lat, meta, **kw)["loss"]))
    w = copy.deepcopy(wrapper)
    w.mask_padding = False
    unmasked = float(w.train_step(lat, [dict(META[0]) for _ in range(B)], **kw)["loss"])
    np.testing.assert_allclose(losses[0], unmasked, rtol=1e-6)
    assert abs(losses[1] - losses[0]) > 1e-3 * abs(losses[0])


# -- the factory and the train entry ------------------------------------------


def test_factory_takes_the_new_keys_and_refuses_inpainting(pair):
    _, _, port = pair
    config = _train_config(True)
    wrapper = create_training_wrapper_from_config(config, port)
    assert (wrapper.pre_encoded, wrapper.mask_padding, wrapper.mask_padding_dropout) == (
        True, True, 0.25)
    assert wrapper.losses.losses[0].mask_key == "padding_mask"
    plain = create_training_wrapper_from_config(dict(config, training=SA2_TRAINING), port)
    assert (plain.pre_encoded, plain.mask_padding, plain.losses.losses[0].mask_key) == (
        False, False, None)
    # inpainting is taken now (the flow-objective slice trains it)
    config["training"]["inpainting_config"] = {"mask_kwargs": {}}
    assert create_training_wrapper_from_config(config, port).inpainting_config == {
        "mask_kwargs": {}}


def test_train_entry_trains_from_pre_encoded_latents(tmp_path):
    # pre-encode WAVs with the port, then `python -m
    # stable_audio_tools_tpu_torch.train`'s code path on the CPU trains the
    # tiny model from those latents with `pre_encoded` and `mask_padding`
    # on: 2 steps, finite losses, a checkpoint
    from stable_audio_tools_tpu_torch import train

    _audio_dir(tmp_path)
    tpre.main(["--model-config", str(tmp_path / "ae.json"), "--dataset-config",
               str(tmp_path / "data.json"), "--output-path", str(tmp_path / "lat"),
               "--batch-size", "1", "--num-workers", "0", "--precision", "32",
               "--device", "cpu"])
    (tmp_path / "model.json").write_text(json.dumps(_train_config(True)))
    (tmp_path / "pre.json").write_text(json.dumps({
        "dataset_type": "pre_encoded", "latent_crop_length": LATENTS,
        "datasets": [{"id": "lat", "path": str(tmp_path / "lat")}]}))
    trainer = train.main(["--model-config", str(tmp_path / "model.json"), "--dataset-config",
                          str(tmp_path / "pre.json"), "--batch-size", "2", "--num-workers", "0",
                          "--max-steps", "2", "--save-dir", str(tmp_path / "run"),
                          "--precision", "32", "--device", "cpu"])
    assert trainer.wrapper.step == 2 and trainer.wrapper.pre_encoded
    lines = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in lines)
    assert (tmp_path / "run" / "step=2.ckpt").exists()
