"""The port's demo callbacks (training/demos.py) against the JAX package's
(training/demos.py): `_save`'s files, peak scaling, log records and pictures
with and without matplotlib, and, for a tiny conditioned model, an
unconditional DAU1d, a token LM and an autoencoder GAN, that a demo renders
what the port's own generation (or forward) gives with the EMA weights and a
generator seeded with the step, and puts the training weights back bit for
bit.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.interface import aeiou as jaeiou
from stable_audio_tools_tpu.training import demos as jdemos
from stable_audio_tools_tpu.training.utils import JSONLLogger as JaxJSONLLogger
from stable_audio_tools_tpu_torch.interface import aeiou as taeiou
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
from stable_audio_tools_tpu_torch.training import demos as tdemos
from stable_audio_tools_tpu_torch.training.ema import ema_weights
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from stable_audio_tools_tpu_torch.training.utils import JSONLLogger
from test_torch_train_entry import FAMILIES


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL_CONFIG = {"model_type": "diffusion_cond", "sample_rate": 16000, "sample_size": 4096}


def _records(path, root):
    """A JSONL log's records with the demo directory cut from file paths."""
    out = []
    for line in open(path):
        rec = json.loads(line)
        out.append({k: [os.path.relpath(p, root) for p in v] if isinstance(v, list) else v
                    for k, v in rec.items()})
    return out


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_save_writes_what_jax_writes(tmp_path, monkeypatch, with_matplotlib):
    # the same files (16-bit WAVs scaled by 0.95 over the batch's peak, and
    # the PNGs where matplotlib is installed), byte for byte where they are
    # WAVs, and the same log records
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(0)
    audio = (0.7 * rng.standard_normal((2, 2, 4096))).astype(np.float32)
    latents = rng.standard_normal((2, 8, 64)).astype(np.float32)
    for side, demo_mod, logger in (("jax", jdemos, JaxJSONLLogger), ("port", tdemos, JSONLLogger)):
        root = str(tmp_path / side)
        os.makedirs(root)
        base = demo_mod._DemoBase(MODEL_CONFIG, os.path.join(root, "demos"), {},
                                  logger(os.path.join(root, "log.jsonl")))
        base._save(audio, "demo_cfg6", 7, latents=latents, caption="cfg=6 | rain")
    names = sorted(os.listdir(tmp_path / "jax" / "demos"))
    assert names == sorted(os.listdir(tmp_path / "port" / "demos"))
    want_names = ["demo_cfg6_step7_0.wav", "demo_cfg6_step7_1.wav"]
    if with_matplotlib:
        want_names += ["demo_cfg6_step7_latents.png", "demo_cfg6_step7_latents_pca.png",
                       "demo_cfg6_step7_mel.png"]
    assert names == sorted(want_names)
    for name in names:
        if name.endswith(".wav"):
            assert (tmp_path / "jax" / "demos" / name).read_bytes() == \
                (tmp_path / "port" / "demos" / name).read_bytes(), name
    assert _records(tmp_path / "port" / "log.jsonl", tmp_path / "port") == \
        _records(tmp_path / "jax" / "log.jsonl", tmp_path / "jax")


def test_pictures_match_jax():
    # the mel spectrogram, the latents' heat map and their PCA, pixel for pixel
    rng = np.random.default_rng(1)
    audio = (0.5 * rng.standard_normal((2, 8000))).astype(np.float32)
    lat = rng.standard_normal((1, 8, 100)).astype(np.float32)
    np.testing.assert_array_equal(taeiou.audio_spectrogram_image(audio, 16000),
                                  jaeiou.audio_spectrogram_image(audio, 16000))
    np.testing.assert_array_equal(taeiou.tokens_spectrogram_image(lat),
                                  jaeiou.tokens_spectrogram_image(lat))
    np.testing.assert_array_equal(taeiou.pca_point_cloud(lat), jaeiou.pca_point_cloud(lat))


def test_unported_demos_are_refused():
    # the inpainting demo is ported (tests/test_torch_rf_training.py)
    assert isinstance(tdemos.create_demo_callback_from_config({
        "model_type": "diffusion_cond_inpaint", "sample_rate": 1, "sample_size": 1}),
        tdemos.DiffusionCondInpaintDemoCallback)
    # the diffusion-autoencoder demo is ported
    # (tests/test_torch_diffae.py)
    assert isinstance(tdemos.create_demo_callback_from_config({
        "model_type": "diffusion_autoencoder", "sample_rate": 1, "sample_size": 1}),
        tdemos.DiffusionAutoencoderDemoCallback)
    with pytest.raises(NotImplementedError, match="compute_fad"):
        tdemos.create_demo_callback_from_config({
            "model_type": "autoencoder", "sample_rate": 1, "sample_size": 1,
            "training": {"demo": {"compute_fad": True}}})


def _wrapper(family):
    cfg = FAMILIES[family]()
    cfg["training"].pop("compute_dtype", None)
    model = init_random_(create_model_from_config(cfg, "cpu"), torch.Generator().manual_seed(3))
    wrapper = create_training_wrapper_from_config(cfg, model)
    if wrapper.ema is None:  # the LM keeps none by default: one, held off the weights
        from stable_audio_tools_tpu_torch.training.ema import ema_init

        wrapper.ema = ema_init(wrapper.params)
    for e in wrapper.ema.values():
        e.mul_(0.9).add_(0.01)
    return cfg, wrapper


def _expected(family, cfg, wrapper, step, reals=None):
    """What the port's own entry points give with the EMA weights and a
    generator (or seed) of `step`: {output name: audio}."""
    from stable_audio_tools_tpu_torch.inference.generation import (generate_diffusion_cond,
                                                                    generate_diffusion_uncond)
    from stable_audio_tools_tpu_torch.models.lm import lm_generate_audio

    demo = cfg["training"]["demo"]
    model = wrapper.model
    gen = torch.Generator().manual_seed(step)
    with ema_weights(wrapper.params, wrapper.ema), torch.no_grad():
        model.eval()
        if family == "dit":
            return {f"demo_cfg{s}": generate_diffusion_cond(
                model, steps=demo["demo_steps"], cfg_scale=s, conditioning=demo["demo_cond"],
                batch_size=1, sample_size=cfg["sample_size"], seed=step).numpy()
                for s in demo["demo_cfg_scales"]}
        if family == "dance":
            return {"demo": generate_diffusion_uncond(
                model, steps=demo["demo_steps"], batch_size=demo["num_demos"],
                sample_size=cfg["sample_size"], seed=step).numpy()}
        if family == "lm":
            cond = model.conditioner(demo["demo_cond"], "cpu")
            return {"lm_demo": lm_generate_audio(
                model, cond, max_gen_len=demo["demo_max_gen_len"],
                cfg_scale=demo["demo_cfg_scale"], generator=gen).numpy()}
        recon, _ = wrapper.ae_forward(torch.from_numpy(reals), generator=gen)
        return {"recon": recon.numpy(), "real": reals}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_demo_renders_the_ports_generation_with_the_ema(tmp_path, family):
    cfg, wrapper = _wrapper(family)
    reals = None
    demo_dl = None
    if family == "ae":
        reals = (0.3 * np.random.default_rng(2).standard_normal(
            (2, 2, cfg["sample_size"]))).astype(np.float32)
        demo_dl = [(torch.from_numpy(reals), [{}, {}])]
    callback = tdemos.create_demo_callback_from_config(cfg, str(tmp_path), demo_dl=demo_dl)
    weights = {n: p.detach().clone() for n, p in wrapper.model.named_parameters()}
    data_ptrs = {n: p.data_ptr() for n, p in wrapper.model.named_parameters()}
    step = 5
    callback(wrapper, step)
    assert all(torch.equal(p, weights[n]) and p.data_ptr() == data_ptrs[n]
               for n, p in wrapper.model.named_parameters())
    assert wrapper.model.training
    want = _expected(family, cfg, wrapper, step, reals)
    for name, audio in want.items():
        np.testing.assert_array_equal(callback.outputs[name], audio, err_msg=name)
        files = sorted(f for f in os.listdir(tmp_path) if f.startswith(f"{name}_step{step}_")
                       and f.endswith(".wav"))
        assert len(files) == audio.shape[0]
    if family == "ae":  # the discriminator's sensitivity, its own gradients untouched
        g = callback.outputs["disc_sensitivity"]
        assert g.shape == want["recon"].shape and np.isfinite(g).all() and g.max() > 0
        assert all(p.grad is None for p in wrapper.disc_params.values())


def test_disc_sensitivity_probe_matches_jax(tmp_path, monkeypatch):
    # |d(adv + fm) / d(fakes)| from the JAX probe (its gradient caught at
    # jax.grad) and the port's, with the same EncodecDiscriminator weights
    # (io/from_jax.py) on the same seeded reals and fakes: f32 convs, 1e-5 of
    # the peak
    import jax
    import jax.numpy as jnp

    from stable_audio_tools_tpu.models.discriminators import EncodecDiscriminator as JaxEncodec
    from stable_audio_tools_tpu_torch.io.from_jax import encodec_discriminator_state_dict
    from stable_audio_tools_tpu_torch.models.discriminators import EncodecDiscriminator

    disc_kw = dict(filters=8, n_ffts=(64, 32), hop_lengths=(16, 8), win_lengths=(64, 32))
    rng = np.random.default_rng(11)
    reals, fakes = (0.3 * rng.standard_normal((2, 2, 2, 600))).astype(np.float32)
    jdisc = JaxEncodec(in_channels=2, **disc_kw)
    params = jax.tree_util.tree_map(
        np.asarray, jdisc.init(jax.random.PRNGKey(0), jnp.asarray(reals))["params"])
    tdisc = EncodecDiscriminator(in_channels=2, **disc_kw)
    tdisc.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in encodec_discriminator_state_dict(params).items()},
                          strict=True)
    cfg = {"model_type": "autoencoder", "sample_rate": 16000, "sample_size": 600}

    caught = []
    grad = jax.grad
    monkeypatch.setattr(jax, "grad", lambda f: lambda x: caught.append(grad(f)(x)) or caught[-1])
    jcallback = jdemos.AutoencoderDemoCallback(cfg, str(tmp_path / "jax"), {}, None)
    os.makedirs(jcallback.demo_dir)
    jcallback._disc_sensitivity_probe(
        type("W", (), {"discriminator": jdisc})(), type("S", (), {"disc_params": params})(),
        jnp.asarray(reals), jnp.asarray(fakes), step=3)
    monkeypatch.setattr(jax, "grad", grad)
    want = np.abs(np.asarray(caught[0]))

    tcallback = tdemos.AutoencoderDemoCallback(cfg, str(tmp_path / "port"), {}, None)
    os.makedirs(tcallback.demo_dir)
    tcallback._disc_sensitivity_probe(type("W", (), {"discriminator": tdisc})(),
                                      torch.from_numpy(reals), torch.from_numpy(fakes), step=3)
    got = tcallback.outputs["disc_sensitivity"]
    assert len(caught) == 1 and got.shape == want.shape == reals.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * want.max())
    assert all(p.grad is None for p in tdisc.parameters())
