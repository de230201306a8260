"""The port's other conditioners against the JAX package on the CPU: `list`,
`phoneme`, `pretransform`, `source_mix`, `clap_audio` (HTSAT-tiny from a
CLAP checkpoint both packages load), `pre_encoded_keys`, the HTSAT trunk at
a narrow width (with and without the fusion branch) carried over by
io/from_jax.py, `clap_logmel`, `prepare_clap_audio` and the bicubic resize;
then a tiny SA-Open-shaped DiT conditioned on an audio prompt through its
own VAE (`pretransform`, `input_concat_ids`) and a `list` label, in
generation and in one AdamW step. The refusals: `lut`, a `phoneme` table
with `g2p_en` present.

Inputs are made from a seed with numpy; f32 throughout. The VAE's posterior
is its mean on both sides (the JAX package's conditioner bank is applied
without a "sample" key, so a sampling VAE cannot run in its generation).
Bounds, each stated where it is used: conditioning outputs 1e-5 of their
peak, the HTSAT 1e-4, generation and gradients 1e-4.
"""

import copy
import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import stable_audio_tools_tpu.models.bottleneck as jbottleneck
import stable_audio_tools_tpu_torch.models.bottleneck as tbottleneck
from stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from stable_audio_tools_tpu.models import conditioners as jcond
from stable_audio_tools_tpu.models import htsat as jhtsat
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu.models.factory import create_pretransform_from_config as jax_create_pt
from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from stable_audio_tools_tpu_torch.io.from_jax import (conditioner_state_dict,
                                                      diffusion_cond_state_dict, htsat_state_dict)
from stable_audio_tools_tpu_torch.models import conditioners as tcond
from stable_audio_tools_tpu_torch.models import htsat as thtsat
from stable_audio_tools_tpu_torch.models.factory import (create_model_from_config,
                                                         create_pretransform_from_config,
                                                         init_random_)
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from test_torch_ae_training import one_torch_thread  # noqa: F401
from test_torch_slice import CONFIG, _replayed_noise
from test_torch_training import SA_OPEN_TRAINING

pytestmark = pytest.mark.usefixtures("one_torch_thread", "posterior_mean")

SR = 16000
VAE = copy.deepcopy(CONFIG["model"]["pretransform"])  # a 2-level Oobleck VAE, ratio 16, 4 latents


def _jax_posterior_mean(self, x, return_info=False, train=False):
    z = jnp.split(x, 2, axis=-1)[0]
    return (z, {"kl": jnp.zeros(())}) if return_info else z


@pytest.fixture
def posterior_mean(monkeypatch):
    """The VAE bottleneck returns its posterior mean in both packages."""
    monkeypatch.setattr(jbottleneck.VAEBottleneck, "encode", _jax_posterior_mean)
    monkeypatch.setattr(tbottleneck, "vae_sample", lambda x, generator=None, noise=None: (
        x.chunk(2, dim=1)[0], torch.zeros((), device=x.device)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _draw(shapes, seed=0):
    """Seeded numpy parameters for flax shapes: kernels ~ N(0, 1/fan_in),
    embedding tables and Fourier weights ~ N(0, 1), weight-norm g and norm
    scales ~ 1 + N(0, 0.1), biases and log-scale snake parameters ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if len(a.shape) >= 2:
            std = 1.0 if name in ("weight", "embedding") else np.prod(a.shape[:-1]) ** -0.5
        elif name in ("gamma", "g", "scale"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        else:
            std = 1.0 if name == "weights" else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bank_pair(config, meta, own=()):
    """The JAX bank's outputs with seeded parameters, and the port's
    MultiConditioner with the same parameters (io/from_jax.py)."""
    mc = jcond.create_multi_conditioner_from_conditioning_config(copy.deepcopy(config))
    bank = mc.make_bank()
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(meta))
    shapes = jax.eval_shape(lambda p: bank.init(jax.random.PRNGKey(0), p), prepared)
    params = _draw(shapes.get("params", {}))
    want = bank.apply({"params": params}, prepared)
    port = tcond.create_multi_conditioner_from_conditioning_config(copy.deepcopy(config),
                                                                  device="cpu")
    sd = {}
    for key, mod in jax.tree_util.tree_map(np.asarray, params).items():
        cid = key[len("modules_"):]
        sd.update(conditioner_state_dict(mod, f"conditioners.{cid}.", cid in own))
    missing, unexpected = port.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=False)
    # not in the JAX bank's params: an own pretransform's decoder (the bank
    # only encodes) and CLAP's frozen audio tower and projection (both
    # packages load those from the checkpoint)
    assert not unexpected and all(any(part in k for part in (
        ".pretransform.model.decoder.", ".audio_branch.", ".audio_projection."))
        for k in missing)
    return want, port


def _check(got, want, keys):
    assert sorted(got) == sorted(want) == sorted(keys)
    for key in keys:
        (g, gm), (w, wm) = got[key], want[key]
        assert tuple(g.shape) == tuple(w.shape), key
        assert _rel(g.detach().numpy(), w) < 1e-5, key
        if wm is None:
            assert gm is None, key
        else:
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm).astype(bool), err_msg=key)


@pytest.mark.parametrize("project_out", [False, True])
def test_list_and_phoneme_conditioners_match_jax(project_out):
    config = {"cond_dim": 32, "configs": [
        {"id": "genre", "type": "list", "config": {"options": ["rock", "jazz", "folk"]}},
        {"id": "lyrics", "type": "phoneme", "config": {"max_length": 12,
                                                       "project_out": project_out}}]}
    meta = [{"genre": "jazz", "lyrics": "la la land, ok?"}, {"genre": "polka", "lyrics": "hey"},
            {"genre": "folk", "lyrics": "Ü and a very long line past twelve"}]
    want, port = _bank_pair(config, meta)
    with torch.no_grad():
        got = port(meta, "cpu")
    _check(got, want, ["genre", "lyrics"])
    assert got["lyrics"][0].shape == (3, 12, 32)
    assert (got["genre"][0][1] == port.conditioners["genre"].embedder.weight[0]).all()


def test_pre_encoded_keys_pass_through_as_in_jax():
    # the pre-encoded key's values are the conditioning (f32, mask None) and
    # build no module: the port's conditioner has no parameter for it
    config = {"cond_dim": 16, "pre_encoded_keys": ["prompt"], "configs": [
        {"id": "prompt", "type": "t5", "config": {"t5_model_name": "t5-base"}},
        {"id": "seconds_total", "type": "number", "config": {"max_val": 512}}]}
    rng = np.random.default_rng(3)
    meta = [{"prompt": rng.standard_normal((5, 16)).astype(np.float64), "seconds_total": 20},
            {"prompt": [rng.standard_normal((5, 16))], "seconds_total": 40}]
    want, port = _bank_pair(config, meta)
    assert not any(k.startswith("conditioners.prompt") for k in port.state_dict())
    with torch.no_grad():
        got = port(meta, "cpu")
    _check(got, want, ["prompt", "seconds_total"])
    assert got["prompt"][0].dtype == torch.float32


def test_pretransform_and_source_mix_conditioners_match_jax():
    # each with its own pretransform (the tiny Oobleck VAE), frozen; a stem
    # missing from a source-mix item is left out, and an item without stems
    # takes `source_length` zeros in one channel (which a stereo VAE cannot
    # take beside stereo items, in either package: compared on the host)
    config = {"cond_dim": 24, "configs": [
        {"id": "prompt_audio", "type": "pretransform", "config": {
            "sample_rate": SR, "pretransform_config": VAE, "pretransform_ckpt_path": "unread"}},
        {"id": "stems", "type": "source_mix", "config": {
            "sample_rate": SR, "pretransform_config": VAE, "source_keys": ["bass", "drums"],
            "source_length": 256}}]}
    rng = np.random.default_rng(4)
    clip = lambda: (0.5 * rng.standard_normal((2, 256))).astype(np.float32)  # noqa: E731
    meta = [{"prompt_audio": clip(), "stems": {"bass": clip(), "drums": clip(), "keys": clip()}},
            {"prompt_audio": clip(), "stems": {"drums": clip()}}]
    want, port = _bank_pair(config, meta, own=("prompt_audio", "stems"))
    jmix = jcond.create_multi_conditioner_from_conditioning_config(copy.deepcopy(config))
    np.testing.assert_array_equal(port.conditioners["stems"].mix({}),
                                  jmix.conditioners["stems"].prepare([{}])["mixes"][0])
    for cid in ("prompt_audio", "stems"):
        c = port.conditioners[cid]
        assert any(k.startswith("pretransform.model.") for k in c.state_dict())
        assert not any(p.requires_grad for p in c.pretransform.parameters())
    with torch.no_grad():
        got = port(meta, "cpu")
    _check(got, want, ["prompt_audio", "stems"])
    assert got["prompt_audio"][0].shape == (2, 24, 16)  # [B, D, S] channels first


# -- CLAP audio ----------------------------------------------------------------------------


def _htsat_pair(enable_fusion, seed):
    """A narrow HTSAT (spec 64, width 16, stages 2 / 2 / 2, windows of 4) with
    seeded flax variables, and the port's with the same (io/from_jax.py)."""
    kw = dict(spec_size=64, embed_dim=16, depths=(2, 2, 2), num_heads=(2, 2, 4), window=4,
              mel_bins=16, enable_fusion=enable_fusion)
    jm = jhtsat.HTSAT(**kw)
    mel = jnp.zeros((2, 4 if enable_fusion else 1, 61, 16))
    longer = jnp.ones((2,), bool) if enable_fusion else None
    shapes = jax.eval_shape(lambda m: jm.init(jax.random.PRNGKey(0), m, longer=longer), mel)
    variables = {"params": _draw(shapes["params"], seed)}
    rng = np.random.default_rng(seed + 1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.1 * rng.standard_normal(a.shape) if p[-1].key == "mean"
                      else 0.5 + rng.random(a.shape)).astype(np.float32),
        shapes["batch_stats"])
    port = thtsat.HTSAT(**kw).eval()
    sd = htsat_state_dict(variables)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return jm, variables, port


@pytest.mark.parametrize("enable_fusion", [False, True])
def test_htsat_trunk_matches_jax(enable_fusion):
    # the fusion branch runs for a `longer` flag (one true, one false here)
    jm, variables, port = _htsat_pair(enable_fusion, seed=5)
    mel = np.random.default_rng(6).standard_normal(
        (2, 4 if enable_fusion else 1, 61, 16)).astype(np.float32)
    longer = np.array([True, False]) if enable_fusion else None
    want = np.asarray(jm.apply(variables, jnp.asarray(mel),
                               longer=None if longer is None else jnp.asarray(longer)))
    port.train()  # the BatchNorms keep their running statistics in any mode
    with torch.no_grad():
        got = port(torch.from_numpy(mel),
                   None if longer is None else torch.from_numpy(longer)).numpy()
    assert got.shape == want.shape == (2, 64)
    assert _rel(got, want) < 1e-4


def test_clap_logmel_prepare_and_bicubic_match_jax():
    rng = np.random.default_rng(7)
    audio = (0.3 * rng.standard_normal((2, 24000))).astype(np.float32)
    got = thtsat.clap_logmel(torch.from_numpy(audio)).numpy()
    want = np.asarray(jhtsat.clap_logmel(jnp.asarray(audio)))
    assert got.shape == want.shape == (2, 1, 51, 64)
    assert np.abs(got - want).max() < 1e-4  # dB: 1e-4 dB
    for n in (0, 7, 480000, 500001):
        clip = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(thtsat.prepare_clap_audio(clip),
                                      jhtsat.prepare_clap_audio(clip))
    x = rng.standard_normal((2, 3, 37, 5)).astype(np.float32)
    got = thtsat.bicubic_resize_1d(torch.from_numpy(x), 64, 2)
    assert _rel(got.numpy(), jhtsat.bicubic_resize_1d(jnp.asarray(x), 64, 2)) < 1e-6
    ref = F.interpolate(torch.from_numpy(x), size=(64, 5), mode="bicubic", align_corners=True)
    assert _rel(got.numpy(), ref.numpy()) < 1e-5


@pytest.fixture(scope="module")
def clap_checkpoint(tmp_path_factory):
    """A CLAP checkpoint of laion-clap's names (`audio_branch.*`,
    `audio_projection.*`) written from the port's HTSAT-tiny at seeded random
    weights (BatchNorm statistics drawn too)."""
    cond = tcond.CLAPAudioConditioner(512, audio_model_type="HTSAT-tiny", enable_fusion=False,
                                      allow_random_init=True)
    init_random_(cond, torch.Generator().manual_seed(8))
    with torch.no_grad():
        for name, buf in cond.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(9))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(10))
    path = tmp_path_factory.mktemp("clap") / "clap.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in cond.state_dict().items()}}, path)
    return str(path)


def test_clap_audio_conditioner_matches_jax(clap_checkpoint):
    # HTSAT-tiny (18 Swin blocks) from the same checkpoint on both sides; a
    # stereo clip shorter than 10 s (mixed down, repeat-padded) and a mono
    # one longer (centre-cut); then the trainable projection to cond_dim 64
    config = {"cond_dim": 64, "configs": [{"id": "ref", "type": "clap_audio", "config": {
        "clap_ckpt_path": clap_checkpoint, "audio_model_type": "HTSAT-tiny",
        "enable_fusion": False}}]}
    rng = np.random.default_rng(11)
    meta = [{"ref": (0.3 * rng.standard_normal((2, 150000))).astype(np.float32)},
            {"ref": (0.3 * rng.standard_normal(500000)).astype(np.float32)}]
    want, port = _bank_pair(config, meta)
    cond = port.conditioners["ref"]
    assert not any(p.requires_grad for n, p in cond.named_parameters()
                   if not n.startswith("proj_out."))
    with torch.no_grad():
        got = port(meta, "cpu")
    assert tuple(got["ref"][0].shape) == (2, 1, 64)
    assert _rel(got["ref"][0].numpy(), want["ref"][0]) < 1e-4
    np.testing.assert_array_equal(got["ref"][1].numpy(), np.asarray(want["ref"][1]))
    cond.set_embed_fn(lambda clips: np.ones((len(clips), 512), np.float32))
    assert (cond.features([m["ref"] for m in meta], "cpu") == 1).all()


def test_clap_audio_needs_a_checkpoint_or_random_init():
    with pytest.raises(RuntimeError, match="allow_random_init"):
        tcond.CLAPAudioConditioner(64)
    cond = tcond.CLAPAudioConditioner(64, audio_model_type="HTSAT-large", allow_random_init=True)
    assert cond.audio_branch.num_features == 2048 and cond.proj_out is not None


def test_lut_and_phoneme_with_g2p_are_refused_by_name(monkeypatch):
    config = {"cond_dim": 8, "configs": [{"id": "t", "type": "lut",
                                         "config": {"tokenizer_name": "t5-base"}}]}
    with pytest.raises(NotImplementedError, match="lut"):
        tcond.create_multi_conditioner_from_conditioning_config(config, device="cpu")
    monkeypatch.setitem(sys.modules, "g2p_en", types.ModuleType("g2p_en"))
    with pytest.raises(NotImplementedError, match="g2p_en"):
        tcond.PhonemeConditioner(8)


# -- an audio-prompted DiT -------------------------------------------------------------------


def _prompted_config():
    """The tiny SA-Open-shaped DiT (test_torch_slice.CONFIG) with its T5 left
    out: the audio prompt through the model's own VAE, projected to cond_dim
    64 and concatenated to the DiT's input; a list label and seconds_total
    cross-attended, seconds_total global."""
    config = copy.deepcopy(CONFIG)
    config["model"]["conditioning"]["configs"] = [
        {"id": "audio_prompt", "type": "pretransform",
         "config": {"use_model_pretransform": True, "sample_rate": SR}},
        {"id": "genre", "type": "list", "config": {"options": ["rock", "jazz", "folk"]}},
        {"id": "seconds_total", "type": "number", "config": {"min_val": 0, "max_val": 512}}]
    d = config["model"]["diffusion"]
    d.update(cross_attention_cond_ids=["genre", "seconds_total"],
             global_cond_ids=["seconds_total"], input_concat_ids=["audio_prompt"])
    d["config"].update(input_concat_dim=64, global_cond_dim=64)
    return config


def _prompted_meta(n, seed):
    rng = np.random.default_rng(seed)
    return [{"audio_prompt": (0.3 * rng.standard_normal((2, 1024))).astype(np.float32),
             "genre": ["rock", "jazz", "folk", "none"][i % 4], "seconds_total": 10 + 7 * i}
            for i in range(n)]


@pytest.fixture(scope="module")
def prompted_pair():
    config = _prompted_config()
    model = jax_create(config)
    mc = model._multi_conditioner
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(_prompted_meta(1, 0)))
    with pytest.MonkeyPatch.context() as mp:  # the bank's VAE needs no key
        mp.setattr(jbottleneck.VAEBottleneck, "encode", _jax_posterior_mean)
        shapes = jax.eval_shape(lambda x, t: model.init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, t,
            cond=prepared, method=model.init_full), jnp.zeros((1, 4, 64)), jnp.ones((1,)))
    params = _draw(shapes["params"])
    # flax binds the one pretransform to the conditioner bank, where it meets it first
    assert "pretransform" not in params
    assert "pretransform" in params["conditioner"]["modules_audio_prompt"]
    port = create_model_from_config(config, "cpu")
    assert port.conditioner.conditioners["audio_prompt"].pretransform is port.pretransform
    sd = diffusion_cond_state_dict(params, dim_heads=64)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model, params, port.eval()


def test_prompted_conditioning_and_generation_match_jax(prompted_pair):
    # 6 CFG steps of dpmpp-3m-sde with the JAX package's noise replayed:
    # f32 sums reassociated through 12 DiT calls, the prompt's encode and the
    # decoder, 1e-4 of the peak (the conditioning alone 1e-5)
    from stable_audio_tools_tpu.inference.generation import compute_conditioning_tensors

    model, params, port = prompted_pair
    meta = _prompted_meta(1, 1)
    want = compute_conditioning_tensors(model, {"params": params}, meta)
    with torch.no_grad():
        got = port.conditioner(meta, "cpu")
    _check(got, want, ["audio_prompt", "genre", "seconds_total"])
    gen = dict(steps=6, cfg_scale=4.0, batch_size=1, sample_size=1024, seed=7, sigma_min=0.3,
               sigma_max=50.0, sampler_type="dpmpp-3m-sde")
    want = np.asarray(jax_generate(model, {"params": params}, conditioning=meta, **gen))
    noise, step_noise = _replayed_noise((1, 4, 64))
    got = generate_diffusion_cond(port, conditioning=meta, noise=noise, step_noise=step_noise,
                                  **gen).numpy()
    assert got.shape == want.shape == (1, 2, 1024)
    assert _rel(got, want) < 1e-4


def test_prompted_training_step_matches_jax(prompted_pair):
    # one AdamW step (SA-Open's optimizer) with CFG dropout off: the trainable
    # parameters are the DiT's, the list table, the prompt's projection and
    # the number embedder, never the VAE (its encode is under no_grad, the
    # JAX package's stop_gradient); the loss 1e-5, each gradient 1e-4 of its
    # largest entry, the step's change 1e-2 of the learning rate where Adam's
    # normalisation is well conditioned (|g| > 1e-2 max |g|), elsewhere
    # within it, plus 2 ulps of the parameter
    from stable_audio_tools_tpu.training.utils import build_optimizer

    model, params, port = prompted_pair
    port = copy.deepcopy(port).train()
    config = _prompted_config()
    config["training"] = copy.deepcopy(SA_OPEN_TRAINING)
    wrapper = create_training_wrapper_from_config(config, port)
    names = list(wrapper.params)
    assert {n.split(".")[2] for n in names if n.startswith("conditioner.")} == {
        "audio_prompt", "genre", "seconds_total"}
    assert not any(n.startswith("pretransform.") or ".pretransform." in n for n in names)
    p_before = {n: p.detach().clone() for n, p in wrapper.params.items()}

    B = 2
    meta = _prompted_meta(B, 2)
    rng = np.random.default_rng(3)
    audio = (0.5 * rng.standard_normal((B, 2, 1024))).astype(np.float32)
    t = rng.random(B).astype(np.float32)
    mc = model._multi_conditioner
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(meta))
    z = np.asarray(model.apply({"params": params}, jnp.asarray(audio),
                               method=lambda m, a: m.pretransform.model.encode(a)))
    noise = rng.standard_normal(z.shape).astype(np.float32)

    def jloss(params):
        a, s = jnp.cos(t * math.pi / 2)[:, None, None], jnp.sin(t * math.pi / 2)[:, None, None]
        out = model.apply({"params": params}, z * a + noise * s, jnp.asarray(t), cond=prepared,
                          cfg_dropout_prob=0.0, train=True)
        return jnp.mean(jnp.square(out - (noise * a - z * s)))

    loss, grads = jax.value_and_grad(jloss)(params)
    entry = config["training"]["optimizer_configs"]["diffusion"]
    jopt = build_optimizer(entry)
    updates, _ = jopt.update(grads, jopt.init(params), params)
    new_params = optax.apply_updates(params, updates)
    lr = entry["optimizer"]["config"]["lr"] * (1 - 0.99)

    aux = wrapper.train_step(torch.from_numpy(audio), meta, t=torch.from_numpy(t),
                             noise=torch.from_numpy(noise),
                             cfg_dropout_mask=torch.zeros(B, dtype=torch.bool))
    np.testing.assert_allclose(float(aux["loss"]), float(loss), rtol=1e-5)
    want_g = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, grads), 64)
    want_p = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, new_params), 64)
    for n in names:
        p = wrapper.params[n]
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, n
        assert _rel(p.grad.numpy(), want_g[n]) < 1e-4, n
        ok = np.abs(want_g[n]) > 1e-2 * np.abs(want_g[n]).max()
        ulps = 2 * np.spacing(np.abs(p_before[n].numpy()) + 2 * lr)
        err = np.abs((p.detach() - p_before[n]).numpy() - (want_p[n] - p_before[n].numpy()))
        assert (err[ok] <= 1e-2 * lr + ulps[ok]).all(), n
        assert (err <= 2.0 * lr + ulps).all(), n
