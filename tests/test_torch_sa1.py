"""The SA-1.0 slice of the port against the JAX package on the CPU: a tiny
SA-1.0-shaped model (CLAP text features and two int conditioners
cross-attended by an ADP `UNetCFG1d`, a DAC VAE) with the JAX model's
weights carried by io/from_jax.py, through the conditioning, guided
generation on replayed noise (a negative prompt, the CFG rescale) and
generation from init audio; the port's state dict read back by the JAX
package's importers; the shipped SA-1.0 and DAC VAE configs; and what the
slice refuses by name. f32 throughout; each tolerance is stated at its
test."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.inference import generation as jgen
from stable_audio_tools_tpu.io import checkpoints as jck
from stable_audio_tools_tpu.io import torch_mapping as jtm
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu_torch.inference import generation as tgen
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import adp as tadp
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

from test_torch_sa1_modules import draw_params
from test_torch_sa2 import META, NEGATIVE, SEED, _jax_vae_noise, _make_clap_ckpt, _replayed_noise
from test_torch_slice import jax_tokenizer, stable_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _sa1_config(clap_path):
    """SA-1.0's shape at toy size, f32: CLAP hidden states (layer -2) and two
    int conditioners, 79 context tokens 64 wide, cross-attended by a 3-level
    UNetCFG1d (64 / 64 / 96 channels, factors 1 and 2, 16 resnet groups, a
    transformer block at every level); a DAC VAE at ratio 8 (encoder 16 ->
    32 -> 64 channels into 8, decoder 96 -> 48 -> 24 from 4 latents)."""
    return {
        "model_type": "diffusion_cond", "sample_size": 2048, "sample_rate": 16000,
        "audio_channels": 2,
        "model": {
            "pretransform": {"type": "autoencoder", "iterate_batch": True, "config": {
                "encoder": {"type": "dac", "config": {"in_channels": 2, "latent_dim": 8,
                                                       "d_model": 16, "strides": [2, 4]}},
                "decoder": {"type": "dac", "config": {"out_channels": 2, "latent_dim": 4,
                                                       "channels": 96, "rates": [4, 2]}},
                "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
                "io_channels": 2}},
            "conditioning": {"cond_dim": 64, "configs": [
                {"id": "prompt", "type": "clap_text", "config": {
                    "audio_model_type": "HTSAT-base", "enable_fusion": True,
                    "clap_ckpt_path": clap_path, "use_text_features": True,
                    "feature_layer_ix": -2}},
                {"id": "seconds_start", "type": "int", "config": {"min_val": 0, "max_val": 512}},
                {"id": "seconds_total", "type": "int", "config": {"min_val": 0, "max_val": 512}}]},
            "diffusion": {
                "cross_attention_cond_ids": ["prompt", "seconds_start", "seconds_total"],
                "type": "adp_cfg_1d",
                "config": {"in_channels": 4, "context_embedding_features": 64,
                           "context_embedding_max_length": 79, "channels": 32,
                           "resnet_groups": 16, "kernel_multiplier_downsample": 2,
                           "multipliers": [2, 2, 3], "factors": [1, 2], "num_blocks": [1, 2],
                           "attentions": [1, 1, 1], "attention_heads": 2,
                           "attention_multiplier": 2, "use_nearest_upsample": False,
                           "use_skip_scale": True, "use_context_time": True}},
            "io_channels": 4,
        },
    }


def _sa1_pair(config):
    """(JAX model, its variables, the port's model with the same weights)."""
    model = jax_create(config)
    mc = model._multi_conditioner
    clap = mc.conditioners["prompt"]
    clap._tower = (jax_tokenizer(77),) + tuple(clap._load_tower()[1:])
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(META))
    shapes = jax.eval_shape(lambda x, t: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        x, t, cond=prepared, method=model.init_full), jnp.zeros((1, 4, 64)), jnp.ones((1,)))
    params = draw_params(shapes["params"], 21)
    # the decoder's weight-norm gains halved: at gains ~1 the random DAC
    # decoder's pre-tanh values grow large and amplify the sampler's f32
    # differences in the latents past the tolerance where the tanh is not
    # saturated; at ~0.5 it stays near 1, and the audio is compared, not the
    # tanh's saturation
    dec = params["pretransform"]["model"]["decoder"]
    params["pretransform"]["model"]["decoder"] = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 0.5 if path[-1].key == "g" else a, dec)
    port = create_model_from_config(config, "cpu")
    port.conditioner.conditioners["prompt"].tokenizer = stable_tokenizer(77)
    sd = from_jax.diffusion_cond_state_dict(params)
    missing, unexpected = port.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=False)
    tower = "conditioner.conditioners.prompt."
    assert not unexpected and all(
        k.startswith((tower + "model.", tower + "text_projection.")) for k in missing), missing
    return model, {"params": params}, port.eval()


@pytest.fixture(scope="module")
def clap_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clap") / "clap.pt")
    _make_clap_ckpt(path)
    return path


@pytest.fixture(scope="module")
def sa1_pair(clap_path):
    return _sa1_pair(_sa1_config(clap_path))


def test_sa1_conditioning_and_routing_match_jax(sa1_pair):
    # CLAP's 77 hidden states and the two int embeddings: 79 tokens, all
    # unmasked; f32 RoBERTa: 3e-5
    model, variables, port = sa1_pair
    want = jgen.compute_conditioning_tensors(model, variables, META)
    with torch.no_grad():
        got = port.conditioner(META, "cpu")
    for key in want:
        np.testing.assert_allclose(got[key][0].numpy(), np.asarray(want[key][0]),
                                   atol=3e-5, rtol=1e-5, err_msg=key)
        np.testing.assert_array_equal(got[key][1].numpy(), np.asarray(want[key][1]).astype(bool))
    inputs = port.get_conditioning_inputs(got)
    assert inputs["cross_attn_cond"].shape == (1, 79, 64) and inputs["cross_attn_mask"].all()
    table = port.conditioner.conditioners["seconds_total"].int_embedder.weight
    np.testing.assert_array_equal(inputs["cross_attn_cond"][0, 78].numpy(),
                                  table[30].detach().numpy())


# f32 end to end through 4 sampler steps, the UNet at CFG batch 2 and the DAC
# decode; as the earlier slices' generation tests: 2e-4 of the audio's peak
GEN_TOL = 2e-4


@pytest.mark.parametrize("case", ["negative", "rescale"])
def test_generate_matches_jax(sa1_pair, case):
    model, variables, port = sa1_pair
    kw = dict(steps=4, cfg_scale=6.0, batch_size=1, sample_size=1024, seed=SEED,
              sigma_min=0.3, sigma_max=50.0, sampler_type="dpmpp-3m-sde")
    if case == "negative":
        kw.update(negative_conditioning=NEGATIVE)
    else:
        kw.update(scale_phi=0.4)
    want = np.asarray(jgen.generate_diffusion_cond(model, variables, conditioning=META, **kw))
    noise, step_noise = _replayed_noise((1, 4, 128))
    calls = []
    unet = port.model.model
    hook = unet.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
    try:
        got = tgen.generate_diffusion_cond(port, conditioning=META, noise=noise,
                                           step_noise=step_noise, **kw).numpy()
    finally:
        hook.remove()
    assert got.shape == want.shape == (1, 2, 1024)
    np.testing.assert_allclose(got, want, atol=GEN_TOL * np.abs(want).max())
    # one UNet call a step (dpmpp-3m-sde: one model call a step), which
    # runs the doubled CFG batch inside
    assert calls == [1] * 4


def test_generate_from_init_audio_matches_jax(sa1_pair):
    # the DAC encoder and the VAE on 1024 samples of init audio (the VAE's
    # noise replayed), varied at sigma 5 with dpmpp-2m; f32: 2e-4
    model, variables, port = sa1_pair
    audio = (0.3 * np.random.default_rng(22).standard_normal((2, 1024))).astype(np.float32)
    kw = dict(steps=4, cfg_scale=6.0, batch_size=1, sample_size=1024, seed=SEED, sigma_min=0.3,
              sampler_type="dpmpp-2m", init_noise_level=5.0)
    want = np.asarray(jgen.generate_diffusion_cond(model, variables, conditioning=META,
                                                   init_audio=(16000, audio), **kw))
    noise, _ = _replayed_noise((1, 4, 128))
    got = tgen.generate_diffusion_cond(
        port, conditioning=META, init_audio=(16000, audio), noise=noise,
        init_noise=_jax_vae_noise(model, variables, audio[None]), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=GEN_TOL * np.abs(want).max())


def test_cfg_interval_is_ignored_as_in_jax(sa1_pair):
    # the JAX UNetCFG1DWrapper takes cfg_interval into **kwargs and drops it:
    # guidance applies at every sigma, so any interval gives the same audio
    _, _, port = sa1_pair
    kw = dict(steps=3, cfg_scale=6.0, conditioning=META, sample_size=256, seed=3,
              sampler_type="dpmpp-2m")
    full = tgen.generate_diffusion_cond(port, cfg_interval=(0.0, 1.0), **kw)
    none = tgen.generate_diffusion_cond(port, cfg_interval=(0.9, 0.95), **kw)
    assert torch.equal(full, none)
    plain = tgen.generate_diffusion_cond(port, **dict(kw, cfg_scale=1.0))
    assert not torch.allclose(plain, full)  # while the scale itself is used


def test_state_dict_reads_back_through_jax_importers(sa1_pair):
    # the port's state dict (reference names) into the JAX model through
    # import_diffusion_cond_state_dict: the same UNet output and decode as the
    # port's own, f32: 1e-4 of the peak (UNet), 2e-5 (decode)
    model, variables, port = sa1_pair
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    back = jtm.import_diffusion_cond_state_dict(model, sd)["params"]
    assert (jax.tree_util.tree_map(np.shape, back["model"])
            == jax.tree_util.tree_map(np.shape, variables["params"]["model"]))
    rng = np.random.default_rng(23)
    x = rng.standard_normal((1, 4, 32)).astype(np.float32)
    with torch.no_grad():
        tensors = port.conditioner(META, "cpu")
        cond = port.get_conditioning_inputs(tensors)
        got = port(_t(x), torch.tensor([0.4]), cfg_scale=6.0, **cond).numpy()
        got_audio = port.pretransform.decode(_t(x)).numpy()
    jcond = {k: (jnp.asarray(c[0].numpy()), jnp.asarray(c[1].numpy()))
             for k, c in tensors.items()}
    full = dict(variables["params"], **back)
    want = np.asarray(model.apply({"params": full}, jnp.asarray(x), jnp.asarray([0.4]),
                                  cond_tensors=jcond, cfg_scale=6.0))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    want_audio = np.asarray(model.apply({"params": full}, jnp.asarray(x),
                                        method=lambda m, z: m.pretransform_decode(z)))
    np.testing.assert_allclose(got_audio, want_audio, atol=2e-5 * np.abs(want_audio).max())
    # ... and the conditioners' int embedders
    for cid in ("seconds_start", "seconds_total"):
        np.testing.assert_array_equal(
            np.asarray(back["conditioner"][f"modules_{cid}"]["int_embedder"]["embedding"]),
            sd[f"conditioner.conditioners.{cid}.int_embedder.weight"])


# -- the shipped configs ----------------------------------------------------------------


def _shipped(name, clap_path=None):
    with open(os.path.join(CONFIGS, name)) as f:
        config = json.load(f)
    if clap_path is not None:
        clap = config["model"]["conditioning"]["configs"][0]["config"]
        assert clap["clap_ckpt_path"] == "/path/to/clap.ckpt"  # a placeholder in the shipped file
        clap["clap_ckpt_path"] = clap_path
    return config


def _jax_count(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))


def test_shipped_sa1_config_builds_unchanged(clap_path):
    # the shipped JSON on the meta device (shapes, no memory): the UNet of
    # 906.7 M parameters (the JAX package's count by jax.eval_shape), 23
    # transformer blocks, the DAC VAE (encoder 89.6 M, decoder 43.9 M) at
    # ratio 1024 in bf16, one item at a time, unchunked
    from stable_audio_tools_tpu.models.adp import create_adp_cond_wrapper

    config = _shipped("txt2audio/stable_audio_1_0.json", clap_path)
    model = create_model_from_config(config, "meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    unet = model.model.model
    assert isinstance(unet, tadp.UNetCFG1d)
    blocks = [m for m in unet.modules() if isinstance(m, tadp.ADPTransformerBlock)]
    assert len(blocks) == 23 and all(b.cross_attention is not None for b in blocks)
    assert unet.fixed_embedding.embedding.weight.shape == (79, 768)
    assert unet.downsamples[3].downsample.weight.shape == (1280, 1280, 9)
    assert unet.upsamples[0].upsample.weight.shape == (1280, 1280, 8)
    jax_unet = create_adp_cond_wrapper("adp_cfg_1d", config["model"]["diffusion"]["config"])
    shapes = jax.eval_shape(lambda: jax_unet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64)), jnp.ones((1,)),
        cross_attn_cond=jnp.zeros((1, 79, 768)), cfg_scale=1.0))
    n_unet = sum(p.numel() for p in unet.parameters())
    assert n_unet == _jax_count(shapes["params"]) == 906_679_744
    pt = model.pretransform
    assert pt.model_half and pt.iterate_batch and not pt.chunked
    assert pt.downsampling_ratio == 1024 and pt.encoded_channels == 64
    ae = pt.model
    assert sum(p.numel() for p in ae.encoder.parameters()) == 89_574_656
    assert sum(p.numel() for p in ae.decoder.parameters()) == 43_856_644
    assert ae.encoder.proj_out.weight.shape == (128, 2048, 1)
    assert ae.decoder.decoder.model[-1].weight_v.shape == (2, 96, 7)
    for cid in ("seconds_start", "seconds_total"):
        assert model.conditioner.conditioners[cid].int_embedder.weight.shape == (513, 768)


@pytest.mark.parametrize("name", ["stable_audio_1_0_vae", "dac_2048_32_vae"])
def test_shipped_dac_vae_configs_build_and_round_trip(name):
    # the shipped JSON on the meta device: the JAX package's parameter count;
    # then its shape at 32 channels (decoder 128) on the CPU: encode and
    # decode keep the length and the channels, and the encoder's output
    # matches the JAX encoder's with the same weights (f32: 2e-5 of the peak)
    config = _shipped(f"autoencoders/{name}.json")
    meta = create_model_from_config(config, "meta")
    jax_ae = jax_create(config)
    io, ratio = config["model"]["io_channels"], config["model"]["downsampling_ratio"]
    shapes = jax.eval_shape(lambda: jax_ae.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, io, 2 * ratio))))
    assert sum(p.numel() for p in meta.parameters()) == _jax_count(shapes["params"])

    small = copy.deepcopy(config)
    small["model"]["encoder"]["config"]["d_model"] = 4
    small["model"]["decoder"]["config"]["channels"] = 128
    jax_ae = jax_create(small)
    audio = (0.3 * np.random.default_rng(24).standard_normal((1, io, 2 * ratio))).astype(np.float32)
    shapes = jax.eval_shape(lambda: jax_ae.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jnp.asarray(audio)))
    params = draw_params(shapes["params"], 25)
    port = create_model_from_config(small, "cpu").eval()
    port.load_state_dict({k: _t(v) for k, v in from_jax.autoencoder_state_dict(params).items()},
                         strict=True)
    with torch.no_grad():
        latents = port.encode(_t(audio), noise=torch.zeros(1, config["model"]["latent_dim"], 2))
        back = port.decode(latents)
        pre = port.encoder(_t(audio)).numpy()
    assert latents.shape == (1, config["model"]["latent_dim"], 2)
    assert back.shape == (1, io, 2 * ratio) and torch.isfinite(back).all()
    want = np.asarray(jax_ae.apply({"params": params}, jnp.asarray(audio),
                                   method=lambda m, a: m.encoder(a.transpose(0, 2, 1))))
    np.testing.assert_allclose(pre, want.transpose(0, 2, 1), atol=2e-5 * np.abs(want).max())
    # the port's state dict reads back through import_autoencoder_state_dict
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    again = jck.import_autoencoder_state_dict(jax_ae, sd)["params"]
    for k, v in from_jax.autoencoder_state_dict(
            jax.tree_util.tree_map(np.asarray, again)).items():
        np.testing.assert_allclose(v, sd[k], atol=1e-6, err_msg=k)


# -- refusals -----------------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["use_stft", "use_stft_context", "use_ncca", "use_xattn_time",
                                  "use_nearest_upsample"])
def test_unported_unet_options_are_refused_by_name(clap_path, flag):
    config = _sa1_config(clap_path)
    config["model"]["diffusion"]["config"][flag] = True
    with pytest.raises(NotImplementedError, match=flag):
        create_model_from_config(config, "meta")


@pytest.mark.parametrize("kind", ["adp_1d", "adp_uncond_1d"])
def test_unported_adp_model_types_are_refused_by_name(clap_path, kind):
    if kind == "adp_1d":
        config = _sa1_config(clap_path)
        config["model"]["diffusion"]["type"] = kind
    else:
        config = {"model_type": "diffusion_uncond", "sample_size": 1024, "sample_rate": 16000,
                  "model": {"type": kind, "config": {}}}
    with pytest.raises(NotImplementedError, match=kind):
        create_model_from_config(config, "meta")


def test_training_adp_and_dac_is_refused_by_name(clap_path):
    # training `adp_cfg_1d` and DAC towers is ported
    # (tests/test_torch_sa1_training.py, test_torch_dac_training.py): their
    # trainers build; the plain conditional ADP UNet (`adp_1d`) is still
    # refused by name
    config = _sa1_config(clap_path)
    config["training"] = {"learning_rate": 1e-4}
    w = create_training_wrapper_from_config(config, create_model_from_config(config, "cpu"))
    assert any(n.startswith("model.model.") for n in w.params)
    config["model"]["diffusion"]["type"] = "adp_1d"
    with pytest.raises(NotImplementedError, match="adp_1d"):
        create_training_wrapper_from_config(config, None)
    vae = _sa1_config(clap_path)["model"]["pretransform"]["config"]
    vae = {"model_type": "autoencoder", "sample_size": 2048, "sample_rate": 16000,
           "audio_channels": 2, "model": vae, "training": {"learning_rate": 1e-4}}
    w = create_training_wrapper_from_config(vae, create_model_from_config(vae, "cpu"))
    assert any(n.endswith(".alpha") for n in w.params)
