"""The whole slice: a tiny SA-Open-shaped `diffusion_cond` config through both
factories and both `generate_diffusion_cond`s, with the JAX model's
parameters (and its T5 tower's) carried into the port by io/from_jax.py and
the JAX package's random numbers replayed into the port.

Shape: T5 (2 layers of 64) + two number conditioners, a DiT of depth 2, width
128, heads of 64 (one prepended global token, cross-attention with 2 query
heads per key/value head as SA-Open), a 2-level Oobleck VAE; 6 sampler steps.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from stable_audio_tools_tpu_torch.io.from_jax import diffusion_cond_state_dict
from stable_audio_tools_tpu_torch.models.conditioners import FallbackTokenizer
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

T5_ARCH = dict(d_model=64, d_ff=128, num_layers=2, num_heads=2, d_kv=32)
CONFIG = {
    "model_type": "diffusion_cond",
    "sample_size": 1024,
    "sample_rate": 16000,
    "audio_channels": 2,
    "model": {
        "pretransform": {
            "type": "autoencoder",
            "config": {
                "encoder": {"type": "oobleck", "config": {
                    "in_channels": 2, "channels": 8, "c_mults": [1, 2], "strides": [4, 4],
                    "latent_dim": 8, "use_snake": True}},
                "decoder": {"type": "oobleck", "config": {
                    "out_channels": 2, "channels": 8, "c_mults": [1, 2], "strides": [4, 4],
                    "latent_dim": 4, "use_snake": True, "final_tanh": False}},
                "bottleneck": {"type": "vae"},
                "latent_dim": 4, "downsampling_ratio": 16, "io_channels": 2,
            },
        },
        "conditioning": {
            "configs": [
                {"id": "prompt", "type": "t5", "config": {
                    "t5_model_name": "t5-base", "max_length": 8, "allow_random_init": True,
                    "arch": [T5_ARCH[k] for k in ("d_model", "d_ff", "num_layers",
                                                  "num_heads", "d_kv")] + [False]}},
                {"id": "seconds_start", "type": "number",
                 "config": {"min_val": 0, "max_val": 512}},
                {"id": "seconds_total", "type": "number",
                 "config": {"min_val": 0, "max_val": 512}},
            ],
            "cond_dim": 64,
        },
        "diffusion": {
            "cross_attention_cond_ids": ["prompt", "seconds_start", "seconds_total"],
            "global_cond_ids": ["seconds_start", "seconds_total"],
            "type": "dit",
            "diffusion_objective": "v",
            "config": {"io_channels": 4, "embed_dim": 128, "depth": 2, "num_heads": 2,
                       "cond_token_dim": 64, "global_cond_dim": 128,
                       "project_cond_tokens": False, "use_checkpointing": False},
        },
        "io_channels": 4,
    },
}
META = [{"prompt": "warm analog pads", "seconds_start": 3, "seconds_total": 30}]
SEED = 7
GEN = dict(steps=6, cfg_scale=4.0, batch_size=1, sample_size=1024, seed=SEED,
           sigma_min=0.3, sigma_max=50.0)


def stable_tokenizer(max_length):
    """The fallback word-hash tokenizer with CRC-32 in place of Python's
    `hash`, which is salted per process: every run and every test worker sees
    the same token ids, so the comparisons below do not move with them (over
    8 salts the f32 end-to-end error spans 1.7e-5 to 8e-5 of the peak)."""
    import zlib

    return FallbackTokenizer(max_length, word_hash=lambda w: zlib.crc32(w.encode("utf-8")))


def jax_tokenizer(max_length):
    """The JAX package's own `_FallbackTokenizer`, its word hash made the same
    CRC-32: the name `hash` is set in that module's namespace for the length
    of a call, where it shadows the salted builtin. The port's tokenizer
    takes no part on the JAX side, so a fault in its padding, end id or mask
    shows in the end-to-end comparisons."""
    import zlib

    import stable_audio_tools_tpu.models.conditioners as jcond

    tok = jcond._FallbackTokenizer(max_length)

    def call(texts, **kwargs):
        jcond.hash = lambda w: zlib.crc32(w.encode("utf-8"))
        try:
            return tok(texts, **kwargs)
        finally:
            del jcond.hash

    return call


def _jax_model(config):
    """The JAX model with a small T5 tower in place of t5-base's (the JAX
    conditioner ignores the port-only `arch` key), and the tower's params."""
    from transformers import FlaxT5EncoderModel, T5Config

    model = jax_create(config)
    mc = model._multi_conditioner
    t5 = mc.conditioners["prompt"]
    flax_t5 = FlaxT5EncoderModel(T5Config(feed_forward_proj="relu", **T5_ARCH), _do_init=False)
    t5_params = jax.jit(lambda r: flax_t5.init_weights(r, (1, 1)))(jax.random.PRNGKey(3))
    encode = jax.jit(lambda i, m: flax_t5(input_ids=i, attention_mask=m, params=t5_params)
                     .last_hidden_state)
    t5._t5, t5._tokenizer, t5._encode = flax_t5, jax_tokenizer(8), encode
    t5.dim = T5_ARCH["d_model"]
    model = model.clone(conditioner=mc.make_bank())
    object.__setattr__(model, "_multi_conditioner", mc)
    return model, jax.tree_util.tree_map(np.asarray, t5_params)


def _init_params(model):
    """Seeded numpy parameters for the JAX model's parameter shapes (traced
    with eval_shape: no compile): kernels ~ N(0, 1/fan_in), Fourier and
    embedding tables ~ N(0, 1), norm scales and weight-norm g ~ 1 + N(0, 0.1),
    biases and log-scale snake parameters ~ N(0, 0.1)."""
    mc = model._multi_conditioner
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(META))
    shapes = jax.eval_shape(lambda x, t: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        x, t, cond=prepared, method=model.init_full), jnp.zeros((1, 4, 64)), jnp.ones((1,)))
    rng = np.random.default_rng(0)

    def draw(path, a):
        name = path[-1].key
        if len(a.shape) >= 2:  # dense and conv kernels, embeddings
            std = 1.0 if name in ("weight", "embedding") else np.prod(a.shape[:-1]) ** -0.5
        elif name in ("gamma", "g"):  # norm scales, weight-norm magnitudes
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        else:  # biases, log-scale snake parameters, Fourier weights
            std = 1.0 if name == "weights" else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _pair(config, params=None):
    """(JAX model, its variables, the port's model with the same weights);
    `params` reuses another pair's parameters (same config up to dtypes)."""
    model, t5_params = _jax_model(config)
    params = _init_params(model) if params is None else params
    port = create_model_from_config(config, "cpu")
    # f32 T5 compute, as the f32 Flax tower _jax_model puts in place of the
    # JAX package's bf16 one
    port.conditioner.conditioners["prompt"].model.compute_dtype = torch.float32
    port.conditioner.conditioners["prompt"].tokenizer = stable_tokenizer(8)
    sd = diffusion_cond_state_dict(params, dim_heads=64, t5_params={"prompt": t5_params})
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model, {"params": params}, port.eval()


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(CONFIG)


def _replayed_noise(shape):
    """The JAX package's noise for seed SEED: the initial latent noise from
    fold_in(key, 0) in [B, C, T], and step i's SDE noise from
    fold_in(fold_in(key, 1), i) drawn in the [B, T, C] layout sample_k runs in."""
    key = jax.random.PRNGKey(SEED)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 0), shape)))
    sampler_key = jax.random.fold_in(key, 1)

    def step_noise(i, x):
        n = jax.random.normal(jax.random.fold_in(sampler_key, i),
                              (x.shape[0], x.shape[2], x.shape[1]))
        return torch.from_numpy(np.ascontiguousarray(np.asarray(n).transpose(0, 2, 1)))

    return noise, step_noise


@pytest.mark.parametrize("sampler", ["dpmpp-2m", "dpmpp-3m-sde"])
def test_generate_matches_jax_f32(f32_pair, sampler):
    # f32 end to end: conditioning, 6 CFG sampler steps, VAE decode. The
    # sums are reassociated differently (f32, ~1e-6 relative per op) and
    # pass through 12 DiT calls and the decoder: 2e-4 relative to the peak.
    model, variables, port = f32_pair
    want = np.asarray(jax_generate(model, variables, conditioning=META,
                                   sampler_type=sampler, **GEN))
    noise, step_noise = _replayed_noise((1, 4, 64))
    got = generate_diffusion_cond(port, conditioning=META, sampler_type=sampler, noise=noise,
                                  step_noise=step_noise, **GEN).numpy()
    assert got.shape == want.shape == (1, 2, 1024)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_conditioning_matches_jax(f32_pair):
    from stable_audio_tools_tpu.inference.generation import compute_conditioning_tensors

    model, variables, port = f32_pair
    want = compute_conditioning_tensors(model, variables, META)
    with torch.no_grad():
        got = port.conditioner(META, "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key][0].numpy(), np.asarray(want[key][0]),
                                   atol=2e-5, rtol=1e-5, err_msg=key)
        np.testing.assert_array_equal(got[key][1].numpy(), np.asarray(want[key][1]).astype(bool))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_generate_matches_jax_bf16(f32_pair):
    # SA-Open's precision: DiT compute in bf16 and the VAE in bf16
    # (model_half), with the f32 pair's weights. bf16 keeps 8 significant
    # bits and the frameworks round in different places (the JAX CPU snake
    # runs wholly in bf16, the port's in f32 and rounds once); 6 CFG steps
    # and a random decoder amplify that to ~10% (relative L2) for either
    # side. The bound is the JAX package's own bf16 error: the port's bf16
    # audio is at most 1.25x as far from the f32 audio as the JAX package's
    # bf16 audio is, and within the triangle bound (2.25x) of it.
    config = copy.deepcopy(CONFIG)
    config["model"]["diffusion"]["config"]["compute_dtype"] = "bfloat16"
    config["model"]["pretransform"]["model_half"] = True
    model, variables, port = _pair(config, params=f32_pair[1]["params"])
    kw = dict(conditioning=META, sampler_type="dpmpp-2m", **GEN)
    want_bf16 = np.asarray(jax_generate(model, variables, **kw))
    want_f32 = np.asarray(jax_generate(f32_pair[0], f32_pair[1], **kw))
    noise, _ = _replayed_noise((1, 4, 64))
    got = generate_diffusion_cond(port, noise=noise, **kw).numpy()
    assert np.isfinite(got).all()
    jax_err = _rel_l2(want_bf16, want_f32)
    assert _rel_l2(got, want_f32) <= 1.25 * jax_err
    assert _rel_l2(got, want_bf16) <= 2.25 * jax_err


def test_shipped_sa_open_config_builds_unchanged():
    # the shipped JSON through the port's factory (on the meta device: no
    # memory), with the published widths: DiT 24 x 1536, 24 heads of 64,
    # cross-attention to 768-wide tokens, a 128-channel Oobleck VAE, t5-base
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "stable_audio_tools_tpu", "configs", "model_configs", "txt2audio",
                        "stable_audio_open_1_0.json")
    with open(path) as f:
        config = json.load(f)
    config["model"]["conditioning"]["configs"][0]["config"]["allow_random_init"] = True
    model = create_model_from_config(config, "meta")
    dit = model.model.model
    assert len(dit.transformer.layers) == 24
    block = dit.transformer.layers[0]
    assert block.self_attn.to_qkv.weight.shape == (3 * 1536, 1536)
    assert block.cross_attn.to_kv.weight.shape == (2 * 768, 768)
    assert block.ff.ff[0].proj.weight.shape == (2 * 6144, 1536)
    assert model.pretransform.model_half and model.pretransform.downsampling_ratio == 2048
    dec = model.pretransform.model.decoder
    assert dec.layers[0].weight_v.shape == (2048, 64, 7)
    assert dec.layers[-1].weight_v.shape == (2, 128, 7)
    t5 = model.conditioner.conditioners["prompt"].model
    assert len(t5.encoder.block) == 12 and t5.shared.weight.shape == (32128, 768)
    # the same parameter count as the JAX package's DiT for this config
    from stable_audio_tools_tpu.models.diffusion import _dit_from_config

    diffusion = config["model"]["diffusion"]
    jax_dit = _dit_from_config(diffusion["config"], "v")
    shapes = jax.eval_shape(lambda: jax_dit.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 1024)), jnp.ones((1,)),
        cross_attn_cond=jnp.zeros((1, 130, 768)), global_embed=jnp.zeros((1, 1536))))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in dit.parameters()) == want
