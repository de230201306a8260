"""Each module of the port against its JAX counterpart, with the same
parameters carried across by io/from_jax.py.

Parameters are seeded numpy values at the JAX modules' parameter shapes
(the JAX package zero-initialises some projections, which would make the
comparison trivial). Everything runs in f32 on the CPU; unless a test says otherwise
the tolerance is 1e-5 relative / 1e-5 absolute on O(1) outputs, i.e. f32
reassociation of the same sums (the JAX side runs matmuls at "highest"
precision, tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import autoencoders as jae
from stable_audio_tools_tpu.models import conditioners as jcond
from stable_audio_tools_tpu.models import dit as jdit
from stable_audio_tools_tpu.ops import activations as jact
from stable_audio_tools_tpu.ops import attention as jattn
from stable_audio_tools_tpu.ops import conv as jconv
from stable_audio_tools_tpu.ops import embeddings as jemb
from stable_audio_tools_tpu.ops import norms as jnorms
from stable_audio_tools_tpu.ops import transformer as jtr
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import autoencoders as tae
from stable_audio_tools_tpu_torch.models import conditioners as tcond
from stable_audio_tools_tpu_torch.models import dit as tdit
from stable_audio_tools_tpu_torch.models import t5 as tt5
from stable_audio_tools_tpu_torch.ops import activations as tact
from stable_audio_tools_tpu_torch.ops import attention as tattn
from stable_audio_tools_tpu_torch.ops import conv as tconv
from stable_audio_tools_tpu_torch.ops import embeddings as temb
from stable_audio_tools_tpu_torch.ops import norms as tnorms
from stable_audio_tools_tpu_torch.ops import transformer as ttr


def _init(module, *args, seed=0, **kwargs):
    """Seeded numpy parameters for `module`'s parameter shapes at these inputs
    (traced with eval_shape: no compile): kernels ~ N(0, 1/fan_in), Fourier
    and embedding tables ~ N(0, 1), norm scales and weight-norm g
    ~ 1 + N(0, 0.1), biases and log-scale snake parameters ~ N(0, 0.1)."""
    shapes = jax.eval_shape(lambda a, k: module.init(jax.random.PRNGKey(seed), *a, **k),
                            args, kwargs)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if len(a.shape) >= 2:  # dense and conv kernels, embeddings
            std = 1.0 if name in ("weight", "embedding") else np.prod(a.shape[:-1]) ** -0.5
        elif name in ("gamma", "g"):  # norm scales, weight-norm magnitudes
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        else:  # biases, log-scale snake parameters, Fourier weights
            std = 1.0 if name == "weights" else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(module, params, *args, static=None, **kwargs):
    """module.apply under jit; `static` holds the Python-valued arguments."""
    run = jax.jit(lambda p, a, k: module.apply({"params": p}, *a, **k, **(static or {})))
    return np.asarray(run(params, args, kwargs))


def _load(module, sd, prefix=""):
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v)) for k, v in sd.items()
          if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _nct(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 10, 64, scale=3.0)
    jm = jnorms.LayerNorm(64)
    p = _init(jm, jnp.asarray(x))
    tm = _load(tnorms.LayerNorm(64), {"gamma": p["gamma"]})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=1e-5, rtol=1e-5)


def test_snake_beta():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 50, 16, scale=2.0)
    jm = jact.SnakeBeta(16)
    p = _init(jm, jnp.asarray(x))
    sd = {}
    from_jax.snake(sd, "m", p)
    tm = _load(tact.SnakeBeta(16), sd, "m.")
    with torch.no_grad():
        got = tm(_nct(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("k,d,fused", [(7, 3, False), (7, 9, True), (1, 1, True)])
def test_wn_conv1d(k, d, fused):
    # fused: the conv takes the snake's parameters (pre_snake) and a residual,
    # the ResidualUnit's path
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 40, 16)
    pad = d * (k - 1) // 2
    jm = jconv.WNConv1d(features=16, kernel_size=k, padding=pad, dilation=d)
    p = _init(jm, jnp.asarray(x))
    sd = {}
    from_jax.wn_conv(sd, "m", p)
    tm = _load(tconv.WNConv1d(16, 16, k, padding=pad, dilation=d), sd, "m.")
    jkw, tkw = {}, {}
    if fused:
        a, b = np.exp(_rand(rng, 16, scale=0.3)), np.exp(_rand(rng, 16, scale=0.3))
        res = _rand(rng, 2, 40, 16)
        jkw = dict(pre_snake=(jnp.asarray(a), jnp.asarray(b)), residual=jnp.asarray(res))
        tkw = dict(pre_snake=(torch.from_numpy(a), torch.from_numpy(b)), residual=_nct(res))
    with torch.no_grad():
        got = tm(_nct(x), **tkw).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x), **jkw), atol=1e-5, rtol=1e-5)


def test_wn_conv_transpose1d():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 20, 16)
    jm = jconv.WNConvTranspose1d(features=8, kernel_size=8, stride=4, padding=2)
    p = _init(jm, jnp.asarray(x))
    sd = {}
    from_jax.wn_conv(sd, "m", p, transposed=True)
    tm = _load(tconv.WNConvTranspose1d(16, 8, 8, stride=4, padding=2), sd, "m.")
    with torch.no_grad():
        got = tm(_nct(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=1e-5, rtol=1e-5)


def _attn_sd(p, dim_heads, cross):
    sd = {}
    if cross:
        from_jax.dense(sd, "to_q", p["to_q"])
        sd["to_kv.weight"] = from_jax.deinterleave_fused(np.asarray(p["to_kv"]["kernel"]), 2, dim_heads).T
    else:
        sd["to_qkv.weight"] = from_jax.deinterleave_fused(np.asarray(p["to_qkv"]["kernel"]), 3, dim_heads).T
    from_jax.dense(sd, "to_out", p["to_out"])
    return sd


def test_self_attention_with_prefix_and_rope():
    # SA-Open's self-attention: one prefix token, partial rotary (32 of 64
    # dims). The port routes it to flash_attention_prefix's plain version.
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 1 + 96, 128)
    freqs = jemb.rotary_freqs(97, 32)
    jm = jattn.Attention(dim=128, dim_heads=64, prefix_len=1)
    p = _init(jm, jnp.asarray(x), rotary_pos_emb=freqs)
    tm = _load(tattn.Attention(128, 64), _attn_sd(p, 64, cross=False))
    np.testing.assert_allclose(temb.rotary_freqs(97, 32).numpy(), np.asarray(freqs), atol=1e-5)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), rotary_pos_emb=temb.rotary_freqs(97, 32), prefix_len=1)
    want = _apply(jm, p, jnp.asarray(x), rotary_pos_emb=freqs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_masked_cross_attention():
    rng = np.random.default_rng(5)
    x, ctx = _rand(rng, 2, 30, 128), _rand(rng, 2, 12, 64)
    mask = np.ones((2, 12), bool)
    mask[0, 7:] = False
    jm = jattn.Attention(dim=128, dim_heads=64, dim_context=64)
    p = _init(jm, jnp.asarray(x), context=jnp.asarray(ctx), mask=jnp.asarray(mask))
    tm = _load(tattn.Attention(128, 64, dim_context=64), _attn_sd(p, 64, cross=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), context=torch.from_numpy(ctx), mask=torch.from_numpy(mask))
    want = _apply(jm, p, jnp.asarray(x), context=jnp.asarray(ctx), mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_transformer_block():
    rng = np.random.default_rng(6)
    x, ctx = _rand(rng, 2, 33, 128), _rand(rng, 2, 12, 64)
    freqs = jemb.rotary_freqs(33, 32)
    jm = jtr.TransformerBlock(dim=128, dim_heads=64, cross_attend=True, dim_context=64,
                              prefix_len=1)
    kw = dict(context=jnp.asarray(ctx), rotary_pos_emb=freqs)
    p = _init(jm, jnp.asarray(x), **kw)
    tm = _load(ttr.TransformerBlock(128, 64, cross_attend=True, dim_context=64),
               from_jax.transformer_block_state_dict(p, "b", 64), "b.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x), context=torch.from_numpy(ctx),
                 rotary_pos_emb=temb.rotary_freqs(33, 32), prefix_len=1).numpy()
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x), **kw), atol=2e-5, rtol=1e-5)


DIT_KW = dict(io_channels=8, embed_dim=128, depth=2, num_heads=2, cond_token_dim=64,
              global_cond_dim=64, project_cond_tokens=False)


@pytest.mark.parametrize("cfg_scale,scale_phi", [(1.0, 0.0), (4.0, 0.7)])
def test_diffusion_transformer(cfg_scale, scale_phi):
    rng = np.random.default_rng(7)
    x, t = _rand(rng, 2, 8, 40), np.array([0.3, 0.8], np.float32)
    ctx, glob = _rand(rng, 2, 12, 64), _rand(rng, 2, 64)
    jm = jdit.DiffusionTransformer(use_checkpointing=False, **DIT_KW)
    args = (jnp.asarray(x), jnp.asarray(t))
    kw = dict(cross_attn_cond=jnp.asarray(ctx), global_embed=jnp.asarray(glob))
    p = _init(jm, *args, **kw)
    tm = _load(tdit.DiffusionTransformer(**DIT_KW), from_jax.dit_state_dict(p, dim_heads=64))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), cross_attn_cond=torch.from_numpy(ctx),
                 global_embed=torch.from_numpy(glob), cfg_scale=cfg_scale,
                 scale_phi=scale_phi).numpy()
    want = _apply(jm, p, *args, static=dict(cfg_scale=cfg_scale, scale_phi=scale_phi), **kw)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_residual_unit():
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 60, 32)
    jm = jae.ResidualUnit(out_channels=32, dilation=3, use_snake=True)
    p = _init(jm, jnp.asarray(x))
    sd = {}
    from_jax.residual_unit(sd, "m", p)
    tm = _load(tae.ResidualUnit(32, 3), sd, "m.")
    with torch.no_grad():
        got = tm(_nct(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=2e-5, rtol=1e-5)


OOBLECK = dict(channels=16, c_mults=(1, 2), strides=(2, 4), use_snake=True)


def test_oobleck_decoder():
    # 2 levels of 3 residual units each; conv sums of up to 7*32 terms in a
    # chain of ~15 convs: 1e-4 relative to the output scale
    rng = np.random.default_rng(9)
    z = _rand(rng, 1, 16, 8)
    jm = jae.OobleckDecoder(out_channels=2, latent_dim=8, final_tanh=False, **OOBLECK)
    p = _init(jm, jnp.asarray(z))
    tm = _load(tae.OobleckDecoder(out_channels=2, latent_dim=8, final_tanh=False, **OOBLECK),
               from_jax.oobleck_decoder_state_dict(p))
    with torch.no_grad():
        got = tm(_nct(z)).numpy().transpose(0, 2, 1)
    want = _apply(jm, p, jnp.asarray(z))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_oobleck_encoder():
    rng = np.random.default_rng(10)
    audio = _rand(rng, 1, 64, 2)
    jm = jae.OobleckEncoder(in_channels=2, latent_dim=8, **OOBLECK)
    p = _init(jm, jnp.asarray(audio))
    tm = _load(tae.OobleckEncoder(in_channels=2, latent_dim=8, **OOBLECK),
               from_jax.oobleck_encoder_state_dict(p))
    with torch.no_grad():
        got = tm(_nct(audio)).numpy().transpose(0, 2, 1)
    want = _apply(jm, p, jnp.asarray(audio))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_encoder_matches_flax(gated):
    from transformers import FlaxT5EncoderModel, T5Config

    cfg = T5Config(d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16, vocab_size=200,
                   feed_forward_proj="gated-gelu" if gated else "relu")
    flax_t5 = FlaxT5EncoderModel(cfg, _do_init=False)
    params = jax.jit(lambda r: flax_t5.init_weights(r, (1, 1)))(jax.random.PRNGKey(11))
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 200, (2, 150))  # > max_distance 128: every bucket kind
    mask = np.ones((2, 150), np.int64)
    mask[1, 90:] = 0
    encode = jax.jit(lambda p, i, m: flax_t5(input_ids=i, attention_mask=m, params=p)
                     .last_hidden_state)
    want = np.asarray(encode(params, ids, mask))
    arch = tt5.T5Arch(32, 64, 2, 2, 16, gated, vocab_size=200)
    tm = _load(tt5.T5EncoderModel(arch), from_jax.t5_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_fallback_tokenizer_matches_jax_and_takes_a_word_hash():
    """Default ids equal the JAX `_FallbackTokenizer`'s (same process, same
    salted `hash`), exactly; a given word hash replaces `hash`."""
    import zlib

    texts = ["warm analog pads", "", "one two three four five six seven eight nine"]
    got, got_mask = tcond.FallbackTokenizer(8)(texts)
    want = jcond._FallbackTokenizer(8)(texts)
    np.testing.assert_array_equal(got, want["input_ids"])
    np.testing.assert_array_equal(got_mask, want["attention_mask"])
    crc = lambda w: zlib.crc32(w.encode("utf-8"))
    ids, mask = tcond.FallbackTokenizer(8, word_hash=crc)(texts)
    np.testing.assert_array_equal(ids[0, :4], [crc(w) % 32000 + 2 for w in texts[0].split()] + [1])
    np.testing.assert_array_equal(mask, got_mask)


def test_number_conditioner():
    values = [0.0, 17.5, 600.0]  # the last is clipped to max_val
    jm = jcond.NumberConditionerModule(output_dim=32, min_val=0, max_val=512)
    floats = jnp.asarray(values, jnp.float32)
    p = _init(jm, floats)
    sd = {"embedder.embedding.0.weights": p["embedder"]["weights"]}
    from_jax.dense(sd, "embedder.embedding.1", p["embedder"]["to_out"])
    tm = _load(tcond.NumberConditioner(32, min_val=0, max_val=512), sd)
    want, want_mask = jax.jit(lambda p_, f: jm.apply({"params": p_}, f))(p, floats)
    with torch.no_grad():
        got, mask = tm(values, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
