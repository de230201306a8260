"""The modules of the port's LM slice against the JAX package's, on the CPU:
the bottom-right-aligned attention mask, the causal / windowed transformer
stack (full forward and KV-cached steps), the codebook patterns, the SEANet
codec with its LSTMs, the RVQ bottleneck, and the shipped configs through the
port's factory. Inputs and weights are f32, made with numpy from a seed; the
JAX parameters reach the port through io/from_jax.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import bottleneck as jbn
from stable_audio_tools_tpu.models import codebook_patterns as jcp
from stable_audio_tools_tpu.models import seanet as jsn
from stable_audio_tools_tpu.ops import attention as jatt
from stable_audio_tools_tpu.ops.transformer import ContinuousTransformer as JaxTransformer
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import bottleneck as tbn
from stable_audio_tools_tpu_torch.models import codebook_patterns as tcp
from stable_audio_tools_tpu_torch.models import seanet as tsn
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.ops import attention as tatt
from stable_audio_tools_tpu_torch.ops.transformer import ContinuousTransformer

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "stable_audio_tools_tpu", "configs", "model_configs")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(tree, seed):
    """Seeded numpy values for a flax parameter tree: kernels ~ N(0, 1/fan_in),
    embeddings N(0, 1), norm scales and weight-norm g ~ 1 + N(0, 0.1), the
    rest (biases) ~ N(0, 0.1). Zero-initialised output projections would
    otherwise hide every error behind them."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name in ("gamma", "g"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if len(a.shape) >= 2:
            std = 1.0 if name == "embedding" else np.prod(a.shape[:-1]) ** -0.5
            return (std * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


# -- the mask -------------------------------------------------------------

@pytest.mark.parametrize("q_len,k_len,causal,window,masked", [
    (12, 12, True, None, False), (5, 12, True, None, False), (20, 6, True, None, False),
    (16, 16, False, (3, 4), False), (9, 14, True, (4, -1), True), (7, 7, False, None, True)])
def test_dot_product_attention_mask_matches_jax(q_len, k_len, causal, window, masked):
    # the bottom-right-aligned causal / window mask and the key mask of JAX
    # `_build_bias`; with q_len > k_len causal rows 0..q_len-k_len-1 see no
    # key and attend uniformly in both (f32 min absorbs the logits). f32:
    # 1e-5 abs on O(1) outputs
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, q_len, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, k_len, 16)).astype(np.float32) for _ in range(2))
    mask = (rng.random((2, k_len)) > 0.3) | (np.arange(k_len) == k_len - 1) if masked else None
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, window=window,
                                      mask=None if mask is None else jnp.asarray(mask))
    got = tatt.dot_product_attention(_t(q), _t(k), _t(v), causal, window,
                                     None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cached_decode_attention_matches_jax():
    # one step at position 5 of a cache of 9: the step written in place, the
    # later positions masked; f32, 1e-6
    rng = np.random.default_rng(1)
    cache = {n: rng.standard_normal((2, 2, 9, 16)).astype(np.float32) for n in ("k", "v")}
    q, ks, vs = (rng.standard_normal((2, 2, 1, 16)).astype(np.float32) for _ in range(3))
    want, want_cache = jatt.cached_decode_attention(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
        {n: jnp.asarray(c) for n, c in cache.items()}, 5)
    port_cache = {n: _t(c) for n, c in cache.items()}
    got = tatt.cached_decode_attention(_t(q), _t(ks), _t(vs), port_cache, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for n in ("k", "v"):
        np.testing.assert_array_equal(port_cache[n].numpy(), np.asarray(want_cache[n]))


# -- the transformer stack --------------------------------------------------

def _transformer_pair(window, depth=2, dim=128, ctx_dim=128, seed=0):
    jt = JaxTransformer(dim=dim, depth=depth, dim_heads=64, causal=True, cross_attend=True,
                        cond_token_dim=ctx_dim, sliding_window=window, use_checkpointing=False)
    x0, c0 = jnp.zeros((1, 8, dim)), jnp.zeros((1, 5, ctx_dim))
    params = randomize(jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), x0, context=c0))
                       ["params"], seed)
    port = ContinuousTransformer(dim, depth, dim_heads=64, cross_attend=True,
                                 cond_token_dim=ctx_dim, causal=True, sliding_window=window)
    sd = {}
    for i in range(depth):
        sd.update(from_jax.transformer_block_state_dict(params[f"layers_{i}"], f"layers.{i}", 64))
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return jt, {"params": params}, port.eval()


@pytest.mark.parametrize("window,n,n_ctx", [(None, 40, 12), ((5, 6), 33, 40), (None, 30, 30)])
def test_causal_transformer_matches_jax(window, n, n_ctx):
    # the causal stack (self-attention through `flash_attention`'s plain
    # version under the causal / window band, the causal cross-attention)
    # against the JAX ContinuousTransformer on XLA; f32 through 2 blocks:
    # 1e-4 of the output's peak
    jt, variables, port = _transformer_pair(window)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, n_ctx, 128)).astype(np.float32)
    want = np.asarray(jt.apply(variables, jnp.asarray(x), context=jnp.asarray(ctx)))
    got = port(_t(x), context=_t(ctx)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_cached_transformer_steps_match_jax():
    # five KV-cached steps (rotary at the cache position, the cross-attention
    # K/V projected once and attended without the causal mask) against the
    # JAX stack's cached path, step by step; f32, 1e-4 of the peak
    jt, variables, port = _transformer_pair(None, seed=3)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((5, 2, 1, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 128)).astype(np.float32)
    jcaches = [jatt.init_kv_cache(2, 2, 8, 64) for _ in range(2)]
    jkv = jt.apply(variables, jnp.zeros((2, 1, 128)), context=jnp.asarray(ctx),
                   compute_cross_kv=True)
    caches = [tatt.init_kv_cache(2, 2, 8, 64) for _ in range(2)]
    kvs = port.compute_cross_kv(_t(ctx))
    for i, x in enumerate(xs):
        want, jcaches = jt.apply(variables, jnp.asarray(x), caches=jcaches, cache_index=i,
                                 cross_kvs=jkv)
        got = port(_t(x), caches=caches, cache_index=i, cross_kvs=kvs)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-4 * np.abs(np.asarray(want)).max())


def test_attention_refuses_unported_options():
    # qk-norm, differential attention and feat_scale are ported (held to JAX
    # in tests/test_torch_transformer_options.py); what stays refused is what
    # JAX refuses too: an unknown qk-norm, and differential attention or
    # feat_scale in the KV-cached decode
    with pytest.raises(ValueError, match="qk_norm"):
        tatt.Attention(128, 64, qk_norm="rms")
    cache = tatt.init_kv_cache(1, 2, 4, 64)
    for kwargs in ({"differential": True}, {"feat_scale": True}):
        with pytest.raises(NotImplementedError, match=next(iter(kwargs))):
            tatt.Attention(128, 64, **kwargs)(torch.zeros(1, 1, 128), cache=cache,
                                              cache_index=0)


# -- codebook patterns ----------------------------------------------------

PROVIDERS = [("delay", {}), ("delay", {"delays": [0, 2, 3, 5]}), ("parallel", {}),
             ("unroll", {}), ("coarse_first", {}), ("musiclm", {})]


@pytest.mark.parametrize("kind,cfg", PROVIDERS)
def test_pattern_build_and_revert_match_jax(kind, cfg):
    # exact: the same index maps, the same gathers
    config = {"type": kind, "config": cfg}
    jp = jcp.pattern_provider_from_config(config, 4).get_pattern(11)
    tp_ = tcp.pattern_provider_from_config(config, 4).get_pattern(11)
    np.testing.assert_array_equal(tp_.index_map, jp.index_map)
    codes = np.random.default_rng(5).integers(0, 50, (2, 4, 11))
    want, _, want_mask = jp.build_pattern_sequence(jnp.asarray(codes), 99)
    got, _, got_mask = tp_.build_pattern_sequence(torch.from_numpy(codes), 99)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    back, _, _ = tp_.revert_pattern_sequence(got, 99)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jp.revert_pattern_sequence(want, 99)[0]))
    np.testing.assert_array_equal(back.numpy(), codes)
    logits = np.random.default_rng(6).standard_normal((2, 3, 4, tp_.S)).astype(np.float32)
    np.testing.assert_array_equal(tp_.revert_pattern_logits(_t(logits), 0.0).numpy(),
                                  np.asarray(jp.revert_pattern_logits(jnp.asarray(logits), 0.0)))


# -- the codec --------------------------------------------------------------

SEANET = dict(channels=1, dimension=16, n_filters=4, lstm=2)


def _seanet_pair(cls_j, cls_t, ratios, x_shape, seed):
    jm = cls_j(ratios=ratios, **SEANET)
    params = randomize(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                      jnp.zeros(x_shape)))["params"], seed)
    tm = cls_t(ratios=ratios, **SEANET)
    sd = from_jax.seanet_state_dict(params)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return jm, {"params": params}, tm.eval()


@pytest.mark.parametrize("T", [64, 61])
def test_seanet_encoder_matches_jax(T):
    # the encodec padding (reflect, frames aligned to the stride), the
    # resnet blocks, the stacked LSTM; f32, 1e-5 of the peak. T = 61 is no
    # multiple of the hop 8: the padding rounds up to whole frames
    jm, variables, tm = _seanet_pair(jsn.SEANetEncoder, tsn.SEANetEncoder, [2, 4], (1, T, 1), 7)
    x = np.random.default_rng(8).standard_normal((2, T, 1)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))  # [B, T', C]
    got = tm(_t(x).transpose(1, 2)).detach().numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, -(-T // 8), 16)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_seanet_decoder_matches_jax():
    # the transposed convs and their trims, the LSTM ahead of them; f32
    jm, variables, tm = _seanet_pair(jsn.SEANetDecoder, tsn.SEANetDecoder, [4, 2], (1, 8, 16), 9)
    z = np.random.default_rng(10).standard_normal((2, 8, 16)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(z)))
    got = tm(_t(z).transpose(1, 2)).detach().numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_lstm_conversion_keeps_the_gate_order():
    # a 2-layer SEANetLSTM alone: the flax cells' i / f / g / o kernels land
    # in torch's stacked weights in torch's gate order (any other order, or
    # the bias on the input side counted twice, is off by O(1)); and a
    # swapped pair of gates is caught
    jm = jsn.SEANetLSTM(16, num_layers=2)
    x = np.random.default_rng(11).standard_normal((2, 20, 16)).astype(np.float32)
    params = randomize(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                      jnp.asarray(x)))["params"], 12)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    sd = {}
    from_jax.lstm_state_dict(sd, "lstm", params)
    tm = tsn.SEANetLSTM(16, 2)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    got = tm(_t(x).transpose(1, 2)).detach().numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    w = sd["lstm.weight_ih_l0"].copy()
    sd["lstm.weight_ih_l0"] = np.concatenate([w[16:32], w[:16], w[32:]])  # f and i swapped
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    bad = tm(_t(x).transpose(1, 2)).detach().numpy().transpose(0, 2, 1)
    assert np.abs(bad - want).max() > 1e-2 * np.abs(want).max()


def test_rvq_codes_and_decode_match_jax():
    # per-stage nearest codeword on the residual: identical codes, and the
    # quantized latents and the decoded codes within f32 rounding
    jb = jbn.RVQBottleneck(dim=16, codebook_size=32, num_quantizers=3)
    x = np.random.default_rng(13).standard_normal((2, 24, 16)).astype(np.float32)
    variables = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), method=jb.encode)
    z, info = jb.apply(variables, jnp.asarray(x), return_info=True, method=jb.encode)
    tb = tbn.RVQBottleneck(dim=16, codebook_size=32, num_quantizers=3)
    for name, value in variables["quantizer_state"]["quantizer"].items():
        getattr(tb.quantizer, name).copy_(torch.from_numpy(np.array(value)))
    got_z, got_info = tb.encode(_t(x).transpose(1, 2), return_info=True)
    np.testing.assert_array_equal(got_info["quantizer_indices"].numpy(),
                                  np.asarray(info["quantizer_indices"]))
    np.testing.assert_allclose(got_z.numpy().transpose(0, 2, 1), np.asarray(z), atol=1e-5)
    np.testing.assert_allclose(float(got_info["quantizer_loss"]), float(info["quantizer_loss"]),
                               rtol=1e-5)
    codes = got_info["quantizer_indices"]
    want = np.asarray(jb.apply(variables, jnp.asarray(codes.numpy()), method=jb.decode_tokens))
    np.testing.assert_allclose(tb.decode_tokens(codes).numpy().transpose(0, 2, 1), want,
                               atol=1e-6)
    # a training pass (the k-means init, the EMA update) moves the state as
    # the JAX module's mutable pass does (tests/test_torch_codec_training.py
    # holds each piece)
    _, updates = jb.apply(variables, jnp.asarray(x), train=True, mutable=["quantizer_state"],
                          method=jb.encode)
    tb.encode(_t(x).transpose(1, 2), train=True)
    for name, want in updates["quantizer_state"]["quantizer"].items():
        np.testing.assert_allclose(getattr(tb.quantizer, name).float().numpy(),
                                   np.asarray(want, np.float32), atol=1e-5, err_msg=name)


# -- the shipped configs ------------------------------------------------------

def _load(rel):
    with open(os.path.join(CONFIGS, rel)) as f:
        return json.load(f)


def test_shipped_musicgen_config_builds_unchanged():
    # lm/musicgen_small_rvq.json through the port's factory on `meta` (the
    # T5 tower random, as the config's weights are not bundled): 24 x 1024,
    # 16 heads of 64, a causal stack with causal cross-attention, the SEANet
    # codec of hop 640 with 4 codebooks of 2048, frozen
    cfg = _load("lm/musicgen_small_rvq.json")
    cfg["model"]["conditioning"]["configs"][0]["config"]["allow_random_init"] = True
    model = create_model_from_config(cfg, "meta")
    assert (model.num_quantizers, model.codebook_size, model.min_input_length) == (4, 2048, 640)
    bb = model.lm.backbone
    assert (bb.embed_dim, bb.depth, bb.num_heads, bb.compute_dtype) == (1024, 24, 16,
                                                                        torch.bfloat16)
    blk = bb.transformer.layers[0]
    assert blk.self_attn.causal and blk.cross_attn.causal and blk.self_attn.dim_heads == 64
    assert model.pattern_provider.get_pattern(500).S == 503
    assert all(p.device.type == "meta" for p in model.parameters())
    assert not any(p.requires_grad for p in model.pretransform.parameters())
    # the LM alone trains (T5 and codec frozen): per block q/k/v/out and
    # cross q/kv/out 8 x 1024^2, the GLU 1024 -> 2 x 4096 (+ bias) and
    # 4096 -> 1024; 4 embeddings of 2049 and 4 heads of 2048 (+ bias); the
    # 768 -> 1024 context projection (+ bias); the 3 norm scales a block
    block = 8 * 1024 ** 2 + 1024 * 8192 + 8192 + 4096 * 1024 + 3 * 1024
    want = 24 * block + 4 * 2049 * 1024 + 4 * (1024 * 2048 + 2048) + 768 * 1024 + 1024
    assert sum(p.numel() for p in model.parameters() if p.requires_grad) == want


def test_shipped_encodec_config_builds_unchanged():
    model = create_model_from_config(_load("autoencoders/encodec_musicgen_rvq.json"), "meta")
    assert model.is_discrete and model.bottleneck.num_quantizers == 4
    assert isinstance(model.encoder, tsn.SEANetEncoder) and model.encoder.lstm is not None
