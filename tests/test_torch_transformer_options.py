"""The transformer options of the port (ops/norms.py, ops/attention.py,
ops/transformer.py) against the JAX package's modules on the CPU:
LayerScale, DynamicTanh, the three qk-norms in self- and cross-attention,
differential attention and `feat_scale`, the ConformerModule, the
TransformerBlock with the TAAE's exact options (heads of 128 under the
sliding window, its own rotary, LayerScale, the feed-forward's bias, norms
of epsilon 1e-2), with adaLN, with DynamicTanh norms, and the
ContinuousTransformer with memory tokens and the global conditioning.

Inputs and weights are f32, made with numpy from a seed; the weights reach
the port through io/from_jax.py. Every forward is held within 1e-5 of the
output's peak (f32 sums over at most a few hundred terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops import attention as jatt
from stable_audio_tools_tpu.ops import norms as jnorms
from stable_audio_tools_tpu.ops import transformer as jtr
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.ops import attention as tatt
from stable_audio_tools_tpu_torch.ops import norms as tnorms
from stable_audio_tools_tpu_torch.ops import transformer as ttr

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(tree, seed):
    """Seeded numpy values for a flax parameter tree: matrices ~ N(0,
    1/fan_in), norm and weight-norm gains (`gamma`, `g`, a LayerNorm's
    `scale`) ~ 1 + N(0, 0.1), every other vector (biases, LayerScale,
    DynamicTanh's alpha, adaLN's gate) ~ N(0, 0.3): zero- or 1e-5-initialised
    branches would otherwise hide every error behind them."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        names = [getattr(k, "key", "") for k in path]
        name = names[-1]
        if name in ("gamma", "g") or (name == "scale" and len(names) > 1
                                          and names[-2].endswith("norm")):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if len(a.shape) >= 2:
            return (np.prod(a.shape[:-1]) ** -0.5 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, *args, seed=1, **kwargs):
    """Seeded numpy weights over the module's parameter shapes."""
    return randomize(jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args), **kwargs))["params"], seed)


def _apply(module, params, *args, **kwargs):
    """module.apply jitted (its kwargs closed over)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kwargs))(
        params, *(jnp.asarray(a) for a in args))


def _load(module, state):
    module.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    return module


def test_layer_scale_and_dynamic_tanh_match_jax():
    x = _x((2, 5, 16))
    for jmod, tmod in ((jnorms.LayerScale(16), tnorms.LayerScale(16)),
                       (jnorms.DynamicTanh(16), tnorms.DynamicTanh(16))):
        p = _init(jmod, x)
        want = _apply(jmod, p, x)
        _load(tmod, {k: v for k, v in p.items()})
        _close(tmod(_t(x)), want)
    # the initial values are JAX's: scale 1e-5; alpha 10, gamma 1, beta 0
    assert torch.equal(tnorms.LayerScale(4).scale, torch.full((4,), 1e-5))
    d = tnorms.DynamicTanh(4)
    assert float(d.alpha) == 10.0 and torch.equal(d.gamma, torch.ones(4))


@pytest.mark.parametrize("qk_norm", ["l2", "ln", "dyt"])
@pytest.mark.parametrize("cross", [False, True])
def test_qk_norms_match_jax(qk_norm, cross):
    # heads of 32 over a width of 64; self-attention under a window with a
    # rotary of 16 dims, cross-attention over 6 context tokens of width 32
    # (one kv head for two query heads)
    B, N, dim, D = 2, 12, 64, 32
    x = _x((B, N, dim))
    kwargs, call = {}, {}
    if cross:
        ctx = _x((B, 6, 32), seed=3)
        kwargs["dim_context"] = 32
        jmod = jatt.Attention(dim=dim, dim_heads=D, qk_norm=qk_norm, **kwargs)
        p = _init(jmod, x, context=ctx)
        want = _apply(jmod, p, x, context=jnp.asarray(ctx))
        call["context"] = _t(ctx)
    else:
        from stable_audio_tools_tpu.ops.embeddings import rotary_freqs
        rope = rotary_freqs(N, 16)
        jmod = jatt.Attention(dim=dim, dim_heads=D, qk_norm=qk_norm)
        p = _init(jmod, x, rotary_pos_emb=rope, sliding_window=(3, 2))
        want = _apply(jmod, p, x, rotary_pos_emb=rope, sliding_window=(3, 2))
        call["rotary_pos_emb"] = _t(rope)
    tmod = tatt.Attention(dim, D, qk_norm=qk_norm,
                          sliding_window=None if cross else (3, 2), **kwargs)
    state = {}
    from_jax.attention_state_dict(state, "a", p, D)
    _load(tmod, {k[2:]: v for k, v in state.items()})
    _close(tmod(_t(x), **call), want)


@pytest.mark.parametrize("cross", [False, True])
def test_differential_attention_and_feat_scale_match_jax(cross):
    B, N, dim, D = 2, 10, 64, 32
    x = _x((B, N, dim))
    jkw, tkw, call = {}, {}, {}
    if cross:
        ctx = _x((B, 5, 64), seed=4)
        jkw = tkw = {"dim_context": 64}
        jargs, call = {"context": jnp.asarray(ctx)}, {"context": _t(ctx)}
    else:
        from stable_audio_tools_tpu.ops.embeddings import rotary_freqs
        rope = rotary_freqs(N, 16)
        jargs, call = {"rotary_pos_emb": rope}, {"rotary_pos_emb": _t(rope)}
    jmod = jatt.Attention(dim=dim, dim_heads=D, differential=True, feat_scale=True,
                          qk_norm="ln", **jkw)
    p = _init(jmod, x, **jargs)
    want = _apply(jmod, p, x, **jargs)
    tmod = tatt.Attention(dim, D, differential=True, feat_scale=True, qk_norm="ln", **tkw)
    state = {}
    from_jax.attention_state_dict(state, "a", p, D)
    _load(tmod, {k[2:]: v for k, v in state.items()})
    _close(tmod(_t(x), **call), want)


def test_conformer_module_matches_jax():
    x = _x((2, 40, 32))
    jmod = jtr.ConformerModule(32, norm_eps=1e-2)
    p = _init(jmod, x)
    want = _apply(jmod, p, x)
    tmod = ttr.ConformerModule(32, norm_eps=1e-2)
    block = from_jax.transformer_block_state_dict(
        {"conformer": p, "self_attn": {"to_qkv": {"kernel": np.zeros((4, 12))},
                                       "to_out": {"kernel": np.zeros((4, 4))}},
         "ff": {"linear_in": {"proj": {"kernel": np.zeros((4, 8))}},
                "linear_out": {"kernel": np.zeros((4, 4))}}}, "b", 4)
    _load(tmod, {k[len("b.conformer."):]: v for k, v in block.items()
                 if k.startswith("b.conformer.")})
    _close(tmod(_t(x)), want)


TAAE_BLOCK = dict(dim_heads=128, layer_scale=True, add_rope=True, qk_norm="ln", ff_mult=4,
                  ff_no_bias=False, norm_eps=1e-2, sliding_window=(31, 32))


@pytest.mark.parametrize("dim,options", [
    (128, {}),  # the TAAE's block at its narrowest level: one head of 128
    (256, {"conformer": True}),  # two heads, the conformer after the attention
    (64, {"remove_norms": True}),  # DynamicTanh norms, heads of min(128, 64)
])
def test_transformer_block_with_taae_options_matches_jax(dim, options):
    # 150 rows: the window (31, 32) visibly clips at both ends and the
    # rotary spans 64 (32) of the head's 128 (64) dims
    x = _x((2, 150, dim))
    jmod = jtr.TransformerBlock(dim=dim, zero_init_branch_outputs=False, **TAAE_BLOCK, **options)
    p = _init(jmod, x)
    want = _apply(jmod, p, x)
    tkw = {k: v for k, v in TAAE_BLOCK.items()}
    tmod = ttr.TransformerBlock(dim, **tkw, **options)
    _load(tmod, {k[2:]: v for k, v in from_jax.transformer_block_state_dict(
        p, "b", min(128, dim)).items()})
    _close(tmod(_t(x)), want)
    # the tables made once by `block_rope` give the same output
    _close(tmod(_t(x), rope_tables=tmod.block_rope(150)), want)


def test_adaln_block_and_memory_tokens_match_jax():
    # the stack with adaLN from a global conditioning vector, 2 memory
    # tokens and a prepended token, qk-norm and LayerScale: the DiT's
    # transformer options
    B, N, dim = 2, 20, 64
    x, prepend, cond = _x((B, N, 32)), _x((B, 1, dim), seed=5), _x((B, 48), seed=6)
    jmod = jtr.ContinuousTransformer(dim=dim, depth=2, dim_in=32, dim_out=32, dim_heads=32,
                                     global_cond_dim=48, num_memory_tokens=2, layer_scale=True,
                                     qk_norm="l2", use_checkpointing=False)
    args = dict(prepend_embeds=jnp.asarray(prepend), global_cond=jnp.asarray(cond))
    p = _init(jmod, x, **args)
    want = _apply(jmod, p, x, **args)
    tmod = ttr.ContinuousTransformer(dim, 2, dim_in=32, dim_out=32, dim_heads=32,
                                     global_cond_dim=48, num_memory_tokens=2, layer_scale=True,
                                     qk_norm="l2")
    state = {"memory_tokens": p["memory_tokens"]}
    for name in ("project_in", "project_out"):
        from_jax.dense(state, name, p[name])
    from_jax.dense(state, "global_embed.0", p["global_embed_0"])
    from_jax.dense(state, "global_embed.2", p["global_embed_1"])
    for i in range(2):
        state.update(from_jax.transformer_block_state_dict(p[f"layers_{i}"], f"layers.{i}", 32))
    _load(tmod, state)
    _close(tmod(_t(x), prepend_embeds=_t(prepend), global_cond=_t(cond)), want)


def test_attention_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="qk_norm"):
        tatt.Attention(64, 32, qk_norm="rms")
    att = tatt.Attention(64, 32, feat_scale=True)
    cache = tatt.init_kv_cache(1, 2, 4, 32)
    with pytest.raises(NotImplementedError, match="feat_scale"):
        att(torch.zeros(1, 1, 64), cache=cache, cache_index=0)
    with pytest.raises(NotImplementedError, match="differential"):
        tatt.Attention(64, 32, dim_context=32, differential=True).compute_kv(
            torch.zeros(1, 3, 32))


@pytest.mark.parametrize("global_cond_type", ["adaLN", "prepend"])
def test_dit_config_keys_match_jax(global_cond_type):
    # the DiT's keys no shipped config sets: patch_size 2, the timestep by
    # input_concat (24 channels), LayerScale, the "ln" qk-norm, ff_mult 2, 2
    # memory tokens and a sliding window, with adaLN or the prepended token
    from stable_audio_tools_tpu.models.dit import DiffusionTransformer as JaxDiT
    from stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer

    kw = dict(io_channels=8, embed_dim=64, depth=2, num_heads=2, cond_token_dim=16,
              global_cond_dim=12, patch_size=2, global_cond_type=global_cond_type,
              timestep_cond_type="input_concat", timestep_embed_dim=24, layer_scale=True,
              qk_norm="ln", ff_mult=2, num_memory_tokens=2, sliding_window=(5, 6))
    x, t = _x((2, 8, 40)), np.array([0.3, 0.8], np.float32)
    ctx, glob = _x((2, 5, 16), seed=7), _x((2, 12), seed=8)
    jdit = JaxDiT(**kw, use_checkpointing=False)
    args = dict(cross_attn_cond=jnp.asarray(ctx), global_embed=jnp.asarray(glob))
    p = randomize(jax.eval_shape(lambda: jdit.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), **args))["params"], 9)
    want = jax.jit(lambda q, a, b: jdit.apply({"params": q}, a, b, **args))(
        p, jnp.asarray(x), jnp.asarray(t))
    tdit = DiffusionTransformer(**kw, use_checkpointing=False)
    _load(tdit, from_jax.dit_state_dict(p, 32))
    _close(tdit(_t(x), _t(t), cross_attn_cond=_t(ctx), global_embed=_t(glob)), want)
