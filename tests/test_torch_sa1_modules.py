"""The modules of the SA-1.0 slice of the port against the JAX package on the
CPU: the int conditioner, the DAC snake, residual unit, encoder and decoder,
the ADP convs (streaming padding, the transposed conv), resnet and attention
blocks, `Transformer1d`, the GroupNorm shared with the Dance UNet, and a
tiny `UNetCFG1d` with and without guidance. The same numpy-seeded f32 inputs
and weights (carried by io/from_jax.py) go to both; each tolerance is
stated at its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from stable_audio_tools_tpu.models import adp as jadp
from stable_audio_tools_tpu.models import conditioners as jcond
from stable_audio_tools_tpu.models import dac as jdac
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import adp as tadp
from stable_audio_tools_tpu_torch.models import conditioners as tcond
from stable_audio_tools_tpu_torch.models import dac as tdac
from stable_audio_tools_tpu_torch.ops.norms import GroupNorm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def draw_params(shapes, seed: int):
    """Seeded numpy parameters for a flax shape tree: conv and dense kernels
    ~ N(0, 1/fan_in), weight-norm v the same and g ~ 1 + N(0, 0.1), norm
    scales and DAC snake alphas ~ 1 + N(0, 0.1), biases ~ N(0, 0.1),
    embedding tables and Fourier weights ~ N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("kernel", "v"):
            std = np.prod(shape[:-1]) ** -0.5
        elif name in ("scale", "g", "alpha"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif name == "bias":
            std = 0.1
        else:
            std = 1.0
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_params(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    return draw_params(shapes["params"], seed)


def load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    return module.eval()


def randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# -- the int conditioner ------------------------------------------------------------


def test_int_conditioner_matches_jax():
    # an embedding lookup of clipped ints: equal
    jm = jcond.IntConditionerModule(16, min_val=3, max_val=40)
    ints = np.array([0, 3, 17, 40, 99], np.int32)
    params = jax_params(jm, jnp.asarray(ints))
    want, want_mask = jm.apply({"params": params}, jnp.asarray(ints))
    tm = tcond.IntConditioner(16, min_val=3, max_val=40)
    load(tm, {"int_embedder.weight": params["int_embedder"]["embedding"]})
    got, mask = tm(ints.tolist(), "cpu")
    assert got.shape == (5, 1, 16) and tm.int_embedder.weight.shape == (38, 16)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


# -- DAC ------------------------------------------------------------------------------

SNAKE_TOL = dict(atol=2e-6, rtol=1e-6)  # one f32 sine; the kernel divides by alpha + 1e-9


def test_dac_snake1d_matches_jax_and_is_snake_beta_with_beta_alpha():
    x = randn(1, 2, 7, 50, scale=3.0)
    jm = jdac.Snake1d(7)
    params = jax_params(jm, jnp.zeros((2, 50, 7)), seed=1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 1))))
    tm = load(tdac.Snake1d(7), {"alpha": params["alpha"].reshape(1, 7, 1)})
    got = tm(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), **SNAKE_TOL)
    a, b = tm.params(torch.bfloat16)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert torch.equal(a, _t(params["alpha"]).bfloat16().float())


def test_dac_residual_unit_matches_jax():
    # snake -> k = 7 d = 3 conv -> snake -> k = 1 conv + skip, f32: 1e-5 of O(1)
    x = randn(2, 2, 24, 80)
    jm = jdac.DACResidualUnit(24, dilation=3)
    params = jax_params(jm, jnp.zeros((2, 80, 24)), seed=2)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 1))))
    sd = {}
    from_jax._dac_unit(sd, "unit", params)
    tm = tdac.DACResidualUnit(24, dilation=3)
    load(tm, {k[len("unit."):]: v for k, v in sd.items()})
    got = tm(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=1e-5, rtol=1e-5)


# a tiny DAC pair: encoder 24 -> 48 -> 96 channels (96: not a multiple of 64)
# at strides 2 and 4 with an 8-wide projection; decoder 96 -> 48 -> 24 at rates
# 4 and 2 into 2 channels
DAC_ENC = dict(d_model=24, strides=(2, 4), latent_dim=8, in_channels=2)
DAC_DEC = dict(input_channel=4, channels=96, rates=(4, 2), d_out=2)


def test_dac_encoder_matches_jax():
    # 3 blocks of convs and snakes in f32, the sums in another order: 2e-5
    x = randn(3, 2, 2, 256, scale=0.5)
    jm = jdac.DACEncoder(**DAC_ENC)
    params = jax_params(jm, jnp.zeros((2, 256, 2)), seed=3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 1))))
    tm = load(tdac.DACEncoderWrapper(**DAC_ENC), from_jax.dac_encoder_state_dict(params))
    got = tm(_t(x)).detach().numpy()
    assert got.shape == (2, 8, 32)
    assert tm.encoder.block[-1].weight_v.shape == (96, 96, 3)
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("final_tanh", [True, False])
def test_dac_decoder_matches_jax(final_tanh):
    # conv_in, 2 blocks (snake, transposed conv, 3 residual units), snake +
    # conv_out (96 -> 48 -> 24 -> 2), f32: 2e-5 of the peak before the tanh
    # (whose slope is at most 1)
    z = randn(4, 2, 4, 16)
    params = jax_params(jdac.DACDecoder(**DAC_DEC), jnp.zeros((2, 16, 4)), seed=4)
    raw, want = (np.asarray(jdac.DACDecoder(**DAC_DEC, final_tanh=tanh).apply(
        {"params": params}, jnp.asarray(z.transpose(0, 2, 1)))).transpose(0, 2, 1)
        for tanh in (False, final_tanh))
    tm = load(tdac.DACDecoderWrapper(**DAC_DEC, final_tanh=final_tanh),
              from_jax.dac_decoder_state_dict(params))
    got = tm(_t(z)).detach().numpy()
    assert got.shape == (2, 2, 128)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(raw).max())


# -- ADP convs ----------------------------------------------------------------------


def _nlc(x):
    return jnp.asarray(x.transpose(0, 2, 1))


@pytest.mark.parametrize("k,stride,T", [(5, 2, 64), (5, 2, 61), (9, 4, 64), (9, 4, 70),
                                         (3, 1, 33), (1, 1, 20)])
def test_adp_conv1d_streaming_padding_matches_jax(k, stride, T):
    # the asymmetric padding (the extra right pad where T does not fill the
    # last frame), then one f32 conv: 1e-5
    x = randn(5, 2, 6, T)
    jm = jadp.ADPConv1d(10, k, stride=stride)
    params = jax_params(jm, _nlc(x), seed=5)
    want = np.asarray(jm.apply({"params": params}, _nlc(x))).transpose(0, 2, 1)
    sd = {}
    from_jax._adp_conv(sd, "c", params)
    tm = load(tadp.ADPConv1d(6, 10, k, stride), {k_[2:]: v for k_, v in sd.items()})
    got = tm(_t(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_adp_conv_transpose1d_matches_jax(factor):
    # a kernel with one live tap at each end of different size (asymmetric:
    # a flip applied twice or not at all moves the output), then random
    # taps; factor 3 takes the cropped path (k - stride odd). f32: 1e-5
    x = randn(6, 2, 5, 12)
    jm = jadp.ADPConvTranspose1d(7, 2 * factor, factor)
    params = jax_params(jm, _nlc(x), seed=6)
    taps = np.zeros_like(params["kernel"])
    taps[0], taps[-1] = 1.0, -0.25
    for kernel in (taps, params["kernel"]):
        p = dict(params, kernel=kernel)
        want = np.asarray(jm.apply({"params": p}, _nlc(x))).transpose(0, 2, 1)
        sd = {}
        from_jax._adp_conv(sd, "c", p, transposed=True)
        tm = load(tadp.ADPConvTranspose1d(5, 7, 2 * factor, factor),
                  {k_[2:]: v for k_, v in sd.items()})
        got = tm(_t(x)).detach().numpy()
        assert got.shape == want.shape == (2, 7, 12 * factor)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- GroupNorm ----------------------------------------------------------------------


@pytest.mark.parametrize("groups,channels", [(1, 24), (16, 64), (32, 96)])
def test_group_norm_matches_flax(groups, channels):
    # flax's GroupNorm (epsilon 1e-6, E[x^2] - E[x]^2) against var_mean + addcmul;
    # f32 statistics over 40 x channels / groups values: 2e-5 of O(1)
    x = randn(7, 2, channels, 40, scale=2.0) + 0.5
    jm = fnn.GroupNorm(num_groups=groups)
    params = jax_params(jm, _nlc(x), seed=7)
    want = np.asarray(jm.apply({"params": params}, _nlc(x))).transpose(0, 2, 1)
    tm = load(GroupNorm(groups, channels), {"weight": params["scale"], "bias": params["bias"]})
    got = tm(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert tm(_t(x).bfloat16()).dtype == torch.bfloat16


# -- blocks ---------------------------------------------------------------------------

BLOCK_TOL = dict(atol=3e-5, rtol=1e-5)  # two norms and two k = 3 convs in f32, O(1) outputs


def test_resnet_block_with_the_mapping_matches_jax():
    # width 32 -> 48 (the to_out 1 x 1 conv), 8 groups, the mapping's scale-shift
    x, mapping = randn(8, 2, 32, 24), randn(9, 2, 20)
    jm = jadp.ResnetBlock1d(48, num_groups=8, context_mapping_features=20)
    params = jax_params(jm, _nlc(x), jnp.asarray(mapping), seed=8)
    want = np.asarray(jm.apply({"params": params}, _nlc(x), jnp.asarray(mapping)))
    sd = {}
    from_jax._adp_resnet(sd, "r", params)
    tm = load(tadp.ResnetBlock1d(32, 48, num_groups=8, context_mapping_features=20),
              {k[2:]: v for k, v in sd.items()})
    got = tm(_t(x), _t(mapping)).detach().numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), **BLOCK_TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_adp_attention_with_a_masked_context_matches_jax(cross):
    # 2 heads of 16 over 24 queries; the context's masked rows zero their k
    # and v (they still take softmax weight: logit 0), f32: 2e-5
    x, ctx = randn(10, 2, 24, 32), randn(11, 2, 9, 20)
    mask = np.ones((2, 9), bool)
    mask[0, 5:] = mask[1, 2] = False
    jm = jadp.ADPAttention(16, 2, context_features=20 if cross else None)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx), jnp.asarray(mask)) if cross else ())
    params = jax_params(jm, *args, seed=10)
    want = np.asarray(jm.apply({"params": params}, *args))
    sd = {}
    from_jax._adp_attention(sd, "a", params)
    tm = load(tadp.ADPAttention(32, 16, 2, 20 if cross else None),
              {k[2:]: v for k, v in sd.items()})
    got = (tm(_t(x), _t(ctx), torch.from_numpy(mask)) if cross else tm(_t(x))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    if cross:  # the mask matters
        unmasked = tm(_t(x), _t(ctx)).detach().numpy()
        assert np.abs(unmasked - got).max() > 1e-3


def test_transformer1d_matches_jax():
    # GroupNorm(32), 1 x 1 conv, 2 blocks of self- and cross-attention and an
    # exact-GELU feed-forward, 1 x 1 conv (no outer residual); f32: 5e-5 of
    # the peak
    x, ctx = randn(12, 2, 64, 20), randn(13, 2, 7, 24)
    mask = np.ones((2, 7), bool)
    mask[1, 4:] = False
    jm = jadp.Transformer1d(num_layers=2, num_heads=2, head_features=32, multiplier=2,
                            context_features=24)
    args = (_nlc(x), jnp.asarray(ctx), jnp.asarray(mask))
    params = jax_params(jm, *args, seed=12)
    want = np.asarray(jm.apply({"params": params}, *args)).transpose(0, 2, 1)
    sd = {}
    from_jax._adp_transformer(sd, "t", params)
    tm = load(tadp.Transformer1d(64, 2, 2, 32, 2, 24), {k[2:]: v for k, v in sd.items()})
    got = tm(_t(x), _t(ctx), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=5e-5 * np.abs(want).max())


# -- a tiny UNetCFG1d ------------------------------------------------------------------

# SA-1.0's UNet at toy size: 3 levels of 64 / 64 / 96 channels (factors 1 and
# 2), 16 resnet groups, a transformer block at every level (2 heads), the
# context 32 wide
UNET = dict(in_channels=4, channels=32, multipliers=(2, 2, 3), factors=(1, 2),
            num_blocks=(1, 2), attentions=(1, 1, 1), resnet_groups=16,
            kernel_multiplier_downsample=2, use_nearest_upsample=False, use_skip_scale=True,
            use_context_time=True, context_embedding_features=32,
            context_embedding_max_length=12, attention_heads=2, attention_multiplier=2)


@pytest.fixture(scope="module")
def unet_pair():
    jm = jadp.UNetCFG1d(**UNET)
    x, t, emb = jnp.zeros((2, 4, 32)), jnp.ones((2,)), jnp.zeros((2, 12, 32))
    params = jax_params(jm, x, t, emb, seed=14)
    tm = tadp.UNetCFG1d(**UNET)
    load(tm, from_jax.adp_unet_cfg_state_dict(params))
    return jm, {"params": params}, tm


def _unet_inputs(L=12):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    emb = rng.standard_normal((2, L, 32)).astype(np.float32)
    mask = np.ones((2, L), bool)
    mask[1, L // 2:] = False
    neg = rng.standard_normal((2, L, 32)).astype(np.float32)
    neg_mask = np.ones((2, L), bool)
    neg_mask[0, 3:] = False
    return x, t, emb, mask, neg, neg_mask


# f32 through 3 levels of resnet and transformer blocks: 1e-4 of the peak
UNET_TOL = 1e-4


@pytest.mark.parametrize("case", ["cfg1", "cfg6", "negative", "rescale", "short"])
def test_unet_cfg1d_matches_jax(unet_pair, case):
    jm, variables, tm = unet_pair
    L = 7 if case == "short" else 12  # a context shorter than the null table
    x, t, emb, mask, neg, neg_mask = _unet_inputs(L)
    kw = dict(embedding_scale=1.0 if case == "cfg1" else 6.0,
              rescale_cfg=case == "rescale", scale_phi=0.4)
    jkw, tkw = dict(kw), dict(kw)
    if case == "negative":
        jkw.update(negative_embedding=jnp.asarray(neg),
                   negative_embedding_mask=jnp.asarray(neg_mask))
        tkw.update(negative_embedding=_t(neg), negative_embedding_mask=torch.from_numpy(neg_mask))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb),
                               jnp.asarray(mask), **jkw))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(emb), torch.from_numpy(mask), **tkw).numpy()
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got, want, atol=UNET_TOL * np.abs(want).max())


def test_unet_cfg1d_guidance_and_the_null_table(unet_pair):
    _, _, tm = unet_pair
    x, t, emb, mask, neg, neg_mask = _unet_inputs()
    with torch.no_grad():
        cond = tm(_t(x), _t(t), _t(emb), torch.from_numpy(mask))
        fixed = tm.fixed_embedding.embedding.weight[None].expand(2, 12, 32)
        uncond = tm(_t(x), _t(t), fixed, torch.from_numpy(mask))
        cfg = tm(_t(x), _t(t), _t(emb), torch.from_numpy(mask), embedding_scale=6.0)
        # a negative context masked everywhere is the null context
        none = tm(_t(x), _t(t), _t(emb), torch.from_numpy(mask), embedding_scale=6.0,
                  negative_embedding=_t(neg),
                  negative_embedding_mask=torch.zeros(2, 12, dtype=torch.bool))
    want = uncond + (cond - uncond) * 6.0
    np.testing.assert_allclose(cfg.numpy(), want.numpy(), atol=1e-4 * want.abs().max().item())
    np.testing.assert_array_equal(none.numpy(), cfg.numpy())
    with pytest.raises(ValueError, match="context_embedding_max_length"):
        tm(_t(x), _t(t), torch.zeros(2, 13, 32))


def test_unet_cfg1d_patching_and_conditioning_channels_match_jax():
    # what SA-1.0 does not set, through the same UNet: patch_size 2 (the time
    # steps folded into the channels and back), conditioning channels joined
    # to the input (context_channels, the wrapper's input_concat_cond) and a
    # global feature vector in the mapping (context_features, global_cond);
    # at CFG 3 both are doubled with the batch. f32: 1e-4 of the peak
    cfg = dict(UNET, patch_size=2, context_channels=(3,), context_features=16)
    jm = jadp.UNetCFG1d(**cfg)
    x, t, emb, mask, _, _ = _unet_inputs()
    rng = np.random.default_rng(16)
    chans = rng.standard_normal((2, 3, 32)).astype(np.float32)
    feats = rng.standard_normal((2, 16)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb), jnp.asarray(mask))
    jkw = dict(features=jnp.asarray(feats), channels_list=[jnp.asarray(chans)])
    params = jax_params(jm, *jargs, **jkw, seed=17)
    tm = load(tadp.UNetCFG1d(**cfg), from_jax.adp_unet_cfg_state_dict(params))
    assert tm.to_in.block.block1.project.weight.shape == (32, 7, 3)
    for scale in (1.0, 3.0):
        want = np.asarray(jm.apply({"params": params}, *jargs, embedding_scale=scale, **jkw))
        with torch.no_grad():
            got = tm(_t(x), _t(t), _t(emb), torch.from_numpy(mask), embedding_scale=scale,
                     features=_t(feats), channels_list=[_t(chans)]).numpy()
        np.testing.assert_allclose(got, want, atol=UNET_TOL * np.abs(want).max())
