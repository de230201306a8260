"""The SA-2.0 slice of the port against the JAX package on the CPU: the NHD
rotary and attention dispatch (the strided-layout flash attention's plain
version is held against the Pallas kernel in test_torch_kernels.py), the RoBERTa tower and
the CLAP text conditioner (both packages read one CLAP state-dict file), the
chunked overlap-paste codec, the rest of the k-diffusion samplers on replayed
noise, the inpainting masks, and generation end to end (negative
conditioning, init audio, inpainting) on a tiny SA-2.0-shaped model with the
JAX model's weights carried over by io/from_jax.py.

All inputs are f32 and made with numpy from a seed; every tolerance is stated
with its reason at the test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_audio_tools_tpu.ops.attention as jattn
from stable_audio_tools_tpu.inference import generation as jgen
from stable_audio_tools_tpu.inference import sampling as jsamp
from stable_audio_tools_tpu.models import conditioners as jcond
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu.models.inpainting import random_inpaint_mask as jax_inpaint_mask
from stable_audio_tools_tpu.ops import embeddings as jemb
from stable_audio_tools_tpu_torch.inference import generation as tgen
from stable_audio_tools_tpu_torch.inference import sampling as tsamp
from stable_audio_tools_tpu_torch.inference.utils import prepare_audio, set_audio_channels
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import conditioners as tcond
from stable_audio_tools_tpu_torch.models import roberta as trob
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.models.inpainting import random_inpaint_mask
from stable_audio_tools_tpu_torch.ops import attention as tattn
from stable_audio_tools_tpu_torch.ops import embeddings as temb
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa

from test_torch_slice import jax_tokenizer, stable_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- the kernel's plain version ------------------------------------------------


def test_flash_attention_nhd_reads_strided_views_and_refuses_bad_arguments():
    rng = np.random.default_rng(2)
    fused = _t(rng.standard_normal((1, 70, 3 * 2 * 64)))
    q, k, v = (t.view(1, 70, 2, 64) for t in fused.chunk(3, dim=-1))
    assert not q.is_contiguous()
    out = tfa.flash_attention_nhd(q, k, v, prefix_len=1)
    want, _ = tfa.flash_attention_prefix_plain(*(t.transpose(1, 2) for t in (q, k, v)), 1)
    np.testing.assert_allclose(out.numpy(), want.transpose(1, 2).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="non-causal"):
        tfa.flash_attention_nhd(q, k, v, causal=True, prefix_len=1)
    with pytest.raises(ValueError, match="prefix_len"):
        tfa.flash_attention_nhd(q, k, v, prefix_len=129)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attention_nhd(q, k[:, :60], v)


def test_apply_rotary_pos_emb_nhd_matches_jax():
    # the same f32 elementwise maths: 1e-6
    rng = np.random.default_rng(3)
    t = rng.standard_normal((2, 10, 3, 64)).astype(np.float32)
    want = jemb.apply_rotary_pos_emb_nhd(jnp.asarray(t), jemb.rotary_freqs(12, 32))
    freqs = temb.rotary_freqs(12, 32)
    got = temb.apply_rotary_pos_emb_nhd(_t(t), freqs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # and the [B, H, N, D] rotation on the transposed tensor
    other = temb.apply_rotary_pos_emb(_t(t).transpose(1, 2), freqs).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), other.numpy(), atol=1e-6)


@pytest.mark.parametrize("use_rope,prefix", [(True, 0), (True, 1), (False, 9)])
def test_attention_nhd_dispatch_matches_jax(use_rope, prefix, monkeypatch):
    # the JAX Attention with its NHD branch forced (the Pallas kernel in
    # interpret mode), as tests/test_flash_attention.py forces it, against
    # the port's Attention taking its NHD branch, with the same weights:
    # f32, two 256-wide projections around the attention, 2e-5
    rng = np.random.default_rng(4)
    B, N, dim, dh = 2, 256 + prefix, 256, 64
    x = rng.standard_normal((B, N, dim)).astype(np.float32)
    params = {"to_qkv": {"kernel": rng.standard_normal((dim, 3 * dim)).astype(np.float32) / 16},
              "to_out": {"kernel": rng.standard_normal((dim, dim)).astype(np.float32) / 16}}
    jm = jattn.Attention(dim=dim, dim_heads=dh, prefix_len=prefix)
    monkeypatch.setattr(jattn, "_should_use_nhd", lambda *a, **k: True)
    rot = jemb.RotaryEmbedding(dim=dh // 2)(N) if use_rope else None
    want = jm.apply({"params": params}, jnp.asarray(x), rotary_pos_emb=rot)

    calls = []
    real = tattn.flash_attention_nhd
    monkeypatch.setattr(tattn, "flash_attention_nhd",
                        lambda q, *a, **k: calls.append(q.shape) or real(q, *a, **k))
    weights = {"to_qkv.weight": _t(from_jax.deinterleave_fused(params["to_qkv"]["kernel"], 3, dh).T),
               "to_out.weight": _t(params["to_out"]["kernel"].T)}
    freqs = temb.rotary_freqs(N, dh // 2) if use_rope else None
    outs = {}
    for name, min_seq in (("nhd", 0), ("bhnd", 10 ** 9)):
        tm = tattn.Attention(dim, dh, nhd_min_seq=min_seq)
        tm.load_state_dict(weights)
        with torch.no_grad():
            outs[name] = tm(_t(x), rotary_pos_emb=freqs, prefix_len=prefix).numpy()
    assert calls == [(B, N, dim // dh, dh)]  # only the first module took the NHD entry
    np.testing.assert_allclose(outs["nhd"], np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(outs["nhd"], outs["bhnd"], atol=2e-5, rtol=1e-5)


def test_attention_default_threshold_sends_sa_open_and_sa2_lengths_apart():
    m = tattn.Attention(128, 64)
    assert 1024 < m.nhd_min_seq <= 6144


# -- RoBERTa and the CLAP text conditioner --------------------------------------


def _make_clap_ckpt(path, hidden=64, with_projection=True):
    """A synthetic laion-clap checkpoint: a Hugging Face torch RoBERTa under
    `module.text_branch.*` and a joint-space projection."""
    from transformers import RobertaConfig, RobertaModel

    cfg = RobertaConfig(vocab_size=32002, hidden_size=hidden, num_hidden_layers=3,
                        num_attention_heads=hidden // 64, intermediate_size=2 * hidden,
                        max_position_embeddings=80, type_vocab_size=1)
    torch.manual_seed(0)
    roberta = RobertaModel(cfg).eval()
    sd = {f"module.text_branch.{k}": v for k, v in roberta.state_dict().items()}
    if with_projection:
        proj = torch.nn.Sequential(torch.nn.Linear(hidden, 24), torch.nn.ReLU(),
                                   torch.nn.Linear(24, 24))
        sd.update({f"module.text_projection.{k}": v for k, v in proj.state_dict().items()})
    torch.save({"state_dict": sd}, path)
    return roberta


TEXTS = ["a dog barking in the rain", "rain", "warm analog pads with a slow attack and tape hiss"]


def _stable_clap_pair(**kw):
    """The JAX and the port's CLAP text conditioners on the same arguments,
    both with the salt-free word-hash tokenizer."""
    jc = jcond.CLAPTextConditioner("prompt", **kw)
    jc._tower = (jax_tokenizer(77),) + tuple(jc._load_tower()[1:])
    tc = tcond.CLAPTextConditioner(**kw)
    tc.tokenizer = stable_tokenizer(77)
    return jc, tc


def test_roberta_position_ids_follow_the_hugging_face_model():
    from transformers.models.roberta.modeling_roberta import create_position_ids_from_input_ids

    ids, _ = tcond.FallbackTokenizer(77)(TEXTS)
    ids = torch.from_numpy(ids)
    want = create_position_ids_from_input_ids(ids, padding_idx=1)
    got = trob.position_ids_from_input_ids(ids)
    assert torch.equal(got, want)
    # the fallback tokenizer pads with 0, not with padding_idx: positions go
    # on counting through the padding, and the closing id 1 gets position 1
    n = len(TEXTS[1].split())
    assert got[1, n].item() == 1 and got[1, n + 1].item() == n + 2


@pytest.mark.parametrize("use_text_features", [True, False])
def test_clap_text_conditioner_matches_jax(tmp_path, use_text_features):
    # both packages read the same CLAP state-dict file; f32 towers (3 post-LN
    # layers of 64): 2e-5 on O(1) features
    path = str(tmp_path / "clap.pt")
    hf = _make_clap_ckpt(path)
    kw = dict(clap_ckpt_path=path, use_text_features=use_text_features, feature_layer_ix=-2)
    jc, tc = _stable_clap_pair(output_dim=16, **kw)
    feats = jc.prepare(TEXTS)["features"]
    got = tc.features(TEXTS, "cpu").numpy()
    np.testing.assert_allclose(got, feats, atol=2e-5, rtol=1e-5)
    assert got.shape == ((3, 77, 64) if use_text_features else (3, 24))
    # ... and Hugging Face's torch model on the same token ids
    ids, mask = (torch.from_numpy(a) for a in tc.tokenizer(TEXTS))
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask, output_hidden_states=True)
        hs, pooled = tc.model(ids, mask)
    np.testing.assert_allclose(hs[-2].numpy(), ref.hidden_states[-2].numpy(), atol=2e-5)
    np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(), atol=2e-5)
    assert len(hs) == 4 and not any(p.requires_grad for p in tc.model.parameters())

    # the learnable projection (CLAPProjModule) with the same weights, all-ones mask
    module = jc.make_module()
    rng = np.random.default_rng(5)
    width = feats.shape[-1]
    proj = {"kernel": rng.standard_normal((width, 16)).astype(np.float32) / 8,
            "bias": rng.standard_normal(16).astype(np.float32)}
    want, want_mask = module.apply({"params": {"proj": {"proj_out": proj}}}, jnp.asarray(feats))
    sd = {}
    from_jax.dense(sd, "proj_out", proj)
    tc.proj_out.load_state_dict({k[len("proj_out."):]: _t(v) for k, v in sd.items()})
    out, out_mask = tc(TEXTS, "cpu")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=3e-5, rtol=1e-5)
    assert out_mask.dtype == torch.bool and out_mask.all()
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(want_mask))


def test_roberta_state_dict_converts_the_flax_tower(tmp_path):
    # the Flax tower the JAX conditioner builds from the file converts back
    # to exactly the file's tensors (transposes only)
    path = str(tmp_path / "clap.pt")
    hf = _make_clap_ckpt(path)
    jc = jcond.CLAPTextConditioner("prompt", output_dim=16, clap_ckpt_path=path)
    flax_model = jc._build_roberta(jcond._load_clap_state_dict(path))
    got = from_jax.roberta_state_dict(jax.tree_util.tree_map(np.asarray, flax_model.params))
    want = {k: v.numpy() for k, v in hf.state_dict().items()
            if not k.endswith(("position_ids", "token_type_ids"))}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port = trob.RobertaModel(trob.RobertaArch.from_state_dict({k: _t(v) for k, v in got.items()}))
    port.load_state_dict({k: _t(v) for k, v in got.items()}, strict=True)


def test_clap_text_conditioner_checkpoint_rules(tmp_path):
    with pytest.raises(RuntimeError, match="allow_random_init"):
        tcond.CLAPTextConditioner(16)
    with pytest.raises(FileNotFoundError):
        tcond.CLAPTextConditioner(16, clap_ckpt_path="/path/to/clap.ckpt")
    path = str(tmp_path / "noproj.pt")
    _make_clap_ckpt(path, with_projection=False)
    with pytest.raises(RuntimeError, match="text_projection"):
        tcond.CLAPTextConditioner(16, clap_ckpt_path=path)
    c = tcond.CLAPTextConditioner(16, clap_ckpt_path=path, allow_random_init=True)
    assert c(["x"], "cpu")[0].shape == (1, 1, 16)
    # no checkpoint, random init allowed: the JAX package's 2-layer 768-wide tower
    c = tcond.CLAPTextConditioner(768, use_text_features=True, allow_random_init=True)
    assert len(c.model.encoder.layer) == 2 and c.proj_out is None
    out, mask = c(["a b c", "d"], "cpu")
    assert out.shape == (2, 77, 768) and mask.shape == (2, 77) and mask.all()
    # precomputed features in place of the tower
    c.set_embed_fn(lambda texts: np.ones((len(texts), 768), np.float32))
    out, mask = c(["a", "b"], "cpu")
    assert out.shape == (2, 1, 768) and mask.shape == (2, 1) and (out == 1).all()


# -- the chunked codec -----------------------------------------------------------

OOBLECK = {"channels": 8, "c_mults": [1, 2], "strides": [2, 4], "use_snake": True}
AE_CONFIG = {
    "model_type": "autoencoder", "sample_rate": 16000,
    "model": {
        "encoder": {"type": "oobleck", "config": dict(OOBLECK, in_channels=2, latent_dim=4)},
        "decoder": {"type": "oobleck", "config": dict(OOBLECK, out_channels=2, latent_dim=4)},
        "latent_dim": 4, "downsampling_ratio": 8, "io_channels": 2,
    },
}
CHUNK = dict(chunked=True, chunk_size=96, overlap=32)


@pytest.fixture(scope="module")
def ae_pair():
    """A small Oobleck autoencoder without a bottleneck (so that encode is
    deterministic) in both packages with the same seeded weights."""
    model = jax_create(AE_CONFIG)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 64))))
    rng = np.random.default_rng(6)

    def draw(path, a):
        name = path[-1].key
        if name == "v":
            return (rng.standard_normal(a.shape) * np.prod(a.shape[:-1]) ** -0.5).astype(np.float32)
        if name == "g":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    port = create_model_from_config(AE_CONFIG, "cpu")
    port.load_state_dict({k: _t(v) for k, v in from_jax.autoencoder_state_dict(params).items()},
                         strict=True)
    return model, {"params": params}, port.eval()


def test_chunk_starts_pin_the_last_chunk_to_the_end(ae_pair):
    model, _, port = ae_pair
    for total, chunk, hop in ((6144, 128, 96), (200, 96, 64), (128, 128, 96), (300, 100, 100)):
        starts = port._chunk_starts(total, chunk, hop)
        assert starts == model._chunk_starts(total, chunk, hop)
        assert starts[-1] + chunk == total
    assert len(port._chunk_starts(6144, 128, 96)) == 64


@pytest.mark.parametrize("chunk_batch", [8, 2])
def test_decode_audio_chunked_matches_jax(ae_pair, chunk_batch):
    # 200 latents in windows of 96 every 64, the last pinned to the end (3
    # chunks; with chunk_batch 2 the last group is a single chunk). The same
    # f32 convs and snakes through 2 decoder blocks, summed in another order
    # on each side: 5e-5 on outputs of O(1)
    model, variables, port = ae_pair
    z = np.random.default_rng(7).standard_normal((2, 4, 200)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(z),
                       method=lambda m, a: m.decode_audio(a, **CHUNK))
    with torch.no_grad():
        got = port.decode_audio(_t(z), chunk_batch=chunk_batch, **CHUNK)
        full = port.decode(_t(z))
        short = port.decode_audio(_t(z[:, :, :96]), **CHUNK)
    assert got.shape == (2, 2, 1600)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)
    # away from the seams (the decoder sees ~30 latents to each side) the
    # chunked decode is the unchunked one; nearer to a seam it is not
    for sl in (slice(0, 60 * 8), slice(140 * 8, 1600)):
        np.testing.assert_allclose(got.numpy()[..., sl], full.numpy()[..., sl], atol=5e-5)
    assert np.abs(got.numpy() - full.numpy()).max() > 1e-3
    # at most one chunk long: the plain decode
    np.testing.assert_array_equal(short.numpy(), port.decode(_t(z[:, :, :96])).detach().numpy())


def test_encode_audio_chunked_matches_jax(ae_pair):
    model, variables, port = ae_pair
    audio = (0.5 * np.random.default_rng(8).standard_normal((1, 2, 1600))).astype(np.float32)
    want = model.apply(variables, jnp.asarray(audio),
                       method=lambda m, a: m.encode_audio(a, **CHUNK))
    with torch.no_grad():
        got = port.encode_audio(_t(audio), **CHUNK)
        full = port.encode(_t(audio))
    assert got.shape == (1, 4, 200)
    # latents of magnitude ~10 from f32 convs: 5e-5 + 1e-5 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy()[..., :50], full.numpy()[..., :50], atol=5e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        port.encode_audio(_t(audio), noise=torch.zeros(1, 4, 200), **CHUNK)


def test_pretransform_chunked_and_iterate_batch(ae_pair):
    from stable_audio_tools_tpu_torch.models.factory import create_pretransform_from_config

    _, _, port = ae_pair
    cfg = {"type": "autoencoder", "config": AE_CONFIG["model"], "scale": 2.0}
    z = _t(np.random.default_rng(9).standard_normal((2, 4, 200)))
    outs = {}
    for name, extra in (("plain", {}), ("chunked", {"chunked": True}),
                        ("both", {"chunked": True, "iterate_batch": True})):
        pt = create_pretransform_from_config(dict(cfg, **extra), 16000, "cpu")
        pt.model.load_state_dict(port.state_dict())
        assert (pt.chunked, pt.iterate_batch) == (extra.get("chunked", False),
                                                  extra.get("iterate_batch", False))
        with torch.no_grad():
            outs[name] = pt.decode(z)
    with torch.no_grad():
        want = port.decode_audio(z * 2.0, chunked=True)
    np.testing.assert_array_equal(outs["chunked"].numpy(), want.numpy())
    # one item at a time: the same convs at batch 1, blocked differently
    np.testing.assert_allclose(outs["both"].numpy(), want.numpy(), atol=5e-5)
    assert np.abs(outs["plain"].numpy() - want.numpy()).max() > 1e-3


# -- samplers --------------------------------------------------------------------

SAMPLER_KEY = jax.random.PRNGKey(11)


def _replayed_step_noise(key):
    """Step i's noise as the JAX samplers draw it: fold_in(key, i), in the
    [B, T, C] layout sample_k's scan runs in."""
    def step_noise(i, x):
        n = jax.random.normal(jax.random.fold_in(key, i), (x.shape[0], x.shape[2], x.shape[1]))
        return torch.from_numpy(np.ascontiguousarray(np.asarray(n).transpose(0, 2, 1)))
    return step_noise


@pytest.mark.parametrize("sampler", ["k-heun", "k-lms", "k-dpm-2", "k-dpmpp-2s-ancestral",
                                     "dpmpp-2m-sde", "k-dpm-fast", "k-dpm-adaptive",
                                     "dpmpp-2m", "dpmpp-3m-sde"])
@pytest.mark.parametrize("with_init", [False, True])
def test_sample_k_matches_jax(sampler, with_init):
    # a closed-form v-model, the same in jnp and torch; the JAX samplers run
    # f32 scans, the port's loops take their step coefficients in float64 and
    # the tensors in f32: 2e-4 of the result's peak over 9 steps
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((2, 3, 8)).astype(np.float32)
    init = rng.standard_normal((2, 3, 8)).astype(np.float32) if with_init else None
    kw = dict(steps=9, sampler_type=sampler, sigma_min=0.3, sigma_max=20.0, rho=1.0)

    def jax_v(x, t):
        return 0.3 * x * jnp.cos(t)[:, None, None] + 0.2 * jnp.sin(2.0 * x)

    def torch_v(x, t):
        return 0.3 * x * torch.cos(t)[:, None, None] + 0.2 * torch.sin(2.0 * x)

    want = np.asarray(jsamp.sample_k(jax_v, jnp.asarray(noise), rng=SAMPLER_KEY,
                                     init_data=None if init is None else jnp.asarray(init), **kw))
    got = tsamp.sample_k(torch_v, _t(noise), init_data=None if init is None else _t(init),
                         step_noise=_replayed_step_noise(SAMPLER_KEY), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_lms_coefficients_match_jax():
    sigmas = tsamp.get_sigmas_polyexponential(12, 0.3, 50.0).astype(np.float64)
    np.testing.assert_array_equal(tsamp._lms_coeffs(sigmas, 4), jsamp._lms_coeffs(sigmas, 4))


def test_stochastic_samplers_draw_from_the_generator_and_unported_ones_are_refused():
    v = lambda x, t: 0.1 * x
    noise = torch.randn(1, 2, 8, generator=torch.Generator().manual_seed(0))
    for sampler in ("k-dpmpp-2s-ancestral", "dpmpp-2m-sde", "dpmpp-3m-sde"):
        run = lambda seed: tsamp.sample_k(v, noise, steps=5, sampler_type=sampler,
                                          generator=torch.Generator().manual_seed(seed))
        assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    for sampler in ("v-ddim-cfgpp", "euler", "rk4", "dpmpp", "pingpong"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tsamp.sample_k(v, noise, sampler_type=sampler)
    out = tsamp.sample_k(v, noise, steps=5, sampler_type="v-ddim")
    assert out.shape == noise.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="Unknown sampler"):
        tsamp.sample_k(v, noise, sampler_type="nope")


# -- inpainting masks and audio preparation ---------------------------------------


@pytest.mark.parametrize("mask_args", [
    {"maskstart": 300, "maskend": 700},
    {"maskstart": 300, "maskend": 700, "softnessL": 0.1, "softnessR": 0.2},
    {"maskstart": 20, "maskend": 990, "softnessL": 0.1, "softnessR": 0.1, "marination": 0.25},
])
def test_build_mask_matches_jax(mask_args):
    want = np.asarray(jgen.build_mask(1000, mask_args))
    got = tgen.build_mask(1000, mask_args)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_inpaint_draws(key, B, K, probs):
    """The integers JAX `random_inpaint_mask` draws from `key`."""
    big = jnp.iinfo(jnp.int32).max
    r_type, r_nseg, r_seg, r_causal = jax.random.split(key, 4)
    seg_keys = jax.random.split(r_seg, 2)
    draws = {"mask_type": jax.random.choice(r_type, 3, (B,), p=jnp.asarray(probs)),
             "num_segments": jax.random.randint(r_nseg, (B,), 1, K + 1),
             "seg_len": jax.random.randint(seg_keys[0], (B, K), 1, big),
             "seg_start": jax.random.randint(seg_keys[1], (B, K), 0, big),
             "prefix": jax.random.randint(r_causal, (B,), 0, big)}
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in draws.items()}


@pytest.mark.parametrize("padded", [False, True])
def test_random_inpaint_mask_matches_jax(padded):
    # the JAX function's random integers replayed into the port: exact
    rng = np.random.default_rng(13)
    B, T, K, probs = 24, 97, 6, [0.3, 0.3, 0.4]
    seq = rng.standard_normal((B, 3, T)).astype(np.float32)
    pad = None
    if padded:
        pad = (np.arange(T)[None, :] < rng.integers(0, T + 1, (B, 1))).astype(np.float32)
        pad[0] = 0  # an empty real region
    key = jax.random.PRNGKey(14)
    want_seq, want_mask = jax_inpaint_mask(jnp.asarray(seq), key,
                                           None if pad is None else jnp.asarray(pad), K, probs)
    got_seq, got_mask = random_inpaint_mask(_t(seq), padding_masks=None if pad is None else _t(pad),
                                            max_mask_segments=K,
                                            draws=_jax_inpaint_draws(key, B, K, probs))
    assert got_mask.shape == (B, 1, T)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    assert len({float(m.mean()) for m in got_mask}) > 3  # not one mask for all


def test_random_inpaint_mask_from_a_generator():
    seq = torch.ones(64, 2, 50)
    run = lambda seed: random_inpaint_mask(seq, torch.Generator().manual_seed(seed))
    (masked, mask), (_, again), (_, other) = run(0), run(0), run(1)
    assert mask.shape == (64, 1, 50) and set(mask.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(mask, again) and not torch.equal(mask, other)
    assert torch.equal(masked, seq * mask)
    full = (mask.sum(dim=(1, 2)) == 0).float().mean().item()
    assert 0.55 < full < 0.98  # FULL_MASK is drawn with probability 0.8


def test_prepare_audio_and_set_audio_channels_match_jax():
    from stable_audio_tools_tpu.inference import utils as jutils

    rng = np.random.default_rng(15)
    a = rng.standard_normal((1, 700)).astype(np.float32)
    for target_len, target_ch, sr in ((1000, 2, 16000), (500, 1, 16000), (900, 2, 32000)):
        want = jutils.prepare_audio(a, 16000, sr, target_len, target_ch)
        got = prepare_audio(a, 16000, sr, target_len, target_ch)
        assert got.shape == (1, target_ch, target_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    x = _t(rng.standard_normal((2, 3, 10)))
    for ch in (1, 2, 3):
        np.testing.assert_allclose(set_audio_channels(x, ch).numpy(),
                                   np.asarray(jutils.set_audio_channels(x.numpy(), ch)), atol=1e-7)
    with pytest.raises(ValueError):
        set_audio_channels(x, 4)


# -- generation end to end on a tiny SA-2.0-shaped model ---------------------------

SEED = 7
META = [{"prompt": "warm analog pads", "seconds_start": 3, "seconds_total": 30}]
NEGATIVE = [{"prompt": "harsh distorted noise", "seconds_start": 3, "seconds_total": 30}]


def _sa2_config(clap_path, model_type="diffusion_cond"):
    """SA-2.0's shape at toy size, f32: a CLAP text conditioner read from a
    checkpoint (hidden states at layer -2) and two number conditioners, all
    cross-attended without projection (2 query heads over 1 key/value head),
    the numbers also as the prepended global token, a chunked VAE decode. The
    port's DiT is set to its strided-layout attention entry in `_sa2_pair`."""
    oobleck = {"channels": 8, "c_mults": [1, 2], "strides": [4, 4], "use_snake": True}
    inpaint = model_type == "diffusion_cond_inpaint"
    return {
        "model_type": model_type, "sample_size": 4096, "sample_rate": 16000,
        "audio_channels": 2,
        "model": {
            "pretransform": {"type": "autoencoder", "chunked": True, "iterate_batch": True,
                             "config": {
                                 "encoder": {"type": "oobleck", "config": dict(
                                     oobleck, in_channels=2, latent_dim=8)},
                                 "decoder": {"type": "oobleck", "config": dict(
                                     oobleck, out_channels=2, latent_dim=4, final_tanh=False)},
                                 "bottleneck": {"type": "vae"}, "latent_dim": 4,
                                 "downsampling_ratio": 16, "io_channels": 2}},
            "conditioning": {"cond_dim": 64, "configs": [
                {"id": "prompt", "type": "clap_text", "config": {
                    "audio_model_type": "HTSAT-base", "enable_fusion": True,
                    "clap_ckpt_path": clap_path, "use_text_features": True,
                    "feature_layer_ix": -2}},
                {"id": "seconds_start", "type": "number", "config": {"min_val": 0, "max_val": 512}},
                {"id": "seconds_total", "type": "number", "config": {"min_val": 0, "max_val": 512}}]},
            "diffusion": {
                "cross_attention_cond_ids": ["prompt", "seconds_start", "seconds_total"],
                "global_cond_ids": ["seconds_start", "seconds_total"],
                "type": "dit",
                "config": dict({"io_channels": 4, "embed_dim": 128, "depth": 2, "num_heads": 2,
                                "cond_token_dim": 64, "global_cond_dim": 128,
                                "project_cond_tokens": False, "use_checkpointing": False,
                                "transformer_type": "continuous_transformer"},
                               **({"input_concat_dim": 5} if inpaint else {}))},
            "io_channels": 4,
        },
    }


def _seeded_params(shapes, seed):
    """Seeded numpy parameters for a flax shape tree: kernels ~ N(0, 1/fan_in),
    Fourier tables ~ N(0, 1), norm scales and weight-norm g ~ 1 + N(0, 0.1),
    biases and log-scale snake parameters ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if len(a.shape) >= 2:
            std = 1.0 if name == "weight" else np.prod(a.shape[:-1]) ** -0.5
        elif name in ("gamma", "g"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        else:
            std = 1.0 if name == "weights" else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _sa2_pair(config):
    """(JAX model, its variables, the port's model with the same weights).
    Both conditioners read their CLAP tower from the config's file."""
    model = jax_create(config)
    mc = model._multi_conditioner
    clap = mc.conditioners["prompt"]
    clap._tower = (jax_tokenizer(77),) + tuple(clap._load_tower()[1:])
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(META))
    extra = {}
    if config["model_type"] == "diffusion_cond_inpaint":
        extra["input_concat_cond"] = jnp.zeros((1, 5, 64))
    shapes = jax.eval_shape(lambda x, t: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        x, t, cond=prepared, method=model.init_full, **extra), jnp.zeros((1, 4, 64)),
        jnp.ones((1,)))
    params = _seeded_params(shapes["params"], 16)
    port = create_model_from_config(config, "cpu")
    for block in port.model.model.transformer.layers:
        block.self_attn.nhd_min_seq = 0
    port.conditioner.conditioners["prompt"].tokenizer = stable_tokenizer(77)
    sd = from_jax.diffusion_cond_state_dict(params, dim_heads=64)
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
def sa2_pair(clap_path):
    return _sa2_pair(_sa2_config(clap_path))


def _replayed_noise(shape):
    """The JAX package's noise for seed SEED: the initial latent noise from
    fold_in(key, 0), and the sampler's step noise under fold_in(key, 1)."""
    key = jax.random.PRNGKey(SEED)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 0), shape)))
    return noise, _replayed_step_noise(jax.random.fold_in(key, 1))


def _jax_vae_noise(model, variables, audio):
    """The standard normal noise the JAX VAE bottleneck draws when generation
    encodes `audio` (key fold_in(PRNGKey(SEED), 99)), recovered from its
    output and its pre-bottleneck mean and scale; [B, C, T]."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 99)
    z, info = model.apply(variables, jnp.asarray(audio), return_info=True, rngs={"sample": key},
                          method=lambda m, a, **kw: m.pretransform.model.encode(a, **kw))
    mean, scale = np.split(np.asarray(info["pre_bottleneck_latents"]), 2, axis=1)
    return _t((np.asarray(z) - mean) / (np.log1p(np.exp(scale)) + 1e-4))


def test_sa2_conditioning_and_routing_match_jax(sa2_pair):
    model, variables, port = sa2_pair
    want = jgen.compute_conditioning_tensors(model, variables, META)
    with torch.no_grad():
        got = port.conditioner(META, "cpu")
    for key in want:
        np.testing.assert_allclose(got[key][0].numpy(), np.asarray(want[key][0]),
                                   atol=3e-5, rtol=1e-5, err_msg=key)
        np.testing.assert_array_equal(got[key][1].numpy(), np.asarray(want[key][1]).astype(bool))
    for negative in (False, True):
        w = model.get_conditioning_inputs(want, negative=negative)
        g = port.get_conditioning_inputs(got, negative=negative)
        assert sorted(g) == sorted(w)
        for k in w:
            assert (g[k] is None) == (w[k] is None), k
            if w[k] is not None:
                assert tuple(g[k].shape) == tuple(w[k].shape), k
    # 77 CLAP tokens + 2 number tokens, 64 wide, unprojected: the DiT's
    # cross-attention has 2 query heads over 1 key/value head
    assert g["negative_cross_attn_cond"].shape == (1, 79, 64)
    assert port.model.model.transformer.layers[0].cross_attn.to_kv.weight.shape == (128, 64)


def test_generate_with_negative_conditioning_matches_jax(sa2_pair, monkeypatch):
    # f32 end to end: CLAP + number conditioning for the prompt and for the
    # negative prompt, 4 CFG steps of dpmpp-3m-sde on 1 + 256 tokens through
    # the port's NHD attention, and the chunked VAE decode (3 chunks). As
    # the SA-Open slice's end-to-end test: 2e-4 of the audio's peak
    model, variables, port = sa2_pair
    calls = []
    real = tattn.flash_attention_nhd
    monkeypatch.setattr(tattn, "flash_attention_nhd",
                        lambda q, *a, **k: calls.append(tuple(q.shape)) or real(q, *a, **k))
    kw = dict(steps=4, cfg_scale=3.0, batch_size=1, sample_size=4096, seed=SEED,
              sigma_min=0.3, sigma_max=50.0, sampler_type="dpmpp-3m-sde")
    want = np.asarray(jgen.generate_diffusion_cond(
        model, variables, conditioning=META, negative_conditioning=NEGATIVE, **kw))
    plain = np.asarray(jgen.generate_diffusion_cond(model, variables, conditioning=META, **kw))
    noise, step_noise = _replayed_noise((1, 4, 256))
    got = tgen.generate_diffusion_cond(port, conditioning=META, negative_conditioning=NEGATIVE,
                                       noise=noise, step_noise=step_noise, **kw).numpy()
    assert got.shape == want.shape == (1, 2, 4096)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())
    assert np.abs(want - plain).max() > 1e-2 * np.abs(want).max()  # the negative prompt matters
    assert calls == [(2, 257, 2, 64)] * 8  # 2 blocks x 4 steps, the batch doubled by CFG
    # ready-made conditioning tensors give the same audio
    with torch.no_grad():
        tensors, neg = port.conditioner(META, "cpu"), port.conditioner(NEGATIVE, "cpu")
    again = tgen.generate_diffusion_cond(port, conditioning_tensors=tensors,
                                         negative_conditioning_tensors=neg, noise=noise,
                                         step_noise=step_noise, **kw).numpy()
    np.testing.assert_array_equal(again, got)


def test_generate_from_init_audio_matches_jax(sa2_pair):
    # init audio of 2048 samples (128 latents: one chunk, so the encoder's
    # noise can be replayed), varied at sigma 5 with dpmpp-2m; f32: 2e-4
    model, variables, port = sa2_pair
    audio = (0.3 * np.random.default_rng(17).standard_normal((2, 2048))).astype(np.float32)
    kw = dict(steps=4, cfg_scale=3.0, batch_size=1, sample_size=2048, seed=SEED, sigma_min=0.3,
              sampler_type="dpmpp-2m", init_noise_level=5.0)
    want = np.asarray(jgen.generate_diffusion_cond(model, variables, conditioning=META,
                                                   init_audio=(16000, audio), **kw))
    noise, _ = _replayed_noise((1, 4, 128))
    got = tgen.generate_diffusion_cond(
        port, conditioning=META, init_audio=(16000, audio), noise=noise,
        init_noise=_jax_vae_noise(model, variables, audio[None]), **kw).numpy()
    assert got.shape == want.shape == (1, 2, 2048)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_generate_inpaint_matches_jax(clap_path):
    # a diffusion_cond_inpaint model (the mask and the masked latents joined
    # to the DiT's input: 4 + 5 channels into preprocess_conv and project_in),
    # a soft-edged hole, 4 steps of dpmpp-3m-sde; f32: 2e-4
    model, variables, port = _sa2_pair(_sa2_config(clap_path, "diffusion_cond_inpaint"))
    dit = port.model.model
    assert dit.preprocess_conv.weight.shape == (9, 9, 1)
    assert dit.transformer.project_in.weight.shape == (128, 9)
    audio = (0.3 * np.random.default_rng(18).standard_normal((2, 2048))).astype(np.float32)
    mask_args = {"maskstart": 512, "maskend": 1536, "softnessL": 0.05, "softnessR": 0.05}
    kw = dict(steps=4, cfg_scale=3.0, batch_size=1, sample_size=2048, seed=SEED, sigma_min=0.3,
              sigma_max=50.0, sampler_type="dpmpp-3m-sde", mask_args=mask_args)
    want = np.asarray(jgen.generate_diffusion_cond_inpaint(
        model, variables, conditioning=META, init_audio=(16000, audio), **kw))
    noise, step_noise = _replayed_noise((1, 4, 128))
    got = tgen.generate_diffusion_cond_inpaint(
        port, conditioning=META, init_audio=(16000, audio), noise=noise, step_noise=step_noise,
        init_noise=_jax_vae_noise(model, variables, audio[None]), **kw).numpy()
    assert got.shape == want.shape == (1, 2, 2048)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="init_audio"):
        tgen.generate_diffusion_cond_inpaint(port, conditioning=META, sample_size=2048)


def test_generation_refuses_what_is_not_ported(sa2_pair):
    _, _, port = sa2_pair
    for kw in ({"mesh": object()}, {"tp_rules": ()}, {"preview": True}):
        for fn in (tgen.generate_diffusion_cond, tgen.generate_diffusion_cond_inpaint):
            with pytest.raises(NotImplementedError, match="not ported"):
                fn(port, conditioning=META, sample_size=2048, init_audio=(16000, np.zeros((2, 8))),
                   **kw)
    for sampler in ("v-ddim-cfgpp", "euler", "rk4", "dpmpp", "pingpong"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tgen.generate_diffusion_cond(port, conditioning=META, sample_size=2048,
                                         sampler_type=sampler, steps=2)
    audio = tgen.generate_diffusion_cond(port, conditioning=META, sample_size=2048,
                                         sampler_type="v-ddim", steps=2, seed=0)
    assert audio.shape == (1, 2, 2048) and torch.isfinite(audio).all()
    with pytest.raises(ValueError, match="conditioning"):
        tgen.generate_diffusion_cond(port, sample_size=2048)


# -- the shipped SA-2.0 config -----------------------------------------------------


def _shipped_sa2_config(clap_path):
    path = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs", "txt2audio",
                        "stable_audio_2_0.json")
    with open(path) as f:
        config = json.load(f)
    clap = config["model"]["conditioning"]["configs"][0]["config"]
    assert clap["clap_ckpt_path"] == "/path/to/clap.ckpt"  # a placeholder in the shipped file
    clap["clap_ckpt_path"] = clap_path
    return config


def test_shipped_sa2_config_builds_unchanged(clap_path):
    # the shipped JSON through the port's factory on the meta device (shapes,
    # no memory): DiT 24 x 1536, 24 heads of 64 over 12 key/value heads of
    # unprojected 768-wide tokens, latent 64, a 5-level Oobleck VAE at ratio
    # 2048 in bf16, decoded one item at a time
    config = _shipped_sa2_config(clap_path)
    model = create_model_from_config(config, "meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    dit = model.model.model
    assert len(dit.transformer.layers) == 24 and dit.compute_dtype == torch.bfloat16
    block = dit.transformer.layers[0]
    assert block.self_attn.to_qkv.weight.shape == (3 * 1536, 1536)
    assert block.self_attn.dim_heads == 64 and block.self_attn.nhd_min_seq <= 6144
    assert block.cross_attn.to_q.weight.shape == (1536, 1536)
    assert block.cross_attn.to_kv.weight.shape == (2 * 768, 768)
    assert dit.to_cond_embed[0].weight.shape == (768, 768)
    assert dit.transformer.project_in.weight.shape == (1536, 64)
    pt = model.pretransform
    assert pt.model_half and pt.iterate_batch and not pt.chunked
    assert pt.downsampling_ratio == 2048 and pt.encoded_channels == 64
    assert pt.model.decoder.layers[0].weight_v.shape == (2048, 64, 7)
    assert pt.model.encoder.layers[-1].weight_v.shape == (128, 2048, 3)
    clap = model.conditioner.conditioners["prompt"]
    assert clap.use_text_features and clap.feature_layer_ix == -2 and clap.proj_out is None
    assert config["sample_size"] // pt.downsampling_ratio == 6144
    # the same parameter count as the JAX package's DiT for this config
    from stable_audio_tools_tpu.models.diffusion import _dit_from_config

    jax_dit = _dit_from_config(config["model"]["diffusion"]["config"], "v")
    shapes = jax.eval_shape(lambda: jax_dit.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 256)), jnp.ones((1,)),
        cross_attn_cond=jnp.zeros((1, 79, 768)), global_embed=jnp.zeros((1, 1536))))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in dit.parameters()) == want


def test_shipped_sa2_config_state_dict_reads_back_through_jax_importers(clap_path):
    # the shipped config at full width and depth 2 (and a narrow VAE): the
    # port's state-dict names and shapes are the ones the JAX package's
    # importers of reference checkpoints read, and they fill its DiT's and
    # autoencoder's parameter trees exactly
    from stable_audio_tools_tpu.io import checkpoints as jck
    from stable_audio_tools_tpu.io import torch_mapping as jtm
    from stable_audio_tools_tpu.models.diffusion import _dit_from_config

    config = _shipped_sa2_config(clap_path)
    config["model"]["diffusion"]["config"]["depth"] = 2
    ae = config["model"]["pretransform"]["config"]
    ae["encoder"]["config"]["channels"] = ae["decoder"]["config"]["channels"] = 4
    port = create_model_from_config(config, "cpu")
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    back = jtm.import_dit({k: v for k, v in sd.items() if k.startswith("model.model.")},
                          "model.model.", depth=2, cross_attend=True, dim_heads=64)
    jax_dit = _dit_from_config(config["model"]["diffusion"]["config"], "v")
    shapes = jax.eval_shape(lambda: jax_dit.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 256)), jnp.ones((1,)),
        cross_attn_cond=jnp.zeros((1, 79, 768)), global_embed=jnp.zeros((1, 1536))))["params"]
    assert (jax.tree_util.tree_map(lambda a: a.shape, back)
            == jax.tree_util.tree_map(lambda a: a.shape, shapes))
    again = from_jax.dit_state_dict(back, dim_heads=64, prefix="model.model.")
    for k, v in again.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    jax_ae = jax_create({"model_type": "autoencoder", "sample_rate": 44100, "model": ae})
    prefix = "pretransform.model."
    ae_back = jck.import_autoencoder_state_dict(
        jax_ae, {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})["params"]
    again = from_jax.autoencoder_state_dict(jax.tree_util.tree_map(np.asarray, ae_back), prefix)
    assert sorted(again) == sorted(k for k in sd if k.startswith(prefix))
    for k, v in again.items():
        np.testing.assert_allclose(v, sd[k], atol=1e-6, err_msg=k)
