"""The port's token LM slice as a whole against the JAX package, on the CPU: a
tiny MusicGen-shaped `lm` config (SEANet codec of hop 8 with 3 RVQ codebooks
of 32, the delay pattern, a causal backbone of 2 blocks of 128 with heads of
64 and cross-attention to a 32-wide context) through both factories, the JAX
parameters (and the codec's `quantizer_state`) carried into the port by
io/from_jax.py. Covered: tokenize, `compute_logits` and the loss, one AdamW
step, the KV-cached decode step by step, greedy generation by both paths,
the codec decode, the JAX package's two recorded faults (the full path's
causal cross-attention, the optimizer's decay of the frozen codec), and the
train entry with a checkpoint and a resume. Everything is f32.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu.models.lm import lm_generate as jax_lm_generate
from stable_audio_tools_tpu.models.lm import lm_generate_cached as jax_lm_generate_cached
from stable_audio_tools_tpu.ops.attention import init_kv_cache as jax_init_kv_cache
from stable_audio_tools_tpu.training.lm import AudioLanguageModelTrainer as JaxTrainer
from stable_audio_tools_tpu_torch.io.from_jax import audio_lm_state_dict
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.models.lm import (lm_generate, lm_generate_audio,
                                                     lm_generate_cached)
from stable_audio_tools_tpu_torch.ops.attention import init_kv_cache
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from tests.test_torch_lm_modules import randomize

K, CARD, HOP, CTX_DIM = 3, 32, 8, 32
SEANET = {"channels": 1, "dimension": 16, "n_filters": 4, "lstm": 2}
CONFIG = {
    "model_type": "lm", "sample_size": 16 * HOP, "sample_rate": 8000, "audio_channels": 1,
    "model": {
        "pretransform": {"type": "autoencoder", "config": {
            "encoder": {"type": "seanet", "config": dict(SEANET, ratios=[2, 4])},
            "decoder": {"type": "seanet", "config": dict(SEANET, ratios=[4, 2])},
            "bottleneck": {"type": "rvq", "config": {"dim": 16, "codebook_size": CARD,
                                                     "num_quantizers": K}},
            "latent_dim": 16, "downsampling_ratio": HOP, "io_channels": 1}},
        "lm": {"type": "continuous_transformer", "codebook_pattern": {"type": "delay"},
               "cross_attention_cond_ids": ["prompt"],
               "config": {"embed_dim": 128, "depth": 2, "num_heads": 2,
                          "cross_attn_cond_dim": CTX_DIM, "use_checkpointing": False}}},
    "training": {"learning_rate": 1e-4},
}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _cond(B, n_ctx, seed):
    """The conditioner's output for the "prompt" id: ([B, n_ctx, 32], mask)."""
    c = np.random.default_rng(seed).standard_normal((B, n_ctx, CTX_DIM)).astype(np.float32)
    m = np.ones((B, n_ctx), bool)
    return {"prompt": (jnp.asarray(c), jnp.asarray(m))}, {"prompt": (_t(c), _t(m, torch.bool))}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's model with the same weights)."""
    model = jax_create(CONFIG)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    jct, _ = _cond(1, 5, 0)
    lm_shapes = jax.eval_shape(lambda: model.init(keys, jnp.zeros((1, K, 16), jnp.int32),
                                                  cond_tensors=jct))
    enc = model.init(keys, jnp.zeros((1, 1, 16 * HOP)), method=model.pretransform_tokenize)
    dec_shapes = jax.eval_shape(lambda: model.init(keys, jnp.zeros((1, K, 16), jnp.int32),
                                                   method=model.pretransform_decode_tokens))
    params = {"lm": lm_shapes["params"]["lm"], "pretransform": {"model": {
        "encoder": enc["params"]["pretransform"]["model"]["encoder"],
        "decoder": dec_shapes["params"]["pretransform"]["model"]["decoder"]}}}
    params = randomize(params, 0)
    variables = {"params": params, "quantizer_state": enc["quantizer_state"]}
    port = create_model_from_config(CONFIG, "cpu")
    sd = audio_lm_state_dict(params, dim_heads=64, quantizer_state=enc["quantizer_state"])
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model, variables, port.eval()


def _codes(B, T, seed):
    return np.random.default_rng(seed).integers(0, CARD, (B, K, T)).astype(np.int32)


def test_tokenize_and_decode_tokens_match_jax(pair):
    # the frozen codec: identical codes from the SEANet encoder + RVQ, and
    # the decoded audio within f32 rounding (1e-5 of its peak)
    model, variables, port = pair
    audio = (0.3 * np.random.default_rng(1).standard_normal((2, 1, 16 * HOP))).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(audio),
                                  method=model.pretransform_tokenize))
    got = port.pretransform_tokenize(_t(audio))
    assert got.shape == (2, K, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    want_audio = np.asarray(model.apply(variables, jnp.asarray(want.transpose(0, 2, 1)),
                                        method=model.pretransform_decode_tokens))
    got_audio = port.pretransform_decode_tokens(got).numpy()
    assert got_audio.shape == (2, 1, 16 * HOP)
    np.testing.assert_allclose(got_audio, want_audio, atol=1e-5 * np.abs(want_audio).max())


def test_compute_logits_and_loss_match_jax(pair):
    # pattern shift, the causal backbone (the flash function's plain
    # version), the heads and the revert; the loss of the pre-tokenized JAX
    # trainer. f32 through 2 blocks: 1e-4 of the logits' peak, 1e-5 relative
    model, variables, port = pair
    codes = _codes(2, 16, 2)
    jct, tct = _cond(2, 5, 3)
    want, want_mask = model.apply(variables, jnp.asarray(codes), cond_tensors=jct,
                                  method=model.compute_logits)
    got, mask = port.compute_logits(torch.from_numpy(codes).long(), cond_tensors=tct)
    want = np.asarray(want)
    assert got.shape == (2, K, 16, CARD)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4 * np.abs(want).max())
    jt = JaxTrainer(model, lr=1e-4, pre_tokenized=True)
    want_loss, want_aux = jt._loss(variables["params"], {"codes": jnp.asarray(codes),
                                                        "cond_tensors": jct},
                                   jax.random.PRNGKey(0))
    tt = create_training_wrapper_from_config(CONFIG, port)
    loss, aux = tt.loss(torch.from_numpy(codes).long(), tct)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in ("perplexity", "ce_q0", "ce_q1", "ce_q2"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_step(pair):
    """One JAX training step on audio (tokenized by the codec): the state
    before and after."""
    model, variables, _ = pair
    jt = JaxTrainer(model, lr=1e-4)
    state = jt.init_state(variables)
    audio = (0.3 * np.random.default_rng(4).standard_normal((2, 1, 16 * HOP))).astype(np.float32)
    jct, tct = _cond(2, 5, 5)
    batch = {"audio": jnp.asarray(audio), "cond_tensors": jct}
    new, aux = jax.jit(jt.make_train_step())(state, batch, jax.random.PRNGKey(0))
    return state, new, aux, audio, tct


def test_one_adamw_step_matches_jax(pair, jax_step):
    # one step of the port's trainer (AdamW, betas (0.9, 0.95), wd 0.1, lr
    # 1e-4) against the JAX trainer's: the loss (1e-5 relative), every LM
    # gradient (read back from JAX's first Adam moment, mu = 0.1 g; 1e-4 of
    # each tensor's peak) and every LM parameter after the update: Adam's
    # first step moves each weight by lr * g / (|g| + eps) and the decay, so
    # where |g| > 1e-6 the weights agree to 1e-7 and 2 f32 ulps, and where |g| comes near
    # eps = 1e-8 the f32 differences of g may move the step up to 2 lr)
    model, variables, port = pair
    state, new, aux, audio, tct = jax_step
    port = copy.deepcopy(port)
    trainer = create_training_wrapper_from_config(CONFIG, port)
    trainer.condition = lambda metadata: tct
    got = trainer.train_step(_t(audio), [{}] * 2)
    np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]), rtol=1e-5)
    adam = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    want_sd = audio_lm_state_dict(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                                         adam.mu), dim_heads=64)
    new_sd = audio_lm_state_dict(jax.tree_util.tree_map(np.asarray, new.params), dim_heads=64)
    params = dict(port.named_parameters())
    assert set(trainer.params) == {k for k in want_sd if k.startswith("lm.")}
    for name, p in trainer.params.items():
        g = want_sd[name]
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=name)
        got_p = params[name].detach().numpy()
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(got_p[big], new_sd[name][big], atol=1e-7, rtol=2.4e-7,
                                   err_msg=name)  # 1e-7 and 2 f32 ulps
        assert np.abs(got_p - new_sd[name]).max() <= 2e-4, name


def test_jax_step_decays_the_frozen_codec(pair, jax_step):
    # recorded JAX-package fault: its LM step hands every parameter to
    # AdamW, and the decoupled decay shrinks the frozen codec's weights by
    # lr * wd = 1e-5 a step although their gradient is zero. The port's step
    # leaves them alone.
    state, new, _, audio, tct = jax_step
    before = jax.tree_util.tree_leaves(state.params["pretransform"])
    after = jax.tree_util.tree_leaves(new.params["pretransform"])
    for b, a in zip(before, after):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b) * (1 - 1e-4 * 0.1), rtol=1e-6)
    assert any(np.abs(np.asarray(a) - np.asarray(b)).max() > 0 for b, a in zip(before, after))
    model, variables, port = pair
    port = copy.deepcopy(port)
    codec = {n: p.detach().clone() for n, p in port.pretransform.named_parameters()}
    trainer = create_training_wrapper_from_config(CONFIG, port)
    trainer.condition = lambda metadata: tct
    trainer.train_step(_t(audio), [{}] * 2)
    assert all(torch.equal(p, codec[n]) for n, p in port.pretransform.named_parameters())


def _jax_cached_logits(model, variables, seq, jct):
    """Teacher-forced KV-cached logits of the JAX LM: the pieces of
    `lm_generate_cached`'s decode step (summed embeddings, the backbone's
    cached step with the cross-attention K/V projected once, the heads)."""
    p = variables["params"]["lm"]
    cross = model.get_conditioning_inputs(jct)["cross_attn_cond"]
    kvs = model.apply(variables, cross, method=model.precompute_cross_kvs)
    B, _, S = seq.shape
    caches = [jax_init_kv_cache(B, 2, S, 64) for _ in range(2)]
    out = []
    for s in range(S):
        x = sum(p[f"embeds_{i}"]["embedding"][seq[:, i, s]] for i in range(K))[:, None]
        h, caches = model.apply(variables, jnp.asarray(x), caches=caches, cache_index=s,
                                cross_kvs=kvs, method=model.lm_forward_embed)
        out.append(np.stack([np.asarray(h[:, 0] @ p[f"quantizer_heads_{i}"]["kernel"]
                                        + p[f"quantizer_heads_{i}"]["bias"]) for i in range(K)], 1))
    return np.stack(out, 2)  # [B, K, S, card]


@torch.no_grad()
def _port_cached_logits(port, seq, tct):
    bb = port.lm.backbone
    cross = port.get_conditioning_inputs(tct)["cross_attn_cond"]
    kvs = bb.compute_cross_kv(cross)
    B, _, S = seq.shape
    caches = [init_kv_cache(B, 2, S, 64) for _ in range(2)]
    out = []
    for s in range(S):
        x = sum(e(torch.from_numpy(np.array(seq[:, i, s])).long())
                for i, e in enumerate(port.lm.embeds))
        h = bb(x[:, None], caches=caches, cache_index=s, cross_kvs=kvs)[:, 0]
        out.append(torch.stack([head(h) for head in port.lm.quantizer_heads], 1))
    return torch.stack(out, 2).numpy()


@pytest.mark.parametrize("n_ctx", [1, 40])
def test_cached_decode_logits_match_jax_per_step(pair, n_ctx):
    # the cached decode's logits at every step of a teacher-forced pattern
    # sequence, port against JAX (f32: 1e-4 of the peak)
    model, variables, port = pair
    seq = np.asarray(model.pattern_provider.get_pattern(16).build_pattern_sequence(
        jnp.asarray(_codes(2, 16, 6)), CARD)[0])
    jct, tct = _cond(2, n_ctx, 7)
    want = _jax_cached_logits(model, variables, seq, jct)
    got = _port_cached_logits(port, seq, tct)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_full_and_cached_paths_differ_by_the_causal_cross_attention(pair):
    # recorded JAX-package fault, copied on purpose: the full forward's
    # cross-attention is causal, aligned bottom-right, while the cached step
    # attends to the whole context. With a T5-length context (128 tokens) and
    # an 18-step pattern sequence, query row i of the full path sees the keys
    # up to i + 110 only, so the two paths' logits differ on both packages;
    # with a one-token context the last row alone sees the key and every
    # other row attends uniformly to it, which is the same thing: the paths
    # agree (which is why the JAX package's own cached-vs-full test, which
    # conditions on one token, passes).
    model, variables, port = pair
    seq = np.asarray(model.pattern_provider.get_pattern(16).build_pattern_sequence(
        jnp.asarray(_codes(2, 16, 8)), CARD)[0])
    for n_ctx, differ in ((128, True), (1, False)):
        jct, tct = _cond(2, n_ctx, 9)
        jax_full = np.asarray(model.apply(variables, jnp.asarray(seq), cond_tensors=jct))
        jax_cached = _jax_cached_logits(model, variables, seq, jct)
        with torch.no_grad():
            port_full = port(torch.from_numpy(seq).long(), cond_tensors=tct).numpy()
        port_cached = _port_cached_logits(port, seq, tct)
        peak = np.abs(jax_full).max()
        np.testing.assert_allclose(port_full, jax_full, atol=1e-4 * peak)
        np.testing.assert_allclose(port_cached, jax_cached, atol=1e-4 * peak)
        for full, cached in ((jax_full, jax_cached), (port_full, port_cached)):
            gap = np.abs(full - cached).max() / peak
            assert gap > 1e-2 if differ else gap < 1e-4, (n_ctx, gap)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("cfg_scale", [None, 3.0])
def test_greedy_generation_matches_jax(pair, cached, cfg_scale):
    # 16 frames (an 18-step pattern sequence), batch 2, top_k = 1: the codes
    # are decided by argmax alone and must be identical to the JAX
    # package's, by the full path and the KV-cached one, with and without CFG
    model, variables, port = pair
    jct, tct = _cond(2, 6, 10)
    kwargs = dict(max_gen_len=16, batch_size=2, top_k=1, cfg_scale=cfg_scale)
    jgen, tgen = (jax_lm_generate_cached, lm_generate_cached) if cached else (jax_lm_generate,
                                                                              lm_generate)
    want = np.asarray(jgen(model, variables, conditioning_tensors=jct,
                           rng=jax.random.PRNGKey(0), **kwargs))
    got = tgen(port, tct, generator=torch.Generator().manual_seed(0), **kwargs)
    assert got.shape == (2, K, 16) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generation_and_audio(pair):
    # top-k / top-p / plain sampling from a torch.Generator: reproducible,
    # codes in range; lm_generate_audio decodes to [B, 1, frames * hop]
    _, _, port = pair
    _, tct = _cond(1, 4, 11)
    for kwargs in ({"top_k": 8}, {"top_p": 0.9}, {"top_k": 0}):
        runs = [lm_generate_cached(port, tct, max_gen_len=12, cfg_scale=2.0,
                                   generator=torch.Generator().manual_seed(3), **kwargs)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1]) and 0 <= runs[0].min() <= runs[0].max() < CARD
    audio = lm_generate_audio(port, tct, max_gen_len=12, top_k=8,
                              generator=torch.Generator().manual_seed(3))
    assert audio.shape == (1, 1, 12 * HOP) and torch.isfinite(audio).all()
    with pytest.raises(NotImplementedError, match="int8"):
        lm_generate_cached(port, tct, max_gen_len=4, weight_quant="int8")


def test_x_transformers_config_is_validated_as_jax():
    # the reference's x-transformers backbone keys map onto the in-repo
    # backbone; an option with another value, or an unknown one, is refused
    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["lm"].update(type="x-transformers", config={
        "dim": 128, "depth": 1, "heads": 2, "cross_attn_cond_dim": CTX_DIM,
        "rotary_pos_emb": True, "attn_flash": True, "ff_dropout": 0.0})
    model = create_model_from_config(cfg, "cpu")
    assert model.lm.backbone.depth == 1 and model.lm.backbone.num_heads == 2
    for key, value in (("rotary_pos_emb", False), ("attn_talking_heads", True)):
        bad = copy.deepcopy(cfg)
        bad["model"]["lm"]["config"][key] = value
        with pytest.raises(NotImplementedError, match=key):
            create_model_from_config(bad, "cpu")


def test_train_entry_trains_checkpoints_and_resumes(tmp_path):
    # `python -m stable_audio_tools_tpu_torch.train`'s code path on the CPU
    # with an LM config (a small random T5 for the prompts): mono WAVs ->
    # audio_dir loader -> 2 steps with a checkpoint each, the LM's loss
    # terms logged, then a resume from the second checkpoint to step 3
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav

    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["conditioning"] = {"cond_dim": CTX_DIM, "configs": [
        {"id": "prompt", "type": "t5", "config": {
            "max_length": 6, "allow_random_init": True, "arch": [32, 64, 1, 2, 16, False]}}]}
    rng = np.random.default_rng(12)
    (tmp_path / "wavs").mkdir()
    for i in range(4):
        save_wav(str(tmp_path / "wavs" / f"{i}.wav"),
                 0.3 * rng.standard_normal((1, 200 + 30 * i)), cfg["sample_rate"])
    (tmp_path / "meta.py").write_text("def get_custom_metadata(info, audio):\n"
                                      "    return {'prompt': 'noise ' + info['relpath']}\n")
    (tmp_path / "model.json").write_text(json.dumps(cfg))
    (tmp_path / "data.json").write_text(json.dumps({"dataset_type": "audio_dir", "datasets": [
        {"id": "n", "path": str(tmp_path / "wavs"),
         "custom_metadata_module": str(tmp_path / "meta.py")}]}))
    argv = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--checkpoint-every", "1", "--save-dir", str(tmp_path / "run"), "--device", "cpu"]
    trainer = train.main(argv + ["--max-steps", "2"])
    assert trainer.wrapper.step == 2
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "model_config.json", "step=1.ckpt", "step=2.ckpt", "train_log.jsonl"]
    logs = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert {"train/loss", "train/perplexity", "train/ce_q0", "train/ce_q2",
            "train/lr"} <= set(logs[0])
    assert all(np.isfinite(v) for rec in logs for v in rec.values())
    state = torch.load(tmp_path / "run" / "step=2.ckpt", weights_only=True)
    weights = dict(trainer.wrapper.model.state_dict())
    assert all(torch.equal(v, weights[k]) for k, v in state["state_dict"].items())
    resumed = train.main(argv + ["--max-steps", "3", "--ckpt-path",
                                 str(tmp_path / "run" / "step=2.ckpt")])
    assert resumed.wrapper.step == 3
    assert [json.loads(s)["step"] for s in open(tmp_path / "run" / "train_log.jsonl")] == [1, 2, 3]


class _WeightCasts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the f32 -> bf16 copies whose source is one of `params`."""

    def __init__(self, params):
        super().__init__()
        self.ptrs = {p.data_ptr() for p in params}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten._to_copy.default and kwargs.get("dtype") == torch.bfloat16
                and args[0].dtype == torch.float32 and args[0].data_ptr() in self.ptrs):
            self.count += 1
        return func(*args, **kwargs)


def test_cached_decode_casts_its_weights_once_per_request(pair):
    # a bf16 decode casts the backbone's f32 linear weights before its step
    # loop (JAX `prepare`), not at every step: the count of f32 -> bf16
    # weight copies does not grow with the step count, and the model's f32
    # parameters are back, unchanged, when the request ends
    port = copy.deepcopy(pair[2])
    port.lm.backbone.compute_dtype = torch.bfloat16
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    _, tct = _cond(1, 4, 12)
    counts = []
    for steps in (3, 8):
        with _WeightCasts(port.parameters()) as casts:
            lm_generate_cached(port, tct, max_gen_len=steps, top_k=1, cfg_scale=3.0,
                               generator=torch.Generator().manual_seed(0))
        counts.append(casts.count)
    n_linear = sum(1 for m in port.lm.backbone.modules() if isinstance(m, torch.nn.Linear)
                   for p in (m.weight, m.bias) if p is not None)
    assert counts[0] == counts[1] and n_linear <= counts[0] < 2 * n_linear, (counts, n_linear)
    for n, p in port.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
