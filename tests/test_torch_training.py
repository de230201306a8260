"""The port's training path against the JAX package on the CPU: the flash
attention and LayerNorm backwards, T5 in bf16, block rematerialisation, the
timestep samplers, losses, schedules, optimizer and EMA, and whole training
steps of a tiny f32 SA-Open-shaped model with the same weights (carried over
by io/from_jax.py), batch, t, noise and VAE sampling noise.

Inputs are made from a seed with numpy; JAX runs on the CPU as its own tests
run it (Pallas kernels in interpret mode). Each tolerance is stated where it
is used.
"""

import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stable_audio_tools_tpu.inference import sampling as jsampling
from stable_audio_tools_tpu.ops.kernels import flash_attention as jfa
from stable_audio_tools_tpu.ops.kernels import layer_norm as jln
from stable_audio_tools_tpu.training import diffusion as jdiffusion
from stable_audio_tools_tpu.training import ema as jema
from stable_audio_tools_tpu.training import utils as jutils
from stable_audio_tools_tpu.training.losses import losses as jlosses
from stable_audio_tools_tpu_torch.inference import sampling as tsampling
from stable_audio_tools_tpu_torch.io.from_jax import diffusion_cond_state_dict
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa
from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as tln
from stable_audio_tools_tpu_torch.training import diffusion as tdiffusion
from stable_audio_tools_tpu_torch.training import ema as tema
from stable_audio_tools_tpu_torch.training import utils as tutils
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from stable_audio_tools_tpu_torch.training.losses import losses as tlosses
from test_torch_slice import CONFIG, META, _pair, stable_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs", "txt2audio",
                       "stable_audio_open_1_0.json")) as _f:
    SA_OPEN_TRAINING = json.load(_f)["training"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- kernels' backwards --------------------------------------------------------


@pytest.mark.parametrize("P,N", [(1, 131), (5, 105), (17, 273)])
def test_flash_attention_prefix_bwd_plain_matches_jax_grad(P, N):
    # jax.grad through the JAX flash_attention_prefix (its custom VJP runs the
    # Pallas backward in interpret mode) against the port's autograd.Function,
    # whose backward on the CPU is flash_attention_prefix_bwd_plain. Lengths
    # are no multiple of 64. f32 on both sides; the Pallas kernels sum over
    # 256-row blocks and the plain version in one product: 2e-5 relative.
    rng = np.random.default_rng(P)
    q, k, v, w = (rng.standard_normal((1, 2, N, 64)).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jnp.asarray(w) * jfa.flash_attention_prefix(q, k, v, P) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out, _ = tfa.flash_attention_prefix(tq, tk, tv, P)
    assert out.grad_fn is not None
    (_t(w) * out ** 2).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert _rel(got.numpy(), ref) < 2e-5, name
    # the plain backward called directly agrees with the Function's
    o, lse = tfa.flash_attention_prefix_plain(_t(q), _t(k), _t(v), P)
    direct = tfa.flash_attention_prefix_bwd_plain(_t(q), _t(k), _t(v), o, lse, 2 * _t(w) * o)
    for got, ref in zip(direct, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("with_beta", [False, True])
def test_layer_norm_bwd_matches_jax_grad(with_beta):
    # jax.grad through the JAX custom VJP the TPU runs (`_ln_backward`, the
    # forward a Pallas kernel in interpret mode) against the port's plain
    # backward; f32 rounding only: 1e-5 relative.
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 50, 256)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(256).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    if with_beta:
        f = lambda x, g, b: jnp.sum(jnp.asarray(dy) * jln._fused_ln_beta(x, g, b, 1e-5))
        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    else:
        f = lambda x, g: jnp.sum(jnp.asarray(dy) * jln._fused_ln_nobeta(x, g, 1e-5))
        want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    dx, dgamma, dbeta = tln.fused_layer_norm_bwd_plain(_t(x), _t(g), _t(dy), 1e-5)
    got = (dx, dgamma, dbeta)[:len(want)]
    for name, a, ref in zip(("dx", "dgamma", "dbeta"), got, want):
        assert _rel(a.numpy(), ref) < 1e-5, name
    # and torch autograd of the plain forward (what CPU tensors take) agrees
    tx, tg = _t(x).requires_grad_(), _t(g).requires_grad_()
    (tln.fused_layer_norm(tx, tg, _t(b) if with_beta else None) * _t(dy)).sum().backward()
    assert _rel(tx.grad.numpy(), dx.numpy()) < 1e-5
    assert _rel(tg.grad.numpy(), dgamma.numpy()) < 1e-5


# -- T5 in bf16 ------------------------------------------------------------------


def test_t5_conditioner_computes_in_bf16_as_jax():
    # The JAX package runs its T5 as FlaxT5EncoderModel(..., dtype=bf16)
    # (models/conditioners.py:427, :486). The port's T5 conditioner, on the
    # same weights and token ids, must land on that bf16 output: its
    # distance to the JAX bf16 output is at most 1% of the distance between
    # the JAX f32 and bf16 outputs (an f32 tower sits at ~100%; the port
    # rounds where Flax does, so only the order of f32 sums differs).
    from transformers import FlaxT5EncoderModel, T5Config

    from stable_audio_tools_tpu_torch.io.from_jax import t5_state_dict
    from stable_audio_tools_tpu_torch.models.conditioners import T5Conditioner

    arch = dict(d_model=128, d_ff=256, num_layers=3, num_heads=2, d_kv=64)
    cfg = T5Config(vocab_size=32128, feed_forward_proj="relu", **arch)
    flax_bf16 = FlaxT5EncoderModel(cfg, dtype=jnp.bfloat16, _do_init=False)
    flax_f32 = FlaxT5EncoderModel(cfg, _do_init=False)
    params = jax.jit(lambda r: flax_f32.init_weights(r, (1, 1)))(jax.random.PRNGKey(2))
    cond = T5Conditioner(128, max_length=12, allow_random_init=True,
                         arch=[arch[k] for k in ("d_model", "d_ff", "num_layers",
                                                 "num_heads", "d_kv")] + [False])
    cond.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in t5_state_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()})
    # CRC-32 word ids: with Python's salted `hash` the ids differ from process
    # to process, and about one draw in six flips a bf16 rounding tie in the
    # tower, which alone costs 2-11% of the gap
    cond.tokenizer = stable_tokenizer(12)
    texts = ["warm analog pads with tape hiss", "drums"]
    ids, mask = cond.tokenizer(texts)
    got, _ = cond(texts, "cpu")
    m = mask[..., None]
    outs = {name: np.asarray(f(input_ids=ids, attention_mask=mask, params=params)
                             .last_hidden_state, np.float32) * m
            for name, f in (("bf16", flax_bf16), ("f32", flax_f32))}
    jax_gap = np.linalg.norm(outs["bf16"] - outs["f32"])
    assert jax_gap > 0
    assert np.linalg.norm(got.numpy() - outs["bf16"]) <= jax_gap / 100
    assert cond.model.compute_dtype == torch.bfloat16
    assert all(not p.requires_grad for p in cond.model.parameters())


# -- block rematerialisation ------------------------------------------------------


def test_use_checkpointing_remats_blocks_with_the_same_gradients(monkeypatch):
    # With use_checkpointing, each block's forward runs again in the
    # backward (twice per step, as nn.remat) and the gradients are those of
    # the plain run: the same f32 ops in the same order, so equal to 1e-6.
    from stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
    from stable_audio_tools_tpu_torch.models.factory import init_random_
    from stable_audio_tools_tpu_torch.ops.transformer import TransformerBlock

    n_calls = [0]
    block_forward = TransformerBlock.forward

    def counted(self, *args, **kwargs):
        n_calls[0] += 1
        return block_forward(self, *args, **kwargs)

    monkeypatch.setattr(TransformerBlock, "forward", counted)

    kw = dict(io_channels=8, embed_dim=128, depth=2, num_heads=2, cond_token_dim=32,
              global_cond_dim=16)
    plain = init_random_(DiffusionTransformer(use_checkpointing=False, **kw),
                         torch.Generator().manual_seed(0))
    remat = DiffusionTransformer(use_checkpointing=True, **kw)
    remat.load_state_dict(plain.state_dict())
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn(2, 8, 40, generator=g), torch.rand(2, generator=g)
    ctx, glob = torch.randn(2, 5, 32, generator=g), torch.randn(2, 16, generator=g)
    grads, calls = [], []
    for model in (plain, remat):
        model.train()
        n_calls[0] = 0
        (model(x, t, cross_attn_cond=ctx, global_embed=glob) ** 2).mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        calls.append(n_calls[0])
    assert calls == [2, 4]  # 2 blocks: once each, or again in the backward
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                   atol=1e-6 * float(grads[0][k].abs().max()) + 1e-12)


# -- timesteps, schedule, losses, optimizer, EMA ------------------------------------


@pytest.mark.parametrize("step,batch", [(0, 4), (1, 1), (7, 7), (123457, 4), (2 ** 31 - 3, 3)])
def test_sobol_timesteps_exact(step, batch):
    want = np.asarray(jdiffusion._sobol_timesteps(step, batch))
    got = tdiffusion._sobol_timesteps(step, batch).numpy()
    np.testing.assert_array_equal(got, want)


def test_timestep_transforms_match_jax():
    # the same base normal draws through both transforms; f32 math on both
    # sides (the JAX truncation bounds are f32, the port's f64): 1e-5
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, (64,)))
    np.testing.assert_allclose(
        tsampling.sample_timesteps_logsnr(64, -1.2, 2.0, normal=_t(z)).numpy(),
        np.asarray(jsampling.sample_timesteps_logsnr(key, 64)), atol=1e-6)
    np.testing.assert_allclose(
        tsampling.truncated_logistic_normal_rescaled((64,), normal=_t(z)).numpy(),
        np.asarray(jsampling.truncated_logistic_normal_rescaled(key, (64,))), atol=1e-5)
    t = np.linspace(0.0, 0.99, 50).astype(np.float32)
    for opts in ({}, {"use_sine": True}):
        np.testing.assert_allclose(
            tsampling.DistributionShift(**opts).time_shift(_t(t), 1000).numpy(),
            np.asarray(jsampling.DistributionShift(**opts).time_shift(jnp.asarray(t), 1000)),
            atol=1e-6)
    a, s = tsampling.get_alphas_sigmas(_t(t))
    ja, js = jsampling.get_alphas_sigmas(jnp.asarray(t))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("sampler", ["uniform", "logit_normal", "trunc_logit_normal",
                                     "log_snr", "sobol"])
def test_timestep_samplers_moments_match_jax(sampler):
    # different generators, same distribution: 20000 draws each, means and
    # standard deviations within 0.01 (their standard errors are < 0.003)
    n = 20000
    want = np.asarray(jdiffusion._sample_timesteps(jax.random.PRNGKey(0), n, sampler, {}))
    got = tdiffusion.sample_timesteps(n, sampler, {},
                                      generator=torch.Generator().manual_seed(0)).numpy()
    assert got.shape == (n,) and 0 <= got.min() and got.max() <= 1
    assert abs(got.mean() - want.mean()) < 0.01
    assert abs(got.std() - want.std()) < 0.01


@pytest.mark.parametrize("masked", [False, True])
def test_mse_multiloss_matches_jax(masked):
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((3, 4, 20)).astype(np.float32) for _ in range(2))
    mask = (rng.random((3, 20)) > 0.3).astype(np.float32) if masked else None
    info_j = {"x": jnp.asarray(a), "y": jnp.asarray(b),
              "m": None if mask is None else jnp.asarray(mask)}
    info_t = {"x": _t(a), "y": _t(b), "m": None if mask is None else _t(mask)}
    jl = jlosses.MultiLoss([jlosses.MSELoss("x", "y", "mse", weight=0.5, mask_key="m")])
    tl = tlosses.MultiLoss([tlosses.MSELoss("x", "y", "mse", weight=0.5, mask_key="m")])
    (jt, jv), (tt, tv) = jl(info_j), tl(info_t)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    np.testing.assert_allclose(float(tv["mse"]), float(jv["mse"]), rtol=1e-6)


def test_inverse_lr_schedule_and_scheduler_match_optax():
    # SA-Open's InverseLR (warmup 0.99): the port's LambdaLR gives the
    # optimizer, update by update, the learning rate optax's schedule gives
    entry = SA_OPEN_TRAINING["optimizer_configs"]["diffusion"]
    cfg = entry["scheduler"]["config"]
    base = entry["optimizer"]["config"]["lr"]
    jsched = jutils.inverse_lr_schedule(base, **cfg)
    opt, sched = tutils.build_optimizer(entry, [torch.nn.Parameter(torch.zeros(3))])
    for step in range(6):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(step)), rtol=1e-6)
        opt.step()
        sched.step()
    for step in (0, 10, 1000, 10 ** 6):
        np.testing.assert_allclose(tutils.inverse_lr_schedule(base, **cfg)(step),
                                   float(jsched(step)), rtol=1e-6)


@pytest.mark.parametrize("opt_type", ["Adam", "AdamW", "SGD"])
def test_optimizer_steps_match_optax(opt_type):
    # three steps on the same gradients (bounded away from 0, so Adam's
    # normalisation is well conditioned); f32: 1e-6 relative to the change
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(50).astype(np.float32)
    grads = [(rng.standard_normal(50) + np.sign(rng.standard_normal(50))).astype(np.float32)
             for _ in range(3)]
    cfg = ({"lr": 1e-2, "momentum": 0.9} if opt_type == "SGD" else
           {"lr": 1e-2, "betas": [0.9, 0.99], "weight_decay": 0.1})
    entry = {"optimizer": {"type": opt_type, "config": cfg},
             "scheduler": {"type": "InverseLR", "config": {"inv_gamma": 10, "power": 0.5,
                                                           "warmup": 0.5}}}
    jopt = jutils.build_optimizer(entry)
    jp, state = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    tp_ = torch.nn.Parameter(_t(p0))
    topt, tsched = tutils.build_optimizer(entry, [tp_])
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp_.grad = _t(g)
        topt.step()
        tsched.step()
    # the changes are differences of f32 parameters: 2 ulps of the parameter
    np.testing.assert_allclose(tp_.detach().numpy() - p0, np.asarray(jp) - p0,
                               rtol=1e-5, atol=2 * np.spacing(np.abs(p0)).max())


@pytest.mark.parametrize("scheduler", [
    {"type": "ExponentialLR", "config": {"gamma": 0.9}},
    {"type": "CosineAnnealingLR", "config": {"T_max": 7, "eta_min": 1e-4}}])
def test_other_schedules_match_jax(scheduler):
    jsched = jutils.create_schedule_from_config(scheduler, 1e-2)
    tsched = tutils.create_schedule_from_config(scheduler, 1e-2)
    for step in range(10):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)


def test_ema_decay_and_update_match_jax():
    rng = np.random.default_rng(6)
    ema0, new = rng.standard_normal(20).astype(np.float32), rng.standard_normal(20).astype(np.float32)
    for step in (0, 1, 2, 3, 10, 1000, 10 ** 6):
        np.testing.assert_allclose(tema.ema_decay(step), float(jema.ema_decay(step)), atol=1e-7)
        want = np.asarray(jema.ema_update({"p": jnp.asarray(ema0)}, {"p": jnp.asarray(new)},
                                          step)["p"])
        ema = {"p": _t(ema0)}
        tema.ema_update(ema, {"p": _t(new)}, step)
        np.testing.assert_allclose(ema["p"].numpy(), want, atol=1e-6)


# -- whole training steps ---------------------------------------------------------------

B = 2


def _train_config():
    config = copy.deepcopy(CONFIG)
    config["model"]["diffusion"]["config"]["use_checkpointing"] = True
    config["training"] = copy.deepcopy(SA_OPEN_TRAINING)
    return config


def _batch(seed):
    rng = np.random.default_rng(seed)
    audio = (0.5 * rng.standard_normal((B, 2, CONFIG["sample_size"]))).astype(np.float32)
    meta = [dict(META[0], seconds_start=3 + 5 * i) for i in range(B)]
    t = rng.random(B).astype(np.float32)
    return audio, meta, t, rng


def _jax_latents(model, variables, audio, key):
    """The JAX encoder's latents for `audio` and the standard normal noise
    its VAE bottleneck drew (recovered from its output), both [B, C, T]."""
    z, info = model.apply(variables, jnp.asarray(audio), return_info=True, rngs={"sample": key},
                          method=lambda m, a, **kw: m.pretransform.model.encode(a, **kw))
    mean, scale = np.split(np.asarray(info["pre_bottleneck_latents"]), 2, axis=1)
    stdev = np.log1p(np.exp(scale)) + 1e-4
    return np.asarray(z), ((np.asarray(z) - mean) / stdev).astype(np.float32)


@pytest.fixture(scope="module")
def train_pair():
    return _pair(_train_config())


def test_training_steps_match_jax(train_pair):
    # Two AdamW + InverseLR steps (SA-Open's training section) of the tiny
    # f32 model, CFG dropout off, against the JAX package's pieces composed
    # here: pretransform encode, model.apply, jax.value_and_grad,
    # build_optimizer, ema_update. Bounds (f32, sums reassociated through 2
    # blocks and the encoder): latents 1e-4, loss 1e-5, each gradient 1e-4
    # of its largest entry, Adam moments 1e-4; the parameter change where
    # Adam's normalisation is well conditioned (|g| > 1e-2 max|g| at every
    # step so far) to 1e-2 of the learning rate, elsewhere within the learning rate, each plus 2 ulps
    # of the f32 parameter; the EMA (a copy of the parameters for the first
    # steps) likewise.
    from stable_audio_tools_tpu.training.utils import build_optimizer

    model, variables, port = train_pair
    config = _train_config()
    params = variables["params"]
    mc = model._multi_conditioner
    wrapper = create_training_wrapper_from_config(config, port)
    names = list(wrapper.params)
    assert all(n.startswith(("model.model.", "conditioner.conditioners.seconds_"))
               for n in names)
    assert not any(p.requires_grad for p in port.pretransform.parameters())
    p_before = {n: p.detach().clone() for n, p in wrapper.params.items()}

    entry = config["training"]["optimizer_configs"]["diffusion"]
    jopt = build_optimizer(entry)
    jstate, jema_params = jopt.init(params), params
    lr = [entry["optimizer"]["config"]["lr"] * (1 - 0.99 ** (s + 1)) for s in range(2)]

    def jloss(params, latents, t, noise, prepared):
        a, s = jnp.cos(t * math.pi / 2)[:, None, None], jnp.sin(t * math.pi / 2)[:, None, None]
        out = model.apply({"params": params}, latents * a + noise * s, t, cond=prepared,
                          cfg_dropout_prob=0.0, train=True)
        return jnp.mean(jnp.square(out - (noise * a - latents * s)))

    well_conditioned = {}
    for step in range(2):
        audio, meta, t, rng = _batch(step)
        z, vae_noise = _jax_latents(model, {"params": params}, audio, jax.random.PRNGKey(step))
        noise = rng.standard_normal(z.shape).astype(np.float32)
        with torch.no_grad():
            zp = port.pretransform_encode(_t(audio), noise=_t(vae_noise))
        assert _rel(zp.numpy(), z) < 1e-4
        prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(meta))
        loss, grads = jax.value_and_grad(jloss)(params, jnp.asarray(z), jnp.asarray(t),
                                                jnp.asarray(noise), prepared)
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        jema_params = jema.ema_update(jema_params, params, step)

        aux = wrapper.train_step(_t(audio), meta, t=_t(t), noise=_t(noise),
                                 encode_noise=_t(vae_noise),
                                 cfg_dropout_mask=torch.zeros(B, dtype=torch.bool))
        np.testing.assert_allclose(float(aux["loss"]), float(loss), rtol=1e-5)
        want_g = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, grads), 64)
        want_p = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, params), 64)
        want_e = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, jema_params), 64)
        mu = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, jstate[0].mu), 64)
        nu = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, jstate[0].nu), 64)
        for n in names:
            p = wrapper.params[n]
            assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, n
            assert _rel(p.grad.numpy(), want_g[n]) < 1e-4, n
            st = wrapper.optimizer.state[p]
            assert _rel(st["exp_avg"].numpy(), mu[n]) < 1e-4, n
            assert _rel(st["exp_avg_sq"].numpy(), nu[n]) < 1e-4, n
            ulps = 2 * np.spacing(np.abs(p_before[n].numpy()) + 2 * sum(lr))
            ok = well_conditioned.setdefault(n, np.ones(p.shape, bool))
            ok &= np.abs(want_g[n]) > 1e-2 * np.abs(want_g[n]).max()
            for got, want in ((p.detach(), want_p[n]), (wrapper.ema[n], want_e[n])):
                err = np.abs((got - p_before[n]).numpy() - (want - p_before[n].numpy()))
                assert (err[ok] <= 1e-2 * lr[step] + ulps[ok]).all(), n
                assert (err <= 2.0 * sum(lr) + ulps).all(), n


def test_jax_step_decays_the_frozen_pretransform(train_pair):
    # The JAX package's DiffusionCondTrainer hands its whole parameter tree,
    # the pretransform included, to optax.adamw: the pretransform's gradient
    # is zero (stop_gradient) but the decoupled weight decay still scales it
    # by (1 - lr * wd) every step. The port's pretransform is frozen and its
    # optimizer never sees it.
    # At SA-Open's settings (lr <= 5e-5, wd 1e-3) a step shrinks a weight by
    # at most 5e-8 of itself, about f32's resolution; this test takes lr 1e-3
    # and wd 0.1 so that one step shows it.
    model, variables, port = train_pair
    config = _train_config()
    config["training"]["optimizer_configs"] = {"diffusion": {"optimizer": {
        "type": "AdamW", "config": {"lr": 1e-3, "weight_decay": 0.1}}}}
    trainer = jdiffusion.DiffusionCondTrainer(
        model, optimizer_configs=config["training"]["optimizer_configs"], cfg_dropout_prob=0.0)
    state = trainer.init_state(variables)
    audio, meta, _, _ = _batch(5)
    batch = {"audio": jnp.asarray(audio), "prepared_cond": jax.tree_util.tree_map(
        jnp.asarray, model._multi_conditioner.gather_inputs(meta))}
    new_state, _ = jax.jit(trainer.make_train_step())(state, batch, jax.random.PRNGKey(0))
    shrink = 1 - 1e-3 * 0.1
    before = jax.tree_util.tree_leaves(state.params["pretransform"])
    after = jax.tree_util.tree_leaves(new_state.params["pretransform"])
    changed = [not np.array_equal(a, b) for a, b in zip(after, before)]
    assert all(changed)
    for a, b in zip(after, before):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b) * shrink, rtol=1e-6, atol=1e-12)

    wrapper = create_training_wrapper_from_config(config, copy.deepcopy(port))
    frozen = {k: v.clone() for k, v in wrapper.model.pretransform.state_dict().items()}
    wrapper.train_step(_t(audio), meta)
    for k, v in wrapper.model.pretransform.state_dict().items():
        assert torch.equal(v, frozen[k]), k


def test_save_then_resume_gives_the_same_next_step(train_pair, tmp_path):
    # a resumed trainer draws the same t, noise and dropout as the
    # uninterrupted one (its generators are seeded from the step) and holds
    # the same weights, moments and EMA: the next step's loss is identical
    from stable_audio_tools_tpu_torch.io.checkpoints import save_training_state
    from stable_audio_tools_tpu_torch.training.trainer import Trainer

    _, _, port = train_pair
    config = _train_config()
    audio, meta, _, _ = _batch(9)
    first = create_training_wrapper_from_config(config, copy.deepcopy(port))
    first.train_step(_t(audio), meta)
    path = str(tmp_path / "step=1.ckpt")
    save_training_state(path, first, config)
    want = float(first.train_step(_t(audio), meta)["loss"])

    resumed = create_training_wrapper_from_config(config, copy.deepcopy(port))
    Trainer(resumed, config, save_dir=str(tmp_path / "run")).restore(path)
    assert resumed.step == 1
    assert float(resumed.train_step(_t(audio), meta)["loss"]) == want
    for n, p in first.params.items():
        assert torch.equal(resumed.params[n], p), n


def test_trainer_fit_logs_checkpoints_and_accumulates(train_pair, tmp_path):
    # the loop over a dataloader: log lines, checkpoints every 2 steps and at
    # the end, 2 microbatches per step; the step's gradient is the average of
    # the microbatches' (the same loss on the whole batch when t and noise
    # are the same: 1e-5)
    from stable_audio_tools_tpu_torch.training.trainer import Trainer

    _, _, port = train_pair
    config = _train_config()
    audio, meta, t, rng = _batch(11)
    noise = _t(rng.standard_normal((B, 4, 64)))
    whole = create_training_wrapper_from_config(config, copy.deepcopy(port))
    split = create_training_wrapper_from_config(config, copy.deepcopy(port))
    kw = dict(t=_t(t), noise=noise, encode_noise=torch.zeros(B, 4, 64),
              cfg_dropout_mask=torch.zeros(B, dtype=torch.bool))
    whole.train_step(_t(audio), meta, **kw)
    split.train_step(_t(audio), meta, accum_steps=2, **kw)
    for n, p in whole.params.items():
        assert _rel(split.params[n].grad.numpy(), p.grad.numpy()) < 1e-5, n

    trainer = Trainer(create_training_wrapper_from_config(config, copy.deepcopy(port)), config,
                      save_dir=str(tmp_path), checkpoint_every=2, max_steps=3)
    trainer.fit([(_t(audio), meta)])
    vals = trainer.wrapper.val_step(_t(audio), meta)  # fixed timesteps 0.1 .. 0.9
    assert sorted(vals) == [f"val/loss_{v:.1f}" for v in (0.1, 0.3, 0.5, 0.7, 0.9)]
    assert all(torch.isfinite(v) for v in vals.values())
    lines = [json.loads(s) for s in open(tmp_path / "train_log.jsonl")]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) for r in lines)
    assert sorted(os.listdir(tmp_path)) == ["model_config.json", "step=2.ckpt", "step=3.ckpt",
                                            "train_log.jsonl"]


def test_train_entry_runs_resumes_and_refuses_unported_flags(tmp_path):
    # `python -m stable_audio_tools_tpu_torch.train`'s code path on the CPU:
    # WAVs -> audio_dir loader -> 2 steps with a checkpoint each step, then a
    # resume from the second checkpoint to step 3; the JAX flags of several
    # cards, and unknown --precision values, are refused
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav

    rng = np.random.default_rng(12)
    (tmp_path / "wavs").mkdir()
    for i in range(4):
        save_wav(str(tmp_path / "wavs" / f"{i}.wav"),
                 0.3 * rng.standard_normal((2, 1500 + 300 * i)), CONFIG["sample_rate"])
    (tmp_path / "meta.py").write_text(
        "def get_custom_metadata(info, audio):\n    return {'prompt': 'noise ' + info['relpath']}\n")
    (tmp_path / "model.json").write_text(json.dumps(_train_config()))
    (tmp_path / "data.json").write_text(json.dumps({"dataset_type": "audio_dir", "datasets": [
        {"id": "n", "path": str(tmp_path / "wavs"),
         "custom_metadata_module": str(tmp_path / "meta.py")}]}))
    argv = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--checkpoint-every", "1", "--save-dir", str(tmp_path / "run"),
            "--device", "cpu"]
    trainer = train.main(argv + ["--max-steps", "2"])
    assert trainer.wrapper.step == 2
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "model_config.json", "step=1.ckpt", "step=2.ckpt", "train_log.jsonl"]
    resumed = train.main(argv + ["--max-steps", "3", "--ckpt-path",
                                 str(tmp_path / "run" / "step=2.ckpt")])
    assert resumed.wrapper.step == 3
    steps = [json.loads(s)["step"] for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert steps == [1, 2, 3]
    args = train.parse_args(argv)
    assert (args.batch_size, args.seed, args.precision) == (2, 42, "16-mixed")  # defaults.ini
    for bad in (["--num-gpus", "2"], ["--strategy", "ddp"], ["--multihost"],
                ["--precision", "fp8"]):
        with pytest.raises(SystemExit):
            train.parse_args(argv + bad)


@pytest.mark.parametrize("key", ["arc", "p_one_shot", "log_loss_info", "inpainting_config"])
def test_factory_refuses_training_options_not_ported(train_pair, key):
    # every JAX trainer option of this list is ported now: the factory takes
    # each (`arc` builds the ARC trainer; tests/test_torch_rf_training.py and
    # test_torch_arc.py hold them against JAX); SA-Open's explicit
    # "log_loss_info": false stays off
    from stable_audio_tools_tpu_torch.training.arc import ARCTrainer

    config = _train_config()
    assert create_training_wrapper_from_config(config, train_pair[2]).log_loss_info is False
    config["training"][key] = {"mask_kwargs": {}} if key == "inpainting_config" else True
    if key == "arc":  # ARC's default optimizers: SA-Open's names no discriminator's
        config["training"][key] = {}
        del config["training"]["optimizer_configs"]
    wrapper = create_training_wrapper_from_config(config, train_pair[2])
    if key == "arc":
        assert isinstance(wrapper, ARCTrainer)
    else:
        assert getattr(wrapper, key) == config["training"][key]
