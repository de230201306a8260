"""Rectified-flow training in the port against the JAX package on the CPU:
the flow objective's step with the timestep shift, `p_one_shot`,
`log_loss_info` and (for a `diffusion_cond_inpaint` model) the inpainting
masks, held to JAX `DiffusionCondTrainer._loss_and_info` over two AdamW +
InverseLR steps with the JAX draws (t, one-shot uniforms, noise, the
inpainting mask's integers) replayed into the port; `val_step` under a flow
objective; the training factory's keys; the inpainting demo's files and
the bit-identity of a run with it and one without.

The model is test_torch_rf.py's tiny rf DiT (no pretransform: the batch is
its latents). Each tolerance is stated where it is used.
"""

import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stable_audio_tools_tpu.training import ema as jema
from stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_training_wrapper)
from stable_audio_tools_tpu_torch.io.from_jax import diffusion_cond_state_dict
from stable_audio_tools_tpu_torch.training import demos as tdemos
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from test_torch_rf import META, T, _t, make_pair, rf_config
from test_torch_sa2 import _jax_inpaint_draws

B = 4
REAL_LENGTHS = (32, 20, 27, 12)
TRAINING = {
    "cfg_dropout_prob": 0.0, "timestep_sampler": "uniform", "p_one_shot": 0.25,
    "log_loss_info": True,
    "optimizer_configs": {"diffusion": {
        "optimizer": {"type": "AdamW", "config": {"lr": 5e-4, "betas": [0.9, 0.999],
                                                  "weight_decay": 1e-3}},
        "scheduler": {"type": "InverseLR", "config": {"inv_gamma": 1e6, "power": 0.5,
                                                      "warmup": 0.99}}}},
}


def train_config(objective="rectified_flow", inpaint=False, mask_padding=False):
    config = rf_config(objective, inpaint=inpaint)
    config["training"] = dict(copy.deepcopy(TRAINING), mask_padding=mask_padding)
    return config


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(seed):
    """Latents [B, 2, T], metadata with the number prompt and a padding mask
    of each item's real length."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, 2, T)).astype(np.float32)
    pm = (np.arange(T)[None, :] < np.asarray(REAL_LENGTHS)[:, None]).astype(np.float32)
    meta = [{"prompt_num": float(rng.uniform()), "padding_mask": pm[i]} for i in range(B)]
    return z, meta, pm


def _jax_draws(rng, shape, inpaint):
    """What JAX `_loss_and_info` draws from `rng` (fold_in 2, 3, 4, 5)."""
    fold = lambda i: jax.random.fold_in(rng, i)
    out = {"t": _t(jax.random.uniform(fold(2), (B,))),
           "one_shot": _t(jax.random.uniform(fold(3), (B,))),
           "noise": _t(jax.random.normal(fold(4), shape))}
    if inpaint:
        out["inpaint_draws"] = _jax_inpaint_draws(fold(5), B, 10, [0.1, 0.8, 0.1])
    return out


@pytest.mark.parametrize("objective,inpaint,mask_padding", [
    ("rectified_flow", False, True), ("rf_denoiser", True, False),
    ("rectified_flow", True, True)])
def test_rf_training_steps_match_jax(objective, inpaint, mask_padding):
    # Two steps of the flow objective with the shift (the model's
    # distribution_shift_options), one-shot t (p 0.25: two items at the
    # second step), the per-sigma buckets
    # and, for the inpainting model, masks within the padding masks. Bounds
    # (f32, sums reassociated through 2 blocks): the loss 1e-5, each bucket
    # 1e-5 of its value (1e-7 absolute where a bucket is empty), each
    # gradient 1e-4 of its largest entry; the parameter change where Adam's
    # normalisation is well conditioned (|g| > 1e-2 max|g| at every step so
    # far) to 1e-2 of the learning rate, elsewhere within it, each plus 2
    # ulps of the f32 parameter; the EMA likewise.
    config = train_config(objective, inpaint, mask_padding)
    model, variables, port = make_pair(config)
    jtrainer = jax_training_wrapper(config, model)
    assert jtrainer.inpainting_config == ({} if inpaint else None)
    wrapper = create_training_wrapper_from_config(config, port)
    assert (wrapper.inpainting_config, wrapper.p_one_shot, wrapper.log_loss_info) == (
        {} if inpaint else None, 0.25, True)
    assert wrapper.dist_shift is not None
    params = variables["params"]
    jstate, jema_params = jtrainer.optimizer.init(params), params
    lr = [5e-4 * (1 - 0.99 ** (s + 1)) for s in range(2)]
    names = list(wrapper.params)
    p_before = {n: p.detach().clone() for n, p in wrapper.params.items()}
    mc = model._multi_conditioner
    well_conditioned = {}
    for step in range(2):
        z, meta, pm = _batch(step)
        rng = jax.random.PRNGKey(10 + step)
        batch = {"audio": jnp.asarray(z), "padding_mask": jnp.asarray(pm),
                 "prepared_cond": jax.tree_util.tree_map(
                     jnp.asarray, mc.gather_inputs([{"prompt_num": m["prompt_num"]}
                                                    for m in meta]))}
        (loss, aux), grads = jax.value_and_grad(jtrainer._loss_and_info, has_aux=True)(
            params, batch, rng, True, step)
        updates, jstate = jtrainer.optimizer.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        jema_params = jema.ema_update(jema_params, params, step)

        got = wrapper.train_step(_t(z), meta, **_jax_draws(rng, z.shape, inpaint),
                                 cfg_dropout_mask=torch.zeros(B, dtype=torch.bool))
        buckets = sorted(k for k in aux if k.startswith("loss_all_"))
        assert len(buckets) == 10 and sorted(k for k in got if k.startswith("loss_all_")) == buckets
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
        for k in buckets + ["std_data", "mse_loss"]:
            np.testing.assert_allclose(float(got[k]), float(aux[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        assert sum(float(aux[k]) > 0 for k in buckets) >= 2  # the draws fill several

        want_g = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, grads), 8)
        want_p = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, params), 8)
        want_e = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, jema_params), 8)
        for n in names:
            p = wrapper.params[n]
            # (a single cross-attention token makes the query's norm gamma's
            # gradient exactly zero, in both packages)
            assert torch.isfinite(p.grad).all(), n
            assert _rel(p.grad.numpy(), want_g[n]) < 1e-4, n
            ulps = 2 * np.spacing(np.abs(p_before[n].numpy()) + 2 * sum(lr))
            ok = well_conditioned.setdefault(n, np.ones(p.shape, bool))
            ok &= np.abs(want_g[n]) > 1e-2 * np.abs(want_g[n]).max()
            for g, want in ((p.detach(), want_p[n]), (wrapper.ema[n], want_e[n])):
                err = np.abs((g - p_before[n]).numpy() - (want - p_before[n].numpy()))
                assert (err[ok] <= 1e-2 * lr[step] + ulps[ok]).all(), n
                assert (err <= 2.0 * sum(lr) + ulps).all(), n


def test_rf_val_step_matches_jax():
    # fixed-timestep validation under the flow objective (no shift, no
    # one-shot draw, noise from fold_in(rng, 1000 vt)): 1e-5 of each loss
    config = train_config()
    model, variables, port = make_pair(config)
    jtrainer = jax_training_wrapper(config, model)
    wrapper = create_training_wrapper_from_config(config, port)
    z, meta, _ = _batch(3)
    rng = jax.random.PRNGKey(4)
    mc = model._multi_conditioner
    batch = {"audio": jnp.asarray(z), "prepared_cond": jax.tree_util.tree_map(
        jnp.asarray, mc.gather_inputs([{"prompt_num": m["prompt_num"]} for m in meta]))}
    want = jtrainer.make_val_step()(types.SimpleNamespace(params=variables["params"]), batch, rng)
    noises = [_t(jax.random.normal(jax.random.fold_in(rng, int(vt * 1000)), z.shape))
              for vt in wrapper.validation_timesteps]
    got = wrapper.val_step(_t(z), meta, noises=noises)
    assert sorted(got) == sorted(want) and len(got) == 5
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_factory_takes_the_flow_keys():
    # the JAX factory's defaults: inpainting_config {} for an inpainting
    # model, None otherwise; p_one_shot 0; log_loss_info off
    for inpaint in (False, True):
        config = rf_config(inpaint=inpaint)
        config["training"] = {"learning_rate": 1e-4}
        port = make_pair(config)[2]
        w = create_training_wrapper_from_config(config, port)
        assert (w.inpainting_config, w.p_one_shot, w.log_loss_info) == (
            {} if inpaint else None, 0.0, False)
        assert w.diffusion_objective == "rectified_flow"
    config = rf_config(shift={})  # an empty dict: no shift, as in JAX
    config["training"] = {"learning_rate": 1e-4}
    assert create_training_wrapper_from_config(config, make_pair(config)[2]).dist_shift is None


# -- the inpainting demo ------------------------------------------------------------


def test_inpaint_demo_writes_its_files(tmp_path):
    # reals, the masked input and one render per cfg scale, each a wav per
    # item; the render is the port's inpainting generation with the EMA
    # weights and seed = step; the training weights come back bit for bit
    config = train_config(inpaint=True)
    config["training"]["demo"] = {"demo_steps": 3, "demo_cfg_scales": [1.0, 4.0],
                                  "num_demos": 2, "demo_mask_args": {
                                      "maskstart": 8, "maskend": 20}}
    port = make_pair(config)[2]
    wrapper = create_training_wrapper_from_config(config, port)
    for e in wrapper.ema.values():
        e.mul_(0.9).add_(0.01)
    z, meta, _ = _batch(5)
    demo_dl = [(torch.from_numpy(z), meta)]
    callback = tdemos.create_demo_callback_from_config(config, str(tmp_path), demo_dl=demo_dl)
    assert isinstance(callback, tdemos.DiffusionCondInpaintDemoCallback)
    weights = {n: p.detach().clone() for n, p in port.named_parameters()}
    callback(wrapper, 7)
    assert all(torch.equal(p, weights[n]) for n, p in port.named_parameters())
    assert sorted(callback.outputs) == ["inpaint_cfg1.0", "inpaint_cfg4.0", "inpaint_masked_input",
                                        "inpaint_reals"]
    np.testing.assert_array_equal(callback.outputs["inpaint_reals"], z[:2])
    masked = callback.outputs["inpaint_masked_input"]
    assert (masked[..., 8:20] == 0).all() and np.array_equal(masked[..., :8], z[:2, :, :8])
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond_inpaint
    from stable_audio_tools_tpu_torch.training.ema import ema_weights

    with ema_weights(wrapper.params, wrapper.ema):
        port.eval()
        want = generate_diffusion_cond_inpaint(
            port, steps=3, cfg_scale=4.0, conditioning=meta[:2], batch_size=2, sample_size=T,
            seed=7, init_audio=(16000, z[:2]), mask_args={"maskstart": 8, "maskend": 20})
        port.train()
    np.testing.assert_array_equal(callback.outputs["inpaint_cfg4.0"], want.numpy())
    wavs = [f for f in os.listdir(tmp_path) if f.endswith(".wav")]
    for name in callback.outputs:
        assert sorted(f for f in wavs if f.startswith(f"{name}_step7_")) == [
            f"{name}_step7_{b}.wav" for b in range(2)]


def test_inpaint_demo_leaves_training_bit_identical(tmp_path):
    # the training entry with the inpainting demo after steps 2 and 4 (its
    # own loader, the EMA weights, its own generator) against the same four
    # steps without it: every weight, moment and EMA entry equal bit for bit
    from stable_audio_tools_tpu_torch import train
    from test_torch_train_entry import _dit_config, _state, write_run_inputs

    cfg = _dit_config()
    cfg["model_type"] = "diffusion_cond_inpaint"
    diffusion = cfg["model"]["diffusion"]
    diffusion["diffusion_objective"] = "rectified_flow"
    diffusion["config"]["input_concat_dim"] = diffusion["config"]["io_channels"] + 1
    cfg["training"].update(p_one_shot=0.2, log_loss_info=True)
    base = write_run_inputs(str(tmp_path), cfg) + ["--max-steps", "4", "--checkpoint-every",
                                                   "0"]
    plain = train.main(base + ["--save-dir", str(tmp_path / "plain")])
    full = train.main(base + ["--save-dir", str(tmp_path / "run"), "--demo-every", "2"])
    a, b = _state(plain.wrapper), _state(full.wrapper)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert a.keys() == b.keys() and not differ, differ[:5]
    assert [h["train/loss"] for h in plain.history] == [h["train/loss"] for h in full.history]
    assert "train/loss_all_0.5" in full.history[0]
    log = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert not any("demo/error" in r for r in log)
    demos = os.listdir(tmp_path / "run" / "demos")
    for kind in ("inpaint_reals", "inpaint_masked_input", "inpaint_cfg"):
        assert any(f.startswith(kind) and "_step4_" in f for f in demos), kind
