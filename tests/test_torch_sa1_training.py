"""SA-1.0 diffusion training of the port against the JAX package on the CPU:
a tiny SA-1.0-shaped model (CLAP text features and two int conditioners
cross-attended by an ADP `UNetCFG1d`, a frozen DAC VAE) with the JAX model's
weights (carried by io/from_jax.py), through the port's
DiffusionCondTrainer and the JAX package's pieces (pretransform encode,
model.apply with CFG dropout in training, jax.value_and_grad, its optimizer
and EMA) on the same batch, t, noise, VAE noise and dropout mask; then the
order of the trainer's draws, resume from a checkpoint and the `train`
entry point.

The JAX UNet draws its dropout mask with `jax.random.bernoulli` from the
"cfg" key; the tests replace that function by one that returns the mask the
port is handed (`cfg_dropout_mask`). f32 on both sides; the tolerances are
stated at each test.
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

from stable_audio_tools_tpu.training import ema as jema
from stable_audio_tools_tpu.training.utils import build_optimizer
from stable_audio_tools_tpu_torch.io.from_jax import diffusion_cond_state_dict
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

from test_torch_sa1 import _sa1_config, _sa1_pair, clap_path  # noqa: F401 (a fixture)
from test_torch_training import _jax_latents
from test_torch_ae_training import one_torch_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA1 = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs", "txt2audio",
                   "stable_audio_1_0.json")
with open(SA1) as _f:
    SA1_TRAINING = json.load(_f)["training"]

B = 2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    """max|got - want| / max|want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = np.abs(want).max()
    err = np.abs(got - want).max()
    return err / peak if peak > 0 else err


def _train_config(clap_path):
    config = _sa1_config(clap_path)
    config["training"] = copy.deepcopy(SA1_TRAINING)
    return config


def _batch(seed, sample_size):
    rng = np.random.default_rng(seed)
    audio = (0.5 * rng.standard_normal((B, 2, sample_size))).astype(np.float32)
    meta = [{"prompt": f"warm analog pads {i}", "seconds_start": 3 + 5 * i,
             "seconds_total": 30 + i} for i in range(B)]
    return audio, meta, rng.random(B).astype(np.float32), rng


@pytest.fixture(scope="module")
def train_pair(clap_path):
    return _sa1_pair(_train_config(clap_path))


class _Bernoulli:
    """Stands in for `jax.random.bernoulli` in the JAX UNet: the dropout mask
    [B] the traced loss was handed, as its [B, 1, 1] draw."""

    mask = None

    def __call__(self, key, p=0.5, shape=None):
        return jnp.reshape(self.mask, shape)


@pytest.fixture(scope="module")
def jax_step(train_pair, clap_path):
    """(the Bernoulli stand-in, the jitted loss and gradient of one JAX
    training step in f32 with the dropout mask an argument: one trace for
    every case)."""
    model = train_pair[0]
    p_drop = _train_config(clap_path)["training"]["cfg_dropout_prob"]
    bernoulli = _Bernoulli()

    def jloss(params, latents, t, noise, prepared, mask):
        bernoulli.mask = mask
        a, s = jnp.cos(t * math.pi / 2)[:, None, None], jnp.sin(t * math.pi / 2)[:, None, None]
        out = model.apply({"params": params}, latents * a + noise * s, t, cond=prepared,
                          cfg_dropout_prob=p_drop, train=True,
                          rngs={"cfg": jax.random.PRNGKey(0)})
        return jnp.mean(jnp.square(out - (noise * a - latents * s)))

    return bernoulli, jax.jit(jax.value_and_grad(jloss))


@pytest.mark.parametrize("mask", [[False, False], [True, True], [True, False]])
def test_training_steps_match_jax(train_pair, jax_step, clap_path, mask, monkeypatch):
    # Two steps of the shipped SA-1.0 training section (AdamW, betas 0.9 /
    # 0.999, weight decay 1e-3, InverseLR with warmup 0.99, cfg_dropout_prob
    # 0.1) of the tiny f32 model, the CFG dropout mask injected on both
    # sides (none, all, one item dropped: the dropped items' context is the
    # learned null embedding, whose gradient is then nonzero, the
    # conditioners' zero), against the JAX package's pieces composed here.
    # Bounds (f32, sums reassociated through the UNet and the DAC encoder):
    # latents 1e-4 of their peak, loss 1e-5 relative, each gradient and Adam
    # moment 1e-4 of its peak (a gradient JAX gives as zero must be zero or
    # absent in the port), the parameters and the EMA after each step within
    # 1e-2 of the learning rate where Adam's normalisation is well
    # conditioned (|g| > 1e-2 max|g| at every step so far), elsewhere within
    # twice the summed learning rates, each plus 2 ulps of the parameter.
    model, variables, port = train_pair
    config = _train_config(clap_path)
    params = variables["params"]
    mc = model._multi_conditioner
    wrapper = create_training_wrapper_from_config(config, copy.deepcopy(port))
    names = list(wrapper.params)
    # the UNet and the conditioners' own layers (the int tables, CLAP's
    # proj_out); the CLAP tower and the DAC are frozen
    assert names and all(n.startswith(("model.model.", "conditioner.conditioners."))
                         and ".prompt.model." not in n for n in names), names
    assert any(n.startswith("model.model.fixed_embedding") for n in names)
    assert not any(p.requires_grad for p in wrapper.model.pretransform.parameters())
    p_before = {n: p.detach().clone() for n, p in wrapper.params.items()}
    bernoulli, jgrad = jax_step
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    entry = config["training"]["optimizer_configs"]["diffusion"]
    jopt = build_optimizer(entry)
    jstate, jema_params = jopt.init(params), params
    lr = [entry["optimizer"]["config"]["lr"] * (1 - 0.99 ** (s + 1)) for s in range(2)]

    well_conditioned = {}
    for step in range(2):
        audio, meta, t, rng = _batch(step, config["sample_size"])
        z, vae_noise = _jax_latents(model, {"params": params}, audio, jax.random.PRNGKey(step))
        noise = rng.standard_normal(z.shape).astype(np.float32)
        with torch.no_grad():
            zp = wrapper.model.pretransform_encode(_t(audio), noise=_t(vae_noise))
        assert _rel(zp.numpy(), z) < 1e-4
        prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(meta))
        loss, grads = jgrad(params, jnp.asarray(z), jnp.asarray(t), jnp.asarray(noise),
                            prepared, jnp.asarray(mask))
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        jema_params = jema.ema_update(jema_params, params, step)

        aux = wrapper.train_step(_t(audio), meta, t=_t(t), noise=_t(noise),
                                 encode_noise=_t(vae_noise),
                                 cfg_dropout_mask=torch.tensor(mask))
        np.testing.assert_allclose(float(aux["loss"]), float(loss), rtol=1e-5)
        conv = lambda tree: diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, tree))
        want_g, want_p, want_e = conv(grads), conv(params), conv(jema_params)
        mu, nu = conv(jstate[0].mu), conv(jstate[0].nu)
        assert set(names) <= set(want_g), sorted(set(names) - set(want_g))
        for n in names:
            p = wrapper.params[n]
            g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            assert np.isfinite(g).all(), n
            if not np.abs(want_g[n]).max() > 0:
                assert not np.abs(g).max() > 0, n
                continue
            assert _rel(g, want_g[n]) < 1e-4, (n, _rel(g, want_g[n]))
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
        fixed = wrapper.params["model.model.fixed_embedding.embedding.weight"]
        assert (fixed.grad is not None and fixed.grad.abs().max() > 0) == any(mask)


def test_dropout_mask_is_drawn_after_t_and_noise(train_pair, clap_path):
    # without injections `loss` draws t, then the diffusion noise, then the
    # UNet's [B, 1, 1] dropout mask from the step's generator (the order
    # training/diffusion.py documents): the same draws made by hand and
    # injected give the same loss, bit for bit
    _, _, port = train_pair
    config = _train_config(clap_path)
    config["training"]["cfg_dropout_prob"] = 0.5
    w = create_training_wrapper_from_config(config, copy.deepcopy(port))
    audio, meta, _, _ = _batch(3, config["sample_size"])
    with torch.no_grad():
        latents = w.encode(_t(audio), noise=torch.zeros(B, 4, config["sample_size"] // 8))
        cond = w.condition(meta)
        drawn, _ = w.loss(latents, cond, generator=w.generator(4))
        g = w.generator(4)
        t = torch.rand((B,), generator=g)
        noise = torch.randn(latents.shape, generator=g)
        mask = torch.rand((B, 1, 1), generator=g) < 0.5
        given, _ = w.loss(latents, cond, t=t, noise=noise, cfg_dropout_mask=mask.reshape(B))
    assert float(drawn) == float(given)


def test_save_then_resume_gives_the_same_next_step(train_pair, clap_path, tmp_path):
    # a resumed trainer draws the same VAE noise, t, noise and dropout mask
    # as the uninterrupted one (its generators are seeded from the step) and
    # holds the same weights, moments and EMA: the next step's loss and
    # parameters are identical
    from stable_audio_tools_tpu_torch.io.checkpoints import save_training_state
    from stable_audio_tools_tpu_torch.training.trainer import Trainer

    _, _, port = train_pair
    config = _train_config(clap_path)
    config["training"]["cfg_dropout_prob"] = 0.5
    audio, meta, _, _ = _batch(9, config["sample_size"])
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
        assert torch.equal(resumed.ema[n], first.ema[n]), n


def test_train_entry_trains_sa1_and_resumes(clap_path, tmp_path):
    # `python -m stable_audio_tools_tpu_torch.train` on the CPU with the tiny
    # SA-1.0 config (its CLAP tower read from the checkpoint file): two
    # steps with finite losses, a checkpoint, and a resumed run to step 3
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav

    rng = np.random.default_rng(1)
    os.makedirs(tmp_path / "wavs")
    for i in range(3):
        save_wav(str(tmp_path / "wavs" / f"c{i}.wav"),
                 (rng.standard_normal((2, 5000)) * 0.2).astype(np.float32), 16000)
    (tmp_path / "meta.py").write_text(
        "def get_custom_metadata(info, audio):\n    return {'prompt': 'pads ' + info['relpath']}\n")
    data = tmp_path / "dataset.json"
    data.write_text(json.dumps({"dataset_type": "audio_dir", "random_crop": True, "datasets": [
        {"id": "d", "path": str(tmp_path / "wavs"),
         "custom_metadata_module": str(tmp_path / "meta.py")}]}))
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps(_train_config(clap_path)))
    argv = ["--model-config", str(cfg_path), "--dataset-config", str(data),
            "--batch-size", "2", "--num-workers", "0", "--max-steps", "2",
            "--checkpoint-every", "2", "--save-dir", str(tmp_path / "run"), "--device", "cpu",
            "--precision", "32"]
    trainer = train.main(argv)
    log = [json.loads(line) for line in
           (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert next(trainer.wrapper.model.model.parameters()).dtype == torch.float32
    resumed = train.main(argv[:9] + ["3"] + argv[10:] +
                         ["--ckpt-path", str(tmp_path / "run" / "step=2.ckpt")])
    assert resumed.wrapper.step == 3

