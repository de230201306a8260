"""The remaining diffusion backbones in the port against the JAX package on
the CPU, f32, the same weights (io/from_jax.py, seeded numpy values) and the
same inputs and draws: the unconditional `adp_uncond_1d` (the ADP `UNet1d`
under `UNet1DUncondWrapper`) and `dit` (`DiTUncondWrapper`) through the
factory (their `min_input_length`), a forward, `generate_diffusion_uncond`
and one step of the unconditional trainer; and the conditioned `adp_1d`
(`UNet1DCondWrapper`, a number conditioner as its `features`) through a
forward and one training step (its input-concat channels: the diffusion
autoencoder's, tests/test_torch_diffae.py). Each
tolerance is stated where it is used."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.inference import generation as jgen
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training import diffusion as jtrain
from stable_audio_tools_tpu_torch.inference import generation as tgen
from stable_audio_tools_tpu_torch.io.from_jax import (diffusion_cond_state_dict,
                                                      diffusion_uncond_state_dict)
from stable_audio_tools_tpu_torch.models import adp as tadp
from stable_audio_tools_tpu_torch.models import diffusion as tdiff
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training import diffusion as ttrain
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

from test_torch_ae_training import one_torch_thread  # noqa: F401
from test_torch_dance import _replayed_noise
from test_torch_transformer_options import randomize

T, SEED = 32, 5

# SA-1.0's UNet1d at toy size: 3 levels of 16 / 32 / 32 channels, factors 2 and
# 2, attention at the bottleneck (2 heads of 16), no cross-attention context
TINY_UNET = dict(in_channels=2, channels=16, multipliers=[1, 2, 2], factors=[2, 2],
                 num_blocks=[1, 1], attentions=[0, 0, 1], resnet_groups=8,
                 attention_heads=2, attention_features=16)
# the DiT at toy size: 2 blocks of 2 heads of 64, no conditioning
TINY_DIT = dict(io_channels=2, embed_dim=128, depth=2, num_heads=2, use_checkpointing=False)
TINY = {
    kind: {"model_type": "diffusion_uncond", "sample_size": T, "sample_rate": 16000,
           "audio_channels": 2, "model": {"type": kind, "config": copy.deepcopy(cfg)},
           "training": {"learning_rate": 1e-4}}
    for kind, cfg in (("adp_uncond_1d", TINY_UNET), ("dit", TINY_DIT))}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dim_heads(cfg):
    c = cfg["model"]["config"]
    return c["embed_dim"] // c["num_heads"] if "embed_dim" in c else 64


@pytest.fixture(scope="module")
def pairs():
    """{kind: (JAX wrapper, {"params": ...}, the port's wrapper)} with the
    same seeded weights."""
    out = {}
    for seed, (kind, cfg) in enumerate(TINY.items()):
        jm = jax_create_model(cfg)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 2, T)),
                                jnp.zeros((2,)))
        params = randomize(shapes["params"], 20 + seed)
        port = create_model_from_config(cfg, "cpu")
        port.load_state_dict({k: _t(v) for k, v in diffusion_uncond_state_dict(
            params, _dim_heads(cfg)).items()}, strict=True)
        out[kind] = (jm, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, port.eval())
    return out


KINDS = list(TINY)


@pytest.mark.parametrize("kind", KINDS)
def test_factory_builds_the_wrapper_with_the_jax_min_input_length(pairs, kind):
    jm, _, port = pairs[kind]
    wrapper = {"adp_uncond_1d": tadp.UNet1DUncondWrapper, "dit": tdiff.DiTUncondWrapper}[kind]
    assert isinstance(port.model, wrapper)
    assert port.min_input_length == jm.min_input_length == (4 if kind != "dit" else 1)
    assert port.io_channels == jm.io_channels == 2


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(pairs, kind):
    # the tiny UNet1d / DiT in f32: 1e-5 of the output's peak
    jm, variables, port = pairs[kind]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(_t(x), _t(t)).numpy()
    assert got.shape == (2, 2, T)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_generate_diffusion_uncond_matches_jax(pairs, kind):
    # 4 dpmpp-2m-sde steps, JAX's noise replayed (tests/test_torch_dance.py),
    # f32: 1e-4 of the audio's peak (the model's 1e-6 roundings through 4
    # steps, the sampler's SDE noise scaled up)
    jm, variables, port = pairs[kind]
    kw = dict(steps=4, batch_size=1, sample_size=T, seed=SEED, sampler_type="dpmpp-2m-sde",
              sigma_min=0.3, sigma_max=50.0)
    want = np.asarray(jgen.generate_diffusion_uncond(jm, variables, **kw))
    noise, step_noise = _replayed_noise((1, 2, T))
    got = tgen.generate_diffusion_uncond(port, noise=noise, step_noise=step_noise, **kw).numpy()
    assert got.shape == want.shape == (1, 2, T) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_uncond_training_step_matches_jax(pairs, kind):
    # one step of each package's unconditional trainer on the same weights
    # and batch: t from the Sobol sequence at step 2 on both sides, JAX's
    # noise (fold_in(rng, 4)) replayed; the loss within 1e-5 relative, each
    # gradient within 1e-4 of its peak (f32 backward through the tiny model)
    # plus 1e-6 of the largest: a bias ahead of a GroupNorm has a zero
    # gradient up to roundoff
    jm, variables, port = pairs[kind]
    port = copy.deepcopy(port)
    audio = (0.5 * np.random.default_rng(7).standard_normal((3, 2, T))).astype(np.float32)
    key, step = jax.random.PRNGKey(9), 2
    jt = jtrain.DiffusionUncondTrainer(jm, lr=1e-4)
    batch = {"audio": jnp.asarray(audio)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_and_info(p, batch, key, True, step), has_aux=True))(
            variables["params"])
    noise = _t(jax.random.normal(jax.random.fold_in(key, 4), audio.shape))
    w = create_training_wrapper_from_config(TINY[kind], port)
    assert isinstance(w, ttrain.DiffusionUncondTrainer)
    w.step = step
    aux = w.train_step(_t(audio), [{}] * 3, noise=noise)
    assert abs(float(aux["loss"]) - float(loss)) <= 1e-5 * float(loss)
    want = diffusion_uncond_state_dict(jax.tree_util.tree_map(np.asarray, grads),
                                       _dim_heads(TINY[kind]))
    assert sorted(want) == sorted(w.params)
    _check_grads(w.params, want)


def _check_grads(params, want):
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g,
                                   atol=1e-4 * np.abs(g).max() + floor, err_msg=name)


# -- the conditioned adp_1d ---------------------------------------------------------

ADP_1D = {
    "model_type": "diffusion_cond", "sample_size": T, "sample_rate": 16000,
    "audio_channels": 2,
    "model": {"io_channels": 2,
              "conditioning": {"cond_dim": 8, "configs": [
                  {"id": "seconds_total", "type": "number",
                   "config": {"min_val": 0, "max_val": 64}}]},
              "diffusion": {"type": "adp_1d", "global_cond_ids": ["seconds_total"],
                            "config": dict(TINY_UNET, context_features=8)}},
    "training": {"learning_rate": 1e-4, "cfg_dropout_prob": 0.1}}


@pytest.fixture(scope="module")
def adp_1d_pair():
    jm = jax_create_model(ADP_1D)
    mc = jm._multi_conditioner
    meta = [{"seconds_total": 10}, {"seconds_total": 40}]
    prepared = jax.tree_util.tree_map(jnp.asarray, mc.gather_inputs(meta))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 2, T)),
                                            jnp.zeros((2,)), cond=prepared))
    params = randomize(shapes["params"], 30)
    port = create_model_from_config(ADP_1D, "cpu")
    port.load_state_dict({k: _t(v) for k, v in diffusion_cond_state_dict(params).items()},
                         strict=True)
    return jm, params, port, meta, prepared


def test_adp_1d_forward_matches_jax(adp_1d_pair):
    # the number conditioner as the UNet's features, f32: 1e-5 of the peak
    jm, params, port, meta, prepared = adp_1d_pair
    assert isinstance(port.model, tadp.UNet1DCondWrapper)
    x = np.random.default_rng(2).standard_normal((2, 2, T)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                               cond=prepared))
    with torch.no_grad():
        cond = port.get_conditioning_inputs(port.conditioner(meta, "cpu"))
        got = port(_t(x), _t(t), **cond).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_adp_1d_training_step_matches_jax(adp_1d_pair):
    # one DiffusionCondTrainer step (its CFG dropout has nothing to drop on
    # the plain UNet, as the JAX wrapper ignores it) against the JAX model's
    # loss and gradient at the same t and noise: the loss 1e-5 relative, each
    # gradient 1e-4 of its peak (the number embedder's included) + 1e-6 of
    # the largest (`_check_grads`)
    jm, params, port, meta, prepared = adp_1d_pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    t = rng.random(2).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        a = jnp.cos(jnp.asarray(t) * np.pi / 2)[:, None, None]
        s = jnp.sin(jnp.asarray(t) * np.pi / 2)[:, None, None]
        out = jm.apply({"params": p}, x * a + noise * s, jnp.asarray(t), cond=prepared,
                       cfg_dropout_prob=0.1, train=True)
        return jnp.mean(jnp.square(out - (noise * a - x * s)))

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    w = create_training_wrapper_from_config(ADP_1D, copy.deepcopy(port))
    aux = w.train_step(_t(x), meta, t=_t(t), noise=_t(noise))
    np.testing.assert_allclose(float(aux["loss"]), float(loss), rtol=1e-5)
    want = diffusion_cond_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert sorted(w.params) == sorted(want)
    _check_grads(w.params, want)
