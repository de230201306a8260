"""Dance Diffusion (`diffusion_uncond`, DAU1d) in the port against the JAX
package on the CPU: the resamplers, the blocks, a tiny UNet, the v-DDIM
sampler, unconditional generation and one training step, with the same
weights (carried by io/from_jax.py, drawn from a numpy seed) and the same
inputs, in f32; then the factory on the four shipped configs, its refusals,
the `train` entry point, the weight-gradient calls of a backward, and the
dtype in which the two packages run a bf16 config. Each tolerance is stated
where it is used."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.inference import generation as jgen
from stable_audio_tools_tpu.inference import sampling as jsamp
from stable_audio_tools_tpu.models import dance_unet as jdance
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training import diffusion as jtrain
from stable_audio_tools_tpu_torch.inference import generation as tgen
from stable_audio_tools_tpu_torch.inference import sampling as tsamp
from stable_audio_tools_tpu_torch.io.from_jax import (dance_unet_state_dict,
                                                      diffusion_uncond_state_dict)
from stable_audio_tools_tpu_torch.models import dance_unet as tdance
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.ops import conv as tconv
from stable_audio_tools_tpu_torch.training import diffusion as ttrain
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DANCE_DIR = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                         "dance_diffusion")
SHIPPED = ("dance_diffusion_base", "dance_diffusion_base_16k", "dance_diffusion_base_44k",
           "dance_diffusion_large")
SEED = 5
T = 64  # the tiny UNet's length: 8 at its innermost level

# a tiny DAU1d: 4 levels, 16-64 channels, attention at levels 2-4 (1 or 2 heads)
TINY = {"model_type": "diffusion_uncond", "sample_size": T, "sample_rate": 16000,
        "audio_channels": 2,
        "model": {"type": "DAU1d", "config": {"io_channels": 2, "depth": 4, "n_attn_layers": 2,
                                               "channels": [16, 32, 64, 64],
                                               "strides": [2, 2, 2]}},
        "training": {"learning_rate": 1e-4}}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def jax_params(module, *shapes, seed=0, **kwargs):
    """The params of a flax module for inputs of `shapes` (f32), drawn from a
    numpy seed without running JAX's init: conv kernels ~ U(+-1/sqrt(k in)),
    biases ~ N(0, 0.1), norm scales ~ 1 + N(0, 0.1), Fourier weights ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes), **kwargs)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            b = 1.0 / np.sqrt(shape[0] * shape[1])
            return rng.uniform(-b, b, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)  # FourierFeatures

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    return module


@pytest.fixture(scope="module")
def tiny_pair():
    """(the JAX wrapper, its params {'params': ...}, the port's wrapper with
    the same weights)."""
    jm = jax_create_model(TINY)
    params = jax_params(jm, (2, 2, T), (2,))
    port = load(create_model_from_config(TINY, "cpu"), diffusion_uncond_state_dict(params))
    return jm, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, port


# -- the blocks ----------------------------------------------------------------


@pytest.mark.parametrize("C,L", [(1, 8), (3, 16), (16, 64)])
def test_fir_resamplers_match_jax(C, L):
    # depthwise 8-tap filters in f32: 1e-6 of the output's peak
    x = np.random.default_rng(C + L).standard_normal((2, C, L)).astype(np.float32)
    for jfn, tfn, length in ((jdance.fir_downsample, tdance.fir_downsample, L // 2),
                             (jdance.fir_upsample, tdance.fir_upsample, 2 * L)):
        want = np.asarray(jfn(jnp.asarray(x.transpose(0, 2, 1)), "cubic")).transpose(0, 2, 1)
        got = tfn(_t(x), tdance.cubic_taps()).numpy()
        assert got.shape == want.shape == (2, C, length)
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("c_in,c_out,is_last", [(16, 16, False), (18, 32, False),
                                                (32, 2, True)])
def test_res_conv_block_matches_jax(c_in, c_out, is_last):
    # two k = 5 convs, GroupNorm(1), tanh GELU, the k = 1 skip where the width
    # changes, in f32: 1e-5 of the output's peak
    block = jdance.ResConvBlock(c_mid=c_out, c_out=c_out, is_last=is_last)
    x = np.random.default_rng(c_in).standard_normal((2, 40, c_in)).astype(np.float32)
    params = jax_params(block, x.shape, seed=c_in)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x))).transpose(0, 2, 1)
    port = tdance.ResConvBlock(c_in, c_out, c_out, is_last)
    load(port, {k[2:]: v for k, v in dance_unet_state_dict({"b": params}).items()})
    assert (port.skip is None) == (c_in == c_out) and (port.norm2 is None) == is_last
    got = port(_t(x.transpose(0, 2, 1))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("C", [32, 64])
def test_self_attention_matches_jax(C):
    # 1 and 2 heads of 32 over 24 positions, f32: 1e-5 of the output's peak
    heads = max(C // 32, 1)
    attn = jdance.SelfAttention1d(n_head=heads)
    x = np.random.default_rng(C).standard_normal((2, 24, C)).astype(np.float32)
    params = jax_params(attn, x.shape, seed=C)
    want = np.asarray(attn.apply({"params": params}, jnp.asarray(x))).transpose(0, 2, 1)
    port = load(tdance.SelfAttention1d(C, heads),
                {k[2:]: v for k, v in dance_unet_state_dict({"a": params}).items()})
    got = port(_t(x.transpose(0, 2, 1))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_tiny_unet_forward_matches_jax(tiny_pair):
    # 4 levels of blocks, attention and resamplers in f32: 1e-5 of the peak
    jm, variables, port = tiny_pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(_t(x), _t(t)).numpy()
    assert got.shape == (2, 2, T)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# -- the v-DDIM sampler --------------------------------------------------------


def _v_models():
    # a closed-form v-model, the same in jnp and torch
    def jax_v(x, t):
        return 0.3 * x * jnp.cos(t)[:, None, None] + 0.2 * jnp.sin(2.0 * x)

    def torch_v(x, t):
        return 0.3 * x * torch.cos(t)[:, None, None] + 0.2 * torch.sin(2.0 * x)

    return jax_v, torch_v


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_sample_matches_jax(eta):
    # the JAX scan in f32 against the port's loop (step coefficients in
    # float64 from the same f32 grid), 12 steps from t = 0.9; with eta the
    # step noise is JAX's own, fold_in(key, i) in [B, C, T]: 1e-5 of the peak
    jax_v, torch_v = _v_models()
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(2).standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(jsamp.sample(jax_v, jnp.asarray(x), 12, eta=eta, sigma_max=0.9, rng=key))
    noise = lambda i, y: _t(jax.random.normal(jax.random.fold_in(key, i), y.shape))
    got = tsamp.sample(torch_v, _t(x), 12, eta=eta, sigma_max=0.9, step_noise=noise).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("with_init", [False, True])
def test_sample_k_vddim_matches_jax(with_init):
    # sample_k's v branch: sigma_max clipped to 1, init_data mixed at
    # (alpha, sigma) of that t; 9 steps in f32: 1e-5 of the peak
    jax_v, torch_v = _v_models()
    rng = np.random.default_rng(4)
    noise = rng.standard_normal((2, 3, 8)).astype(np.float32)
    init = rng.standard_normal((2, 3, 8)).astype(np.float32) if with_init else None
    kw = dict(steps=9, sampler_type="v-ddim", sigma_min=0.3,
              sigma_max=0.6 if with_init else 500.0)
    want = np.asarray(jsamp.sample_k(jax_v, jnp.asarray(noise), rng=jax.random.PRNGKey(0),
                                     init_data=None if init is None else jnp.asarray(init), **kw))
    got = tsamp.sample_k(torch_v, _t(noise), init_data=None if init is None else _t(init),
                         **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# -- generation ----------------------------------------------------------------


def _replayed_noise(shape):
    """JAX generate_diffusion_uncond's noise for seed SEED: the initial noise
    from fold_in(key, 0) and step i's sampler noise from fold_in(fold_in(key,
    1), i), drawn in the [B, T, C] layout sample_k's k-diffusion scan runs in."""
    key = jax.random.PRNGKey(SEED)
    noise = _t(jax.random.normal(jax.random.fold_in(key, 0), shape))
    sampler_key = jax.random.fold_in(key, 1)

    def step_noise(i, x):
        n = jax.random.normal(jax.random.fold_in(sampler_key, i),
                              (x.shape[0], x.shape[2], x.shape[1]))
        return _t(np.asarray(n).transpose(0, 2, 1))

    return noise, step_noise


@pytest.mark.parametrize("sampler,with_init", [("dpmpp-2m-sde", False), ("v-ddim", False),
                                               ("dpmpp-2m-sde", True)])
def test_generate_diffusion_uncond_matches_jax(tiny_pair, sampler, with_init):
    # the tiny UNet through 4 sampler steps, JAX's noise replayed, f32: 1e-4
    # of the audio's peak (the model's 1e-6 roundings pass through 4 steps)
    jm, variables, port = tiny_pair
    kw = dict(steps=4, batch_size=1, sample_size=T, seed=SEED, sampler_type=sampler,
              sigma_min=0.3, sigma_max=50.0)
    if with_init:
        audio = 0.3 * np.random.default_rng(6).standard_normal((2, T)).astype(np.float32)
        kw.update(init_audio=(16000, audio), init_noise_level=3.0)
    want = np.asarray(jgen.generate_diffusion_uncond(jm, variables, **kw))
    noise, step_noise = _replayed_noise((1, 2, T))
    got = tgen.generate_diffusion_uncond(port, noise=noise, step_noise=step_noise, **kw).numpy()
    assert got.shape == want.shape == (1, 2, T) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_generation_refuses_what_is_not_ported(tiny_pair):
    # several cards are refused; cfg++ is refused by name on this model, which
    # the JAX package cannot run it on either (the DAU1d takes no
    # return_info); a flow sampler on a v-model is unknown to sample_k, as in
    # JAX; preview collects each denoiser call's estimate
    jm, variables, port = tiny_pair
    for kw in ({"mesh": object()}, {"tp_rules": ()}):
        with pytest.raises(NotImplementedError, match="not ported"):
            tgen.generate_diffusion_uncond(port, steps=2, sample_size=T, seed=0, **kw)
    with pytest.raises(NotImplementedError, match="v-ddim-cfgpp"):
        tgen.generate_diffusion_uncond(port, steps=2, sample_size=T, seed=0,
                                       sampler_type="v-ddim-cfgpp")
    with pytest.raises(TypeError):
        jgen.generate_diffusion_uncond(jm, variables, steps=2, sample_size=T, seed=0,
                                       sampler_type="v-ddim-cfgpp")
    for gen, args in ((tgen.generate_diffusion_uncond, (port,)),
                      (jgen.generate_diffusion_uncond, (jm, variables))):
        with pytest.raises(ValueError, match="Unknown sampler"):
            gen(*args, steps=2, sample_size=T, seed=0, sampler_type="euler")
    tgen.generate_diffusion_uncond(port, steps=2, sample_size=T, seed=0, preview=True,
                                   sampler_type="dpmpp-2m")
    assert [s for _, s in port._preview_buffer] == pytest.approx([500.0, 0.3])


# -- training ------------------------------------------------------------------


def test_sobol_timesteps_match_jax():
    for step, batch in ((0, 4), (3, 4), (1000, 7)):
        np.testing.assert_array_equal(ttrain._sobol_timesteps(step, batch).numpy(),
                                      np.asarray(jtrain._sobol_timesteps(step, batch)))


def test_uncond_training_step_matches_jax(tiny_pair):
    # one step of each package's uncond trainer on the same weights and
    # batch: t from the Sobol sequence at step 2 on both sides, JAX's noise
    # (fold_in(rng, 4)) replayed; loss within 1e-5 relative, each gradient
    # within 1e-4 of its peak (f32 backward through the tiny UNet)
    jm, variables, port = tiny_pair
    port = copy.deepcopy(port)
    rng = np.random.default_rng(7)
    audio = (0.5 * rng.standard_normal((3, 2, T))).astype(np.float32)
    key, step = jax.random.PRNGKey(9), 2
    jt = jtrain.DiffusionUncondTrainer(jm, lr=1e-4)
    batch = {"audio": jnp.asarray(audio)}
    (loss, info), grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_and_info(p, batch, key, True, step), has_aux=True))(
            variables["params"])
    noise = _t(jax.random.normal(jax.random.fold_in(key, 4), audio.shape))
    w = create_training_wrapper_from_config(TINY, port)
    assert isinstance(w, ttrain.DiffusionUncondTrainer) and w.cfg_dropout_prob == 0.0
    w.step = step
    aux = w.train_step(_t(audio), [{}] * 3, noise=noise)
    assert abs(float(aux["loss"]) - float(loss)) <= 1e-5 * float(loss)
    assert abs(float(aux["std_data"]) - float(info["std_data"])) <= 1e-6
    want = diffusion_uncond_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert sorted(want) == sorted(w.params)
    for name, g in want.items():
        got = w.params[name].grad.numpy()
        np.testing.assert_allclose(got, g, atol=1e-4 * max(np.abs(g).max(), 1e-12),
                                   err_msg=name)


def test_every_conv_calls_the_weight_gradient_once_per_backward(tiny_pair, monkeypatch):
    # each stride-1 conv of the UNet hands its (x, dy, k) to conv1d_wgrad
    # once in a backward, and no other call does
    _, _, port = tiny_pair
    port = copy.deepcopy(port)
    seen, calls = [], []
    for m in port.modules():
        if isinstance(m, tdance.Conv1d):
            m.register_forward_hook(lambda m, i, o: seen.append(
                (m.in_channels, m.out_channels, m.kernel_size[0], i[0].shape[-1])))
    real = tconv.conv1d_wgrad

    def spy(dy, x, k, *args):
        calls.append((x.shape[1], dy.shape[1], k, x.shape[-1]))
        return real(dy, x, k, *args)

    monkeypatch.setattr(tconv, "conv1d_wgrad", spy)
    x = torch.randn(2, 2, T, generator=torch.Generator().manual_seed(0))
    port(x, torch.tensor([0.3, 0.6])).square().mean().backward()
    assert len(seen) == port.model.conv_sites() == 93
    assert sorted(calls) == sorted(seen)


# -- configs, the map, refusals ------------------------------------------------


def _shipped(name):
    with open(os.path.join(DANCE_DIR, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_builds_with_the_jax_parameter_count(name):
    # the JAX count by jax.eval_shape of init (no compute), the port's on meta
    cfg = _shipped(name)
    jm = jax_create_model(cfg)
    n = 2 ** len(cfg["model"]["config"]["strides"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 2, n), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.float32))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    port = create_model_from_config(cfg, "meta")
    assert sum(p.numel() for p in port.parameters()) == want
    assert port.model.compute_dtype == torch.bfloat16 and port.min_input_length == n
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in diffusion_uncond_state_dict(
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes["params"])).items()}


def test_the_map_uses_every_leaf_and_refuses_unknown_ones(tiny_pair):
    jm, variables, port = tiny_pair
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    sd = diffusion_uncond_state_dict(params)
    assert sorted(sd) == sorted(port.state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    extra = copy.deepcopy(params)
    extra["model"]["head_0"]["conv1"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="head_0/conv1/stray"):
        diffusion_uncond_state_dict(extra)


def test_factory_refuses_what_is_not_ported():
    def with_model(**changes):
        cfg = copy.deepcopy(TINY)
        cfg["model"].update(changes.pop("model", {}))
        cfg["model"]["config"].update(changes)
        return cfg

    # strides other than 1 and 2 stay refused (the JAX module resamples only
    # at 2); the unconditional adp_uncond_1d and dit, DAU1d's conditioning
    # and learned_resample are built
    # (tests/test_torch_uncond_backbones.py, tests/test_torch_diffae.py)
    with pytest.raises(NotImplementedError, match="strides"):
        create_model_from_config(with_model(strides=[2, 4, 2]), "cpu")
    assert create_model_from_config(with_model(model={"type": "dit", "config": {
        "io_channels": 2, "embed_dim": 64, "depth": 1, "num_heads": 1}}), "cpu").model.model
    for cfg in (with_model(model={"type": "adp_uncond_1d", "config": {
                    "in_channels": 2, "channels": 8, "multipliers": [1, 1], "factors": [2],
                    "num_blocks": [1], "attentions": [0, 0], "resnet_groups": 4}}),
                with_model(cond_dim=4), with_model(cond_dim=4, cond_noise_aug=True),
                with_model(learned_resample=True)):
        create_model_from_config(cfg, "cpu")
    # the unconditional model takes no cond
    model = create_model_from_config(TINY, "cpu")
    with pytest.raises(ValueError, match="cond"):
        model.model(torch.zeros(1, 2, T), torch.zeros(1), cond=torch.zeros(1, 2, T))


# -- the bf16 config: where the two packages compute in it ---------------------


def test_bf16_config_runs_bf16_in_the_port_and_f32_past_the_first_conv_in_jax(tiny_pair):
    # The JAX module's flax GroupNorm promotes to its f32 parameters, so with
    # compute_dtype bfloat16 only head_0's conv1 and skip run in bf16; the
    # port runs every conv in bf16 (the weight-gradient kernel's dtype). The
    # two outputs lie apart by the port's bf16 rounding: each, and their
    # distance, within 5% of the f32 output's peak, the port's farther from
    # it than the JAX one's (1.4% and 0.4% at this seed).
    jm, variables, port = tiny_pair
    cfg = copy.deepcopy(TINY)
    cfg["model"]["config"]["compute_dtype"] = "bfloat16"
    unet = jdance.DiffusionAttnUnet1D(**{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in cfg["model"]["config"].items()})
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, 2, T)).astype(np.float32))
    t = jnp.asarray(np.array([0.25, 0.75], np.float32))
    out16, inter = jax.jit(lambda p, x, t: unet.apply(
        {"params": p}, x, t, capture_intermediates=True, mutable=["intermediates"]))(
            variables["params"]["model"], x, t)
    inter = inter["intermediates"]
    assert inter["head_0"]["conv1"]["__call__"][0].dtype == jnp.bfloat16
    assert inter["head_0"]["skip"]["__call__"][0].dtype == jnp.bfloat16
    for path in (("head_0", "conv2"), ("down_3_1", "conv1"), ("up_2_2", "conv2"),
                 ("tail_2", "conv2")):
        assert inter[path[0]][path[1]]["__call__"][0].dtype == jnp.float32, path
    ref = np.asarray(jax.jit(jm.apply)(variables, x, t))

    port16 = create_model_from_config(cfg, "cpu")
    port16.load_state_dict(port.state_dict())
    dtypes = []
    for m in port16.modules():
        if isinstance(m, tdance.Conv1d):
            m.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
    with torch.no_grad():
        got16 = port16(_t(np.asarray(x)), _t(np.asarray(t)))
    assert got16.dtype == torch.float32 and set(dtypes) == {torch.bfloat16}
    peak = np.abs(ref).max()
    jax_err = np.abs(np.asarray(out16) - ref).max() / peak
    port_err = np.abs(got16.numpy() - ref).max() / peak
    apart = np.abs(got16.numpy() - np.asarray(out16)).max() / peak
    assert jax_err < port_err <= 0.05 and apart <= 0.05, (jax_err, port_err, apart)


# -- the training entry --------------------------------------------------------


def test_train_entry_trains_checkpoints_and_reloads_on_the_cpu(tmp_path):
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav
    from stable_audio_tools_tpu_torch.io.checkpoints import load_training_state

    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "wavs")
    for i, n in enumerate((100, 140, 90, 200)):
        save_wav(str(tmp_path / "wavs" / f"{i}.wav"), 0.3 * rng.standard_normal((2, n)), 16000)
    (tmp_path / "model.json").write_text(json.dumps(TINY))
    (tmp_path / "data.json").write_text(json.dumps({
        "dataset_type": "audio_dir", "random_crop": False,
        "datasets": [{"id": "w", "path": str(tmp_path / "wavs")}]}))
    argv = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--max-steps", "2", "--save-dir", str(tmp_path / "run"), "--device", "cpu",
            "--precision", "32"]
    trainer = train.main(argv)
    w = trainer.wrapper
    assert isinstance(w, ttrain.DiffusionUncondTrainer) and w.step == 2
    assert w.model.model.compute_dtype == torch.float32  # --precision 32 where the config sets none
    assert [h["step"] for h in trainer.history] == [1, 2]
    assert all(np.isfinite(h["train/loss"]) for h in trainer.history)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in w.params.values())
    fresh = train.build(train.parse_args(argv))[0].wrapper
    load_training_state(str(tmp_path / "run" / "step=2.ckpt"), fresh)
    assert fresh.step == 2
    for name, p in w.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], p), name
    for name, e in w.ema.items():
        assert torch.equal(fresh.ema[name], e), name
