"""Rectified flow in the port against the JAX package on the CPU: the t grid
and the timestep shift, the four flow samplers, the JAX behaviour the port
copies (the shift reaching rk4 alone, dpmpp-3m-sde turning into euler),
generation and inpainting generation under `rectified_flow` and
`rf_denoiser`, the preview taps, cfg++ on a conditioned DiT, and the DiT's
`return_info`, `exit_layer_ix` and flow-objective CFG interval.

The model is a tiny rf DiT (depth 2, width 16, 2 heads, a number
conditioner as its cross-attention tokens: the `RF_DIT_CONFIG` of
tests/test_arc.py) with seeded numpy weights, carried into the port by
io/from_jax.py; the JAX package's noise is replayed into the port. Each
tolerance is stated where it is used.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.inference import generation as jgen
from stable_audio_tools_tpu.inference import sampling as jsamp
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu_torch.inference import generation as tgen
from stable_audio_tools_tpu_torch.inference import sampling as tsamp
from stable_audio_tools_tpu_torch.io.from_jax import diffusion_cond_state_dict
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

SHIFT = {"base_shift": 0.5, "max_shift": 1.15, "min_length": 256, "max_length": 4096}
RF_DIT_CONFIG = {
    "model_type": "diffusion_cond",
    "sample_size": 32,
    "sample_rate": 16000,
    "audio_channels": 2,
    "model": {
        "conditioning": {
            "configs": [{"id": "prompt_num", "type": "number",
                         "config": {"min_val": 0, "max_val": 1}}],
            "cond_dim": 16,
        },
        "diffusion": {
            "cross_attention_cond_ids": ["prompt_num"],
            "type": "dit",
            "diffusion_objective": "rectified_flow",
            "distribution_shift_options": SHIFT,
            "config": {"io_channels": 2, "embed_dim": 16, "depth": 2,
                       "num_heads": 2, "cond_token_dim": 16,
                       "use_checkpointing": False},
        },
        "io_channels": 2,
    },
}
META = [{"prompt_num": 0.3}, {"prompt_num": 0.7}]
T = 32
SEED = 5


def rf_config(objective="rectified_flow", inpaint=False, shift=SHIFT):
    config = copy.deepcopy(RF_DIT_CONFIG)
    diffusion = config["model"]["diffusion"]
    diffusion["diffusion_objective"] = objective
    diffusion["distribution_shift_options"] = shift
    if inpaint:
        config["model_type"] = "diffusion_cond_inpaint"
        diffusion["config"]["input_concat_dim"] = 3  # masked latents + the mask
    return config


def init_params(model, config, seed=0):
    """Seeded numpy parameters for the JAX model's shapes (traced with
    eval_shape): kernels ~ N(0, 1/fan_in), Fourier tables ~ N(0, 1), norm
    scales ~ 1 + N(0, 0.1), biases ~ N(0, 0.1). The zero-initialised pre /
    post convs get weights too, so the whole network shapes the output."""
    ch = config["model"]["io_channels"] + config["model"]["diffusion"]["config"].get(
        "input_concat_dim", 0)
    prepared = jax.tree_util.tree_map(
        jnp.asarray, model._multi_conditioner.gather_inputs(META))
    kw = {}
    if config["model"]["diffusion"]["config"].get("input_concat_dim"):
        kw["input_concat_cond"] = jnp.zeros((2, ch - 2, T))
    shapes = jax.eval_shape(lambda x, t: model.init(
        {"params": jax.random.PRNGKey(0), "cfg": jax.random.PRNGKey(1)}, x, t, cond=prepared,
        **kw), jnp.zeros((2, 2, T)), jnp.ones((2,)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if len(a.shape) >= 2:
            std = 1.0 if name == "weights" else np.prod(a.shape[:-1]) ** -0.5
        elif name == "gamma":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        else:
            std = 1.0 if name == "weights" else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def make_pair(config, params=None):
    """(JAX model, its variables, the port's model with the same weights)."""
    model = jax_create(config)
    params = init_params(model, config) if params is None else params
    port = create_model_from_config(config, "cpu")
    sd = diffusion_cond_state_dict(params, dim_heads=8)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model, {"params": params}, port.eval()


@pytest.fixture(scope="module")
def rf_pair():
    return make_pair(rf_config())


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def replayed_noise(shape, seed=SEED):
    """The JAX generation's noise for `seed`: the initial noise from
    fold_in(key, 0), pingpong's step i noise from fold_in(fold_in(key, 1), i),
    both in [B, C, T] (sample_rf runs in that layout)."""
    key = jax.random.PRNGKey(seed)
    noise = _t(jax.random.normal(jax.random.fold_in(key, 0), shape))
    sampler_key = jax.random.fold_in(key, 1)

    def step_noise(i, x):
        return _t(jax.random.normal(jax.random.fold_in(sampler_key, i), tuple(x.shape)))

    return noise, step_noise


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


# -- the t grid and the shift ----------------------------------------------------


@pytest.mark.parametrize("steps,sigma_max", [(8, 1.0), (50, 1.0), (10, 0.7)])
def test_rf_schedule_matches_jax(steps, sigma_max):
    np.testing.assert_array_equal(tsamp.get_rf_schedule(steps, sigma_max),
                                  jsamp.get_rf_schedule(steps, sigma_max))


@pytest.mark.parametrize("use_sine", [False, True])
@pytest.mark.parametrize("seq_len", [64, 1024, 8192])
def test_distribution_shift_matches_jax(use_sine, seq_len):
    # the numpy schedule with t[0] = 1 (1 / (1 - 1) is silenced, t = 1 stays
    # 1): equal arrays; a torch tensor of drawn t: within f32 rounding
    kw = dict(SHIFT, use_sine=use_sine)
    grid = np.linspace(1.0, 0, 9).astype(np.float32)
    want = jsamp.DistributionShift(**kw).time_shift(grid, seq_len)
    got = tsamp.DistributionShift(**kw).time_shift(grid, seq_len)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0] == (1.0 if not use_sine else np.sin(np.pi / 2).astype(np.float32))
    t = np.random.default_rng(0).uniform(0.01, 0.99, 16).astype(np.float32)
    np.testing.assert_allclose(
        tsamp.DistributionShift(**kw).time_shift(_t(t), seq_len).numpy(),
        np.asarray(jsamp.DistributionShift(**kw).time_shift(jnp.asarray(t), seq_len)),
        rtol=1e-6, atol=1e-7)


# -- the samplers on the tiny rf DiT -----------------------------------------------


def _model_fns(rf_pair, cfg_scale):
    model, variables, port = rf_pair
    prepared = jax.tree_util.tree_map(jnp.asarray,
                                      model._multi_conditioner.gather_inputs(META))
    ct = model.apply(variables, prepared, method=model.run_conditioner)
    with torch.no_grad():
        cond = port.get_conditioning_inputs(port.conditioner(META, "cpu"))

    def jax_fn(x, t, **kw):
        return model.apply(variables, x, t, cond_tensors=ct, cfg_scale=cfg_scale, **kw)

    def torch_fn(x, t, **kw):
        return port(x, t, cfg_scale=cfg_scale, **cond, **kw)

    return jax_fn, torch_fn


@pytest.mark.parametrize("sampler", ["euler", "rk4", "dpmpp", "pingpong"])
@pytest.mark.parametrize("with_init", [False, True])
def test_flow_samplers_match_jax(rf_pair, sampler, with_init):
    # sample_rf over the DiT (CFG 3, the shift handed in): the JAX sampler
    # scans in f32, the port's loop takes its step sizes in float64; 6 steps
    # through 2 blocks (4 calls a step for rk4): 1e-4 of the result's peak
    jax_fn, torch_fn = _model_fns(rf_pair, 3.0)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((2, 2, T)).astype(np.float32)
    init = rng.standard_normal((2, 2, T)).astype(np.float32) if with_init else None
    key = jax.random.PRNGKey(3)
    kw = dict(steps=6, sampler_type=sampler, sigma_max=0.8 if with_init else 1.0)
    want = np.asarray(jsamp.sample_rf(
        jax_fn, jnp.asarray(noise), init_data=None if init is None else jnp.asarray(init),
        rng=key, dist_shift=jsamp.DistributionShift(**SHIFT), **kw))
    with torch.no_grad():
        got = tsamp.sample_rf(
            torch_fn, _t(noise), init_data=None if init is None else _t(init),
            step_noise=lambda i, x: _t(jax.random.normal(jax.random.fold_in(key, i), x.shape)),
            dist_shift=tsamp.DistributionShift(**SHIFT), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_shift_reaches_rk4_alone_as_in_jax():
    # a JAX fault the port copies: sample_rf hands euler, dpmpp and pingpong
    # the rf schedule, so their dist_shift is never read; rk4 runs on the even
    # grid and shifts it. Pinned on both packages with a closed-form flow.
    noise = np.random.default_rng(2).standard_normal((1, 2, 300)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    def jax_v(x, t):
        return 0.4 * x * jnp.cos(t)[:, None, None] + 0.1 * jnp.sin(x)

    def torch_v(x, t):
        return 0.4 * x * torch.cos(t)[:, None, None] + 0.1 * torch.sin(x)

    step_noise = lambda i, x: _t(jax.random.normal(jax.random.fold_in(key, i), x.shape))
    for sampler in ("euler", "rk4", "dpmpp", "pingpong"):
        runs = {}
        for shift in (None, SHIFT):
            want = np.asarray(jsamp.sample_rf(
                jax_v, jnp.asarray(noise), steps=5, sampler_type=sampler, rng=key,
                dist_shift=None if shift is None else jsamp.DistributionShift(**shift)))
            got = tsamp.sample_rf(
                torch_v, _t(noise), steps=5, sampler_type=sampler, step_noise=step_noise,
                dist_shift=None if shift is None else tsamp.DistributionShift(**shift)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
            runs[shift is None] = (want, got)
        moved = [not np.array_equal(runs[True][i], runs[False][i]) for i in (0, 1)]
        assert moved == [sampler == "rk4"] * 2, sampler


# -- generation ------------------------------------------------------------------------


GEN_CASES = [  # the JAX UI's defaults for each objective (interface/gradio.py:323-324)
    ("rf_denoiser", "pingpong", 8, 1.0),
    ("rectified_flow", "euler", 50, 7.0),
    ("rectified_flow", "rk4", 4, 7.0),
    ("rectified_flow", "dpmpp", 4, 7.0),
    ("rectified_flow", "dpmpp-3m-sde", 6, 7.0),  # turned into euler under a flow objective
]


@pytest.fixture(scope="module")
def objective_pairs(rf_pair):
    params = rf_pair[1]["params"]
    return {"rectified_flow": rf_pair,
            "rf_denoiser": make_pair(rf_config("rf_denoiser"), params)}


@pytest.mark.parametrize("objective,sampler,steps,cfg_scale", GEN_CASES)
def test_generate_diffusion_cond_matches_jax(objective_pairs, objective, sampler, steps,
                                             cfg_scale):
    # the latents of a 2-item batch with the model's shift: f32, the same
    # weights and noise; up to 50 steps of CFG through 2 blocks: 2e-4 of the
    # peak
    model, variables, port = objective_pairs[objective]
    kw = dict(steps=steps, cfg_scale=cfg_scale, conditioning=META, batch_size=2,
              sample_size=T, seed=SEED, sampler_type=sampler, return_latents=True)
    want = np.asarray(jgen.generate_diffusion_cond(model, variables, **kw))
    noise, step_noise = replayed_noise((2, 2, T))
    got = tgen.generate_diffusion_cond(port, noise=noise, step_noise=step_noise, **kw).numpy()
    assert got.shape == want.shape == (2, 2, T) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())
    if sampler == "dpmpp-3m-sde":  # the port samples it as euler, as JAX does
        euler = tgen.generate_diffusion_cond(port, noise=noise, **dict(kw, sampler_type="euler"))
        assert torch.equal(torch.from_numpy(got), euler)


def test_empty_shift_options_mean_no_shift(rf_pair):
    # JAX tests the dict's truth: {} builds no DistributionShift, as None
    assert tgen._get_dist_shift(rf_pair[2]) is not None
    for options in ({}, None):
        port = copy.copy(rf_pair[2])
        port.distribution_shift_options = options
        assert tgen._get_dist_shift(port) is None and jgen._get_dist_shift(
            rf_pair[0].clone(distribution_shift_options=options), T) is None


@pytest.fixture(scope="module")
def inpaint_pairs():
    params = None
    out = {}
    for objective in ("rectified_flow", "rf_denoiser"):
        out[objective] = make_pair(rf_config(objective, inpaint=True), params)
        params = out[objective][1]["params"]
    return out


@pytest.mark.parametrize("objective,sampler,cfg_scale", [("rf_denoiser", "pingpong", 1.0),
                                                         ("rectified_flow", "euler", 7.0)])
def test_generate_inpaint_matches_jax(inpaint_pairs, objective, sampler, cfg_scale):
    # inpainting: the latents (no pretransform here) masked by build_mask and
    # joined with the mask on the channel axis at every step; 2e-4 of the peak
    model, variables, port = inpaint_pairs[objective]
    audio = np.random.default_rng(4).standard_normal((2, 2, T)).astype(np.float32)
    kw = dict(steps=8, cfg_scale=cfg_scale, conditioning=META, batch_size=2, sample_size=T,
              seed=SEED, sampler_type=sampler, init_audio=(16000, audio),
              mask_args={"maskstart": 8, "maskend": 20, "softnessL": 0.1})
    want = np.asarray(jgen.generate_diffusion_cond_inpaint(model, variables, **kw))
    noise, step_noise = replayed_noise((2, 2, T))
    got = tgen.generate_diffusion_cond_inpaint(port, noise=noise, step_noise=step_noise,
                                               **kw).numpy()
    assert got.shape == want.shape == (2, 2, T) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("objective,sampler", [("rf_denoiser", "pingpong"),
                                               ("rectified_flow", "rk4"),
                                               ("v", "dpmpp-2m"), ("v", "v-ddim")])
def test_preview_matches_the_jax_tap(objective_pairs, rf_pair, objective, sampler):
    # preview=True: every model call's (denoised, sigma), in order, against
    # the JAX package's io_callback tap; 2e-4 of each estimate's peak, the
    # sigmas within f32 rounding (the v-DDIM label is tan of t near 1)
    if objective == "v":
        pair = make_pair(rf_config("v"), rf_pair[1]["params"])
    else:
        pair = objective_pairs[objective]
    model, variables, port = pair
    kw = dict(steps=4, cfg_scale=3.0, conditioning=META, batch_size=2, sample_size=T,
              seed=SEED, sampler_type=sampler, sigma_min=0.3, sigma_max=20.0,
              return_latents=True, preview=True)
    jgen.generate_diffusion_cond(model, variables, **kw)
    want = list(model._preview_buffer)
    noise, step_noise = replayed_noise((2, 2, T))
    if objective == "v":  # the k-diffusion SDE noise is drawn in [B, T, C]
        step_noise = None
    tgen.generate_diffusion_cond(port, noise=noise, step_noise=step_noise, **kw)
    got = port._preview_buffer
    assert len(got) == len(want) == {"rk4": 16}.get(sampler, 4)
    for (gd, gs), (wd, ws) in zip(got, want):
        assert gd.shape == wd.shape == (2, 2, T)
        np.testing.assert_allclose(gd, wd, atol=2e-4 * np.abs(wd).max())
        assert gs == pytest.approx(ws, rel=1e-5)
    tgen.generate_diffusion_cond(port, noise=noise, step_noise=step_noise,
                                 **dict(kw, steps=2))
    assert len(port._preview_buffer) == {"rk4": 8}.get(sampler, 2)  # emptied per call


# -- cfg++ ----------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_interval", [(0.0, 1.0), (0.2, 0.6)])
def test_cfgpp_on_a_conditioned_dit_matches_jax(rf_pair, cfg_interval):
    # JAX runs v-ddim-cfgpp on a diffusion_cond DiT (its wrapper passes
    # return_info through, the DiT returns (output, info)), so the port runs
    # it too: the step's noise from the unguided half. 8 steps, CFG 4: 2e-4
    model, variables, port = make_pair(rf_config("v"), rf_pair[1]["params"])
    kw = dict(steps=8, cfg_scale=4.0, conditioning=META, batch_size=2, sample_size=T,
              seed=SEED, sampler_type="v-ddim-cfgpp", return_latents=True,
              cfg_interval=cfg_interval)
    want = np.asarray(jgen.generate_diffusion_cond(model, variables, **kw))
    noise, _ = replayed_noise((2, 2, T))
    got = tgen.generate_diffusion_cond(port, noise=noise, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())
    plain = tgen.generate_diffusion_cond(port, noise=noise,
                                         **dict(kw, sampler_type="v-ddim")).numpy()
    assert _rel(plain, got) > 1e-3  # cfg++ is not plain v-DDIM here


# -- the DiT ---------------------------------------------------------------------------


def _dit_inputs(rf_pair, seed=6):
    model, variables, port = rf_pair
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    t = np.array([0.5, 0.5], np.float32)
    prepared = jax.tree_util.tree_map(jnp.asarray,
                                      model._multi_conditioner.gather_inputs(META))
    ct = model.apply(variables, prepared, method=model.run_conditioner)
    with torch.no_grad():
        cond = port.get_conditioning_inputs(port.conditioner(META, "cpu"))
    return x, t, ct, cond


@pytest.mark.parametrize("exit_layer_ix", [-1, 0, 1])
def test_dit_exit_layer_matches_jax(rf_pair, exit_layer_ix):
    # the transformer's output at the exit, prepended token kept: io_channels
    # wide after project_out at -1 (no block has that index), embed_dim wide
    # at a block's index; CFG is skipped. 1e-5 of the peak (f32)
    model, variables, port = rf_pair
    x, t, ct, cond = _dit_inputs(rf_pair)
    want = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(t), cond_tensors=ct,
                                  cfg_scale=3.0, exit_layer_ix=exit_layer_ix))
    with torch.no_grad():
        got = port(_t(x), _t(t), cfg_scale=3.0, exit_layer_ix=exit_layer_ix, **cond).numpy()
    assert got.shape == want.shape == (2, 1 + T, 2 if exit_layer_ix == -1 else 16)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_dit_return_info_matches_jax(rf_pair, cfg_scale):
    # (output, info): the blocks' hidden states (the CFG pass's doubled batch
    # under CFG) and the unguided half; 1e-5 of each peak
    model, variables, port = rf_pair
    x, t, ct, cond = _dit_inputs(rf_pair)
    out, info = model.apply(variables, jnp.asarray(x), jnp.asarray(t), cond_tensors=ct,
                            cfg_scale=cfg_scale, return_info=True)
    with torch.no_grad():
        got, got_info = port(_t(x), _t(t), cfg_scale=cfg_scale, return_info=True, **cond)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5 * np.abs(out).max())
    assert sorted(got_info) == sorted(info)
    assert ("uncond_output" in got_info) == (cfg_scale != 1.0)
    for key, want in info.items():
        wants = want if isinstance(want, list) else [want]
        gots = got_info[key] if isinstance(want, list) else [got_info[key]]
        assert len(gots) == len(wants) == (2 if key == "hidden_states" else 1)
        for g, w in zip(gots, wants):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("objective", ["rectified_flow", "v"])
@pytest.mark.parametrize("return_info", [False, True])
def test_dit_cfg_interval_gates_on_the_objectives_sigma(rf_pair, objective, return_info):
    # at t = 0.5 with the interval (0.3, 0.6): a flow model's sigma is t =
    # 0.5, inside (guided); a v-model's is sin(pi / 4) = 0.71, outside (the
    # conditional output); with return_info JAX runs the doubled batch either
    # way and selects. 1e-5 of the peak
    model, variables, port = (rf_pair if objective == "rectified_flow"
                              else make_pair(rf_config("v"), rf_pair[1]["params"]))
    x, t, ct, cond = _dit_inputs(rf_pair)
    kw = dict(cfg_scale=3.0, cfg_interval=(0.3, 0.6), return_info=return_info)
    want = model.apply(variables, jnp.asarray(x), jnp.asarray(t), cond_tensors=ct, **kw)
    with torch.no_grad():
        got = port(_t(x), _t(t), **kw, **cond)
        single = port(_t(x), _t(t), **cond)
    if return_info:
        want, got = want[0], got[0]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    assert (_rel(single, got) < 1e-5) == (objective == "v")
