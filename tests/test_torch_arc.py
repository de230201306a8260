"""ARC post-training in the port against the JAX package on the CPU: the
discriminator heads and the ConvNeXt trunk, one ODE warm-up step, one
discriminator step and one generator step of `ARCTrainer` on the tiny rf DiT
of test_torch_rf.py with every JAX draw replayed into the port (losses, aux
keys, every updated parameter and the EMA), `_maybe_trim`'s lengths, and the
training entry's refusal of `arc`, whose reason (the JAX entry cannot call
the trainer) is pinned on the JAX package. Each tolerance is stated where it
is used.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import arc as jarc
from stable_audio_tools_tpu.models import convnext as jconvnext
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu.training.arc import ARCTrainer as JaxARCTrainer
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import arc as tarc
from stable_audio_tools_tpu_torch.models import convnext as tconvnext
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training.arc import ARCTrainer
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from test_torch_rf import META, T, _t, init_params, rf_config


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)


def _init(module, x, seed=0):
    """Flax params of `module` on x, with every leaf redrawn from a seeded
    numpy normal (std 1/sqrt(fan_in) for kernels, 0.3 otherwise around the
    init's scale of 1 for norm scales and weight-norm g), so zero-initialised
    layers take part."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name in ("scale", "g"):
            return (1 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        std = np.prod(a.shape[:-1]) ** -0.5 if a.ndim >= 2 else 0.3
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


# -- the heads ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("N", [33, 1025])
def test_conv_discriminator_matches_jax(dtype, tol, N):
    # hidden states [B, N, 24] into 4 strided convs + GroupNorm (flax's eps,
    # f32 out) + SiLU and the 1-channel conv with "same" padding (one zero
    # ahead, two behind: an asymmetric kernel pins the split). f32: 1e-5 of
    # the peak; bf16 hidden states (the first conv in bf16): 3e-2
    x = np.random.default_rng(0).standard_normal((2, N, 24)).astype(np.float32)
    head = jarc.ConvDiscriminator(channels=16)
    params = _init(head, jnp.asarray(x))
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x, dtype)), np.float32)
    port = tarc.ConvDiscriminator(24, 16)
    _load(port, from_jax.arc_head_state_dict(params))
    with torch.no_grad():
        got = port(_t(x).to(torch.bfloat16 if dtype != np.float32 else torch.float32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol * np.abs(want).max())
    assert port.norms[0].eps == 1e-6 and port.norms[0].num_groups == 16


def test_convnext_block_matches_jax():
    # depthwise conv, weight-normalised up-projection, tanh-GELU (jax.nn.gelu's
    # default), down-projection, residual: 1e-5 of the peak
    x = np.random.default_rng(1).standard_normal((2, 40, 12)).astype(np.float32)
    block = jconvnext.ConvNeXtBlock(12)
    params = _init(block, jnp.asarray(x), seed=2)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    port = tconvnext.ConvNeXtBlock(12)
    sd = from_jax.convnext_encoder_state_dict(
        {"conv_in": params["proj_up"], "conv_out": params["proj_up"],
         "stage_0": {"block_0": params, "downsample": params["proj_up"]}})
    _load(port, {k[len("stages.0.blocks.0."):]: v for k, v in sd.items()
                 if k.startswith("stages.0.blocks.0.")})
    with torch.no_grad():
        got = port(_t(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("stride,T", [(2, 41), (4, 40), (8, 35)])
def test_convnext_encoder_block_matches_jax(stride, T):
    # three blocks, then the strided weight-normalised conv (k = 2 x stride,
    # padding ceil(stride / 2)) at the head's strides, on lengths that do
    # and do not divide: the output length and 1e-5 of the peak
    x = np.random.default_rng(6).standard_normal((2, T, 8)).astype(np.float32)
    stage = jconvnext.ConvNeXtEncoderBlock(out_channels=12, stride=stride)
    params = _init(stage, jnp.asarray(x), seed=stride)
    want = np.asarray(stage.apply({"params": params}, jnp.asarray(x)))
    port = tconvnext.ConvNeXtEncoderBlock(8, 12, stride)
    sd = from_jax.convnext_encoder_state_dict(
        {"conv_in": params["downsample"], "conv_out": params["downsample"], "stage_0": params})
    _load(port, {k[len("stages.0."):]: v for k, v in sd.items() if k.startswith("stages.0.")})
    with torch.no_grad():
        got = port(_t(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, (T + 2 * -(-stride // 2) - 2 * stride) // stride + 1, 12)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_convnext_discriminator_matches_jax():
    # the ConvNeXt head as ARC builds it (the JAX head's defaults: conv_in to
    # 128 channels, stages of 3 blocks at 128 / 128 / 256 / 512 and strided
    # convs to 128 / 256 / 512 / 1024, conv_out to 1) over 1025 hidden states
    # (SA-Open's 1 + 1024) of 24 channels: 1e-4 of the peak (f32 through 32
    # convs)
    x = np.random.default_rng(3).standard_normal((2, 1025, 24)).astype(np.float32)
    head = jarc.ConvNeXtDiscriminator()
    params = _init(head, jnp.asarray(x), seed=4)
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x)))
    port = tarc.ConvNeXtDiscriminator(24)
    _load(port, from_jax.arc_head_state_dict(params))
    assert [s.blocks[0].dw_conv.shape[0] for s in port.encoder.stages] == [128, 128, 256, 512]
    assert port.encoder.conv_out.weight_v.shape[1] == 1024
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == want.shape == (2, 1, 2)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_relativistic_losses_match_jax():
    rng = np.random.default_rng(5)
    real, fake = rng.standard_normal((2, 3, 7, 1)).astype(np.float32)
    for got, want in zip(tarc.get_relativistic_losses(_t(real), _t(fake)),
                         jarc.get_relativistic_losses(jnp.asarray(real), jnp.asarray(fake))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the trainer ---------------------------------------------------------------------


ARC_CONFIG = {"ode_warmup": {"warmup_steps": 1, "refresh_rate": 1, "n_sampling_steps": 4,
                             "cfg_scale": 2.0},
              "gan": {"grad_penalties": True, "contrastive": True}}
SGD = {"optimizer": {"type": "SGD", "config": {"lr": 1e-2}}}
B = 2


def _cond(model, variables, meta):
    prepared = jax.tree_util.tree_map(jnp.asarray,
                                      model._multi_conditioner.gather_inputs(meta))
    return model.apply(variables, prepared, method=model.run_conditioner)


@pytest.fixture(scope="module", params=[-1, 0])
def arc_pair(request):
    """A JAX ARCTrainer and its state and the port's trainer with the same
    weights, the discriminator exiting at `request.param`."""
    config = rf_config()
    arc_config = copy.deepcopy(ARC_CONFIG)
    arc_config["gan"]["discriminator_dit_layer"] = request.param
    student, disc = jax_create(config), jax_create(config)
    gen_params, disc_params = init_params(student, config, 0), init_params(disc, config, 1)
    latents = np.random.default_rng(7).standard_normal((B, 2, T)).astype(np.float32)
    jtrainer = JaxARCTrainer(model=student, discriminator=disc, arc_config=arc_config,
                             optimizer_configs={"diffusion": SGD, "discriminator": SGD})
    state = jtrainer.init_state({"params": gen_params}, {"params": disc_params},
                                jnp.asarray(latents))
    state = jax.tree_util.tree_map(np.asarray, state)
    port_student = create_model_from_config(config, "cpu")
    port_disc = create_model_from_config(config, "cpu")
    trainer = ARCTrainer(port_student, port_disc, arc_config,
                         {"diffusion": SGD, "discriminator": SGD})
    sds = from_jax.arc_state_dicts(state, dim_heads=8)
    _load(port_student, sds["model"])
    _load(port_disc, sds["discriminator"])
    _load(trainer.head, sds["head"])
    for n, e in trainer.ema.items():
        e.copy_(torch.from_numpy(np.array(sds["ema"][n])))
    return jtrainer, state, trainer, latents, student, {"params": gen_params}


def _jax_draws(rng, kind, shape):
    """The draws JAX's ODE / generator / discriminator step takes from rng."""
    fold = lambda i: jax.random.fold_in(rng, i)
    normal = lambda k: _t(jax.random.normal(k, shape))
    uniform = lambda k: _t(jax.random.uniform(k, (B,)))
    if kind == "ode":
        return {"ode_noise": normal(fold(777)),
                "ixs": torch.from_numpy(np.array(jax.random.randint(rng, (B,), 0, 4)))}
    if kind == "gen":
        return {"t": uniform(fold(0)), "noise": normal(fold(1)), "t_gan": uniform(fold(3)),
                "gan_noise": normal(fold(4))}
    return {"t": uniform(fold(0)), "noise": normal(fold(1)), "t_gan": uniform(fold(2)),
            "gan_noise": normal(fold(3)), "gp_noise_real": normal(fold(4)),
            "gp_noise_fake": normal(fold(5))}


def test_arc_steps_match_jax(arc_pair):
    # an ODE step (the teacher's 4-step DPM++ trajectory at cfg 2 on the
    # student's weights, refreshed), a generator step (through the frozen
    # discriminator) and a discriminator step (R1/R2 by input noise, the
    # contrastive term on rolled prompts), SGD at lr 1e-2. Bounds (f32 through
    # the DiT pair and the head): the ODE step's loss 1e-4 relative, each
    # parameter's change (from the port's own state before the step) 1e-3 of
    # the largest change in its module (student, discriminator or head; SGD:
    # -lr x gradient). The GAN steps' gradients pass
    # through both DiTs and the tiny head, whose GroupNorms of one channel
    # over 16 or fewer steps are ill-conditioned, and the discriminator's
    # R1/R2 square the difference of two nearly equal scores. Against the
    # port run in f64, the JAX package's f32 changes are off by up to 1.5e-2
    # (generator) and 2.4e-2 (discriminator) of the largest at exit layer 0,
    # 9.4e-4 and 1.7e-3 at -1; the port's f32 by 4.5e-3 and 1.4e-3 at most.
    # There the losses and aux values 1e-3 relative (1e-4 absolute: a mean
    # of scores can sit near 0) and the changes 3e-2.
    # Every parameter, the head's, plus 4 ulps of the parameter; the EMA
    # within 1e-6
    jtrainer, state, trainer, latents, student, gen_vars = arc_pair
    cond = _cond(student, gen_vars, META)
    rolled = _cond(student, gen_vars, META[::-1])
    with torch.no_grad():
        port_cond = trainer.model.conditioner(META, "cpu")
        port_rolled = trainer.model.conditioner(META[::-1], "cpu")
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    want_keys = {"ode": {"ode_mse_loss", "loss"},
                 "disc": {"loss_dis", "disc_real_scores_mean", "disc_fake_scores_mean",
                          "grad_penalty_loss", "contrastive_loss_dis", "loss"},
                 "gen": {"loss", "adv_loss", "gen_disc_scores_mean"}}
    modules = (("model", trainer.model), ("discriminator", trainer.discriminator),
               ("head", trainer.head))
    # the discriminator step last: its R1/R2 gradients carry the largest
    # differences, which the next step's losses would read through the
    # discriminator's weights
    for step, kind in ((0, "ode"), (2, "gen"), (3, "disc")):
        before = from_jax.arc_state_dicts(jax.tree_util.tree_map(np.asarray, jstate), 8)
        port_before = {part: {n: v.clone() for n, v in m.state_dict().items()}
                       for part, m in modules}
        rng = jax.random.PRNGKey(100 + step)
        jstate, aux = jtrainer.train_step(jstate, jnp.asarray(latents), cond, rng, step,
                                          rolled_cond_tensors=rolled)
        got = trainer.train_step(_t(latents), port_cond, step=step,
                                 rolled_cond_tensors=port_rolled,
                                 draws=_jax_draws(rng, kind, latents.shape))
        assert set(got) == set(aux) == want_keys[kind], kind
        for k in aux:
            np.testing.assert_allclose(float(got[k]), float(aux[k]),
                                       rtol=1e-4 if kind == "ode" else 1e-3,
                                       atol=1e-7 if kind == "ode" else 1e-4,
                                       err_msg=f"{kind} {k}")
        after = from_jax.arc_state_dicts(jax.tree_util.tree_map(np.asarray, jstate), 8)
        moved = 0
        for part, module in modules:
            sd = module.state_dict()
            deltas = {n: (want - before[part][n], (sd[n] - port_before[part][n]).numpy())
                      for n, want in after[part].items()}
            scale = max(np.abs(dw).max() for dw, _ in deltas.values())
            tol = 1e-3 if kind == "ode" else 3e-2
            for n, (delta_want, delta_got) in deltas.items():
                ulps = 4 * np.spacing(np.abs(before[part][n]))  # the f32 update's rounding
                assert (np.abs(delta_got - delta_want) <= tol * scale + ulps).all(), (
                    kind, part, n)
                moved += np.abs(delta_want).max() > 1e-6 * scale
        assert moved > 10, kind
        for n, e in trainer.ema.items():
            np.testing.assert_allclose(e.numpy(), after["ema"][n], atol=1e-6, err_msg=n)
    assert trainer.step == 3 and int(jstate.step) == 3


def test_arc_head_takes_the_hidden_states_width(arc_pair):
    # exit layer -1: the DiT's io_channels (2) after project_out; a block's
    # index: embed_dim (16). The head's own width is embed_dim either way.
    trainer = arc_pair[2]
    layer = trainer.discriminator_dit_layer
    assert trainer.head.convs[0].in_channels == (2 if layer == -1 else 16)
    assert trainer.head.convs[0].out_channels == 16


def test_maybe_trim_gives_jax_lengths(arc_pair):
    # the random trim with its bucket rounding: the same lengths from the
    # same numpy generator (seeded with the step), with and without masks
    jtrainer, _, trainer, _, _, _ = arc_pair
    cfg = {"trim_prob": 0.7, "type": "random_item", "bucket_multiple": 8}
    for tr in (jtrainer, trainer):
        tr.trim_config = cfg
        tr.trim_prob, tr.trim_type, tr.trim_bucket = 0.7, "random_item", 8
    try:
        big = np.zeros((2, 2, 512), np.float32)
        rng = np.random.default_rng(8)
        lengths = []
        for step in range(40):
            masks = None
            if step % 3:
                masks = (np.arange(512)[None] < rng.integers(100, 512, (2, 1))).astype(bool)
            want = jtrainer._maybe_trim(jnp.asarray(big), masks, step).shape[-1]
            got = trainer._maybe_trim(_t(big), None if masks is None else torch.from_numpy(
                masks), step).shape[-1]
            assert got == want, step
            lengths.append(got)
        assert len(set(lengths)) > 3 and all(n % 8 == 0 or n == 512 for n in lengths)
    finally:
        for tr in (jtrainer, trainer):
            tr.trim_config = None


def test_factory_builds_arc_and_the_train_entry_refuses_it(tmp_path):
    # the factory's `arc` branch builds the trainer (the discriminator a copy
    # of the student, the teacher the student's weights); the training entry
    # refuses it, as the JAX entry cannot call it: its init_state and
    # train_step do not take the arguments train.py and the Trainer pass
    from stable_audio_tools_tpu_torch import train
    from test_torch_train_entry import write_run_inputs

    config = rf_config()
    config["training"] = {"learning_rate": 1e-5, "arc": ARC_CONFIG}
    port = create_model_from_config(config, "cpu")
    trainer = create_training_wrapper_from_config(config, port)
    assert isinstance(trainer, ARCTrainer) and trainer.teacher_model is None
    assert trainer.cfg_dropout_prob == 0.1 and trainer.ode_warmup_steps == 1
    assert trainer.discriminator is not port and all(
        torch.equal(a, b) for a, b in zip(port.state_dict().values(),
                                          trainer.discriminator.state_dict().values()))
    assert type(trainer.optimizer).__name__ == "AdamW"

    obj = object.__new__(JaxARCTrainer)
    with pytest.raises(TypeError):  # train.py:233
        inspect.signature(JaxARCTrainer.init_state).bind(obj, {"params": {}})
    with pytest.raises(TypeError):  # training/trainer.py:228
        inspect.signature(JaxARCTrainer.train_step).bind(obj, None, None, None, 0)
    argv = write_run_inputs(str(tmp_path), config) + ["--save-dir", str(tmp_path / "run")]
    with pytest.raises(NotImplementedError, match="arc"):
        train.main(argv)
