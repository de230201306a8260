"""Autoencoder GAN training of the port against the JAX package on the CPU: a
tiny SA-2.0-VAE-shaped model (Oobleck with snakes, VAE bottleneck) and a tiny
EnCodec discriminator with the same weights (carried over by io/from_jax.py),
the same batch and the same VAE noise, through one generator step and one
discriminator step of each package's AutoencoderTrainer, in f32. Then the
factory on the shipped SA-2.0 VAE config, the training loop with its
checkpoint, and the `train` entry point.

JAX runs on the CPU as its own tests run it. Its VAE draws noise inside its
jitted step from a PRNG key; the tests replace its `vae_sample` by one that
adds the same numpy noise the port is handed (the KL still comes from JAX's
own function). Each tolerance is stated where it is used.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import bottleneck as jbottleneck
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_create_wrapper)
from stable_audio_tools_tpu_torch.io.from_jax import (autoencoder_state_dict,
                                                      encodec_discriminator_state_dict)
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA2_VAE = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "autoencoders", "stable_audio_2_0_vae.json")
with open(SA2_VAE) as _f:
    SA2_VAE_CONFIG = json.load(_f)

B, T, LATENT = 2, 1024, 8


def tiny_config() -> dict:
    """The shipped SA-2.0 VAE config at toy size: channels 16, c_mults
    [1, 2], strides [2, 2], latent 8, the discriminator's filters 8 over two
    STFT scales, two MRSTFT resolutions with A-weighting, the shipped
    optimizers (AdamW with eps 1e-3, see `test_steps_match_jax`), an L1 time
    loss, f32 compute."""
    cfg = copy.deepcopy(SA2_VAE_CONFIG)
    cfg["sample_size"] = T
    m = cfg["model"]
    m["encoder"]["config"].update(channels=16, c_mults=[1, 2], strides=[2, 2],
                                  latent_dim=2 * LATENT)
    m["decoder"]["config"].update(channels=16, c_mults=[1, 2], strides=[2, 2],
                                  latent_dim=LATENT)
    m.update(latent_dim=LATENT, downsampling_ratio=4)
    tr = cfg["training"]
    del tr["compute_dtype"]
    for side in tr["optimizer_configs"].values():
        side["optimizer"]["config"]["eps"] = 1e-3
    losses = tr["loss_configs"]
    losses["discriminator"]["config"] = dict(filters=8, n_ffts=[64, 32], hop_lengths=[16, 8],
                                             win_lengths=[64, 32])
    losses["spectral"]["config"].update(fft_sizes=[64, 16], hop_sizes=[16, 4],
                                        win_lengths=[64, 16])
    losses["time"]["weights"]["l1"] = 0.1
    return cfg


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny steps here are many small ops: one intra-op thread keeps
    them from spinning against other test processes' threads (the codec and
    SA-1.0 training files import this fixture too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ae_pair():
    """(cfg, JAX trainer, its state, the port's trainer with the same
    weights, batch [B, 2, T], VAE noise per step [B, LATENT, T/4])."""
    cfg = tiny_config()
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((B, 2, T)) * 0.3).astype(np.float32)
    noise = [rng.standard_normal((B, LATENT, T // 4)).astype(np.float32) for _ in range(2)]
    jtr = jax_create_wrapper(cfg, jax_create_model(cfg))
    state = jtr.init_state(jax.random.PRNGKey(0), jnp.asarray(audio))
    model = create_model_from_config(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           autoencoder_state_dict(_tree_np(state.gen_params)).items()})
    ttr = create_training_wrapper_from_config(cfg, model)
    ttr.discriminator.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                                       encodec_discriminator_state_dict(
                                           _tree_np(state.disc_params)).items()})
    return cfg, jtr, state, ttr, audio, noise


def _replay_noise(monkeypatch, noise_nct):
    """JAX's vae_sample with `noise_nct` (port layout) in place of its draw."""
    real = jbottleneck.vae_sample
    noise = jnp.asarray(noise_nct.transpose(0, 2, 1))

    def vae_sample(mean, scale, rng):
        _, kl = real(mean, scale, rng)
        return noise.astype(mean.dtype) * (jax.nn.softplus(scale) + 1e-4) + mean, kl

    monkeypatch.setattr(jbottleneck, "vae_sample", vae_sample)


def _jax_grads(opt_state, beta1):
    """The gradient of a first optax Adam(W) update, from its state: the
    first moment is (1 - beta1) * g after one step from zero."""
    for part in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(part, "mu"):
            return jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - beta1), part.mu)
    raise AssertionError("no Adam state")


def test_steps_match_jax(ae_pair, monkeypatch):
    # step 0 (generator) and step 1 (discriminator) of both trainers, f32:
    # - every named loss to 1e-4 relative (f32 STFTs by FFT against the JAX
    #   conv-DFT, through two Oobleck levels);
    # - every gradient to 2e-3 of its tensor's peak (the A-weighted log
    #   magnitudes amplify the STFTs' f32 differences, 1.4e-4 at a single
    #   loss: test_torch_ae_modules.py; the GAN terms add the
    #   discriminator's), plus 1e-4 of the side's largest gradient: a sum
    #   whose terms cancel keeps f32 roundoff at that scale (the bias of the
    #   last conv before conv_post: the hinge's +-1/N over reals and fakes
    #   cancel wherever the leaky ReLU's slope is constant, exactly 0 in the
    #   port, up to 4e-5 of the side's peak in JAX);
    # - the parameters and the EMA after AdamW to 3e-6 absolute: the update
    #   is lr * m / (sqrt(v) + eps) with eps 1e-3 in this config, smooth in
    #   the gradient (with the shipped 1e-8 the first update is lr * sign(g),
    #   which flips on gradients near 0 and would hide nothing but say
    #   little), lr = 1.5e-4 and 3e-4 after InverseLR's warmup factor.
    # The JAX gradients come from its optimizers' first moments. The port's
    # generator step times its pieces (`gen_split`) while it is held.
    cfg, jtr, state, ttr, audio, noise = ae_pair
    ttr.gen_split = {}
    reals = jnp.asarray(audio)
    step_tol = 3e-6
    beta1 = cfg["training"]["optimizer_configs"]["autoencoder"]["optimizer"]["config"]["betas"][0]
    gen_grads = None
    for step in (0, 1):
        _replay_noise(monkeypatch, noise[step])
        gen = step == 0
        state, jaux = jtr.train_step(state, reals, jax.random.PRNGKey(2 + step), step)
        taux = ttr.train_step(torch.from_numpy(audio), noise=torch.from_numpy(noise[step]))
        assert ttr.step == step + 1 and int(state.step) == step + 1
        assert set(taux) == set(jaux), (sorted(taux), sorted(jaux))
        for name in jaux:
            np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-4,
                                       err_msg=f"step {step} {name}")
        to_port = autoencoder_state_dict if gen else encodec_discriminator_state_dict
        want_grads = to_port(_jax_grads(state.gen_opt_state if gen else state.disc_opt_state,
                                        beta1))
        params = ttr.params if gen else ttr.disc_params
        assert set(want_grads) == set(params)
        floor = 1e-4 * max(np.abs(g).max() for g in want_grads.values())
        for name, p in params.items():
            assert p.grad is not None, name
            want = want_grads[name]
            err = np.abs(p.grad.numpy() - want).max()
            assert err <= 2e-3 * np.abs(want).max() + floor, (step, name, err)
        if gen:
            assert all(p.grad is None for p in ttr.disc_params.values()), "the disc took a grad"
            gen_grads = {n: p.grad.clone() for n, p in ttr.params.items()}
        else:  # the generator's gradients are still step 0's
            assert all(torch.equal(p.grad, gen_grads[n]) for n, p in ttr.params.items())
        want_params = to_port(_tree_np(state.gen_params if gen else state.disc_params))
        for name, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_params[name], rtol=0,
                                       atol=step_tol, err_msg=f"step {step} {name}")
        if gen:
            want_ema = autoencoder_state_dict(_tree_np(state.ema_params))
            for name, e in ttr.ema.items():
                np.testing.assert_allclose(e.numpy(), want_ema[name], rtol=0, atol=step_tol)
    rates = ttr.learning_rates()
    assert set(rates) == {"lr", "lr_disc"} and rates["lr"] > 0 and rates["lr_disc"] > 0
    pieces = ("ae_forward", "discriminator", "losses", "backward", "optimizer", "ema")
    assert set(ttr.gen_split) == {f"{p}_ms" for p in pieces}
    assert all(v >= 0 for v in ttr.gen_split.values())
    ttr.gen_split = None


@pytest.mark.parametrize("mode,disc_steps", [("adv", [1, 3, 5]), ("full", [5])])
def test_warmup_and_parity_follow_jax(mode, disc_steps):
    # JAX train_step :513: with warmup_mode "adv" the discriminator trains
    # on every odd step from the start; with "full" only once warmed up
    cfg = tiny_config()
    cfg["training"].update(warmup_steps=4, warmup_mode=mode)
    w = create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))
    assert [s for s in range(7) if w.uses_disc(s)] == disc_steps


def test_shipped_sa2_vae_config_builds_unchanged():
    # the shipped config through the port's factories on `meta` (shapes
    # only): the SA-2.0 VAE's parameter count against the JAX module's
    # (jax.eval_shape of its init), and the trainer's pieces from the
    # config's training section on the CPU
    model = create_model_from_config(SA2_VAE_CONFIG, "meta")
    shapes = jax.eval_shape(jax_create_model(SA2_VAE_CONFIG).init,
                            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                            jax.ShapeDtypeStruct((1, 2, 4096), np.float32))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want == 156_112_514
    assert model.encoder.layers[0].weight_v.shape == (128, 2, 7)
    assert model.decoder.layers[0].weight_v.shape == (2048, 64, 7)
    model = create_model_from_config(copy.deepcopy(SA2_VAE_CONFIG), "cpu")
    w = create_training_wrapper_from_config(copy.deepcopy(SA2_VAE_CONFIG), model)
    assert w.compute_dtype == torch.bfloat16
    assert len(w.discriminator.discriminators.discriminators) == 5
    assert w.discriminator.discriminators.discriminators[0].convs[1].weight_v.shape == (
        64, 64, 3, 9)
    assert [loss.name for loss in w.losses_gen.losses] == [
        "loss_adv", "feature_matching_loss", "mrstft_loss", "stft_loss_left",
        "stft_loss_right", "kl_loss"]
    assert w.optimizer.param_groups[0]["weight_decay"] == 1e-3


@pytest.mark.parametrize("key,value", [("encoder_freeze_on_warmup", True),
                                       ("latent_mask_ratio", 0.5),
                                       ("teacher_model", {"model_type": "autoencoder"})])
def test_factory_refuses_unported_options(key, value):
    cfg = tiny_config()
    cfg["training"][key] = value
    with pytest.raises(NotImplementedError, match=key):
        create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))


def test_factory_refuses_unported_discriminators_and_losses():
    cfg = tiny_config()
    cfg["training"]["loss_configs"]["discriminator"]["type"] = "oobleck"
    with pytest.raises(NotImplementedError, match="oobleck"):
        create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))
    cfg = tiny_config()
    cfg["training"]["loss_configs"]["mrmel"] = {"weights": {"mrmel": 1.0}, "config": {}}
    with pytest.raises(NotImplementedError, match="mrmel"):
        create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))


def _write_dataset(root: str) -> str:
    from stable_audio_tools_tpu_torch.data.wav import save_wav

    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(root, "wavs"))
    for i in range(3):
        save_wav(os.path.join(root, "wavs", f"c{i}.wav"),
                 (rng.standard_normal((2, 3000)) * 0.2).astype(np.float32), 44100)
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as f:
        json.dump({"dataset_type": "audio_dir", "random_crop": True,
                   "datasets": [{"id": "d", "path": os.path.join(root, "wavs")}]}, f)
    return path


def test_train_entry_trains_checkpoints_and_resumes(tmp_path):
    # `python -m stable_audio_tools_tpu_torch.train` on the CPU: four steps
    # (gen, disc, gen, disc) logged with both learning rates, a checkpoint
    # holding both sides that reloads into a fresh trainer exactly, and a
    # resumed run that continues from its step
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.io.checkpoints import load_training_state

    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps(tiny_config()))
    argv = ["--model-config", str(cfg_path), "--dataset-config", _write_dataset(str(tmp_path)),
            "--batch-size", "2", "--num-workers", "0", "--max-steps", "4",
            "--checkpoint-every", "4", "--save-dir", str(tmp_path / "run"), "--device", "cpu",
            "--precision", "32"]
    trainer = train.main(argv)
    log = [json.loads(line) for line in (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    assert "train/mrstft_loss" in log[0] and "train/discriminator_loss" in log[1]
    assert all("train/lr" in r and "train/lr_disc" in r for r in log)
    assert all(np.isfinite(v) for r in log for v in r.values())
    ckpt = tmp_path / "run" / "step=4.ckpt"
    fresh, _ = train.build(train.parse_args(argv))
    state = load_training_state(str(ckpt), fresh.wrapper)
    assert {"discriminator", "disc_optimizer", "disc_scheduler"} <= set(state)
    w, f = trainer.wrapper, fresh.wrapper
    for a, b in ((w.model, f.model), (w.discriminator, f.discriminator)):
        for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(p, q), n
    assert f.step == 4 and all(torch.equal(w.ema[n], f.ema[n]) for n in w.ema)
    assert f.disc_scheduler.state_dict() == w.disc_scheduler.state_dict()
    resumed = train.main(argv[:9] + ["6"] + argv[10:] + ["--ckpt-path", str(ckpt)])
    assert resumed.wrapper.step == 6


def test_tiny_ae_check_needs_the_reduced_gain():
    # chip_smoke.py's tiny card-vs-CPU AE check scales the weight-norm gains
    # by SMALL_AE_GAIN (0.3). The reason, read on the CPU alone with the
    # check's own model, batch and noise: at the init's gains one bf16
    # generator step's gradient lies about its own size away from the f32
    # step's (106% over the whole generator, 152% for the worst tensor, when
    # written), so no 5% bound between two bf16 runs can hold there; at 0.3
    # every tensor's bf16 gradient is within 5% of its f32 one (1.2% at worst
    # when written)
    import chip_smoke

    audio, noises = chip_smoke.tiny_gan_batch(chip_smoke.tiny_ae_config())
    spread = {}
    for gain in (1.0, chip_smoke.SMALL_AE_GAIN):
        ref = chip_smoke.tiny_gan_trainer(chip_smoke.tiny_ae_config("float32"), "cpu", gain=gain)
        bf16 = chip_smoke.tiny_gan_trainer(chip_smoke.tiny_ae_config(), "cpu", gain=gain)
        for w in (ref, bf16):
            w.train_step(audio, noise=noises[0])
        spread[gain] = chip_smoke.grad_rel_errs(bf16.params, ref.params)
    assert spread[1.0][2] > 0.5, spread
    assert spread[chip_smoke.SMALL_AE_GAIN][1] < 0.05, spread
