"""Codec training of the port against the JAX package on the CPU: the RVQ's
k-means init, EMA codebook update, dead-code revival, commitment loss and
straight-through estimator (`ResidualVQ` with `train`), the bottleneck's
`quantizer_loss` in the autoencoder trainer, and whole generator /
discriminator steps of a tiny EnCodec-shaped codec (SEANet with a 2-layer
LSTM and weight norm, a 2 x 16 RVQ, the EnCodec discriminator) with the same
weights and quantizer state (carried over by io/from_jax.py); then resume
from a checkpoint, the `train` entry point and the SEANet's bf16 routing.

The JAX RVQ draws its dead-code indices with `jax.random.randint` from the
step's key; the tests replace that function by one that returns the indices
the port is handed (`revive_indices`). f32 on both sides; each tolerance is
stated where it is used: module outputs and state within 1e-5 of their peak,
gradients within 1e-4 of their norm unless a test says otherwise.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import bottleneck as jbn
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create_model
from stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_create_wrapper)
from stable_audio_tools_tpu_torch.io.from_jax import (autoencoder_state_dict,
                                                      encodec_discriminator_state_dict)
from stable_audio_tools_tpu_torch.models import bottleneck as tbn
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.training.autoencoders import create_loss_modules_from_bottleneck
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

from test_torch_ae_training import _jax_grads, _tree_np
from test_torch_ae_training import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_dac_training import decoder_dtype_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODEC = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "autoencoders", "encodec_musicgen_rvq.json")
with open(ENCODEC) as _f:
    ENCODEC_CONFIG = json.load(_f)

B, T, Q, K, D = 2, 1024, 2, 16, 8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _peak_close(name, got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


def _norm_close(name, got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= rel * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))


class _Randint:
    """Stands in for `jax.random.randint` inside the JAX RVQ: the dead-code
    indices of stage q are `indices[q]` (in call order, cycling: the JAX
    discriminator step traces the same draws and discards them)."""

    def __init__(self, indices):
        self.indices, self.calls = np.asarray(indices), 0

    def __call__(self, key, shape, minval, maxval, dtype=jnp.int32):
        out = self.indices[self.calls % len(self.indices)]
        assert out.shape == tuple(shape) and out.max() < maxval, (out.shape, shape, maxval)
        self.calls += 1
        return jnp.asarray(out, dtype)


# -- the quantizer ------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(40, 16), (10, 16), (101, 7)])
def test_kmeans_matches_jax(n, k):
    # the even-stride seeding (rows repeat where n < k), Lloyd iterations, an
    # empty cluster keeping its center: the same centers within 1e-5 of the
    # peak (n, k chosen with no tie in the seeding's rounding)
    data = np.random.default_rng(n * k).standard_normal((n, 6)).astype(np.float32)
    want = np.asarray(jbn._kmeans(jnp.asarray(data), k, 10))
    _peak_close("centers", tbn.kmeans(_t(data), k, 10).numpy(), want)


def _rvq_pair(threshold, seed=0):
    jq = jbn.ResidualVQ(dim=D, codebook_size=K, num_quantizers=Q, kmeans_init=True,
                        kmeans_iters=5, threshold_ema_dead_code=threshold)
    x = np.random.default_rng(seed).standard_normal((B, 24, D)).astype(np.float32)
    variables = jq.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tq = tbn.ResidualVQ(D, K, Q, kmeans_init=True, kmeans_iters=5,
                        threshold_ema_dead_code=threshold)
    for name, value in variables["quantizer_state"].items():
        getattr(tq, name).copy_(torch.from_numpy(np.array(value)))
    return jq, variables, tq


@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_rvq_training_passes_match_jax(threshold, monkeypatch):
    # two training passes of a 2-stage RVQ on other batches: the first runs
    # the k-means init (its codebook quantizes that pass) and restarts the
    # EMA trackers from it, the second the EMA update from the state the
    # first left; with a dead-code threshold, expired codes re-seeded from
    # the injected rows. Per pass: the codes identical, the quantized
    # output, the stages' commitment losses, the new state (codebooks,
    # counts, sums, initted) within 1e-5 of their peaks, and the gradient of
    # a loss of the output and the commitment losses with respect to the
    # input (the straight-through estimator and the residual's path through
    # the stages) within 1e-4 of its norm
    jq, variables, tq = _rvq_pair(threshold)
    rng = np.random.default_rng(1)
    for step in range(2):
        x = rng.standard_normal((B, 24, D)).astype(np.float32)
        probe = rng.standard_normal((B, 24, D)).astype(np.float32)
        revive = rng.integers(0, B * 24, size=(Q, K))
        monkeypatch.setattr(jax.random, "randint", _Randint(revive))

        def jloss(xj, variables):
            (z, idx, losses), upd = jq.apply(variables, xj, train=True,
                                             mutable=["quantizer_state"],
                                             rngs={"sample": jax.random.PRNGKey(step)})
            return jnp.sum(z * probe) + 3.0 * jnp.sum(losses), (z, idx, losses, upd)

        (_, (z, idx, losses, upd)), gx = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(x), variables)
        xt = _t(x).requires_grad_(True)
        tz, tidx, tlosses = tq(xt, train=True, revive_indices=torch.from_numpy(revive))
        ((tz * _t(probe)).sum() + 3.0 * tlosses.sum()).backward()
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        _peak_close(f"pass {step} quantized", tz.detach().numpy(), z)
        _peak_close(f"pass {step} losses", tlosses.detach().numpy(), losses)
        _norm_close(f"pass {step} dx", xt.grad.numpy(), gx)
        for name, want in upd["quantizer_state"].items():
            _peak_close(f"pass {step} {name}", getattr(tq, name).float().numpy(),
                        np.asarray(want, np.float32))
        variables = {"quantizer_state": upd["quantizer_state"]}
    assert bool(tq.initted)


def test_rvq_eval_pass_keeps_the_state_and_draws_from_the_generator():
    # without `train` the state stays; with it and no injected rows the
    # dead-code rows come from the generator: the same seed, the same state
    _, _, tq = _rvq_pair(2.0)
    x = _t(np.random.default_rng(3).standard_normal((B, 24, D)))
    before = {k: v.clone() for k, v in tq.state_dict().items()}
    tq(x)
    assert all(torch.equal(v, before[k]) for k, v in tq.state_dict().items())
    states = []
    for _ in range(2):
        tq.load_state_dict(before)
        tq(x, train=True, generator=torch.Generator().manual_seed(5))
        states.append({k: v.clone() for k, v in tq.state_dict().items()})
    assert all(torch.equal(v, states[1][k]) for k, v in states[0].items())
    assert not torch.equal(states[0]["codebooks"], before["codebooks"])


def test_quantizer_loss_module_matches_jax_and_others_are_refused():
    # an RVQ bottleneck adds `quantizer_loss` at weight 1, as JAX :54-70;
    # a bottleneck the port does not train is refused by name
    from stable_audio_tools_tpu.training.autoencoders import (
        create_loss_modules_from_bottleneck as jax_losses)

    cfg = ENCODEC_CONFIG["training"]["loss_configs"]
    want = jax_losses(jbn.RVQBottleneck(), cfg)
    got = create_loss_modules_from_bottleneck(tbn.RVQBottleneck(), cfg)
    assert [(m.name, m.key, m.weight) for m in got] == [(m.name, m.key, m.weight) for m in want]

    class Other(torch.nn.Module):
        pass

    with pytest.raises(NotImplementedError, match="Other"):
        create_loss_modules_from_bottleneck(Other(), cfg)


# -- whole codec steps ----------------------------------------------------------------------

def tiny_codec_config() -> dict:
    """The shipped encodec_musicgen_rvq.json at toy size: SEANet with 4
    filters, ratios [2, 2], dimension 8, its 2-layer LSTM and weight norm;
    an RVQ of 2 x 16 codes of 8 (decay 0.99, dead-code threshold 2, k-means
    init of 50 iterations); the discriminator's filters 4 over two STFT
    scales, two MRSTFT resolutions, f32 compute. Both sides' optimizers are
    the trainer's default AdamW (lr 1e-4, betas 0.8 / 0.99) with eps 1e-3:
    at 1e-8 the first update is lr * sign(g), which flips on gradients near
    0 and would part the two packages' weights before the third step
    (tests/test_torch_ae_training.py does the same)."""
    cfg = copy.deepcopy(ENCODEC_CONFIG)
    cfg["sample_size"] = T
    m = cfg["model"]
    for side in ("encoder", "decoder"):
        m[side]["config"].update(n_filters=4, ratios=[2, 2], dimension=D)
    m["bottleneck"]["config"].update(num_quantizers=Q, codebook_size=K, dim=D)
    m.update(latent_dim=D, downsampling_ratio=4)
    tr = cfg["training"]
    del tr["compute_dtype"]
    adamw = {"optimizer": {"type": "AdamW", "config": {"lr": 1e-4, "betas": [0.8, 0.99],
                                                       "eps": 1e-3}}}
    tr["optimizer_configs"] = {"autoencoder": adamw, "discriminator": copy.deepcopy(adamw)}
    losses = tr["loss_configs"]
    losses["discriminator"]["config"] = dict(filters=4, n_ffts=[64, 32], hop_lengths=[16, 8],
                                             win_lengths=[64, 32])
    losses["spectral"]["config"].update(fft_sizes=[64, 16], hop_sizes=[16, 4],
                                        win_lengths=[64, 16])
    return cfg


def _codec_pair(cfg):
    """(JAX trainer, its state, the port's trainer with the same weights,
    quantizer state and discriminator)."""
    audio = np.zeros((B, 1, T), np.float32)
    jtr = jax_create_wrapper(cfg, jax_create_model(cfg))
    state = jtr.init_state(jax.random.PRNGKey(0), jnp.asarray(audio))
    model = create_model_from_config(cfg, "cpu")
    sd = autoencoder_state_dict(_tree_np(state.gen_params),
                                quantizer_state=_tree_np(state.quantizer_state))
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    ttr = create_training_wrapper_from_config(cfg, model)
    ttr.discriminator.load_state_dict({k: _t(v) for k, v in encodec_discriminator_state_dict(
        _tree_np(state.disc_params)).items()})
    return jtr, state, ttr


def test_codec_steps_match_jax(monkeypatch):
    # steps 0 (generator: the k-means init), 1 (discriminator) and 2
    # (generator: the EMA update and dead-code revival from the state step 0
    # left) of both trainers, f32, the same batch per step and the same
    # revival rows: every named loss within 1e-4 relative (the STFT losses'
    # f32 differences, as tests/test_torch_ae_training.py); each generator
    # gradient within 1e-3 of its norm plus 1e-4 of the side's largest
    # gradient norm (the A-weighted log magnitudes amplify the STFTs' f32
    # differences; sums whose terms cancel keep roundoff at the side's
    # scale), the discriminator's likewise; the quantizer state after each
    # step within 1e-5 of its peak (the discriminator step leaves it). The
    # JAX gradients come from its optimizers' first moments (one Adam step
    # from zero each side at steps 0 and 1).
    cfg = tiny_codec_config()
    jtr, state, ttr = _codec_pair(cfg)
    beta1 = 0.8  # the trainers' default AdamW betas (0.8, 0.99)
    rng = np.random.default_rng(7)
    frames = B * T // 4
    for step in range(3):
        audio = (rng.standard_normal((B, 1, T)) * 0.3).astype(np.float32)
        revive = rng.integers(0, frames, size=(Q, K))
        if step == 2:
            # the generator's weights as JAX's stand: torch's LSTM trains two
            # biases where the flax cell trains one, so after an update the
            # port's summed bias has moved twice as far (the reference
            # torch codec's two biases move as the port's do)
            sd = autoencoder_state_dict(_tree_np(state.gen_params))
            with torch.no_grad():
                for name, p in ttr.params.items():
                    p.copy_(_t(sd[name]))
        monkeypatch.setattr(jax.random, "randint", _Randint(revive))
        jtr._jit_cache.clear()  # the injected rows are constants of the trace
        state, jaux = jtr.train_step(state, jnp.asarray(audio), jax.random.PRNGKey(3 + step),
                                     step)
        taux = ttr.train_step(_t(audio), revive_indices=torch.from_numpy(revive))
        assert set(taux) == set(jaux), (sorted(taux), sorted(jaux))
        for name in jaux:
            np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-4,
                                       err_msg=f"step {step} {name}")
        gen = step != 1
        if step < 2:
            to_port = autoencoder_state_dict if gen else encodec_discriminator_state_dict
            want = to_port(_jax_grads(state.gen_opt_state if gen else state.disc_opt_state,
                                      beta1))
            params = ttr.params if gen else ttr.disc_params
            assert set(want) == set(params)
            floor = 1e-4 * max(np.linalg.norm(g) for g in want.values())
            for name, p in params.items():
                # torch's LSTM adds two biases where the flax cell has one
                # (io/from_jax.py puts it on the hidden side, the input
                # side's at zero): each takes the one bias's gradient
                ref = want[name.replace("bias_ih", "bias_hh")]
                err = np.linalg.norm(p.grad.numpy() - ref)
                assert err <= 1e-3 * np.linalg.norm(ref) + floor, (step, name, err)
        want_q = _tree_np(state.quantizer_state["bottleneck"]["quantizer"])
        for name, w in want_q.items():
            got = getattr(ttr.model.bottleneck.quantizer, name)
            _peak_close(f"step {step} {name}", got.float().numpy(), np.asarray(w, np.float32))
    assert "train/quantizer_loss" not in taux and "quantizer_loss" in taux


def test_quantizer_state_is_buffers_that_only_the_generator_step_moves():
    # codebooks, trackers and the flag are buffers: not among the trained
    # parameters or the EMA; the generator step moves them, the
    # discriminator step does not
    cfg = tiny_codec_config()
    model = create_model_from_config(cfg, "cpu")
    w = create_training_wrapper_from_config(cfg, model)
    names = {"bottleneck.quantizer." + n for n in ("codebooks", "ema_counts", "ema_sums",
                                                  "initted")}
    assert names <= set(model.state_dict()) and not names & set(w.params)
    assert not names & set(w.ema)
    audio = _t(np.random.default_rng(2).standard_normal((B, 1, T)) * 0.3)
    q = model.bottleneck.quantizer
    before = {k: v.clone() for k, v in q.state_dict().items()}
    w.train_step(audio)
    after_gen = {k: v.clone() for k, v in q.state_dict().items()}
    assert bool(q.initted) and not torch.equal(after_gen["codebooks"], before["codebooks"])
    w.train_step(audio)  # the discriminator's
    assert all(torch.equal(v, after_gen[k]) for k, v in q.state_dict().items())


def test_resume_gives_the_uninterrupted_next_step(tmp_path):
    # a checkpoint after a generator and a discriminator step holds the
    # quantizer state; a trainer resumed from it takes the uninterrupted
    # run's next generator step bit for bit: losses, parameters, state
    from stable_audio_tools_tpu_torch.io.checkpoints import save_training_state
    from stable_audio_tools_tpu_torch.training.trainer import Trainer

    cfg = tiny_codec_config()
    audio = _t(np.random.default_rng(4).standard_normal((B, 1, T)) * 0.3)
    first = create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))
    first.train_step(audio)
    first.train_step(audio)
    path = str(tmp_path / "step=2.ckpt")
    save_training_state(path, first, cfg)
    state = torch.load(path, weights_only=True)
    assert bool(state["state_dict"]["bottleneck.quantizer.initted"])
    want = first.train_step(audio)

    resumed = create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))
    Trainer(resumed, cfg, save_dir=str(tmp_path / "run")).restore(path)
    assert resumed.step == 2
    got = resumed.train_step(audio)
    assert all(float(got[k]) == float(v) for k, v in want.items())
    for (n, p), (_, q) in zip(first.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(p, q), n


def test_train_entry_trains_the_codec_and_checkpoints_its_state(tmp_path):
    # `python -m stable_audio_tools_tpu_torch.train` on the CPU with the
    # tiny codec: four steps (gen, disc, gen, disc) with finite losses, the
    # quantizer loss logged on the generator steps, a checkpoint whose
    # quantizer state is the trainer's
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav

    rng = np.random.default_rng(1)
    os.makedirs(tmp_path / "wavs")
    for i in range(3):
        save_wav(str(tmp_path / "wavs" / f"c{i}.wav"),
                 (rng.standard_normal((1, 3000)) * 0.2).astype(np.float32), 32000)
    data = tmp_path / "dataset.json"
    data.write_text(json.dumps({"dataset_type": "audio_dir", "random_crop": True, "datasets": [
        {"id": "d", "path": str(tmp_path / "wavs")}]}))
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(json.dumps(tiny_codec_config()))
    trainer = train.main(["--model-config", str(cfg_path), "--dataset-config", str(data),
                          "--batch-size", "2", "--num-workers", "0", "--max-steps", "4",
                          "--checkpoint-every", "4", "--save-dir", str(tmp_path / "run"),
                          "--device", "cpu", "--precision", "32"])
    log = [json.loads(line) for line in
           (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    assert "train/quantizer_loss" in log[0] and "train/discriminator_loss" in log[1]
    assert all(np.isfinite(v) for r in log for v in r.values())
    state = torch.load(tmp_path / "run" / "step=4.ckpt", weights_only=True)["state_dict"]
    q = trainer.wrapper.model.bottleneck.quantizer
    for name in ("codebooks", "ema_counts", "ema_sums", "initted"):
        assert torch.equal(state[f"bottleneck.quantizer.{name}"], getattr(q, name)), name


def test_bf16_seanet_routes_stride1_convs_to_the_weight_gradient_kernel(monkeypatch):
    # under a bf16 compute dtype the encoder computes in bf16 up to its LSTM
    # (each stride-1 conv through ops/conv.py's Conv1dS1, whose weight
    # gradient is `conv1d_wgrad`), the LSTM and everything after it in f32
    # (the flax cells promote a bf16 input to their f32 parameters), so the
    # latents are f32; the trainer hands them to the decoder in bf16, whose
    # conv_in then takes Conv1dS1 too
    from stable_audio_tools_tpu_torch.ops import conv as tconv

    cfg = tiny_codec_config()
    cfg["training"]["compute_dtype"] = "bfloat16"
    w = create_training_wrapper_from_config(cfg, create_model_from_config(cfg, "cpu"))
    seen = []
    real = tconv.Conv1dS1.apply
    monkeypatch.setattr(tconv.Conv1dS1, "apply",
                        lambda x, *a: seen.append(x.dtype) or real(x, *a))
    enc = w.model.encoder
    lat = w.model.encode(_t(np.random.default_rng(5).standard_normal((B, 1, T)) * 0.3)
                         .to(torch.bfloat16))
    # conv_in, and per level a residual block's two convs and its shortcut
    assert seen == [torch.bfloat16] * (1 + 3 * len(enc.blocks)) and lat.dtype == torch.float32
    seen.clear()
    aux = w.train_step(_t(np.random.default_rng(6).standard_normal((B, 1, T)) * 0.3))
    assert seen == [torch.bfloat16] * (2 + 3 * len(enc.blocks))
    assert all(np.isfinite(float(v)) for v in aux.values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in w.params.values())


def test_bf16_config_decodes_in_bf16_to_the_lstm_in_the_port_and_f32_in_jax():
    # Under the shipped bf16 compute dtype the JAX trainer hands its SEANet
    # decoder the RVQ's f32 output, so the JAX decoder computes in f32; the
    # port's trainer casts the latents to bf16, so its decoder's conv_in
    # computes in bf16 (row 11 plain's dtype) and the LSTM and every layer
    # after it in f32: a deliberate divergence (ROADMAP queue 3). The JAX
    # trainer's output equals its f32 decode (jitted there, eager here: the
    # LSTM parts them by 1.5e-6) within 1e-5 of the peak, as does the port's
    # f32 run; the port's bf16 run lies within 5% and farther than 1e-4
    # (0.070% when written)
    cfg = tiny_codec_config()
    cfg["training"]["compute_dtype"] = "bfloat16"
    reals = (np.random.default_rng(9).standard_normal((B, 1, T)) * 0.3).astype(np.float32)
    gaps, dtypes = decoder_dtype_gaps(cfg, reals)
    assert dtypes.pop("conv_in") == torch.bfloat16 and "lstm" in dtypes
    assert set(dtypes.values()) == {torch.float32}, dtypes
    assert gaps["jax"] <= 1e-5 and gaps["port_f32"] <= 1e-5, gaps
    assert 1e-4 < gaps["port_bf16"] <= 0.05, gaps
