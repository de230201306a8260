"""The port's training entry as users run it, on the CPU: demos and
validation inside `Trainer.fit` for each model family (a conditioned DiT, an
unconditional DAU1d, a token LM, an autoencoder GAN) leave the training's
parameters, optimizer state and EMA bit for bit where a run without them
leaves them; the config's `demo_every` applies when `--demo-every` is 0;
`--recover`, `--save-top-k`, `--profile-dir` and the logger; the flags
against the JAX package's `train.py` (read from the repository, not run).
"""

import ast
import copy
import json
import os

import numpy as np
import pytest
import torch

from stable_audio_tools_tpu_torch import train
from stable_audio_tools_tpu_torch.data.wav import load_wav, save_wav
from stable_audio_tools_tpu_torch.training.trainer import step_checkpoints
from stable_audio_tools_tpu_torch.training.utils import create_logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dit_config():
    from test_torch_training import _train_config

    cfg = _train_config()
    cfg["training"]["demo"]["demo_steps"] = 2
    return cfg


def _dance_config():
    from test_torch_dance import TINY

    cfg = copy.deepcopy(TINY)
    cfg["training"]["demo"] = {"demo_every": 2000, "demo_steps": 2, "num_demos": 2}
    return cfg


def _lm_config():
    from test_torch_lm import CONFIG, CTX_DIM

    cfg = copy.deepcopy(CONFIG)
    # a codebook as large as the sampler's default top_k (250)
    cfg["model"]["pretransform"]["config"]["bottleneck"]["config"]["codebook_size"] = 256
    cfg["model"]["conditioning"] = {"cond_dim": CTX_DIM, "configs": [
        {"id": "prompt", "type": "t5", "config": {
            "max_length": 6, "allow_random_init": True, "arch": [32, 64, 1, 2, 16, False]}}]}
    cfg["training"]["demo"] = {"demo_every": 2000, "demo_max_gen_len": 4,
                               "demo_cond": [{"prompt": "a bell"}], "demo_cfg_scale": 3.0}
    return cfg


def _ae_config():
    from test_torch_ae_training import tiny_config

    cfg = tiny_config()
    cfg["sample_size"] = 4096  # the validation's STFT of 2048 reflect-pads 1024 on each side
    return cfg


FAMILIES = {"dit": _dit_config, "dance": _dance_config, "lm": _lm_config, "ae": _ae_config}


def write_run_inputs(tmp, cfg: dict, n: int = 4) -> list:
    """Seeded WAVs with prompts, the model and dataset configs; returns the
    entry's base arguments."""
    rng = np.random.default_rng(12)
    os.makedirs(os.path.join(tmp, "wavs"), exist_ok=True)
    channels = cfg.get("audio_channels", 2)
    for i in range(n):
        save_wav(os.path.join(tmp, "wavs", f"{i}.wav"),
                 0.3 * rng.standard_normal((channels, cfg["sample_size"] + 300 * i)),
                 cfg["sample_rate"])
    with open(os.path.join(tmp, "meta.py"), "w") as f:
        f.write("def get_custom_metadata(info, audio):\n"
                "    return {'prompt': 'noise ' + info['relpath']}\n")
    with open(os.path.join(tmp, "model.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tmp, "data.json"), "w") as f:
        json.dump({"dataset_type": "audio_dir", "datasets": [
            {"id": "n", "path": os.path.join(tmp, "wavs"),
             "custom_metadata_module": os.path.join(tmp, "meta.py")}]}, f)
    return ["--model-config", os.path.join(tmp, "model.json"), "--dataset-config",
            os.path.join(tmp, "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--device", "cpu", "--precision", "32"]


def _state(wrapper) -> dict:
    """Every tensor the training carries: weights and buffers, the optimizers'
    states, the EMA."""
    out = {f"model.{k}": v for k, v in wrapper.model.state_dict().items()}
    opts = [("opt", wrapper.optimizer)]
    if getattr(wrapper, "disc_optimizer", None) is not None:
        opts.append(("disc_opt", wrapper.disc_optimizer))
        out.update({f"disc.{k}": v for k, v in wrapper.discriminator.state_dict().items()})
    for tag, opt in opts:
        for i, st in enumerate(opt.state_dict()["state"].values()):
            out.update({f"{tag}.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    out.update({f"ema.{k}": v for k, v in (wrapper.ema or {}).items()})
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_demos_and_validation_leave_training_bit_identical(tmp_path, family):
    # four steps with a demo and a validation pass after steps 2 and 4 (and
    # checkpoints there, the newest kept), against four steps without them:
    # every weight, optimizer moment and EMA entry equal bit for bit. The
    # demos render with the EMA weights (put back after), their own
    # generator, their own loader; validation runs without the EMA, in eval
    # mode, under no_grad.
    cfg = FAMILIES[family]()
    base = write_run_inputs(str(tmp_path), cfg) + ["--max-steps", "4"]
    plain = train.main(base + ["--save-dir", str(tmp_path / "plain"), "--checkpoint-every", "0"])
    extra = ["--save-dir", str(tmp_path / "run"), "--checkpoint-every", "2", "--save-top-k",
             "1", "--demo-every", "2"]
    if family != "lm":  # the LM trainer has no validation step (nor has JAX's)
        extra += ["--val-dataset-config", str(tmp_path / "data.json"), "--val-every", "2"]
    full = train.main(base + extra)
    a, b = _state(plain.wrapper), _state(full.wrapper)
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]
    def logged(h):
        return {k: v for k, v in h.items() if k != "train/steps_per_sec"}

    assert [logged(h) for h in plain.history] == [logged(h) for h in full.history]
    log = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert not any("demo/error" in r for r in log)
    demos = os.listdir(tmp_path / "run" / "demos")
    assert any("_step2_" in f for f in demos) and any("_step4_" in f for f in demos)
    assert [s for s, _ in step_checkpoints(str(tmp_path / "run"))] == [4]
    if family != "lm":
        vals = [r for r in log if any(k.startswith("val/") for k in r)]
        assert [r["step"] for r in vals] == [2, 4]
        assert all(np.isfinite(v) for r in vals for v in r.values())
    for f in demos:
        if f.endswith(".wav"):
            audio, sr = load_wav(str(tmp_path / "run" / "demos" / f))
            assert sr == cfg["sample_rate"] and np.isfinite(audio).all()


def test_config_demo_every_applies_when_the_flag_is_zero(tmp_path):
    # --demo-every 0 (the default) takes the model config's demo.demo_every,
    # as the JAX entry does; a positive flag overrides it
    cfg = _dit_config()
    cfg["training"]["demo"]["demo_every"] = 3
    argv = write_run_inputs(str(tmp_path), cfg) + ["--save-dir", str(tmp_path / "run"),
                                                   "--max-steps", "3"]
    trainer, _, _ = train.build(train.parse_args(argv))
    assert trainer.demo_every == 3 and trainer.demo_callback is not None
    trainer, _, _ = train.build(train.parse_args(argv + ["--demo-every", "5"]))
    assert trainer.demo_every == 5
    train.main(argv)
    assert sorted(f for f in os.listdir(tmp_path / "run" / "demos") if f.endswith(".wav")) == [
        f"demo_cfg{s}_step3_0.wav" for s in (3, 6, 9)]


def test_a_failing_demo_is_logged_and_training_goes_on(tmp_path, monkeypatch):
    from stable_audio_tools_tpu_torch.training import demos

    def boom(self, wrapper, step):
        raise RuntimeError("no audio today")

    monkeypatch.setattr(demos.DiffusionCondDemoCallback, "__call__", boom)
    argv = write_run_inputs(str(tmp_path), _dit_config()) + [
        "--save-dir", str(tmp_path / "run"), "--max-steps", "2", "--demo-every", "1"]
    trainer = train.main(argv)
    assert trainer.wrapper.step == 2
    log = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    errors = [r for r in log if "demo/error" in r]
    assert [r["step"] for r in errors] == [1, 2] and "no audio today" in errors[0]["demo/error"]


def test_recover_resumes_from_the_newest_checkpoint(tmp_path):
    cfg = _dit_config()
    argv = write_run_inputs(str(tmp_path), cfg) + ["--save-dir", str(tmp_path / "run"),
                                                   "--checkpoint-every", "1"]
    args = train.parse_args(argv + ["--recover"])
    assert train.recover_path(args) == ""  # nothing to recover: a fresh start
    first = train.main(argv + ["--max-steps", "3", "--save-top-k", "-1"])
    assert [s for s, _ in step_checkpoints(str(tmp_path / "run"))] == [1, 2, 3]
    # a step=10 file sorts before step=3 by name, after it by step
    os.link(tmp_path / "run" / "step=2.ckpt", tmp_path / "run" / "step=10.ckpt")
    assert train.recover_path(args).endswith("step=10.ckpt")
    os.remove(tmp_path / "run" / "step=10.ckpt")
    assert train.recover_path(args).endswith("step=3.ckpt")
    assert train.recover_path(train.parse_args(argv + ["--recover", "--ckpt-path", "x.ckpt"])) \
        == "x.ckpt"
    restored, _, _ = train.build(args)
    restored.restore(train.recover_path(args))
    a, b = _state(restored.wrapper), _state(first.wrapper)
    assert restored.wrapper.step == 3 and a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    resumed = train.main(argv + ["--recover", "--max-steps", "4"])
    assert resumed.wrapper.step == 4
    log = [json.loads(s) for s in open(tmp_path / "run" / "train_log.jsonl")]
    assert [r["step"] for r in log] == [1, 2, 3, 4]


def test_save_top_k_keeps_the_newest(tmp_path):
    argv = write_run_inputs(str(tmp_path), _dit_config()) + [
        "--save-dir", str(tmp_path / "run"), "--checkpoint-every", "1", "--max-steps", "4",
        "--save-top-k", "2"]
    train.main(argv)
    assert [s for s, _ in step_checkpoints(str(tmp_path / "run"))] == [3, 4]


def test_profile_dir_traces_steps_10_to_12(tmp_path):
    from stable_audio_tools_tpu_torch.training.trainer import Trainer

    class Counting:
        device = torch.device("cpu")

        def __init__(self):
            self.step, self.model = 0, torch.nn.Linear(2, 2)

        def train_step(self, audio, metadata, accum_steps=1):
            with torch.profiler.record_function(f"step_{self.step}"):
                self.model(audio.float()).sum()
            self.step += 1
            return {"loss": torch.tensor(0.0)}

        def learning_rates(self):
            return {}

    loader = [(torch.zeros(1, 2), [{}])] * 15
    trainer = Trainer(Counting(), {}, save_dir=str(tmp_path / "run"), checkpoint_every=0)
    trainer.profile_dir = str(tmp_path / "trace")
    trainer.fit(loader, max_steps=15, save_at_end=False)
    files = os.listdir(tmp_path / "trace")
    assert files == ["trace_steps_10-12.json"]
    with open(tmp_path / "trace" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"step_{i}" for i in (10, 11, 12)} <= names
    assert not names & {f"step_{i}" for i in (9, 13)}


def test_logger_backends():
    log = create_logger("jsonl", "/nonexistent", project="p", name="n", config={})
    assert log.path == "/nonexistent/train_log.jsonl"
    for name in ("wandb", "comet"):
        with pytest.raises(NotImplementedError, match=name):
            create_logger(name, "/nonexistent")


def test_jsonl_logger_records_audio_and_image_keys(tmp_path):
    log = create_logger("jsonl", str(tmp_path))
    log.log_audio("demo/x", np.zeros((2, 4)), 44100, caption="cfg=6", step=3)
    log.log_image("demo/x_melspec", np.zeros((4, 4, 3)), step=3)
    log.log_metrics({"demo/x_files": ["a.wav"], "val/stft": torch.tensor(0.5)}, step=3)
    recs = [json.loads(s) for s in open(tmp_path / "train_log.jsonl")]
    assert recs == [{"demo/x": "cfg=6", "step": 3}, {"demo/x_melspec": "image", "step": 3},
                    {"demo/x_files": ["a.wav"], "val/stft": 0.5, "step": 3}]


def _jax_train_flags() -> set:
    """The option strings the repository's JAX `train.py` adds to its parser."""
    with open(os.path.join(ROOT, "train.py")) as f:
        tree = ast.parse(f.read())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            and node.args and isinstance(node.args[0], ast.Constant)}


MULTI_CARD = {"--num-gpus": "2", "--num-nodes": "2", "--strategy": "ddp", "--mesh-model": "2",
              "--multihost": None}


def test_parser_has_every_jax_flag_and_refuses_the_multi_card_ones(tmp_path):
    jax_flags = _jax_train_flags()
    assert len(jax_flags) == 29 and set(MULTI_CARD) <= jax_flags
    port_flags = {s for a in train.build_parser()._actions for s in a.option_strings}
    assert port_flags - {"-h", "--help"} == jax_flags | {"--device"}
    base = ["--model-config", "m.json", "--dataset-config", "d.json"]
    # each of the JAX entry's single-card flags parses with a value
    values = {"--name": "run", "--project": "p", "--precision": "32", "--recover": None,
              "--save-top-k": "1", "--remove-pretransform-weight-norm": "post_load",
              "--val-every": "5", "--val-dataset-config": "v.json", "--pretrained-ckpt-path":
              "p.ckpt", "--pretransform-ckpt-path": "a.ckpt", "--logger": "jsonl",
              "--demo-every": "3", "--profile-dir": "t", "--num-gpus": "1",
              "--strategy": "auto", "--num-nodes": "1", "--mesh-model": "1"}
    argv = base + [x for k, v in values.items() for x in ((k,) if v is None else (k, v))]
    args = train.parse_args(argv)
    assert (args.recover, args.save_top_k, args.val_every, args.demo_every) == (True, 1, 5, 3)
    for flag, value in MULTI_CARD.items():
        with pytest.raises(SystemExit):
            train.parse_args(base + ([flag] if value is None else [flag, value]))


def test_multi_card_refusal_names_the_flag(capsys):
    with pytest.raises(SystemExit):
        train.parse_args(["--model-config", "m", "--dataset-config", "d", "--strategy", "ddp"])
    assert "--strategy ddp" in capsys.readouterr().err
