"""The fine-tuning chain of the port against the JAX package: a tiny
SA-Open-shaped model trains a step, `python -m
stable_audio_tools_tpu_torch.unwrap_model` writes its EMA model under the
reference names (`.ckpt` or `.safetensors`), and that file goes into a fresh
port model through `--pretrained-ckpt-path` (and its VAE through
`--pretransform-ckpt-path`) and into the JAX model through
`import_diffusion_cond_state_dict` / `import_autoencoder_state_dict`; both
generate (or decode) the same audio.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from stable_audio_tools_tpu.io import checkpoints as jck
from stable_audio_tools_tpu.io import torch_mapping as jtm
from stable_audio_tools_tpu_torch import train, unwrap_model
from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from stable_audio_tools_tpu_torch.io.checkpoints import (load_ckpt_state_dict,
                                                         save_training_state)
from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config
from test_torch_slice import CONFIG, GEN, META, _pair, _replayed_noise, stable_tokenizer
from test_torch_training import _train_config


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, its variables, the port's trained model, the training
    checkpoint, the unwrapped .ckpt and .safetensors): one AdamW step of the
    tiny f32 model, its EMA then held away from the weights, so that what is
    exported shows which of the two it is."""
    tmp = tmp_path_factory.mktemp("finetune")
    model, variables, port = _pair(CONFIG)
    cfg = _train_config()
    wrapper = create_training_wrapper_from_config(cfg, port)
    rng = np.random.default_rng(3)
    audio = torch.from_numpy((0.3 * rng.standard_normal((2, 2, 1024))).astype(np.float32))
    wrapper.train_step(audio, [META[0], dict(META[0], seconds_start=9)])
    for e in wrapper.ema.values():
        e.mul_(0.98)
    ckpt = str(tmp / "step=1.ckpt")
    save_training_state(ckpt, wrapper, CONFIG)
    paths = {ext: unwrap_model.main(["--ckpt-path", ckpt, "--name", str(tmp / f"m_{ext}")]
                                    + (["--use-safetensors"] if ext == "safetensors" else []))
             for ext in ("ckpt", "safetensors")}
    return model, variables, wrapper, ckpt, paths, tmp


def test_unwrap_writes_the_ema_under_reference_names(exported, capsys):
    _, _, wrapper, ckpt, paths, tmp = exported
    want = dict(wrapper.model.state_dict())
    want.update(wrapper.ema)
    for ext, path in paths.items():
        got = load_ckpt_state_dict(path)
        assert got.keys() == want.keys(), ext
        for k, v in want.items():
            assert torch.equal(got[k], v.float() if v.is_floating_point() else v), (ext, k)
    state = torch.load(paths["ckpt"], weights_only=True)
    assert state["model_config"] == CONFIG and set(state) == {"state_dict", "model_config"}
    # --reference-layout (the JAX entry's flag) is accepted and changes nothing
    again = load_ckpt_state_dict(unwrap_model.main(
        ["--ckpt-path", ckpt, "--name", str(tmp / "ref"), "--reference-layout"]))
    assert all(torch.equal(again[k], v) for k, v in load_ckpt_state_dict(paths["ckpt"]).items())
    with pytest.raises(SystemExit):
        unwrap_model.parse_args(["--help"])
    assert "changes nothing" in capsys.readouterr().out


def _entry_args(tmp, **flags):
    (tmp / "model.json").write_text(json.dumps(CONFIG))
    argv = ["--model-config", str(tmp / "model.json"), "--dataset-config", "unused.json",
            "--precision", "32", "--seed", "11"]
    for flag, value in flags.items():
        argv += [f"--{flag.replace('_', '-')}", value]
    return train.parse_args(argv)


def _fresh(args):
    model, report = train.build_model(args, copy.deepcopy(CONFIG), torch.device("cpu"))
    t5 = model.conditioner.conditioners["prompt"]
    t5.model.compute_dtype = torch.float32  # as the pair's (test_torch_slice._pair)
    t5.tokenizer = stable_tokenizer(8)
    return model.eval(), report


@pytest.mark.parametrize("ext", ["ckpt", "safetensors"])
def test_pretrained_checkpoint_generates_as_jax_imports_it(exported, ext):
    # the unwrapped file in the port (--pretrained-ckpt-path: 0 skipped, every
    # tensor equal) and in the JAX model (the importers): the f32 generation
    # of test_torch_slice on replayed noise, 2e-4 of the peak apart
    model, variables, wrapper, _, paths, tmp = exported
    fresh, report = _fresh(_entry_args(tmp, pretrained_ckpt_path=paths[ext]))
    sd = load_ckpt_state_dict(paths[ext])
    assert report["pretrained_skipped"] == [] and report["pretrained_loaded"] == len(sd)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # the T5 tower is frozen: the file holds the pair's tower, which the JAX
    # model runs as its own Flax T5 (test_torch_slice._jax_model); handed to
    # the importer, it would replace that tower with the JAX package's own
    t5 = "conditioner.conditioners.prompt.model."
    pair_t5 = {k: v for k, v in wrapper.model.state_dict().items() if k.startswith(t5)}
    assert pair_t5 and all(torch.equal(sd[k], v) for k, v in pair_t5.items())
    imported = jtm.import_diffusion_cond_state_dict(
        model, {k: v.numpy() for k, v in sd.items() if not k.startswith(t5)})["params"]
    params = dict(variables["params"])
    for key, sub in imported.items():
        params[key] = sub if key != "conditioner" else {**params[key], **sub}
    want = np.asarray(jax_generate(model, {"params": params}, conditioning=META,
                                   sampler_type="dpmpp-2m", **GEN))
    noise, step_noise = _replayed_noise((1, 4, 64))
    got = generate_diffusion_cond(fresh, conditioning=META, sampler_type="dpmpp-2m", noise=noise,
                                  step_noise=step_noise, **GEN).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())
    # the JAX model with its own (untrained) weights is far from it
    old = np.asarray(jax_generate(model, variables, conditioning=META, sampler_type="dpmpp-2m",
                                  **GEN))
    assert np.abs(old - want).max() > 1e-2 * np.abs(want).max()


def test_pretransform_checkpoint_decodes_as_jax_imports_it(exported):
    # the VAE of the same file through --pretransform-ckpt-path (the rest of
    # the fresh model stays random) against import_autoencoder_state_dict:
    # the decode of seeded latents within 1e-5 of the peak (f32)
    model, variables, wrapper, _, paths, tmp = exported
    fresh, report = _fresh(_entry_args(tmp, pretransform_ckpt_path=paths["ckpt"]))
    sd = load_ckpt_state_dict(paths["ckpt"])
    sub = {k[len("pretransform.model."):]: v for k, v in sd.items()
           if k.startswith("pretransform.model.")}
    assert report["pretransform_loaded"] == len(sub)
    for k, v in fresh.pretransform.model.state_dict().items():
        assert torch.equal(v, sub[k]), k
    ae = jck.import_autoencoder_state_dict(model.pretransform.model,
                                           {k: v.numpy() for k, v in sub.items()})["params"]
    params = dict(variables["params"], pretransform={"model": ae})
    z = np.random.default_rng(6).standard_normal((1, 4, 64)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(z),
                                  method=model.pretransform_decode))
    with torch.no_grad():
        got = fresh.pretransform.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_pretransform_file_missing_a_tensor_is_refused(exported):
    _, _, _, _, paths, tmp = exported
    sd = load_ckpt_state_dict(paths["ckpt"])
    dropped = next(k for k in sd if k.startswith("pretransform.model.decoder."))
    del sd[dropped]
    torch.save({"state_dict": sd}, tmp / "partial.ckpt")
    with pytest.raises(RuntimeError, match="lacks 1 tensors"):
        _fresh(_entry_args(tmp, pretransform_ckpt_path=str(tmp / "partial.ckpt")))


@pytest.mark.parametrize("when", ["pre_load", "post_load"])
def test_remove_pretransform_weight_norm_around_the_load(exported, when):
    # pre_load re-normalises the random VAE, which the load then overwrites:
    # the file's tensors exactly; post_load re-normalises the loaded ones:
    # the same weights (v := w, g := ||w||) and decode
    _, _, _, _, paths, tmp = exported
    plain, _ = _fresh(_entry_args(tmp, pretransform_ckpt_path=paths["ckpt"]))
    fresh, _ = _fresh(_entry_args(tmp, pretransform_ckpt_path=paths["ckpt"],
                                  remove_pretransform_weight_norm=when))
    a, b = plain.pretransform.model.state_dict(), fresh.pretransform.model.state_dict()
    if when == "pre_load":
        assert all(torch.equal(a[k], b[k]) for k in a)
    else:
        assert any(not torch.equal(a[k], b[k]) for k in a if k.endswith("weight_g"))
        z = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 4, 64))
                             .astype(np.float32))
        with torch.no_grad():
            want, got = plain.pretransform.decode(z), fresh.pretransform.decode(z)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
