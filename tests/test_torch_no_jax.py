"""The port imports and runs (generation, a diffusion training step, an
autoencoder GAN generator and discriminator step, an LM training step, a
KV-cached LM generation, pre-encoding then training from the latents,
Dance Diffusion's generation and training step, SA-1.0's generation, and the
training steps of SA-1.0, a DAC VAE-GAN and an EnCodec-style codec)
with JAX,
flax, transformers and the JAX package unimportable (the machine with the
card has none of them), and without triton: no module imports it at import
time."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import torch
    import stable_audio_tools_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
             if not m.name.endswith("_triton")]  # Triton sources: need triton
    for name in names:
        importlib.import_module(name)
    assert "triton" not in sys.modules, "a module imported triton at import time"

    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    config = {
        "model_type": "diffusion_cond", "sample_size": 512, "sample_rate": 16000,
        "model": {
            "io_channels": 4,
            "pretransform": {"type": "autoencoder", "model_half": True, "config": {
                "encoder": {"type": "oobleck", "config": {
                    "in_channels": 2, "channels": 8, "c_mults": [1, 2], "strides": [2, 4],
                    "latent_dim": 8, "use_snake": True}},
                "decoder": {"type": "oobleck", "config": {
                    "out_channels": 2, "channels": 8, "c_mults": [1, 2], "strides": [2, 4],
                    "latent_dim": 4, "use_snake": True}},
                "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
                "io_channels": 2}},
            "conditioning": {"cond_dim": 64, "configs": [
                {"id": "prompt", "type": "t5", "config": {
                    "max_length": 8, "allow_random_init": True,
                    "arch": [64, 128, 1, 2, 32, True]}},
                {"id": "seconds_total", "type": "number", "config": {"max_val": 512}}]},
            "diffusion": {"type": "dit", "cross_attention_cond_ids": ["prompt"],
                          "global_cond_ids": ["seconds_total"],
                          "config": {"io_channels": 4, "embed_dim": 128, "depth": 1,
                                     "num_heads": 2, "cond_token_dim": 64,
                                     "global_cond_dim": 64, "project_cond_tokens": False,
                                     "compute_dtype": "bfloat16"}}},
        "training": {"cfg_dropout_prob": 0.5, "optimizer_configs": {"diffusion": {
            "optimizer": {"type": "AdamW", "config": {"lr": 1e-4, "weight_decay": 1e-3}},
            "scheduler": {"type": "InverseLR", "config": {"inv_gamma": 1e6, "power": 0.5,
                                                          "warmup": 0.99}}}}}}
    model = init_random_(create_model_from_config(config, "cpu"), torch.Generator().manual_seed(0))
    audio = generate_diffusion_cond(model.eval(), steps=2, conditioning=[
        {"prompt": "rain on a tin roof", "seconds_total": 10}], sample_size=512, seed=0)
    assert audio.shape == (1, 2, 512) and torch.isfinite(audio).all()

    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    wrapper = create_training_wrapper_from_config(config, model)
    meta = [{"prompt": "rain", "seconds_total": 10}, {"prompt": "a drum", "seconds_total": 3}]
    audio = torch.randn(2, 2, 512, generator=torch.Generator().manual_seed(1)) * 0.3
    losses = [float(wrapper.train_step(audio, meta, accum_steps=s)["loss"]) for s in (1, 2)]
    assert all(torch.isfinite(torch.tensor(losses))) and wrapper.step == 2
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in wrapper.params.values())
    assert "triton" not in sys.modules
    print("ok", len(names))
""")


def test_port_runs_without_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


SA2_SCRIPT = textwrap.dedent("""
    import sys, tempfile, os
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import numpy as np
    import torch
    from stable_audio_tools_tpu_torch.inference.generation import (
        generate_diffusion_cond, generate_diffusion_cond_inpaint)
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.roberta import RobertaArch, RobertaModel

    # a CLAP checkpoint written without transformers: the port's own RoBERTa
    # under CLAP's names
    torch.manual_seed(0)
    tower = RobertaModel(RobertaArch(vocab_size=32002, hidden_size=64, num_layers=2,
                                     num_heads=1, intermediate_size=128, max_positions=80))
    sd = {f"module.text_branch.{k}": v for k, v in tower.state_dict().items()}
    sd["module.text_projection.0.weight"], sd["module.text_projection.0.bias"] = (
        torch.randn(24, 64), torch.zeros(24))
    sd["module.text_projection.2.weight"], sd["module.text_projection.2.bias"] = (
        torch.randn(24, 24), torch.zeros(24))
    tmp = tempfile.TemporaryDirectory()  # removed when the process ends
    path = os.path.join(tmp.name, "clap.pt")
    torch.save({"state_dict": sd}, path)

    oobleck = {"channels": 8, "c_mults": [1, 2], "strides": [2, 4], "use_snake": True}
    config = {
        "model_type": "diffusion_cond_inpaint", "sample_size": 2048, "sample_rate": 16000,
        "model": {
            "io_channels": 4,
            "pretransform": {"type": "autoencoder", "model_half": True, "chunked": True,
                             "iterate_batch": True, "config": {
                "encoder": {"type": "oobleck", "config": dict(oobleck, in_channels=2,
                                                              latent_dim=8)},
                "decoder": {"type": "oobleck", "config": dict(oobleck, out_channels=2,
                                                              latent_dim=4)},
                "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
                "io_channels": 2}},
            "conditioning": {"cond_dim": 64, "configs": [
                {"id": "prompt", "type": "clap_text", "config": {
                    "clap_ckpt_path": path, "use_text_features": True, "feature_layer_ix": -2}},
                {"id": "seconds_total", "type": "number", "config": {"max_val": 512}}]},
            "diffusion": {"type": "dit", "cross_attention_cond_ids": ["prompt", "seconds_total"],
                          "global_cond_ids": ["seconds_total"],
                          "config": {"io_channels": 4, "embed_dim": 128, "depth": 1,
                                     "num_heads": 2, "cond_token_dim": 64, "global_cond_dim": 64,
                                     "project_cond_tokens": False, "input_concat_dim": 5,
                                     "compute_dtype": "bfloat16"}}}}
    meta = [{"prompt": "rain on a tin roof", "seconds_total": 10}]
    negative = [dict(meta[0], prompt="hiss")]
    init = (16000, 0.1 * np.random.default_rng(0).standard_normal((2, 2048)).astype("float32"))

    def build(model_type, input_concat_dim):
        config["model_type"] = model_type
        config["model"]["diffusion"]["config"]["input_concat_dim"] = input_concat_dim
        model = create_model_from_config(config, "cpu")
        for block in model.model.model.transformer.layers:
            block.self_attn.nhd_min_seq = 0  # the strided-layout attention entry
        return init_random_(model, torch.Generator().manual_seed(0)).eval()

    audio = generate_diffusion_cond(build("diffusion_cond", 0), steps=2, conditioning=meta,
                                    negative_conditioning=negative, sample_size=2048, seed=0,
                                    sampler_type="k-heun", init_audio=init, init_noise_level=3.0)
    assert audio.shape == (1, 2, 2048) and torch.isfinite(audio).all()
    audio = generate_diffusion_cond_inpaint(
        build("diffusion_cond_inpaint", 5), steps=2, conditioning=meta, sample_size=2048, seed=0,
        init_audio=init, mask_args={"maskstart": 500, "maskend": 1500, "softnessL": 0.05})
    assert audio.shape == (1, 2, 2048) and torch.isfinite(audio).all()
    assert "triton" not in sys.modules
    print("ok")
""")


def test_sa2_path_runs_without_jax_or_triton():
    # SA-2.0's shape at toy size (CLAP text conditioner from a checkpoint,
    # NHD attention, chunked codec, negative conditioning, inpainting)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SA2_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


AE_SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import torch
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    oobleck = {"channels": 8, "c_mults": [1, 2], "strides": [2, 2], "use_snake": True}
    scales = {"n_ffts": [64, 32], "hop_lengths": [16, 8], "win_lengths": [64, 32]}
    config = {
        "model_type": "autoencoder", "sample_size": 512, "sample_rate": 44100,
        "model": {"encoder": {"type": "oobleck", "config": dict(oobleck, in_channels=2,
                                                                latent_dim=8)},
                  "decoder": {"type": "oobleck", "config": dict(oobleck, out_channels=2,
                                                                latent_dim=4)},
                  "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 4,
                  "io_channels": 2},
        "training": {"learning_rate": 1e-4, "compute_dtype": "bfloat16", "loss_configs": {
            "discriminator": {"type": "encodec", "config": dict(scales, filters=4),
                              "weights": {"adversarial": 0.1, "feature_matching": 5.0}},
            "spectral": {"type": "mrstft", "config": {
                "fft_sizes": [64, 32], "hop_sizes": [16, 8], "win_lengths": [64, 32],
                "perceptual_weighting": True}, "weights": {"mrstft": 1.0}},
            "bottleneck": {"type": "kl", "weights": {"kl": 1e-4}}}}}
    model = init_random_(create_model_from_config(config, "cpu"), torch.Generator().manual_seed(0))
    wrapper = create_training_wrapper_from_config(config, model)
    audio = torch.randn(2, 2, 512, generator=torch.Generator().manual_seed(1)) * 0.3
    gen = wrapper.train_step(audio)
    disc = wrapper.train_step(audio)
    assert wrapper.step == 2 and "mrstft_loss" in gen and "discriminator_loss" in disc
    assert all(torch.isfinite(v) for v in (*gen.values(), *disc.values()))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in (*wrapper.params.values(), *wrapper.disc_params.values()))
    assert "triton" not in sys.modules
    print("ok")
""")


def test_ae_training_runs_without_jax_or_triton():
    # the autoencoder GAN path at toy size in bf16 (snake and snake-conv
    # Functions with their plain backwards, Conv1dS1, STFT losses, EnCodec
    # discriminator): one generator step and one discriminator step
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", AE_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


LM_SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import torch
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.lm import lm_generate_audio
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    seanet = {"channels": 1, "dimension": 16, "n_filters": 4, "lstm": 1}
    config = {
        "model_type": "lm", "sample_size": 128, "sample_rate": 8000, "audio_channels": 1,
        "model": {
            "pretransform": {"type": "autoencoder", "config": {
                "encoder": {"type": "seanet", "config": dict(seanet, ratios=[2, 4])},
                "decoder": {"type": "seanet", "config": dict(seanet, ratios=[4, 2])},
                "bottleneck": {"type": "rvq", "config": {"dim": 16, "codebook_size": 32,
                                                         "num_quantizers": 2}},
                "latent_dim": 16, "downsampling_ratio": 8, "io_channels": 1}},
            "conditioning": {"cond_dim": 32, "configs": [{"id": "prompt", "type": "t5", "config": {
                "max_length": 6, "allow_random_init": True, "arch": [32, 64, 1, 2, 16, False]}}]},
            "lm": {"codebook_pattern": {"type": "delay"}, "cross_attention_cond_ids": ["prompt"],
                   "config": {"embed_dim": 128, "depth": 1, "num_heads": 2,
                              "cross_attn_cond_dim": 32, "compute_dtype": "bfloat16"}}},
        "training": {"learning_rate": 1e-4}}
    model = init_random_(create_model_from_config(config, "cpu"), torch.Generator().manual_seed(0))
    wrapper = create_training_wrapper_from_config(config, model)
    audio = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(1)) * 0.3
    aux = wrapper.train_step(audio, [{"prompt": "rain"}, {"prompt": "a drum"}])
    assert wrapper.step == 1 and all(torch.isfinite(v) for v in aux.values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in wrapper.params.values())
    cond = model.conditioner([{"prompt": "rain"}], "cpu")
    out = lm_generate_audio(model.eval(), cond, max_gen_len=6, cfg_scale=3.0, top_k=8,
                            generator=torch.Generator().manual_seed(2))
    assert out.shape == (1, 1, 48) and torch.isfinite(out).all()
    assert "triton" not in sys.modules
    print("ok")
""")


def test_lm_path_runs_without_jax_or_triton():
    # the token LM at toy size in bf16 (SEANet + RVQ codec, T5, the causal
    # backbone through the flash function's plain version): one training
    # step and a KV-cached CFG generation decoded to audio
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", LM_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


SA2_TRAINING_SCRIPT = textwrap.dedent("""
    import json, os, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import numpy as np
    import torch
    from stable_audio_tools_tpu_torch import pre_encode, train
    from stable_audio_tools_tpu_torch.data.wav import save_wav
    from stable_audio_tools_tpu_torch.ops.attention import Attention

    ae = {"encoder": {"type": "oobleck", "config": {
              "in_channels": 2, "channels": 8, "c_mults": [1, 2], "strides": [2, 4],
              "latent_dim": 8, "use_snake": True}},
          "decoder": {"type": "oobleck", "config": {
              "out_channels": 2, "channels": 8, "c_mults": [1, 2], "strides": [2, 4],
              "latent_dim": 4, "use_snake": True}},
          "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
          "io_channels": 2}
    model = {
        "model_type": "diffusion_cond", "sample_size": 512, "sample_rate": 16000,
        "model": {
            "io_channels": 4,
            "pretransform": {"type": "autoencoder", "config": ae},
            "conditioning": {"cond_dim": 64, "configs": [
                {"id": "seconds_total", "type": "number", "config": {"max_val": 512}}]},
            "diffusion": {"type": "dit", "cross_attention_cond_ids": ["seconds_total"],
                          "global_cond_ids": ["seconds_total"],
                          "config": {"io_channels": 4, "embed_dim": 128, "depth": 1,
                                     "num_heads": 2, "cond_token_dim": 64,
                                     "global_cond_dim": 64, "project_cond_tokens": False,
                                     "use_checkpointing": True}}},
        "training": {"pre_encoded": True, "mask_padding": True, "optimizer_configs": {
            "diffusion": {"optimizer": {"type": "AdamW", "config": {"lr": 1e-4}}}}}}
    calls = []
    real = Attention._forward_fused
    Attention._forward_fused = lambda self, *a: calls.append(1) or real(self, *a)
    import stable_audio_tools_tpu_torch.ops.attention as attn
    attn.NHD_MIN_SEQ = 32  # the fused route needs the NHD route's length: 1 + 64 tokens
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/wavs")
        rng = np.random.default_rng(0)
        for i, n in enumerate((400, 512, 700, 900)):
            save_wav(f"{tmp}/wavs/{i}.wav", 0.3 * rng.standard_normal((2, n)), 16000)
        files = {"ae.json": {"model_type": "autoencoder", "sample_size": 512,
                             "sample_rate": 16000, "model": ae},
                 "wavs.json": {"dataset_type": "audio_dir", "random_crop": False,
                               "datasets": [{"id": "w", "path": f"{tmp}/wavs"}]},
                 "lat.json": {"dataset_type": "pre_encoded", "latent_crop_length": 64,
                              "datasets": [{"id": "l", "path": f"{tmp}/lat"}]},
                 "model.json": model}
        for name, content in files.items():
            with open(f"{tmp}/{name}", "w") as f:
                json.dump(content, f)
        got = pre_encode.main(["--model-config", f"{tmp}/ae.json", "--dataset-config",
                               f"{tmp}/wavs.json", "--output-path", f"{tmp}/lat",
                               "--batch-size", "2", "--num-workers", "0", "--device", "cpu"])
        assert got["items"] == 4
        trainer = train.main(["--model-config", f"{tmp}/model.json", "--dataset-config",
                              f"{tmp}/lat.json", "--batch-size", "2", "--num-workers", "0",
                              "--max-steps", "2", "--save-dir", f"{tmp}/run", "--device", "cpu"])
        assert trainer.wrapper.step == 2 and len(calls) == 2 * 2
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in trainer.wrapper.params.values())
    assert "triton" not in sys.modules
    print("ok")
""")


def test_sa2_training_runs_without_jax_or_triton():
    # pre-encode WAVs, then train a rotary DiT from the latents with the
    # padding mask, its self-attention on the fused-QKV entry (bf16 compute)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SA2_TRAINING_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "ok"  # after pre_encode's own line


DANCE_SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import torch
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_uncond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    config = {
        "model_type": "diffusion_uncond", "sample_size": 256, "sample_rate": 16000,
        "model": {"type": "DAU1d", "config": {
            "io_channels": 2, "depth": 4, "n_attn_layers": 2, "channels": [16, 32, 64, 64],
            "strides": [2, 2, 2], "compute_dtype": "bfloat16"}},
        "training": {"learning_rate": 1e-4}}
    model = init_random_(create_model_from_config(config, "cpu"), torch.Generator().manual_seed(0))
    for sampler in ("dpmpp-2m-sde", "v-ddim"):
        audio = generate_diffusion_uncond(model.eval(), steps=3, sample_size=256, seed=0,
                                          sampler_type=sampler)
        assert audio.shape == (1, 2, 256) and torch.isfinite(audio).all()
    wrapper = create_training_wrapper_from_config(config, model)
    audio = torch.randn(2, 2, 256, generator=torch.Generator().manual_seed(1)) * 0.3
    aux = wrapper.train_step(audio, [{}, {}])
    assert wrapper.step == 1 and all(torch.isfinite(v) for v in aux.values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in wrapper.params.values())
    assert "triton" not in sys.modules
    print("ok")
""")


def test_dance_path_runs_without_jax_or_triton():
    # Dance Diffusion at toy size in bf16 (DAU1d: Conv1dS1 with the plain
    # weight gradient, GroupNorm, attention, FIR resamplers): generation by
    # dpmpp-2m-sde and v-DDIM, and one unconditional training step
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", DANCE_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


SA1_SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import torch
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    config = {
        "model_type": "diffusion_cond", "sample_size": 512, "sample_rate": 16000,
        "model": {
            "io_channels": 4,
            "pretransform": {"type": "autoencoder", "model_half": True, "iterate_batch": True,
                             "config": {
                "encoder": {"type": "dac", "config": {"in_channels": 2, "latent_dim": 8,
                                                       "d_model": 8, "strides": [2, 4]}},
                "decoder": {"type": "dac", "config": {"out_channels": 2, "latent_dim": 4,
                                                       "channels": 32, "rates": [4, 2]}},
                "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
                "io_channels": 2}},
            "conditioning": {"cond_dim": 32, "configs": [
                {"id": "prompt", "type": "clap_text", "config": {
                    "allow_random_init": True, "use_text_features": True,
                    "feature_layer_ix": -2}},
                {"id": "seconds_start", "type": "int", "config": {"max_val": 512}},
                {"id": "seconds_total", "type": "int", "config": {"max_val": 512}}]},
            "diffusion": {"type": "adp_cfg_1d",
                          "cross_attention_cond_ids": ["prompt", "seconds_start",
                                                       "seconds_total"],
                          "config": {"in_channels": 4, "channels": 32, "multipliers": [1, 2],
                                     "factors": [2], "num_blocks": [1], "attentions": [1, 1],
                                     "resnet_groups": 8, "attention_heads": 2,
                                     "context_embedding_features": 32,
                                     "context_embedding_max_length": 79}}}}
    model = init_random_(create_model_from_config(config, "cpu"), torch.Generator().manual_seed(0))
    meta = [{"prompt": "rain on a tin roof", "seconds_start": 0, "seconds_total": 10}]
    negative = [{"prompt": "noise", "seconds_start": 0, "seconds_total": 10}]
    audio = generate_diffusion_cond(model.eval(), steps=2, conditioning=meta,
                                    negative_conditioning=negative, sample_size=512, seed=0)
    assert audio.shape == (1, 2, 512) and torch.isfinite(audio).all() and audio.abs().max() <= 1
    varied = generate_diffusion_cond(model, steps=2, conditioning=meta, sample_size=512, seed=0,
                                     init_audio=(16000, 0.3 * torch.randn(2, 512)),
                                     init_noise_level=5.0, scale_phi=0.4)
    assert varied.shape == (1, 2, 512) and torch.isfinite(varied).all()
    assert "triton" not in sys.modules
    print("ok")
""")


def test_sa1_path_runs_without_jax_or_triton():
    # SA-1.0's shape at toy size (CLAP text features, int conditioners, the
    # ADP UNetCFG1d with its own CFG, the DAC VAE in bf16): generation with a
    # negative prompt, and from init audio with the CFG rescale
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SA1_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


TRAINING_SCRIPT = textwrap.dedent("""
    import copy, sys
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import torch
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    def finite(wrapper, *auxs):
        assert all(torch.isfinite(v) for aux in auxs for v in aux.values())
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in wrapper.params.values())

    dac = {"type": "autoencoder", "model_half": True, "iterate_batch": True, "config": {
        "encoder": {"type": "dac", "config": {"in_channels": 2, "latent_dim": 8, "d_model": 8,
                                              "strides": [2, 4]}},
        "decoder": {"type": "dac", "config": {"out_channels": 2, "latent_dim": 4,
                                              "channels": 32, "rates": [4, 2]}},
        "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
        "io_channels": 2}}
    sa1 = {
        "model_type": "diffusion_cond", "sample_size": 512, "sample_rate": 16000,
        "model": {
            "io_channels": 4, "pretransform": dac,
            "conditioning": {"cond_dim": 32, "configs": [
                {"id": "prompt", "type": "clap_text", "config": {
                    "allow_random_init": True, "use_text_features": True,
                    "feature_layer_ix": -2}},
                {"id": "seconds_start", "type": "int", "config": {"max_val": 512}},
                {"id": "seconds_total", "type": "int", "config": {"max_val": 512}}]},
            "diffusion": {"type": "adp_cfg_1d",
                          "cross_attention_cond_ids": ["prompt", "seconds_start",
                                                       "seconds_total"],
                          "config": {"in_channels": 4, "channels": 32, "multipliers": [1, 2],
                                     "factors": [2], "num_blocks": [1], "attentions": [1, 1],
                                     "resnet_groups": 8, "attention_heads": 2,
                                     "context_embedding_features": 32,
                                     "context_embedding_max_length": 79}}},
        "training": {"cfg_dropout_prob": 0.5, "optimizer_configs": {"diffusion": {
            "optimizer": {"type": "AdamW", "config": {"lr": 5e-5, "weight_decay": 1e-3}}}}}}
    model = init_random_(create_model_from_config(sa1, "cpu"), torch.Generator().manual_seed(0))
    w = create_training_wrapper_from_config(sa1, model)
    meta = [{"prompt": "rain", "seconds_start": 0, "seconds_total": 10},
            {"prompt": "a drum", "seconds_start": 2, "seconds_total": 3}]
    finite(w, w.train_step(torch.randn(2, 2, 512) * 0.3, meta))

    scales = {"n_ffts": [64, 32], "hop_lengths": [16, 8], "win_lengths": [64, 32]}
    losses = {
        "discriminator": {"type": "encodec", "config": dict(scales, filters=4),
                          "weights": {"adversarial": 0.1, "feature_matching": 5.0}},
        "spectral": {"type": "mrstft", "config": {
            "fft_sizes": [64, 32], "hop_sizes": [16, 8], "win_lengths": [64, 32],
            "perceptual_weighting": True}, "weights": {"mrstft": 1.0}}}
    seanet = {"channels": 1, "dimension": 8, "n_filters": 4, "ratios": [2, 2], "lstm": 2}
    codec = {"encoder": {"type": "seanet", "config": seanet},
             "decoder": {"type": "seanet", "config": seanet},
             "bottleneck": {"type": "rvq", "config": {
                 "num_quantizers": 2, "codebook_size": 16, "dim": 8,
                 "threshold_ema_dead_code": 2}},
             "latent_dim": 8, "downsampling_ratio": 4, "io_channels": 1}
    for channels, model_cfg in ((2, dac["config"]), (1, codec)):
        cfg = {"model_type": "autoencoder", "sample_size": 512, "sample_rate": 32000,
               "audio_channels": channels, "model": copy.deepcopy(model_cfg),
               "training": {"learning_rate": 1e-4, "compute_dtype": "bfloat16",
                            "loss_configs": losses}}
        model = init_random_(create_model_from_config(cfg, "cpu"),
                             torch.Generator().manual_seed(0))
        w = create_training_wrapper_from_config(cfg, model)
        audio = torch.randn(2, channels, 512) * 0.3
        gen, disc = w.train_step(audio), w.train_step(audio)
        finite(w, gen, disc)
    assert "quantizer_loss" in gen and bool(model.bottleneck.quantizer.initted)
    assert "triton" not in sys.modules
    print("ok")
""")


def test_sa1_dac_and_codec_training_run_without_jax_or_triton():
    # the training paths of SA-1.0 (the ADP UNetCFG1d with CFG dropout, the
    # frozen DAC encode), of a DAC VAE-GAN and of an EnCodec-style codec (the
    # RVQ's k-means init, EMA update and dead-code revival, the SEANet in
    # bf16 up to its LSTM), at toy size: one step each, two for the GANs
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TRAINING_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")
