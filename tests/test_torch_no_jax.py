"""The port imports and runs (a generation and a training step) with JAX,
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
    model = init_random_(create_model_from_config(config), torch.Generator().manual_seed(0))
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
