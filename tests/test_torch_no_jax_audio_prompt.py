"""The other pretransforms and conditioners run with JAX, flax, transformers
and the JAX package unimportable (the machine with the card has none of
them), and without triton: each new module imported alone; the `patched`,
`wavelet`, `pqmf`, `dac_pretrained` and `audiocraft_pretrained`
pretransforms round trip; the `list`, `phoneme`, `pretransform`,
`source_mix` and `clap_audio` conditioners run; a tiny audio-prompted DiT
trains two steps through the training entry (the prompt and the label from
a `custom_metadata_module`) and generates. The subprocess takes one
intra-op thread."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, json, os, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "transformers", "safetensors",
                 "stable_audio_tools_tpu"):
        sys.modules[name] = None  # any import of these raises ImportError

    import numpy as np
    import torch
    torch.set_num_threads(1)
    for name in ("pqmf", "wavelets", "htsat", "pretransforms", "conditioners"):
        importlib.import_module("stable_audio_tools_tpu_torch.models." + name)

    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.data.wav import save_wav
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.conditioners import (
        create_multi_conditioner_from_conditioning_config)
    from stable_audio_tools_tpu_torch.models.factory import (
        create_pretransform_from_config, init_random_)

    g = torch.Generator().manual_seed(0)
    for cfg, ch in (({"type": "patched", "config": {"patch_size": 4}}, 2),
                    ({"type": "wavelet", "config": {"channels": 2, "levels": 2,
                                                    "wavelet": "bior2.6"}}, 2),
                    ({"type": "pqmf", "config": {"num_bands": 4}}, 2),
                    ({"type": "dac_pretrained", "config": {
                        "model_type": "custom", "strides": [2, 4], "d_model": 16,
                        "latent_dim": 64, "channels": 32, "n_codebooks": 2,
                        "codebook_size": 16}}, 1),
                    ({"type": "audiocraft_pretrained", "config": {
                        "model_type": "custom", "ratios": [4, 2], "n_filters": 8,
                        "dimension": 16, "num_quantizers": 2, "codebook_size": 32}}, 1)):
        pt = init_random_(create_pretransform_from_config(cfg, 16000, "cpu"), g)
        x = torch.randn(1, ch, 256, generator=g)
        with torch.no_grad():
            y = pt.decode(pt.encode(x))
            if pt.is_discrete:
                y = pt.decode_tokens(pt.tokenize(x))
        assert y.shape == x.shape and torch.isfinite(y).all(), cfg["type"]

    vae = {"type": "autoencoder", "config": {
        "encoder": {"type": "oobleck", "config": {"in_channels": 2, "channels": 8,
                    "c_mults": [1, 2], "strides": [2, 4], "latent_dim": 8}},
        "decoder": {"type": "oobleck", "config": {"out_channels": 2, "channels": 8,
                    "c_mults": [1, 2], "strides": [2, 4], "latent_dim": 4}},
        "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
        "io_channels": 2}}
    mc = create_multi_conditioner_from_conditioning_config({"cond_dim": 32, "configs": [
        {"id": "genre", "type": "list", "config": {"options": ["a", "b"]}},
        {"id": "lyrics", "type": "phoneme", "config": {"project_out": True}},
        {"id": "ref", "type": "pretransform", "config": {"sample_rate": 16000,
                                                         "pretransform_config": vae}},
        {"id": "stems", "type": "source_mix", "config": {"sample_rate": 16000,
                                                         "pretransform_config": vae,
                                                         "source_keys": ["bass"]}},
        {"id": "clap", "type": "clap_audio", "config": {
            "audio_model_type": "HTSAT-tiny", "allow_random_init": True}}]}, device="cpu")
    init_random_(mc, g)
    clip = np.random.default_rng(1).standard_normal((2, 256)).astype(np.float32)
    with torch.no_grad():
        out = mc([{"genre": "b", "lyrics": "hi", "ref": clip, "stems": {"bass": clip},
                   "clap": clip}], "cpu")
    shapes = {k: tuple(v[0].shape) for k, v in out.items()}
    assert shapes == {"genre": (1, 1, 32), "lyrics": (1, 2, 32), "ref": (1, 32, 32),
                      "stems": (1, 32, 32), "clap": (1, 1, 32)}, shapes
    assert all(torch.isfinite(v[0]).all() for v in out.values())

    config = {
        "model_type": "diffusion_cond", "sample_size": 512, "sample_rate": 16000,
        "model": {
            "io_channels": 4, "pretransform": vae,
            "conditioning": {"cond_dim": 64, "configs": [
                {"id": "audio_prompt", "type": "pretransform",
                 "config": {"use_model_pretransform": True, "sample_rate": 16000}},
                {"id": "genre", "type": "list", "config": {"options": ["a", "b"]}}]},
            "diffusion": {"type": "dit", "cross_attention_cond_ids": ["genre"],
                          "input_concat_ids": ["audio_prompt"],
                          "config": {"io_channels": 4, "embed_dim": 64, "depth": 1,
                                     "num_heads": 1, "cond_token_dim": 64,
                                     "input_concat_dim": 64, "project_cond_tokens": False}}},
        "training": {"learning_rate": 1e-4}}
    tmp = tempfile.TemporaryDirectory()  # removed when the process ends
    root = tmp.name
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(root, "wavs"))
    for i in range(4):
        save_wav(os.path.join(root, "wavs", f"{i}.wav"), 0.3 * rng.standard_normal((2, 600)),
                 16000)
    with open(os.path.join(root, "meta.py"), "w") as f:
        f.write("def get_custom_metadata(info, audio):\\n"
                "    return {'audio_prompt': audio[:, ::-1].copy(), 'genre': 'a'}\\n")
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump({"dataset_type": "audio_dir", "datasets": [
            {"id": "n", "path": os.path.join(root, "wavs"),
             "custom_metadata_module": os.path.join(root, "meta.py")}]}, f)
    with open(os.path.join(root, "model.json"), "w") as f:
        json.dump(config, f)
    trainer = train.main(["--model-config", os.path.join(root, "model.json"),
                          "--dataset-config", os.path.join(root, "data.json"),
                          "--batch-size", "2", "--num-workers", "0", "--device", "cpu",
                          "--precision", "32", "--save-dir", os.path.join(root, "run"),
                          "--max-steps", "2", "--checkpoint-every", "0"])
    log = [json.loads(s) for s in open(os.path.join(root, "run", "train_log.jsonl"))]
    assert len([r for r in log if "train/loss" in r]) == 2
    model = trainer.wrapper.model.eval()
    prompt = np.random.default_rng(3).standard_normal((2, 512)).astype(np.float32)
    audio = generate_diffusion_cond(model, steps=3, cfg_scale=3.0, batch_size=1,
                                    sample_size=512, seed=0, sampler_type="dpmpp-2m",
                                    conditioning=[{"audio_prompt": prompt, "genre": "b"}])
    assert audio.shape == (1, 2, 512) and torch.isfinite(audio).all()
    assert "triton" not in sys.modules
    print("ok")
""")


def test_other_pretransforms_and_conditioners_run_without_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
