"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with a CUDA card, `nvcc` and
`triton`; needs no network and no JAX. Three phases, each printing one line;
any failure raises and the exit code is nonzero:

1. Device and build: the card's name and power limit, then every CUDA source
   of the port compiled from the checkout (seconds printed).
2. Kernels: each hand-written kernel on the main path against its plain
   PyTorch version on the card, at the main path's shapes, bf16, with the
   tolerance stated beside it; both timed with CUDA events after a warm-up.
3. Main path: SA-Open (the shipped stable_audio_open_1_0.json, built by the
   port's factory, random weights from a seeded torch.Generator, random T5)
   runs generate_diffusion_cond with cfg 6, dpmpp-3m-sde, sigma in [0.3, 500],
   batch 1, 2,097,152 samples, 100 steps. Every kernel's launch count must
   rise during that call and the audio must be finite [1, 2, 2097152]; a tiny
   SA-Open-shaped model must agree between the card (kernels) and the CPU
   (plain versions) on replayed noise.

The last lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SA_OPEN = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "txt2audio", "stable_audio_open_1_0.json")
STEPS = 100
SAMPLE_SIZE = 2097152
PROMPT = [{"prompt": "An upbeat electronic track with a driving bassline",
           "seconds_start": 0, "seconds_total": SAMPLE_SIZE / 44100.0}]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all() or err > tol:
        raise AssertionError(f"{name}: max|err| {err:.4g} > tol {tol:.4g}")
    return err


def bf16_tol(want: torch.Tensor, ulps: int = 2) -> float:
    """`ulps` bf16 units in the last place at the reference's largest value
    (bf16 keeps 8 significant bits: one ulp at magnitude m is <= m * 2^-7)."""
    return ulps * 2.0 ** -7 * max(1.0, want.float().abs().max().item())


def phase_kernels(dev):
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs
    from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa
    from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln
    from stable_audio_tools_tpu_torch.ops.kernels import snake as sn

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rec = {}

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # 1. DiT self-attention: [2, 24, 1 + 1024, 64], prefix 1
    q, k, v = (randn(2, 24, 1025, 64) for _ in range(3))
    out, lse = fa.flash_attention_prefix(q, k, v, 1)
    ref, ref_lse = fa.flash_attention_prefix_plain(q, k, v, 1)
    err = compare("flash out", out, ref, bf16_tol(ref))
    compare("flash lse", lse, ref_lse, 1e-3)
    rec["flash_attention_prefix"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/flash_prefix.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/flash_attention.py:181",
        shape="q,k,v [2,24,1025,64] bf16, prefix 1", max_abs_err=err,
        tol="2 bf16 ulps at max|ref| (out), 1e-3 (lse)",
        ms=cuda_ms(lambda: fa.flash_attention_prefix(q, k, v, 1), 50),
        plain_ms=cuda_ms(lambda: fa.flash_attention_prefix_plain(q, k, v, 1), 20))

    # 2. DiT block norms: [2, 1025, 1536] bf16, gamma f32
    x = randn(2, 1025, 1536, scale=3.0)
    gamma = randn(1536, dtype=torch.float32)
    y, ref = ln.fused_layer_norm(x, gamma), ln.fused_layer_norm_plain(x, gamma)
    err = compare("layer norm", y, ref, bf16_tol(ref))
    rec["fused_layer_norm"] = dict(
        route="triton", source="stable_audio_tools_tpu_torch/ops/kernels/layer_norm_triton.py",
        replaces="stable_audio_tools_tpu/ops/kernels/layer_norm.py:32",
        shape="x [2,1025,1536] bf16, gamma f32", max_abs_err=err,
        tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(lambda: ln.fused_layer_norm(x, gamma), 200),
        plain_ms=cuda_ms(lambda: ln.fused_layer_norm_plain(x, gamma), 200))

    # 3. decoder snakes before each transposed upsample, [1, C, L]
    errs = []
    for C, L in ((2048, 1024), (1024, 8192), (512, 65536), (256, 262144), (128, 1048576)):
        x = randn(1, C, L, scale=2.0)
        a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
        y, ref = sn.snake_fused(x, a, b), sn.snake_fused_plain(x, a, b)
        errs.append(compare(f"snake [1,{C},{L}]", y, ref, bf16_tol(ref)))
    rec["snake_fused"] = dict(
        route="triton", source="stable_audio_tools_tpu_torch/ops/kernels/snake_triton.py",
        replaces="stable_audio_tools_tpu/ops/kernels/snake.py:52",
        shape="x [1,128,1048576] bf16 (timed; 5 decoder shapes checked)",
        max_abs_err=max(errs), tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(lambda: sn.snake_fused(x, a, b), 20),
        plain_ms=cuda_ms(lambda: sn.snake_fused_plain(x, a, b), 10))

    # 4. decoder residual units: conv1 k=7 d in {1,3,9}; conv2 k=1 + skip;
    #    conv_out k=7 128 -> 2 without bias
    def conv_case(C, Co, L, kk, d, bias=True, res=False):
        x = randn(1, C, L)
        w = randn(Co, C, kk, scale=(C * kk) ** -0.5)
        bias_t = randn(Co, dtype=torch.float32) * 0.1 if bias else None
        a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
        r = randn(1, Co, L) if res else None
        pad = d * (kk - 1) // 2
        if res:
            run = lambda: cs.snake_conv1d_res(x, w, bias_t, a, b, r, pad, pad, d)
        else:
            run = lambda: cs.snake_conv1d(x, w, bias_t, a, b, pad, pad, d)
        plain = lambda: cs.snake_conv1d_plain(x, w, bias_t, a, b, pad, pad, d, r)
        ref = plain()
        return compare(f"snake_conv1d C={C} Co={Co} L={L} k={kk} d={d} res={res}",
                       run(), ref, bf16_tol(ref)), run, plain

    errs = []
    for C, L, d in ((1024, 8192, 1), (512, 65536, 3), (256, 262144, 9), (128, 1048576, 1)):
        errs.append(conv_case(C, C, L, 7, d)[0])
    errs.append(conv_case(128, 2, SAMPLE_SIZE, 7, 1, bias=False)[0])
    err, run, plain = conv_case(128, 128, SAMPLE_SIZE, 7, 9)
    errs.append(err)
    rec["snake_conv1d"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake_conv1d.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:88",
        shape="x [1,128,2097152] k=7 d=9 bf16 (timed; 6 decoder shapes checked)",
        max_abs_err=max(errs), tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(run, 3), plain_ms=cuda_ms(plain, 3))
    errs = [conv_case(C, C, L, 1, 1, res=True)[0]
            for C, L in ((1024, 8192), (512, 65536), (256, 262144))]
    err, run, plain = conv_case(128, 128, SAMPLE_SIZE, 1, 1, res=True)
    errs.append(err)
    rec["snake_conv1d_res"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake_conv1d.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:107",
        shape="x [1,128,2097152] k=1 + residual bf16 (timed; 4 decoder shapes checked)",
        max_abs_err=max(errs), tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(run, 3), plain_ms=cuda_ms(plain, 3))
    return rec


def counters():
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs
    from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa
    from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln
    from stable_audio_tools_tpu_torch.ops.kernels import snake as sn

    return {"flash_attention_prefix": fa.flash_attention_prefix,
            "fused_layer_norm": ln.fused_layer_norm,
            "snake_conv1d": cs.snake_conv1d,
            "snake_conv1d_res": cs.snake_conv1d_res,
            "snake_fused": sn.snake_fused}


def sa_open_config():
    with open(SA_OPEN) as f:
        cfg = json.load(f)
    for c in cfg["model"]["conditioning"]["configs"]:
        if c["type"] == "t5":
            c["config"]["allow_random_init"] = True
    return cfg


def tiny_config():
    """SA-Open's shape at toy size: the same blocks, conditioners and kernels
    (head dim 64, prefix 1), 2 DiT layers of 128, a small T5, a 2-level VAE."""
    cfg = sa_open_config()
    m = cfg["model"]
    m["conditioning"]["configs"][0]["config"].update(max_length=16, arch=[64, 128, 2, 2, 32, False])
    m["conditioning"]["cond_dim"] = 64
    m["diffusion"]["config"].update(embed_dim=128, depth=2, num_heads=2, cond_token_dim=64,
                                    global_cond_dim=128, io_channels=16)
    m["io_channels"] = 16
    ae = m["pretransform"]["config"]
    ae["encoder"]["config"].update(channels=32, c_mults=[1, 2], strides=[4, 8], latent_dim=32)
    ae["decoder"]["config"].update(channels=32, c_mults=[1, 2], strides=[4, 8], latent_dim=16)
    ae.update(latent_dim=16, downsampling_ratio=32)
    return cfg


@torch.inference_mode()
def small_check(dev) -> float:
    """Largest relative error (max|card - CPU| / max|CPU|) of a tiny
    SA-Open-shaped model's conditioning + CFG denoiser call and VAE decode,
    with the kernels on the card against the plain versions on the CPU.
    Both run bf16 compute; 5% is a few bf16 roundings through 2 DiT layers
    and the decoder."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    cpu = init_random_(create_model_from_config(tiny_config()),
                       torch.Generator().manual_seed(1)).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(2)
    x, z = torch.randn(1, 16, 128, generator=g), torch.randn(1, 16, 128, generator=g)
    t = torch.tensor([0.5])
    errs = []
    for name, run in (
        ("denoiser", lambda m, d: m(x.to(d), t.to(d), cfg_scale=6.0,
                                    **m.get_conditioning_inputs(m.conditioner(PROMPT, d)))),
        ("decode", lambda m, d: m.pretransform.decode(z.to(d))),
    ):
        want, got = run(cpu, "cpu").float(), run(gpu, dev).float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"small {name}: non-finite output on the card")
        errs.append((got - want).abs().max().item() / max(want.abs().max().item(), 1e-6))
    return max(errs)


@torch.inference_mode()
def stage_breakdown(model, dev) -> dict:
    """Where the main path's time goes, per layer: conditioning (T5 + number
    conditioners), one sampler step (a CFG denoiser call on the doubled
    batch), the VAE decode; host clock around synchronised work. Then
    torch.profiler over one step and one decode: device-busy share (kernel
    time / wall) and the largest kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed(fn, n=1):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, out

    cond_ms, tensors = timed(lambda: model.conditioner(PROMPT, dev), 3)
    cond = model.get_conditioning_inputs(tensors)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 64, SAMPLE_SIZE // 2048, generator=g, device=dev)
    t = torch.full((1,), 0.5, device=dev)
    step = lambda: model(x, t, cfg_scale=6.0, **cond)
    decode = lambda: model.pretransform.decode(x)
    step_ms, _ = timed(step, 5)
    decode_ms, _ = timed(decode, 2)
    out = dict(cond_ms=cond_ms, step_ms=step_ms, decode_ms=decode_ms)
    for name, fn in (("step", step), ("decode", decode)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out[f"{name}_device_busy"] = busy_us / wall_us
        out[f"{name}_top_kernels_ms"] = {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
                                         for e in top}
    return out


def phase_main_path(dev):
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    # small input: kernels on the card vs plain versions on the CPU, stage by
    # stage (a random bf16 model amplifies rounding differences chaotically
    # over sampler steps, so the steps are not compared end to end)
    small_err, small_tol = small_check(dev), 0.05
    if small_err > small_tol:
        raise AssertionError(f"small SA-Open-shaped model: card vs CPU relative error "
                             f"{small_err:.4g} > {small_tol}")

    # full width: SA-Open from the shipped config
    t0 = time.perf_counter()
    with torch.device(dev):
        model = create_model_from_config(sa_open_config())
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    run = lambda steps, seed: generate_diffusion_cond(
        model, steps=steps, cfg_scale=6.0, conditioning=PROMPT, batch_size=1,
        sample_size=SAMPLE_SIZE, seed=seed, sampler_type="dpmpp-3m-sde",
        sigma_min=0.3, sigma_max=500.0)
    run(2, 0)  # warm-up: Triton JIT and cuDNN plans at the full shapes
    torch.cuda.synchronize()
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    audio = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    if tuple(audio.shape) != (1, 2, SAMPLE_SIZE) or not torch.isfinite(audio).all():
        raise AssertionError(f"audio {tuple(audio.shape)} finite={bool(torch.isfinite(audio).all())}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the main path: {idle}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    return dict(wall_s=wall, steps=STEPS, audio_s=SAMPLE_SIZE / 44100.0,
                audio_s_per_s=SAMPLE_SIZE / 44100.0 / wall, launches=launches,
                params=n_params, build_s=build_s, small_err=small_err, small_tol=small_tol,
                peak_gib=peak_gib, breakdown=stage_breakdown(model, dev))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stable_audio_tools_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device+build: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc seconds {json.dumps({k: round(v, 2) for k, v in _build.build_all().items()})}",
          flush=True)

    rec = phase_kernels(dev)
    print("phase 2 kernels: " + "; ".join(
        f"{n} err {r['max_abs_err']:.3g} ({r['tol']}) {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms"
        for n, r in rec.items()), flush=True)

    main_rec = phase_main_path(dev)
    print(f"phase 3 main path: SA-Open {main_rec['params'] / 1e9:.3f}B params, {STEPS} steps "
          f"dpmpp-3m-sde cfg 6, {SAMPLE_SIZE} samples: wall {main_rec['wall_s']:.3f} s, "
          f"{main_rec['audio_s_per_s']:.3f} audio-s/s, peak {main_rec['peak_gib']:.2f} GiB, "
          f"launches {json.dumps(main_rec['launches'])}, small card-vs-CPU rel err "
          f"{main_rec['small_err']:.3g} (tol {main_rec['small_tol']:.3g}) on {card}", flush=True)

    kernels = [dict(name=n, route=r["route"], source=r["source"], replaces=r["replaces"],
                    launches=main_rec["launches"][n], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"], shape=r["shape"])
               for n, r in rec.items()]
    print(json.dumps({"kernels": kernels, "card": card, "main_path": {
        k: main_rec[k] for k in ("wall_s", "steps", "audio_s_per_s", "peak_gib", "breakdown")}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
