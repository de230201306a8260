"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with a CUDA card and `nvcc`;
needs no network, no Triton and no JAX. Fourteen phases, each printing one
line (phase 2 several); any failure raises and the exit code is nonzero:

1. Device and build: the card's name and power limit, then every CUDA source
   of the port compiled from the checkout, all at once (seconds printed).
2. Kernels: each hand-written kernel on the main paths against its plain
   PyTorch version on the card, at the main paths' shapes, bf16, with the
   tolerance stated beside it; both timed with CUDA events after a warm-up,
   beside the one PyTorch call that computes the same function where there
   is one (`scaled_dot_product_attention`, `layer_norm`; a yardstick only,
   used nowhere in the port) and the least time the card could take (the
   larger of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s).
   The flash-attention backward is checked and timed by both of its routes
   (single pass with atomic dQ; two passes) at SA-Open's and SA-2.0's
   training shapes, beside SDPA's backward and its bound; the training
   route must give the same bits on two runs, and ptxas's registers and
   spills of every instantiation are printed; and the autograd wrappers'
   gradients (flash attention in both layouts, LayerNorm) against autograd
   through the plain versions. The strided-layout flash attention is checked
   on views of a fused projection output and on contiguous tensors, at
   SA-2.0's and SA-Open's lengths and causally, and timed against the
   [B, H, N, 64] entry with the transposed copy of its output that route
   pays (both entries launch the same kernel). The
   backward kernels of autoencoder training (snake backward, snake-conv dx,
   snake-conv and plain weight gradients) are held at the SA-2.0 VAE's
   shapes at batch 4: dx within 2 bf16 ulps, the f32 gradient sums within 1%
   of their peaks. The snake (`csrc/snake.cu`: row 4 forward, row 9
   backward) is timed at each of the VAE's six snake sites both ways and
   summed with a generator step's launches against the summed byte bounds,
   the forward also over an SA-2.0 decode group's five sites; two backward
   calls must give the same bits. The causal / sliding-window `flash_attention` and the
   banded backward (both routes) are held at the LM's causal shapes and
   TAAE's windowed ones (FLASH_SHAPES), each timed beside SDPA with the same
   mask, and `flash_attention_nhd`'s causal backward at [1, 4096, 16, 64].
   The fused-QKV entry `flash_attention_fused_qkv` (the rotary pass, then
   the attention kernel) is held at SA-2.0's training shape [4, 6145, 24, 64] with rotary
   32 and at FUSED_CASES, its Function's gradient against autograd through
   the plain version (at the training shape too, a few heads at a time),
   timed beside SDPA on pre-rotated q, k, v, and against the rotary pass +
   `flash_attention_nhd`: at the training shape forward, forward + backward
   and memory, at the generation shape forward. The backward kernels are
   also held at that training shape, [4, 24, 6145, 64], on their own. The
   snake-conv forward without the residual (`snake_conv1d`, row 12, the
   carry) is held at every decoder and VAE shape, the pre-encode's k = 3
   conv_out, a strip of one tile and a ragged length, within 2 bf16 ulps of
   the plain version and of row 3 (`snake_conv1d_res` with a zero residual:
   equal bit for bit by design, counted); rows 3 and 12 are timed in turns
   at [1, 128, 2097152] k=7 d=9 and at SA-2.0's decode levels, beside the
   bound and `F.conv1d` alone on the pre-snaked input; row 3's k = 1 conv +
   residual at the five decode levels beside its byte bound and `F.conv1d`
   k = 1 on the pre-snaked input plus the residual; ptxas's registers and
   spills of every instantiation of the two kernels are printed. The plain
   weight gradient (`conv1d_wgrad`) is also held at each of the 64 distinct
   shapes of a Dance Diffusion training step (batch 4 x 65,536; k = 5 and 1,
   Ci / Co from 2 to 1536, L from 65,536 to 8, read from the shipped
   config's model) and at the 14 of a codec generator step (phase 14; batch
   4 x 32,000, the bf16 stride-1 convs of encodec_musicgen_rvq.json's
   SEANet on their self-padded inputs: 1 -> 64 at k = 7, 64 -> 32 at k = 3
   down to 512 -> 256, the k = 1 convs and shortcuts, the decoder's conv_in
   128 -> 1024 at 50 frames), each call moving its launch counter, each
   timed beside `torch.nn.grad.conv1d_weight` and its bound and summed with
   the step's launches. At SA-1.0's shapes (phase 11):
   rows 12 and 3 at the DAC decoder's and encoder's residual units (96 to
   1024 channels at 32,768 to 4,194,304 samples; the conv_outs 96 -> 2 and
   2048 -> 2048 k = 3), row 4 at their snake sites, all with beta = alpha
   (DAC's snake), each against its plain version, beside its bound and
   `F.conv1d` on the pre-snaked input, and summed over a decode's and an
   encode's launches; row 2 in f32 at the UNet's five row shapes (within
   1e-5 of the peak), beside `F.layer_norm` and summed over a UNet
   forward's 92 launches. At the shapes of both DAC VAE-GANs' generator
   steps (phase 13; batch 4 x 65,536, read from the shipped configs by
   `dac_step_shapes`): rows 10 and 11 at every snake-conv (96 to 1024
   channels at k = 7, d = 1 / 3 / 9 and k = 1, the conv_outs 96 -> 2 / 96 ->
   1 and 2048 -> 2048 k = 3 at 64 / 32 samples), row 11 plain at the
   conv_ins (2 / 1 -> 128, 64 / 32 -> 1536) and row 9 at the snake sites,
   alpha passed as beta, each against its plain version, each call moving
   its launch counter, timed beside cuDNN's `conv1d_input` /
   `conv1d_weight` on the pre-snaked input and its bound, and summed over
   each config's generator step.
3. Generation: SA-Open (the shipped stable_audio_open_1_0.json, built by the
   port's factory, random weights from a seeded torch.Generator, random T5)
   runs generate_diffusion_cond with cfg 6, dpmpp-3m-sde, sigma in [0.3, 500],
   batch 1, 2,097,152 samples, 100 steps. Every kernel of that path must
   launch during the call and the audio must be finite [1, 2, 2097152]; a tiny
   SA-Open-shaped model must agree between the card (kernels) and the CPU
   (plain versions) on replayed noise.
4. Training: a tiny SA-Open-shaped training step on the card against the
   CPU (same weights, batch, t, noise, dropout mask); then SA-Open at full
   width, batch 4, through the code path of `python -m
   stable_audio_tools_tpu_torch.train` on 8 seeded synthetic 50 s stereo WAVs:
   2 warm-up steps and 5 timed ones, a checkpoint, and its reload into a
   fresh model. Every loss must be finite, every trainable parameter's
   gradient finite and not all zero, the parameters and the EMA must move,
   every kernel of the path must launch (the flash backward among them), and
   the reloaded weights must be identical.

5. SA-2.0 generation: a tiny SA-2.0-shaped model (CLAP text tower read from
   a checkpoint, strided-layout attention, chunked decode over three chunks)
   must agree between the card and the CPU, and serve an inpainting and an
   init-audio request; then the shipped stable_audio_2_0.json at full width
   with `pretransform.chunked`, its CLAP tower read from a seeded random
   RoBERTa-base state dict written to a temporary file, runs one request:
   cfg 6, dpmpp-3m-sde, 100 steps, 12,582,912 samples (6144 latents, 64
   decode chunks). The audio must be finite [1, 2, 12582912], the path must
   launch `flash_attention_nhd` 2400 times and every other forward kernel,
   and must not launch `flash_attention_prefix`.

6. Autoencoder GAN training: one generator and one discriminator step of a
   tiny SA-2.0-VAE-shaped model (deterministic algorithms on, warn only)
   agree between the card and the CPU at reduced gains (losses, each
   generator gradient and the discriminator's whole gradient within 5%),
   and at the init's own gains each side's gradient on the card lies within
   GAN_SPREAD times the CPU's bf16 spread of the CPU's f32 one; then the shipped
   stable_audio_2_0_vae.json at full width (156 M parameters, the EnCodec
   discriminator with 64 filters over 5 scales, MRSTFT with A-weighting,
   bf16 compute) trains through the code path of `python -m
   stable_audio_tools_tpu_torch.train` on the synthetic WAVs, batch 4 x
   65,536 samples: 2 warm-up and 5 timed generator + discriminator pairs,
   the pieces of one generator step as the step itself times them, one
   generator step under the profiler, a checkpoint that reloads identical
   and resumes for a pair. Losses must be finite, every
   parameter of each side must get a finite nonzero gradient in its step,
   the parameters and the EMA must move, and the kernels must launch exactly
   as counted from the model.

7. LM generation: a tiny MusicGen-shaped LM's teacher-forced logits (the
   KV-cached decode and the full forward) agree between the card and the
   CPU within 5%; then the shipped lm/musicgen_small_rvq.json at full width
   (24 x 1024, 16 heads of 64, the SEANet + RVQ codec; seeded random weights,
   random T5) generates 10 s (500 frames, 32 kHz) from a prompt with
   `lm_generate_audio`, batch 1, cfg 3, top_k 250: KV-cached, then by the
   full forward at every step. The audio must be finite [1, 1, 320000], and
   the kernels must launch exactly as counted from the model (the cached
   path: no `flash_attention`).

8. LM training: one step of the tiny LM agrees between the card and the CPU
   (loss and every LM gradient within 5%); then the shipped config at full
   width through the code path of `python -m
   stable_audio_tools_tpu_torch.train` on seeded synthetic mono 32 kHz WAVs
   with prompts, batch 4 x 320,000 samples: 2 warm-up and 5 timed steps, the
   pieces of one step, its forward+backward under the profiler, a checkpoint
   and its reload. Every LM parameter must get a finite nonzero gradient and
   move, and the kernels must launch exactly as counted from the model.

9. SA-2.0 training: one step of a tiny SA-2.0-shaped model (rotary
   self-attention on the fused-QKV entry, pre-encoded latents with a padding
   mask) agrees between the card and the CPU within 5%; then the shipped
   stable_audio_2_0.json, nothing cut, its CLAP tower from the seeded
   RoBERTa-base file: (a) its pretransform saved as a port checkpoint and
   `python -m stable_audio_tools_tpu_torch.pre_encode` over 8 synthetic
   stereo WAVs of 290-300 s (latents [64, 6144], finite, masks of 6144;
   launches as counted from the encoder), then one clip's encode under the
   profiler (busy share, top kernels);
   (b) training from those latents through the code path of `python -m
   stable_audio_tools_tpu_torch.train` with `pre_encoded` and `mask_padding`,
   batch 4 x 6144 latents: 2 warm-up and 5 timed steps, the pieces of one
   step, its forward+backward under the profiler, launches exactly as
   counted from the model (row 8's forward 240, row 6's backward 120), moved
   weights and EMA, a checkpoint that reloads identical; (c) training from
   audio, batch 1 x 12,582,912 samples (the in-step encode): 1 warm-up and 2
   timed steps.

10. Dance Diffusion: a tiny DAU1d (4 levels of 32-64 channels, attention
   with 2 heads) generates by dpmpp-2m-sde and v-DDIM on replayed noise and
   takes one training step (the same weights, batch, t and noise) on the
   card in bf16 and on the CPU in f32 and bf16: the card's distance from the
   CPU's f32 result may be at most DANCE_SPREAD times the CPU's bf16 one.
   Then BASELINE (b), the shipped dance_diffusion_base_16k.json with seeded
   random weights: one request of batch 1, 65,536 samples, 100
   dpmpp-2m-sde steps (finite [1, 2, 65536] audio, no hand-written kernel
   launched), a sampler step timed and profiled; and training through the
   code path of `python -m stable_audio_tools_tpu_torch.train` on seeded
   synthetic 16 kHz stereo WAVs, batch 4 x 65,536: 2 warm-up and 5 timed
   steps, one forward+backward profiled, a checkpoint and its reload. Losses
   and gradients finite, every gradient nonzero, parameters and EMA moved,
   and `conv1d_wgrad` launched once per stride-1 conv of the model a step.

11. SA-1.0 generation: a tiny SA-1.0-shaped model (CLAP text features, two
   int conditioners, an ADP UNetCFG1d, a DAC VAE in bf16) agrees between the
   card and the CPU (the f32 conditioning and CFG denoiser within 5%; the
   bf16 decode and encode within DANCE_SPREAD times the CPU's own bf16
   distance from its f32 run) and serves an init-audio request; then the
   shipped stable_audio_1_0.json, nothing cut, its CLAP tower from the
   seeded RoBERTa-base file: one request of batch 1, 4,194,304 samples (95.1
   s), 100 dpmpp-3m-sde steps at cfg 6 (audio finite in [-1, 1], one UNet
   call a step at batch 1, launches exactly 92 of `fused_layer_norm` a call
   and 13 / 12 / 4 of rows 12 / 3 / 4 for the decode, counted from the
   model); the sampler step and the decode back to back and profiled; the
   DAC encode of one clip (13 / 12 / 4 launches).

12. SA-1.0 training: one training step's loss and gradients of the tiny
   SA-1.0-shaped model (f32 UNet, the same latents, t, noise and CFG-dropout
   mask) agree between the card and the CPU within 5%; then the shipped
   stable_audio_1_0.json, its CLAP tower from the seeded RoBERTa-base file,
   trains through the code path of `python -m
   stable_audio_tools_tpu_torch.train` on 8 synthetic stereo WAVs of 96-131
   s, batch 4 x 4,194,304 samples: 2 warm-up and 5 timed steps, finite
   losses and nonzero gradients, moved weights and EMA, launches exactly as
   counted from the model (row 2 92 a step, rows 12 / 3 / 4 of each clip's
   frozen DAC encode), one step's pieces and its forward+backward under the
   profiler, a checkpoint that reloads identical and resumes.

13. DAC VAE-GAN training: for each of autoencoders/stable_audio_1_0_vae.json
   and dac_2048_32_vae.json, one generator and one discriminator step of
   its tiny twin and the shipped config at full width, as phase 6 reads
   the SA-2.0 VAE (the same code), launches exactly as counted from the
   model (rows 12 / 3 / 4 / 9 / 10 / 11 / 11 plain).

14. Codec training: two generator steps (the RVQ's k-means init, then its
   EMA update and dead-code revival) and a discriminator step of a tiny
   EnCodec-shaped codec on the card against the CPU, f32 with TF32 off
   (each step from the CPU's state: losses and the encoder's output within
   1e-3, gradients within 1e-2, every codeword within 1e-3, 99% of
   an encode's codes equal); then the shipped encodec_musicgen_rvq.json at full width,
   batch 4 x 32,000: as phase 13, the only hand-written kernel row 11
   plain on the towers' bf16 stride-1 convs (14 a generator step,
   asserted).

The last lines are the kernels' JSON record, the card line and the result
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SA_OPEN = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "txt2audio", "stable_audio_open_1_0.json")
SA2 = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                   "txt2audio", "stable_audio_2_0.json")
STEPS = 100
SAMPLE_SIZE = 2097152
SA2_SAMPLE_SIZE = 12582912
SA2_PROMPT = [{"prompt": "A slow ambient piece with warm pads and distant piano",
               "seconds_start": 0, "seconds_total": 285}]
# published peaks of one H100 SXM (dense): bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# (channels, length) of the five decoder levels of one SA-2.0 chunk of 128 latents
SA2_CHUNK_LEVELS = ((1024, 1024), (512, 8192), (256, 32768), (128, 131072), (128, 262144))
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


def profiled_us(fn, iters: int = 50, tries: int = 3) -> dict:
    """What the profiler reads of `iters` calls of fn: the device microseconds
    a call summed over its kernels, the kernels a call launches, and each
    kernel's microseconds a call (a launch-sized call's own duration, without
    the host time between launches). A warm-up step of `iters` calls runs
    with the tracer already on and is discarded, because the tracer can miss
    the start of its window (one launch, or a whole window of short ones);
    a window in which it recorded no kernel at all is read again, up to
    `tries` windows (`windows` says how many were read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for window in range(1, tries + 1):
        readings = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: readings.append(p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # a scheduled profile also puts each step's span on the device timeline
        ks = [e for e in (readings[0] if readings else [])
              if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
        if ks:
            break
    return dict(device_us=sum(e.self_device_time_total for e in ks) / iters,
                kernels_per_call=sum(e.count for e in ks) / iters,
                by_kernel={e.key[:60]: e.self_device_time_total / iters for e in ks},
                windows=window)


def one_kernel(profiled: dict, kernel: str, what: str) -> None:
    """Raises unless a call launched `kernel` and nothing else, once (the
    profiler may miss the first launch of its window)."""
    per_call = profiled["kernels_per_call"]
    if not (all(kernel in k for k in profiled["by_kernel"]) and 0.95 <= per_call <= 1.0):
        raise AssertionError(f"{what}: not one {kernel} a call: {profiled}")


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds a call: `iters` calls enqueued without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def compare(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all() or err > tol:
        raise AssertionError(f"{name}: max|err| {err:.4g} > tol {tol:.4g}")
    return err


# the flash backward rounds P and dS to bf16 before its products (as the
# JAX kernels do) and returns bf16 gradients; the plain version is f32
# throughout: max|kernel - plain| within 2% of the gradient's peak
BWD_REL_TOL = 2e-2


def rel_err(name, got, want, tol):
    """max|got - want| / max|want|; raises above `tol` or on a non-finite value."""
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    if not torch.isfinite(got.float()).all() or not err <= tol:
        raise AssertionError(f"{name}: relative max|err| {err:.4g} > tol {tol:.4g}")
    return err


def counted(fn, *args):
    """fn(*args), which must launch its kernel once (its wrapper's count
    moves by one): no shape falls back to the plain version."""
    before = fn.launches
    out = fn(*args)
    if fn.launches != before + 1:
        raise AssertionError(f"{fn.__name__}: no kernel launch at "
                             f"{[tuple(a.shape) for a in args[:2]]}")
    return out


def bound(flops: float, *tensors) -> dict:
    """The least time the card could take for a call: the larger of its
    operations (bf16 tensor-core work) over the peak rate and the bytes of
    `tensors` (every input read once, every output written once) over the
    memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def attn_flops(B: int, H: int, N: int, D: int, n_matmuls: int = 2) -> float:
    """`n_matmuls` N x N x D products per (batch, head): 2 forward, 5 backward."""
    return 2.0 * n_matmuls * B * H * N * N * D


def bf16_tol(want: torch.Tensor, ulps: int = 2) -> float:
    """`ulps` bf16 units in the last place at the reference's largest value
    (bf16 keeps 8 significant bits: one ulp at magnitude m is <= m * 2^-7)."""
    return ulps * 2.0 ** -7 * max(1.0, want.float().abs().max().item())


def deterministic(fa, name, q, k, v, out, lse, dout) -> bool:
    """Whether BWD_ROUTE gives the same bits on two runs; raises if not."""
    a, b = (fa.flash_attention_prefix_bwd(q, k, v, out, lse, dout) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"flash bwd {name}: route {fa.BWD_ROUTE} differs between two runs")
    return True


def phase_kernels(dev):
    from stable_audio_tools_tpu_torch.ops.kernels import _build
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs
    from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa
    from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln
    from stable_audio_tools_tpu_torch.ops.kernels import snake as sn

    import torch.nn.functional as F

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
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/flash_fwd.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/flash_attention.py:181",
        shape="q,k,v [2,24,1025,64] bf16, prefix 1", max_abs_err=err,
        tol="2 bf16 ulps at max|ref| (out), 1e-3 (lse)",
        ms=cuda_ms(lambda: fa.flash_attention_prefix(q, k, v, 1), 50),
        plain_ms=cuda_ms(lambda: fa.flash_attention_prefix_plain(q, k, v, 1), 20),
        library="F.scaled_dot_product_attention",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50),
        profiled=profiled_us(lambda: fa.flash_attention_prefix(q, k, v, 1)),
        library_profiled=profiled_us(lambda: F.scaled_dot_product_attention(q, k, v)),
        **bound(attn_flops(2, 24, 1025, 64), q, k, v, out, lse))

    # 1b. its backward at the training path's shape (batch 4, no CFG
    #     doubling): both routes against the plain f32 backward
    q, k, v, dout = (randn(4, 24, 1025, 64) for _ in range(4))
    out, lse = fa.flash_attention_prefix(q, k, v, 1)
    want = fa.flash_attention_prefix_bwd_plain(q, k, v, out, lse, dout)
    routes = {}
    for route in fa.BWD_ROUTES:
        run = lambda route=route: fa.flash_attention_prefix_bwd(q, k, v, out, lse, dout, route=route)
        got = run()
        routes[route] = dict(
            max_rel_err=max(rel_err(f"flash bwd {route} d{n}", a, b, BWD_REL_TOL)
                            for n, a, b in zip("qkv", got, want)),
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)),
            ms=cuda_ms(run, 20))
    chosen = routes[fa.BWD_ROUTE]
    rec["flash_attention_prefix_bwd"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/flash_bwd.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/flash_attention.py:371",
        also_replaces=["stable_audio_tools_tpu/ops/kernels/flash_attention.py:296",
                       "stable_audio_tools_tpu/ops/kernels/flash_attention.py:329"],
        shape="q,k,v,dO [4,24,1025,64] bf16, lse f32", main_route=fa.BWD_ROUTE, routes=routes,
        max_abs_err=chosen["max_abs_err"], max_rel_err=chosen["max_rel_err"],
        tol=f"max|err| <= {BWD_REL_TOL} x max|plain| per gradient, both routes",
        ms=chosen["ms"],
        plain_ms=cuda_ms(lambda: fa.flash_attention_prefix_bwd_plain(q, k, v, out, lse, dout), 5),
        **bound(attn_flops(4, 24, 1025, 64, 5), q, k, v, out, lse, dout, q, k, v))
    # 1c. the autograd Function on the card against autograd through the plain forward
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o, _ = fa.flash_attention_prefix(*qkv, 1)
    if o.grad_fn is None:
        raise AssertionError("flash_attention_prefix: no grad_fn on a CUDA input that requires grad")
    got = torch.autograd.grad((o.float() * dout.float()).sum(), qkv)
    want = torch.autograd.grad((fa.flash_attention_prefix_plain(*qkv, 1)[0].float()
                                * dout.float()).sum(), qkv)
    rec["flash_attention_prefix_bwd"]["autograd_rel_err"] = max(
        rel_err(f"flash autograd d{n}", a, b, BWD_REL_TOL) for n, a, b in zip("qkv", got, want))
    lib_out = F.scaled_dot_product_attention(*qkv)
    rec["flash_attention_prefix_bwd"].update(
        library="autograd through F.scaled_dot_product_attention (backward only)",
        library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, qkv, dout, retain_graph=True), 20))
    del lib_out, o, qkv
    # 1d. the training route adds no atomics: two runs give the same bits;
    #     and what ptxas reported for each instantiation of the source
    rec["flash_attention_prefix_bwd"]["deterministic"] = deterministic(
        fa, "[4,24,1025,64]", q, k, v, out, lse, dout)
    rec["flash_attention_prefix_bwd"]["ptxas"] = {
        n: r for n, r in _build.ptxas_report("flash_bwd").items() if "flash_bwd" in n}
    rec["flash_attention_prefix_bwd"]["sa2_training_shape"] = long_bwd_checks(fa, randn, F)

    rec["flash_attention_nhd"] = nhd_checks(fa, randn, F)
    rec["flash_attention_fused_qkv"] = fused_qkv_checks(fa, randn, F)
    rec["flash_attention"], rec["flash_attention_prefix_bwd"]["banded"] = flash_checks(
        fa, randn, F)
    rec["flash_attention"]["ptxas"] = {
        n: r for n, r in _build.ptxas_report("flash_fwd").items() if "flash_" in n}

    # 2. DiT block norms: [2, 1025, 1536] bf16, gamma f32
    x = randn(2, 1025, 1536, scale=3.0)
    gamma = randn(1536, dtype=torch.float32)
    y, ref = ln.fused_layer_norm(x, gamma), ln.fused_layer_norm_plain(x, gamma)
    err = compare("layer norm", y, ref, bf16_tol(ref))
    run = lambda: ln.fused_layer_norm(x, gamma)
    lib = lambda gb=gamma.to(bf): F.layer_norm(x, (1536,), gb)
    rec["fused_layer_norm"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/layer_norm.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/layer_norm.py:32",
        also_replaces=["stable_audio_tools_tpu/ops/kernels/layer_norm.py:43"],
        shape="x [2,1025,1536] bf16, gamma f32", max_abs_err=err,
        tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(run, 200), plain_ms=cuda_ms(lambda: ln.fused_layer_norm_plain(x, gamma), 200),
        library="F.layer_norm (gamma in bf16)", library_ms=cuda_ms(lib, 200),
        # launch-sized: the kernel's own duration (profiler) and the host's
        # time a call, beside the library call's
        profiled=profiled_us(run), library_profiled=profiled_us(lib),
        host_us=host_us(run), library_host_us=host_us(lib),
        **bound(8.0 * x.numel(), x, gamma, y))
    one_kernel(rec["fused_layer_norm"]["profiled"], "ln_warp_kernel", "fused_layer_norm")
    # SA-2.0's rows, a bf16 gamma (read as it lies: still one kernel), beta,
    # and the kernel's edges (row lengths off its 16-byte vectors, past its
    # warp kernel's reach, row counts that do not fill a block)
    x2 = randn(2, 6145, 1536, scale=3.0)
    ref = ln.fused_layer_norm_plain(x2, gamma)
    errs = [err, compare("layer norm [2,6145,1536]", ln.fused_layer_norm(x2, gamma), ref,
                         bf16_tol(ref))]
    gb, bb = gamma.to(bf), randn(1536)
    one_kernel(profiled_us(lambda: ln.fused_layer_norm(x, gb, bb)), "ln_warp_kernel",
               "fused_layer_norm, bf16 gamma and beta")
    for shape, g_dtype, beta in (((2, 1025, 1536), bf, True), ((5, 1000), torch.float32, False),
                                 ((3, 100), bf, False), ((7, 16384), torch.float32, True)):
        xe = randn(*shape, scale=3.0)
        g_ = randn(shape[-1], dtype=g_dtype)
        b_ = randn(shape[-1], dtype=g_dtype) if beta else None
        ref = ln.fused_layer_norm_plain(xe, g_, b_)
        errs.append(compare(f"layer norm {shape}", ln.fused_layer_norm(xe, g_, b_), ref,
                            bf16_tol(ref)))
    rec["fused_layer_norm"]["max_abs_err"] = max(errs)
    rec["fused_layer_norm"]["shape"] += ("; [2,6145,1536], bf16 gamma + beta, [5,1000], [3,100], "
                                         "[7,16384] checked")
    del x2, ref
    # 2b. its autograd Function (the kernel forward, plain backward as the JAX
    #     package's) at the training shape against autograd through the plain
    #     version: bf16 dx, f32 dgamma, 1% of each gradient's peak; and under
    #     no_grad (no Function) the same bits as through the Function
    x = randn(4, 1025, 1536, scale=3.0).requires_grad_()
    gamma = randn(1536, dtype=torch.float32).requires_grad_()
    dy = randn(4, 1025, 1536)
    y = ln.fused_layer_norm(x, gamma)
    if y.grad_fn is None:
        raise AssertionError("fused_layer_norm: no grad_fn on a CUDA input that requires grad")
    with torch.no_grad():
        if not torch.equal(ln.fused_layer_norm(x, gamma), y):
            raise AssertionError("fused_layer_norm: no_grad and autograd routes differ")
    got = torch.autograd.grad((y.float() * dy.float()).sum(), (x, gamma))
    want = torch.autograd.grad((ln.fused_layer_norm_plain(x, gamma).float()
                                * dy.float()).sum(), (x, gamma))
    rec["fused_layer_norm"]["autograd_rel_err"] = max(
        rel_err(f"layer norm autograd {n}", a, b, 1e-2)
        for n, a, b in zip(("dx", "dgamma"), got, want))
    rec["fused_layer_norm"]["no_grad_bit_identical"] = True

    # 3. decoder snakes before each transposed upsample: SA-2.0's groups of 8
    #    chunks of 128 latents (each timed, and summed over a group's five
    #    launches against their summed bound), then SA-Open's whole clip
    #    [1, C, L]; the autograd route (an input that requires a gradient)
    #    gives the launch's bits
    errs, group = [], dict(ms=0.0, bound_ms=0.0)
    for B, C, L in SA2_DECODE_SNAKES + ((1, 2048, 1024), (1, 1024, 8192), (1, 512, 65536),
                                        (1, 256, 262144), (1, 128, 1048576)):
        x = randn(B, C, L, scale=2.0)
        a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
        y, ref = sn.snake_fused(x, a, b), sn.snake_fused_plain(x, a, b)
        errs.append(compare(f"snake [{B},{C},{L}]", y, ref, bf16_tol(ref)))
        if (B, C, L) in SA2_DECODE_SNAKES:
            group["ms"] += cuda_ms(lambda: sn.snake_fused(x, a, b), 10)
            group["bound_ms"] += bound(0.0, x, a, b, y)["bound_ms"]
    group["share_of_bound"] = group["bound_ms"] / group["ms"]
    y_grad = sn.snake_fused(x.detach().requires_grad_(), a, b)
    if y_grad.grad_fn is None or not torch.equal(y_grad.detach(), y):
        raise AssertionError("snake_fused: the autograd route is missing or differs")
    rec["snake_fused"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/snake.py:52",
        shape="x [1,128,1048576] bf16 (timed; 5 SA-Open and 5 SA-2.0 decoder shapes checked)",
        max_abs_err=max(errs), tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(lambda: sn.snake_fused(x, a, b), 20),
        plain_ms=cuda_ms(lambda: sn.snake_fused_plain(x, a, b), 10),
        library=None, library_ms=None,  # no single PyTorch call computes a snake
        decode_group=group, **bound(6.0 * x.numel(), x, a, b, y))
    del y_grad

    # 4. decoder residual units: conv1 k=7 d in {1,3,9}; conv2 k=1 + skip;
    #    conv_out k=7 128 -> 2 without bias. snake_conv1d launches row 12
    #    (the carry), snake_conv1d_res row 3; every case without the residual
    #    also holds row 12 against row 3 on the same inputs.
    carry = dict(vs_row3=[], bitwise=0, cases=0)

    def hold_row3(name, x, w, bias_t, a, b, pad, d, got):
        """Row 12's output `got` against row 3's on the same inputs
        (`snake_conv1d_res` with a zero residual: + 0 in f32 is exact); the
        two share the window contents, the tap loop and the epilogue, so
        they are equal bit for bit (counted), and held to 2 bf16 ulps."""
        row3 = cs.snake_conv1d_res(x, w, bias_t, a, b, torch.zeros_like(got), pad, pad, d)
        carry["vs_row3"].append(compare(f"snake_conv1d vs row 3 {name}", got, row3,
                                        bf16_tol(row3)))
        carry["bitwise"] += bool(torch.equal(got, row3))
        carry["cases"] += 1

    def conv_case(C, Co, L, kk, d, bias=True, res=False, B=1):
        x = randn(B, C, L)
        w = randn(Co, C, kk, scale=(C * kk) ** -0.5)
        bias_t = randn(Co, dtype=torch.float32) * 0.1 if bias else None
        a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
        r = randn(B, Co, L) if res else None
        pad = d * (kk - 1) // 2
        if res:
            run = lambda: cs.snake_conv1d_res(x, w, bias_t, a, b, r, pad, pad, d)
        else:
            run = lambda: cs.snake_conv1d(x, w, bias_t, a, b, pad, pad, d)
        plain = lambda: cs.snake_conv1d_plain(x, w, bias_t, a, b, pad, pad, d, r)
        ref = plain()
        least = bound(2.0 * Co * C * kk * L, x, w, bias_t, a, b, r, ref)
        name = f"snake_conv1d B={B} C={C} Co={Co} L={L} k={kk} d={d} res={res}"
        out = run()
        if not res:
            hold_row3(name, x, w, bias_t, a, b, pad, d, out)
        return compare(name, out, ref, bf16_tol(ref)), run, plain, least

    errs = []
    for C, L, d in ((1024, 8192, 1), (512, 65536, 3), (256, 262144, 9), (128, 1048576, 1)):
        errs.append(conv_case(C, C, L, 7, d)[0])
    errs.append(conv_case(128, 2, SAMPLE_SIZE, 7, 1, bias=False)[0])
    # SA-2.0's decode: groups of 8 chunks, 262,144 samples each at the last level
    for C, L in SA2_CHUNK_LEVELS:
        errs += [conv_case(C, C, L, 7, d, B=8)[0] for d in (1, 3, 9)]
    errs.append(conv_case(128, 2, 262144, 7, 1, bias=False, B=8)[0])
    # the pre-encode's k = 3 conv_out, a strip of one tile, a ragged L
    errs.append(conv_case(2048, 128, SA2_SAMPLE_SIZE // 2048, 3, 1)[0])
    errs.append(conv_case(1024, 1024, 100, 7, 9)[0])
    errs.append(conv_case(128, 128, 131071, 7, 3, B=8)[0])
    err, run, plain, least = conv_case(128, 128, SAMPLE_SIZE, 7, 9)
    errs.append(err)
    timed = carry_ab(cs, F, randn, 1, 128, SAMPLE_SIZE, 9)
    levels = [carry_ab(cs, F, randn, 8, C, L, d) for C, L in SA2_CHUNK_LEVELS for d in (1, 3, 9)]
    rec["snake_conv1d"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake_conv1d.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:134",
        # the JAX package's default route runs `_fwd_kernel` for this function
        also_replaces=["stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:88"],
        shape="x [1,128,2097152] k=7 d=9 bf16 (timed; 6 SA-Open and 16 SA-2.0 decoder "
              "cases, the pre-encode's [1,2048,6144] k=3 conv_out, a strip of one tile "
              "[1,1024,100] d=9 and a ragged [8,128,131071] checked)",
        max_abs_err=max(errs), tol="2 bf16 ulps at max|ref|, against the plain version "
                                   "and against row 3",
        ms=cuda_ms(run, 3), plain_ms=cuda_ms(plain, 3),
        # cuDNN's conv alone omits the snake: it is in the plain version (ab: conv_only_ms)
        library=None, library_ms=None, ab=dict(timed=timed, sa2_levels=levels), **least)
    errs = [conv_case(C, C, L, 1, 1, res=True)[0]
            for C, L in ((1024, 8192), (512, 65536), (256, 262144))]
    errs += [conv_case(C, C, L, 1, 1, res=True, B=8)[0] for C, L in SA2_CHUNK_LEVELS]
    err, run, plain, least = conv_case(128, 128, SAMPLE_SIZE, 1, 1, res=True)
    errs.append(err)
    rec["snake_conv1d_res"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake_conv1d.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:107",
        shape="x [1,128,2097152] k=1 + residual bf16 (timed; 4 SA-Open and 5 SA-2.0 "
              "decoder shapes checked)",
        max_abs_err=max(errs), tol="2 bf16 ulps at max|ref|",
        ms=cuda_ms(run, 3), plain_ms=cuda_ms(plain, 3), library=None, library_ms=None,
        sa2_levels=[res_level(cs, F, randn, 8, C, L) for C, L in SA2_CHUNK_LEVELS], **least)
    # what ptxas reported for each instantiation of the forward kernels
    rec["snake_conv1d"]["ptxas"] = {
        n: r for n, r in _build.ptxas_report("snake_conv1d").items() if "snake_conv1d" in n}
    rec.update(ae_backward_checks(sn, cs, randn, rec, hold_row3))
    sa1_kernel_checks(rec, cs, sn, ln, F, randn, hold_row3)
    dac_backward_checks(rec, cs, sn, randn)
    rec["snake_conv1d"]["vs_row3"] = dict(max_abs_diff=max(carry["vs_row3"]),
                                          bitwise_equal_cases=carry["bitwise"],
                                          cases=carry["cases"])
    return rec


# SA-1.0's DAC VAE at batch 1 x 4,194,304 samples (95.1 s): (channels,
# length) of the residual units of the decoder's four blocks and of the
# encoder's, and of the snake_fused sites before the decoder's transposed and
# the encoder's strided convs
SA1_DECODE_LEVELS = ((768, 32768), (384, 262144), (192, 1048576), (96, 4194304))
SA1_ENCODE_LEVELS = ((128, 4194304), (256, 1048576), (512, 262144), (1024, 32768))
SA1_DECODE_SNAKES = ((1536, 4096), (768, 32768), (384, 262144), (192, 1048576))
SA1_ENCODE_SNAKES = SA1_ENCODE_LEVELS
# the rows of the UNet's f32 LayerNorms at CFG batch 2 ([2, L, C]) and their
# launches a UNet forward: each transformer block normalises x three times
# (self-attention's norm and norm_context, cross-attention's norm) and the
# 79-token context once; 2 blocks at 4096 latents, 6 at 2048, 6 at 1024, 9
# at 256, the context in all 23
SA1_LN_ROWS = (((2, 4096, 1024), 6), ((2, 2048, 1024), 18), ((2, 1024, 1280), 18),
               ((2, 256, 1280), 27), ((2, 79, 768), 23))
# f32 LayerNorm against its plain version (other summation orders): 1e-5 of
# the peak
LN_F32_REL_TOL = 1e-5


def sa1_kernel_checks(rec, cs, sn, ln, F, randn, hold_row3) -> None:
    """Rows 12, 3 and 4 at the SA-1.0 DAC VAE's shapes (DAC's snake: beta =
    alpha) and row 2 in f32 at its UNet's, each against its plain version on
    the card (bf16 within 2 ulps, row 12 also against row 3; the f32
    LayerNorm within LN_F32_REL_TOL of the peak), timed by CUDA events beside
    its bound and the library call (`F.conv1d` on the pre-snaked input,
    `F.layer_norm`), and summed over one decode's / encode's launches and one
    UNet forward's. Adds an `sa1` entry to each record and folds the errors
    into its max_abs_err."""
    def conv(C, Co, L, kk, d, res=False, bias=True, iters=3):
        x = randn(1, C, L)
        w = randn(Co, C, kk, scale=(C * kk) ** -0.5)
        bias_t = randn(Co, dtype=torch.float32) * 0.1 if bias else None
        a = randn(C, dtype=torch.float32).exp()
        r = randn(1, Co, L) if res else None
        pad = d * (kk - 1) // 2
        if res:
            run = lambda: cs.snake_conv1d_res(x, w, bias_t, a, a, r, pad, pad, d)
        else:
            run = lambda: cs.snake_conv1d(x, w, bias_t, a, a, pad, pad, d)
        plain = lambda: cs.snake_conv1d_plain(x, w, bias_t, a, a, pad, pad, d, r)
        ref, out = plain(), run()
        name = f"SA-1.0 snake_conv1d [1,{C},{L}] -> {Co} k={kk} d={d} res={res}"
        err = compare(name, out, ref, bf16_tol(ref))
        if not res:
            hold_row3(name, x, w, bias_t, a, a, pad, d, out)
        sx = cs._snake_f32(x, a, a).to(x.dtype)
        b_bf = None if bias_t is None else bias_t.to(x.dtype)
        lib = ((lambda: F.conv1d(sx, w, b_bf) + r) if res
               else (lambda: F.conv1d(sx, w, b_bf, padding=pad, dilation=d)))
        case = dict(shape=f"[1,{C},{L}] -> {Co} k={kk} d={d}" + (" + residual" if res else ""),
                    max_abs_err=err, ms=cuda_ms(run, iters), plain_ms=cuda_ms(plain, 1),
                    library_ms=cuda_ms(lib, iters),
                    **bound(2.0 * Co * C * kk * L, x, w, bias_t, a, a, r, ref))
        del x, r, ref, out, sx
        return case

    def total(cases):
        out = {k: sum(c[k] for c in cases) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out.update(launches=len(cases), share_of_bound=out["bound_ms"] / out["ms"])
        return out

    row12, row3 = {}, {}
    for path, levels, conv_out in (("decode", SA1_DECODE_LEVELS, (96, 2, 4194304, 7, False)),
                                   ("encode", SA1_ENCODE_LEVELS, (2048, 2048, 4096, 3, True))):
        c12 = [conv(C, C, L, 7, d) for C, L in levels for d in (1, 3, 9)]
        C, Co, L, kk, bias = conv_out
        c12.append(conv(C, Co, L, kk, 1, bias=bias))
        c3 = [conv(C, C, L, 1, 1, res=True) for C, L in levels]
        # three residual units a level: row 3 runs three times at each shape
        row12[path] = dict(cases=c12, total=total(c12))
        row3[path] = dict(cases=c3, total=total(c3 * 3))
    for name, entry in (("snake_conv1d", row12), ("snake_conv1d_res", row3)):
        rec[name]["sa1"] = entry
        rec[name]["max_abs_err"] = max([rec[name]["max_abs_err"]] + [
            c["max_abs_err"] for p in entry.values() for c in p["cases"]])

    snakes = {}
    for path, sites in (("decode", SA1_DECODE_SNAKES), ("encode", SA1_ENCODE_SNAKES)):
        cases = []
        for C, L in sites:
            x = randn(1, C, L, scale=2.0)
            a = randn(C, dtype=torch.float32).exp()
            y, ref = sn.snake_fused(x, a, a), sn.snake_fused_plain(x, a, a)
            cases.append(dict(shape=f"[1,{C},{L}]",
                              max_abs_err=compare(f"SA-1.0 snake [1,{C},{L}]", y, ref,
                                                  bf16_tol(ref)),
                              ms=cuda_ms(lambda: sn.snake_fused(x, a, a), 10),
                              plain_ms=cuda_ms(lambda: sn.snake_fused_plain(x, a, a), 2),
                              library_ms=None, **bound(6.0 * x.numel(), x, a, a, y)))
        tot = {k: sum(c[k] for c in cases) for k in ("ms", "plain_ms", "bound_ms")}
        tot.update(launches=len(cases), share_of_bound=tot["bound_ms"] / tot["ms"])
        snakes[path] = dict(cases=cases, total=tot)
    rec["snake_fused"]["sa1"] = snakes
    rec["snake_fused"]["max_abs_err"] = max([rec["snake_fused"]["max_abs_err"]] + [
        c["max_abs_err"] for p in snakes.values() for c in p["cases"]])

    cases = []
    for shape, launches in SA1_LN_ROWS:
        C = shape[-1]
        x = randn(*shape, scale=3.0, dtype=torch.float32) + 0.5
        gam, bet = (randn(C, dtype=torch.float32) for _ in range(2))
        run = lambda: ln.fused_layer_norm(x, gam, bet, 1e-6)
        y, ref = run(), ln.fused_layer_norm_plain(x, gam, bet, 1e-6)
        err = (y - ref).abs().max().item()
        if y.dtype != torch.float32 or not err <= LN_F32_REL_TOL * ref.abs().max().item():
            raise AssertionError(f"SA-1.0 f32 layer norm {shape}: max|err| {err:.3g} past "
                                 f"{LN_F32_REL_TOL} of the peak")
        cases.append(dict(shape=f"x {list(shape)} f32, gamma + beta f32", launches=launches,
                          max_abs_err=err, ms=cuda_ms(run, 50),
                          plain_ms=cuda_ms(lambda: ln.fused_layer_norm_plain(x, gam, bet, 1e-6),
                                           20),
                          library_ms=cuda_ms(lambda: F.layer_norm(x, (C,), gam, bet, 1e-6), 50),
                          **bound(8.0 * x.numel(), x, gam, bet, y)))
    tot = {k: sum(c[k] * c["launches"] for c in cases)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    tot.update(launches=sum(c["launches"] for c in cases),
               share_of_bound=tot["bound_ms"] / tot["ms"])
    rec["fused_layer_norm"]["sa1_f32"] = dict(cases=cases, unet_forward=tot,
                                              tol=f"{LN_F32_REL_TOL} x max|ref| (f32)")
    rec["fused_layer_norm"]["max_abs_err"] = max(rec["fused_layer_norm"]["max_abs_err"],
                                                 max(c["max_abs_err"] for c in cases))


DAC_VAES = {name: os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                               "autoencoders", f"{name}.json")
            for name in ("stable_audio_1_0_vae", "dac_2048_32_vae")}
DAC_BATCH, DAC_T = 4, 65536


def dac_vae_config(name: str) -> dict:
    with open(DAC_VAES[name]) as f:
        return json.load(f)


def dac_step_shapes(cfg: dict, T: int = DAC_T) -> dict:
    """The kernel call shapes of one DAC VAE-GAN generator step on [B, C, T]
    audio, read from the config (models/dac.py's towers), each with its
    launches in a step:
    `snake_conv` (C, Co, L, k, d) of rows 12 / 3 forward and rows 10 / 11
    backward (a residual unit's k = 7 conv at d = 1 / 3 / 9 and its k = 1
    conv with the skip, three units a level, the encoder's level widths
    d_model * 2^i, the decoder's channels / 2^(i+1); the snake + conv_out of
    each tower), `plain` (Ci, Co, L) of the conv_ins (k = 7, row 11 plain),
    `snake` (C, L) of row 4 / row 9 (before each strided and transposed
    conv)."""
    enc, dec = cfg["model"]["encoder"]["config"], cfg["model"]["decoder"]["config"]
    snake_conv, plain, snake = {}, [], []

    def add(key, n=1):
        snake_conv[key] = snake_conv.get(key, 0) + n

    d, L = enc["d_model"], T
    plain.append((enc.get("in_channels", 1), d, L))
    for stride in enc["strides"]:
        for dil in (1, 3, 9):
            add((d, d, L, 7, dil))
        add((d, d, L, 1, 1), 3)
        snake.append((d, L))
        d, L = 2 * d, L // stride
    add((d, d, L, 3, 1))  # the snake + conv_out (2048 -> 2048 at k = 3)
    ch, L = dec["channels"], T // math.prod(dec["rates"])
    plain.append((dec["latent_dim"], ch, L))
    for rate in dec["rates"]:
        snake.append((ch, L))
        ch, L = ch // 2, L * rate
        for dil in (1, 3, 9):
            add((ch, ch, L, 7, dil))
        add((ch, ch, L, 1, 1), 3)
    add((ch, dec.get("out_channels", 1), L, 7, 1))
    return dict(snake_conv=snake_conv, plain=plain, snake=snake)


def dac_gen_launches(model) -> dict:
    """Launches of one generator step counted from a DAC autoencoder: each
    residual unit runs row 12 (k = 7) and row 3 (k = 1 + skip), each tower's
    snake + conv_out row 12; each snake-conv's backward rows 10 and 11; a
    snake before each strided / transposed conv rows 4 and 9; each tower's
    conv_in row 11 plain. The discriminator step runs the forward kernels
    alone (under no_grad)."""
    from stable_audio_tools_tpu_torch.models.dac import (DACDecoderBlock, DACEncoderBlock,
                                                         DACResidualUnit)

    def count(cls):
        return sum(isinstance(m, cls) for m in model.modules())

    units = count(DACResidualUnit)
    blocks = count(DACEncoderBlock) + count(DACDecoderBlock)
    fwd = {"snake_conv1d": units + 2, "snake_conv1d_res": units, "snake_fused": blocks}
    return dict(gen={**fwd, "snake_conv1d_dx": 2 * units + 2,
                     "snake_conv1d_wgrad": 2 * units + 2, "snake_fused_bwd": blocks,
                     "conv1d_wgrad": 2}, disc=fwd)


def dac_backward_checks(rec, cs, sn, randn) -> None:
    """Rows 10, 11, 11 plain and 9 at the shapes of both DAC VAE-GANs'
    generator steps (`dac_step_shapes`, batch 4 x 65,536; DAC's snake:
    alpha passed as beta), each against its plain version on the card
    (outputs within 2 bf16 ulps, gradient sums within GRAD_REL_TOL of their
    peaks), each call moving its wrapper's launch counter (no shape falls
    back); timed by CUDA events beside its bound and cuDNN's
    `conv1d_input` / `conv1d_weight` on the pre-snaked input (rows 10 / 11)
    or `torch.nn.grad.conv1d_weight` (row 11 plain), and summed over each
    config's generator step. Adds a `dac` entry to each record and folds
    the errors into its max_abs_err. A shape both configs share is run once
    and weighed by each."""
    B = DAC_BATCH
    shapes = {name: dac_step_shapes(dac_vae_config(name)) for name in DAC_VAES}

    def step_sum(cases, weights, keys):
        out = {k: sum(weights[c["key"]] * c[k] for c in cases if c["key"] in weights)
               for k in keys}
        out["launches"] = sum(weights.values())
        return out

    def shares(total, ms, bound_ms):
        total["share_of_bound"] = total[bound_ms] / total[ms]
        return total

    # rows 10 and 11 at every snake-conv shape of both configs
    keys = sorted({k for s in shapes.values() for k in s["snake_conv"]}, key=lambda k: -k[2] * k[0])
    cases, dx_errs, w_errs, w_abs = [], [], [], []
    for C, Co, L, kk, dil in keys:
        x = randn(B, C, L, scale=2.0)
        w = randn(Co, C, kk, scale=(C * kk) ** -0.5)
        a = randn(C, dtype=torch.float32).exp()
        pad = dil * (kk - 1) // 2
        dy = randn(B, Co, L)
        name = f"DAC [{B},{C},{L}] -> {Co} k={kk} d={dil}"
        got = counted(cs.snake_conv1d_dx, dy, x, w, a, a, pad, pad, dil)
        want = cs.snake_conv1d_dx_plain(dy, x, w, a, a, pad, pad, dil)
        dx_errs.append(compare(f"snake_conv1d_dx dx {name}", got[0], want[0], bf16_tol(want[0])))
        for n, p_, q_ in zip(("dalpha", "dbeta"), got[1:], want[1:]):
            rel_err(f"snake_conv1d_dx {n} {name}", p_, q_, GRAD_REL_TOL)
        del got, want
        gw = counted(cs.snake_conv1d_wgrad, dy, x, kk, a, a, pad, pad, dil)
        ww = cs.conv1d_wgrad_plain(dy, x, kk, pad, pad, dil, (a, a))
        w_errs.append(max(rel_err(f"snake_conv1d_wgrad {n} {name}", p_, q_, GRAD_REL_TOL)
                          for n, p_, q_ in zip(("dW", "db"), gw, ww)))
        w_abs.append(max((p_ - q_).abs().max().item() for p_, q_ in zip(gw, ww)))
        sx = cs._snake_f32(x, a, a).to(x.dtype)
        cases.append(dict(
            key=(C, Co, L, kk, dil), shape=f"[{B},{C},{L}] -> {Co} k={kk} d={dil}",
            dx_ms=cuda_ms(lambda: cs.snake_conv1d_dx(dy, x, w, a, a, pad, pad, dil), 3),
            wgrad_ms=cuda_ms(lambda: cs.snake_conv1d_wgrad(dy, x, kk, a, a, pad, pad, dil), 3),
            conv1d_input_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
                x.shape, w, dy, padding=pad, dilation=dil), 3),
            conv1d_weight_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
                sx, w.shape, dy, padding=pad, dilation=dil), 3),
            dx_bound_ms=bound(2.0 * B * L * C * Co * kk, dy, x, w, a, a, x)["bound_ms"],
            wgrad_bound_ms=bound(2.0 * B * L * C * Co * kk, dy, x, a, a, gw[0])["bound_ms"]))
        del x, w, dy, gw, ww, sx
    dx_entry, w_entry = {}, {}
    for cfg_name, s in shapes.items():
        launches = {f"[{B},{C},{L}] -> {Co} k={kk} d={dil}": n
                    for (C, Co, L, kk, dil), n in s["snake_conv"].items()}
        dx_entry[cfg_name] = dict(
            launches=launches, generator_step=shares(step_sum(
                cases, s["snake_conv"], ("dx_ms", "conv1d_input_ms", "dx_bound_ms")),
                "dx_ms", "dx_bound_ms"))
        w_entry[cfg_name] = dict(
            launches=launches, generator_step=shares(step_sum(
                cases, s["snake_conv"], ("wgrad_ms", "conv1d_weight_ms", "wgrad_bound_ms")),
                "wgrad_ms", "wgrad_bound_ms"))
    strip = lambda c, drop: {k: v for k, v in c.items() if k not in drop and k != "key"}
    dx_entry["cases"] = [strip(c, ("wgrad_ms", "conv1d_weight_ms", "wgrad_bound_ms"))
                         for c in cases]
    w_entry["cases"] = [strip(c, ("dx_ms", "conv1d_input_ms", "dx_bound_ms")) for c in cases]
    rec["snake_conv1d_dx"]["dac"] = dx_entry
    rec["snake_conv1d_dx"]["max_abs_err"] = max(rec["snake_conv1d_dx"]["max_abs_err"], *dx_errs)
    rec["snake_conv1d_wgrad"]["dac"] = w_entry
    rec["snake_conv1d_wgrad"]["max_abs_err"] = max(rec["snake_conv1d_wgrad"]["max_abs_err"],
                                                   *w_abs)
    rec["snake_conv1d_wgrad"]["max_rel_err"] = max(rec["snake_conv1d_wgrad"]["max_rel_err"],
                                                   *w_errs)

    # row 11 plain at the conv_ins (Ci = 2 / 1 into 128; 64 / 32 into 1536)
    plain_cases, errs, abs_errs = [], [], []
    for Ci, Co, L in sorted({k for s in shapes.values() for k in s["plain"]}):
        x, dy = randn(B, Ci, L), randn(B, Co, L)
        got = counted(cs.conv1d_wgrad, dy, x, 7, 3, 3, 1)
        want = cs.conv1d_wgrad_plain(dy, x, 7, 3, 3, 1)
        name = f"DAC conv_in [{B},{Ci},{L}] -> {Co} k=7"
        errs.append(max(rel_err(f"conv1d_wgrad {n} {name}", p_, q_, GRAD_REL_TOL)
                        for n, p_, q_ in zip(("dW", "db"), got, want)))
        abs_errs.append(max((p_ - q_).abs().max().item() for p_, q_ in zip(got, want)))
        plain_cases.append(dict(
            key=(Ci, Co, L), shape=f"[{B},{Ci},{L}] -> {Co} k=7",
            ms=cuda_ms(lambda: cs.conv1d_wgrad(dy, x, 7, 3, 3, 1), 5),
            conv1d_weight_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
                x, (Co, Ci, 7), dy, padding=3), 5),
            **bound(2.0 * B * L * Ci * Co * 7, dy, x, got[0])))
        del x, dy, got, want
    entry = {"cases": [strip(c, ()) for c in plain_cases]}
    for cfg_name, s in shapes.items():
        entry[cfg_name] = shares(step_sum(plain_cases, {k: 1 for k in s["plain"]},
                                          ("ms", "conv1d_weight_ms", "bound_ms")), "ms", "bound_ms")
    rec["conv1d_wgrad"]["dac"] = entry
    rec["conv1d_wgrad"]["max_abs_err"] = max(rec["conv1d_wgrad"]["max_abs_err"], *abs_errs)
    rec["conv1d_wgrad"]["max_rel_err"] = max(rec["conv1d_wgrad"]["max_rel_err"], *errs)

    # row 9 (and row 4) at the snake sites, alpha passed as beta: dalpha and
    # dbeta come back separately, and autograd sums them into the one alpha
    snake_cases, errs = [], []
    for C, L in sorted({k for s in shapes.values() for k in s["snake"]}):
        x, g = randn(B, C, L, scale=2.0), randn(B, C, L)
        a = randn(C, dtype=torch.float32).exp()
        y = sn.snake_fused_plain(x, a, a)
        errs.append(compare(f"DAC snake [{B},{C},{L}]", counted(sn.snake_fused, x, a, a), y,
                            bf16_tol(y)))
        got = counted(sn.snake_fused_bwd, x, a, a, g)
        want = sn.snake_fused_bwd_plain(x, a, a, g)
        errs.append(compare(f"DAC snake bwd dx [{B},{C},{L}]", got[0], want[0],
                            bf16_tol(want[0])))
        for n, p_, q_ in zip(("dalpha", "dbeta"), got[1:], want[1:]):
            rel_err(f"DAC snake bwd {n} [{B},{C},{L}]", p_, q_, GRAD_REL_TOL)
        rel_err(f"DAC snake bwd dalpha + dbeta [{B},{C},{L}]", got[1] + got[2],
                want[1] + want[2], GRAD_REL_TOL)
        snake_cases.append(dict(
            key=(C, L), shape=f"[{B},{C},{L}]",
            bwd_ms=cuda_ms(lambda: sn.snake_fused_bwd(x, a, a, g), 10),
            fwd_ms=cuda_ms(lambda: sn.snake_fused(x, a, a), 10),
            bwd_bound_ms=bound(0.0, x, g, a, a, *got)["bound_ms"],
            fwd_bound_ms=bound(0.0, x, a, a, y)["bound_ms"]))
        del x, g, y, got, want
    entry = {"cases": [strip(c, ()) for c in snake_cases]}
    for cfg_name, s in shapes.items():
        entry[cfg_name] = shares(step_sum(snake_cases, {k: 1 for k in s["snake"]},
                                          ("bwd_ms", "fwd_ms", "bwd_bound_ms", "fwd_bound_ms")),
                                 "bwd_ms", "bwd_bound_ms")
    rec["snake_fused_bwd"]["dac"] = entry
    rec["snake_fused_bwd"]["max_abs_err"] = max(rec["snake_fused_bwd"]["max_abs_err"], *errs)


def carry_ab(cs, F, randn, B, C, L, d, iters=3) -> dict:
    """Rows 3 and 12 timed in turns (row 3, row 12, row 12, row 3) on one
    k = 7 residual-unit conv [B, C, L] at dilation d (row 3 through
    `snake_conv1d_res` with a zero residual, which adds one read of the
    output's size; row 12's strip length and whether it carries), and
    `F.conv1d` alone on the pre-snaked input (the conv without the snake: not
    the same function, the reference for the kernels' data movement)."""
    x = randn(B, C, L)
    w = randn(C, C, 7, scale=(C * 7) ** -0.5)
    bias = randn(C, dtype=torch.float32) * 0.1
    a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
    pad = 3 * d
    zero = torch.zeros_like(x)
    row3 = lambda: cs.snake_conv1d_res(x, w, bias, a, b, zero, pad, pad, d)
    row12 = lambda: cs.snake_conv1d(x, w, bias, a, b, pad, pad, d)
    turns = [cuda_ms(fn, iters) for fn in (row3, row12, row12, row3)]
    strip, carried = cs.carry_strip_tiles(B, C, C, L, 7, d)
    out = dict(shape=f"[{B},{C},{L}] k=7 d={d}", row3_ms=[turns[0], turns[3]],
               carry_ms=[turns[1], turns[2]], strip_tiles=strip, carried=carried)
    sx = cs._snake_f32(x, a, b).to(x.dtype)
    bias_bf = bias.to(x.dtype)
    out["conv_only_ms"] = cuda_ms(lambda: F.conv1d(sx, w, bias_bf, padding=pad, dilation=d),
                                  iters)
    out.update(bound(2.0 * B * C * C * 7 * L, x, w, bias, a, b, x))
    out["share_of_bound"] = out["bound_ms"] / min(out["carry_ms"])
    return out


def res_level(cs, F, randn, B, C, L, iters=3) -> dict:
    """Row 3 (`snake_conv1d_res`) on one residual unit's k = 1 conv + skip
    [B, C, L], beside its byte bound (x and the residual read once, y written
    once) and `F.conv1d` k = 1 on the pre-snaked input plus the residual add
    (without the snake: the reference for the kernel's data movement)."""
    x, r = randn(B, C, L), randn(B, C, L)
    w = randn(C, C, 1, scale=C ** -0.5)
    bias = randn(C, dtype=torch.float32) * 0.1
    a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
    run = lambda: cs.snake_conv1d_res(x, w, bias, a, b, r, 0, 0, 1)
    out = dict(shape=f"[{B},{C},{L}] k=1 + residual", ms=cuda_ms(run, iters))
    sx = cs._snake_f32(x, a, b).to(x.dtype)
    bias_bf = bias.to(x.dtype)
    out["conv_plus_res_ms"] = cuda_ms(lambda: F.conv1d(sx, w, bias_bf) + r, iters)
    out.update(bound(2.0 * B * C * C * L, x, w, bias, a, b, r, x))
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


# (channels, length) of the SA-2.0 VAE's residual-unit levels at batch 4 x
# 65,536 samples: the encoder's and, in reverse, the decoder's
AE_LEVELS = ((128, 65536), (128, 32768), (256, 8192), (512, 2048), (1024, 256))
# inputs of its snake_fused sites: before the encoder's downsampling convs and
# the decoder's upsampling ones
AE_SNAKES = AE_LEVELS + ((2048, 32),)
# their launches in one generator step: each level's snake runs in the
# encoder and the decoder, the outermost and the innermost once
AE_SNAKE_LAUNCHES = (1, 2, 2, 2, 2, 1)
# (B, C, L) of the snake_fused sites of one SA-2.0 decode group (8 chunks of
# 128 latents): one launch each
SA2_DECODE_SNAKES = ((8, 2048, 128), (8, 1024, 1024), (8, 512, 8192), (8, 256, 32768),
                     (8, 128, 131072))
AE_BATCH = 4
# the backward kernels' f32 gradient sums (up to 4 x 65,536 terms, in another
# order than the plain version's): max|err| within 1% of the gradient's peak
GRAD_REL_TOL = 1e-2


def ae_backward_checks(sn, cs, randn, fwd: dict, hold_row3) -> dict:
    """The four backward kernels of the autoencoder-training path against
    their plain versions at its shapes (batch 4, bf16): dx within 2 bf16 ulps,
    dW, db, dalpha, dbeta within 1% of their peaks; each timed at its largest
    shape beside its plain version and its bound, and the plain weight
    gradient beside `torch.nn.grad.conv1d_weight` (a yardstick only). The
    forward kernels of the path (`snake_fused`, `snake_conv1d`, `_res`) are
    held at the same shapes, 2 bf16 ulps, and their errors join `fwd`'s
    records; `hold_row3` holds row 12 (`snake_conv1d`) against row 3."""
    rec, B = {}, AE_BATCH

    def params(C):
        return (randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp())

    def join_fwd(name, errs, what):
        fwd[name]["max_abs_err"] = max(fwd[name]["max_abs_err"], *errs)
        fwd[name]["shape"] += f"; {what} of the SA-2.0 VAE at batch {B} checked"

    # A. snake backward (and forward) at every snake_fused site: two backward
    #    calls give the same bits; each site timed both ways, by CUDA events
    #    over back-to-back calls (the host paces the small sites) and by the
    #    profiler's kernel time (`device_ms`), and summed with the launches
    #    of one generator step against the summed byte bounds
    errs, fwd_errs, sites = [], [], []
    for (C, L), n in zip(AE_SNAKES, AE_SNAKE_LAUNCHES):
        x, g = randn(B, C, L, scale=2.0), randn(B, C, L)
        a, b = params(C)
        y = sn.snake_fused_plain(x, a, b)
        fwd_errs.append(compare(f"snake [{B},{C},{L}]", sn.snake_fused(x, a, b), y, bf16_tol(y)))
        got, want = sn.snake_fused_bwd(x, a, b, g), sn.snake_fused_bwd_plain(x, a, b, g)
        errs.append(compare(f"snake bwd dx [{B},{C},{L}]", got[0], want[0], bf16_tol(want[0])))
        for name, p, q in zip(("dalpha", "dbeta"), got[1:], want[1:]):
            rel_err(f"snake bwd {name} [{B},{C},{L}]", p, q, GRAD_REL_TOL)
        if not all(torch.equal(p, q) for p, q in zip(got, sn.snake_fused_bwd(x, a, b, g))):
            raise AssertionError(f"snake bwd [{B},{C},{L}]: two calls give other bits")
        bwd, fwd_ = lambda: sn.snake_fused_bwd(x, a, b, g), lambda: sn.snake_fused(x, a, b)
        sites.append(dict(shape=f"[{B},{C},{L}]", launches=n, bwd_ms=cuda_ms(bwd, 20),
                          fwd_ms=cuda_ms(fwd_, 20),
                          bwd_device_ms=profiled_us(bwd, 20)["device_us"] / 1e3,
                          fwd_device_ms=profiled_us(fwd_, 20)["device_us"] / 1e3,
                          bwd_bound_ms=bound(0.0, x, g, a, b, *got)["bound_ms"],
                          fwd_bound_ms=bound(0.0, x, a, b, y)["bound_ms"]))
        del x, g, y, got, want
    step = {k: sum(s["launches"] * s[k] for s in sites)
            for k in ("bwd_ms", "fwd_ms", "bwd_device_ms", "fwd_device_ms", "bwd_bound_ms",
                      "fwd_bound_ms")}
    if sum(AE_SNAKE_LAUNCHES) != AE_GEN_LAUNCHES["snake_fused_bwd"]:
        raise AssertionError(f"the snake sites weigh {AE_SNAKE_LAUNCHES} launches, not a step's")
    join_fwd("snake_fused", fwd_errs, f"the {len(AE_SNAKES)} snake_fused shapes")
    fwd["snake_fused"]["generator_step"] = dict(
        ms=step["fwd_ms"], device_ms=step["fwd_device_ms"], bound_ms=step["fwd_bound_ms"],
        share_of_bound=step["fwd_bound_ms"] / step["fwd_ms"],
        device_share_of_bound=step["fwd_bound_ms"] / step["fwd_device_ms"])
    x, g = randn(B, 128, 65536, scale=2.0), randn(B, 128, 65536)
    a, b = params(128)
    dx = sn.snake_fused_bwd(x, a, b, g)[0]
    rec["snake_fused_bwd"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/snake.py:64",
        shape=f"x, g [{B},128,65536] bf16 (timed; the 6 snake_fused shapes of the SA-2.0 "
              "VAE checked)",
        max_abs_err=max(errs), tol=f"2 bf16 ulps at max|ref| (dx), {GRAD_REL_TOL} x "
                                   "max|plain| (dalpha, dbeta)",
        ms=cuda_ms(lambda: sn.snake_fused_bwd(x, a, b, g), 20),
        plain_ms=cuda_ms(lambda: sn.snake_fused_bwd_plain(x, a, b, g), 10),
        library=None, library_ms=None,  # no single PyTorch call computes it
        deterministic=True, levels=sites,
        generator_step=dict(ms=step["bwd_ms"], device_ms=step["bwd_device_ms"],
                            bound_ms=step["bwd_bound_ms"],
                            share_of_bound=step["bwd_bound_ms"] / step["bwd_ms"],
                            device_share_of_bound=step["bwd_bound_ms"] / step["bwd_device_ms"]),
        **bound(20.0 * x.numel(), x, g, a, b, dx))
    del x, g, dx

    # B, C. snake-conv dx and weight gradient (and the forward) at every
    # snake-conv shape: k = 7 at d 1/3/9 and k = 1 with the residual per
    # level, the encoder's conv_out (2048 -> 128, k 3 at L = 32, a ragged
    # tile) and the decoder's (128 -> 2, k 7 at 65,536, no bias)
    def snake_conv_case(C, Co, L, kk, d):
        x = randn(B, C, L, scale=2.0)
        w = randn(Co, C, kk, scale=(C * kk) ** -0.5)
        a, b = params(C)
        pad = d * (kk - 1) // 2
        name = f"[{B},{C},{L}] -> {Co} k={kk} d={d}"
        bias = randn(Co, dtype=torch.float32) * 0.1 if Co > 2 else None
        r = randn(B, Co, L) if kk == 1 else None
        y = cs.snake_conv1d_plain(x, w, bias, a, b, pad, pad, d, r)
        if r is None:
            out = cs.snake_conv1d(x, w, bias, a, b, pad, pad, d)
            err = compare(f"snake_conv1d {name}", out, y, bf16_tol(y))
            conv_fwd_errs["snake_conv1d"].append(err)
            hold_row3(name, x, w, bias, a, b, pad, d, out)
            del out
        else:
            err = compare(f"snake_conv1d_res {name}",
                          cs.snake_conv1d_res(x, w, bias, a, b, r, pad, pad, d), y, bf16_tol(y))
            conv_fwd_errs["snake_conv1d_res"].append(err)
        del y, r
        dy = randn(B, Co, L)
        got = cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d)
        want = cs.snake_conv1d_dx_plain(dy, x, w, a, b, pad, pad, d)
        dx_err = compare(f"snake_conv1d_dx dx {name}", got[0], want[0], bf16_tol(want[0]))
        for n, p, q in zip(("dalpha", "dbeta"), got[1:], want[1:]):
            rel_err(f"snake_conv1d_dx {n} {name}", p, q, GRAD_REL_TOL)
        got = cs.snake_conv1d_wgrad(dy, x, kk, a, b, pad, pad, d)
        want = cs.conv1d_wgrad_plain(dy, x, kk, pad, pad, d, (a, b))
        w_err = max(rel_err(f"snake_conv1d_wgrad {n} {name}", p, q, GRAD_REL_TOL)
                    for n, p, q in zip(("dW", "db"), got, want))
        w_abs = max((p - q).abs().max().item() for p, q in zip(got, want))
        return dx_err, w_err, w_abs, (x, w, a, b, pad, d, dy, got[0])

    # each case timed too, beside each kernel's bound (row 10 reads dy, x, w,
    # alpha, beta and writes dx; row 11 reads dy, x, alpha, beta and writes
    # dW) and cuDNN's input and weight gradients of the conv alone on the
    # pre-snaked input (yardsticks the port never calls), and summed with the
    # launches of one generator step (each k = 7 case twice: encoder and
    # decoder; k = 1 six times; the conv_outs once)
    cases = [(C, C, L, kk, d) for C, L in AE_LEVELS for kk, d in ((7, 1), (7, 3), (7, 9), (1, 1))]
    cases += [(2048, 128, 32, 3, 1), (128, 2, 65536, 7, 1)]
    dx_errs, w_errs, w_abs, levels = [], [], [], []
    conv_fwd_errs = {"snake_conv1d": [], "snake_conv1d_res": []}
    for C, Co, L, kk, d in cases:
        e_dx, e_w, a_w, (x, w, a, b, pad, _, dy, dW) = snake_conv_case(C, Co, L, kk, d)
        dx_errs.append(e_dx)
        w_errs.append(e_w)
        w_abs.append(a_w)
        sx = cs._snake_f32(x, a, b).to(x.dtype)
        levels.append(dict(
            shape=f"[{B},{C},{L}] -> {Co} k={kk} d={d}",
            launches=1 if Co != C else 6 if kk == 1 else 2,
            dx_ms=cuda_ms(lambda: cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d), 3),
            wgrad_ms=cuda_ms(lambda: cs.snake_conv1d_wgrad(dy, x, kk, a, b, pad, pad, d), 3),
            conv1d_input_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
                x.shape, w, dy, padding=pad, dilation=d), 3),
            conv1d_weight_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
                sx, w.shape, dy, padding=pad, dilation=d), 3),
            dx_bound_ms=bound(2.0 * B * L * C * Co * kk, dy, x, w, a, b, x)["bound_ms"],
            wgrad_bound_ms=bound(2.0 * B * L * C * Co * kk, dy, x, a, b, dW)["bound_ms"]))
        del x, w, dy, dW, sx
    step = {k: sum(c["launches"] * c[k] for c in levels)
            for k in ("dx_ms", "wgrad_ms", "conv1d_input_ms", "conv1d_weight_ms", "dx_bound_ms",
                      "wgrad_bound_ms")}
    if sum(c["launches"] for c in levels) != AE_GEN_LAUNCHES["snake_conv1d_dx"]:
        raise AssertionError(f"the {len(levels)} cases weigh {levels} launches, not a step's")
    for n, what in (("snake_conv1d", "k = 7 and k = 3"), ("snake_conv1d_res", "k = 1")):
        join_fwd(n, conv_fwd_errs[n], f"the {len(conv_fwd_errs[n])} {what} cases")
    _, _, _, (x, w, a, b, pad, d, dy, dW) = snake_conv_case(128, 128, 65536, 7, 9)
    flops = 2.0 * B * 65536 * 128 * 128 * 7
    dx_run = lambda: cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d)
    rec["snake_conv1d_dx"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/snake_conv1d_dx.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:199",
        shape=f"dy, x [{B},128,65536] k=7 d=9 bf16 (timed; {len(cases)} cases of the SA-2.0 "
              "VAE checked)",
        max_abs_err=max(dx_errs), tol=f"2 bf16 ulps at max|ref| (dx), {GRAD_REL_TOL} x "
                                      "max|plain| (dalpha, dbeta)",
        ms=cuda_ms(dx_run, 5),
        plain_ms=cuda_ms(lambda: cs.snake_conv1d_dx_plain(dy, x, w, a, b, pad, pad, d), 3),
        library=None, library_ms=None,  # cuDNN's input gradient omits the snake
        levels=[{k: v for k, v in c.items()
                 if k not in ("wgrad_ms", "conv1d_weight_ms", "wgrad_bound_ms")} for c in levels],
        generator_step=dict(ms=step["dx_ms"], bound_ms=step["dx_bound_ms"],
                            share_of_bound=step["dx_bound_ms"] / step["dx_ms"],
                            conv1d_input_ms=step["conv1d_input_ms"]),
        **bound(flops, dy, x, w, a, b, x))
    rec["snake_conv1d_wgrad"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/conv1d_wgrad.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:303",
        shape=f"dy, x [{B},128,65536] k=7 d=9 bf16 -> dW f32 (timed; {len(cases)} cases "
              "checked)",
        max_abs_err=max(w_abs), max_rel_err=max(w_errs),
        tol=f"{GRAD_REL_TOL} x max|plain| (dW, db)",
        ms=cuda_ms(lambda: cs.snake_conv1d_wgrad(dy, x, 7, a, b, pad, pad, d), 5),
        plain_ms=cuda_ms(lambda: cs.conv1d_wgrad_plain(dy, x, 7, pad, pad, d, (a, b)), 3),
        library=None, library_ms=None,  # conv1d_weight omits the snake
        levels=[{k: v for k, v in c.items()
                 if k not in ("dx_ms", "conv1d_input_ms", "dx_bound_ms")} for c in levels],
        generator_step=dict(ms=step["wgrad_ms"], bound_ms=step["wgrad_bound_ms"],
                            share_of_bound=step["wgrad_bound_ms"] / step["wgrad_ms"],
                            conv1d_weight_ms=step["conv1d_weight_ms"]),
        **bound(flops, dy, x, a, b, dW))
    del x, w, dy, dW

    # D. the plain weight gradient of the encoder's and decoder's conv_in
    errs, abs_errs = [], []
    for C, Co, L in ((2, 128, 65536), (64, 2048, 32)):
        x, dy = randn(B, C, L), randn(B, Co, L)
        got, want = cs.conv1d_wgrad(dy, x, 7, 3, 3, 1), cs.conv1d_wgrad_plain(dy, x, 7, 3, 3, 1)
        errs.append(max(rel_err(f"conv1d_wgrad {n} [{B},{C},{L}] -> {Co}", p, q, GRAD_REL_TOL)
                        for n, p, q in zip(("dW", "db"), got, want)))
        abs_errs.append(max((p - q).abs().max().item() for p, q in zip(got, want)))
    # and at every shape of a Dance Diffusion and a codec training step
    dance = plain_wgrad_checks(cs, randn, dance_wgrad_shapes(), DANCE_BATCH)
    codec = plain_wgrad_checks(cs, randn, codec_wgrad_shapes(), 4)
    x, dy = randn(B, 2, 65536), randn(B, 128, 65536)
    dW = cs.conv1d_wgrad(dy, x, 7, 3, 3, 1)[0]
    rec["conv1d_wgrad"] = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/conv1d_wgrad.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/conv1d_snake.py:311",
        shape=f"dy [{B},128,65536], x [{B},2,65536] k=7 bf16 -> dW f32 (timed; the "
              f"encoder's and the decoder's conv_in, the {len(dance['levels'])} shapes of "
              f"a Dance and the {len(codec['levels'])} of a codec training step checked)",
        max_abs_err=max(*abs_errs, dance["max_abs_err"], codec["max_abs_err"]),
        max_rel_err=max(*errs, dance["max_rel_err"], codec["max_rel_err"]),
        dance_step=dance, codec_step=codec,
        tol=f"{GRAD_REL_TOL} x max|plain| (dW, db)",
        ms=cuda_ms(lambda: cs.conv1d_wgrad(dy, x, 7, 3, 3, 1), 10),
        plain_ms=cuda_ms(lambda: cs.conv1d_wgrad_plain(dy, x, 7, 3, 3, 1), 5),
        library="torch.nn.grad.conv1d_weight (bf16, weight only)",
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(x, (128, 2, 7), dy, padding=3),
                           10),
        **bound(2.0 * B * 65536 * 2 * 128 * 7, dy, x, dW))
    return rec


def nhd_checks(fa, randn, F) -> dict:
    """`flash_attention_nhd` against its plain version, and timed against the
    [B, H, N, 64] entry with the copies that route needs, at SA-2.0's and
    SA-Open's self-attention shapes. q and k are fresh tensors (as after the
    rotary), v a strided view of the fused projection output, as the
    attention module hands them over."""
    H, D = 24, 64

    def operands(B, N):
        fused = randn(B, N, 3 * H * D)
        q, k, v = (t.view(B, N, H, D) for t in fused.chunk(3, dim=-1))
        return fused, q.clone(), k.clone(), v

    def check(name, out, q, k, v, causal=False, heads=4):
        # the plain version a few heads at a time: 6145^2 f32 logits for all
        # 48 (batch, head) pairs at once would take 7.2 GB, and as much again
        errs = []
        for h in range(0, q.shape[2], heads):
            sl = slice(h, h + heads)
            ref, _ = fa.flash_attention_nhd_plain(q[:, :, sl], k[:, :, sl], v[:, :, sl], causal)
            errs.append(compare(f"{name} heads {h}+", out[:, :, sl], ref, bf16_tol(ref)))
        return max(errs)

    def via_prefix(q, k, v):
        # the other route: the [B, H, N, 64] entry on transposed views (the
        # kernel reads them through their strides), one transposed copy out
        out, _ = fa.flash_attention_prefix(*(t.transpose(1, 2) for t in (q, k, v)), 1)
        return out.transpose(1, 2).reshape(q.shape[0], q.shape[1], H * D)

    rec, errs, ab = {}, {}, {}
    for N, iters in ((6145, 10), (1025, 50)):
        fused, q, k, v = operands(2, N)
        out = fa.flash_attention_nhd(q, k, v, prefix_len=1)
        errs[f"views N={N}"] = check(f"flash nhd N={N}", out, q, k, v)
        vc = v.contiguous()
        if not torch.equal(fa.flash_attention_nhd(q, k, vc, prefix_len=1), out):
            raise AssertionError(f"flash nhd N={N}: a contiguous v gives another result")
        q3, k3, v3 = (t.view(2, N, H, D) for t in fused.chunk(3, dim=-1))  # all three strided
        errs[f"fused N={N}"] = check(f"flash nhd fused N={N}",
                                     fa.flash_attention_nhd(q3, k3, v3, prefix_len=1), q3, k3, v3)
        compare(f"flash nhd vs prefix entry N={N}", out.view(2, N, H * D), via_prefix(q, k, v),
                bf16_tol(out))
        ab[N] = dict(
            nhd_ms=cuda_ms(lambda: fa.flash_attention_nhd(q, k, v, prefix_len=1), iters),
            prefix_with_copies_ms=cuda_ms(lambda: via_prefix(q, k, v), iters),
            sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (q, k, v))), iters))
        if N == 6145:
            lse = torch.empty((2, H, N), dtype=torch.float32, device=q.device)
            rec.update(bound(attn_flops(2, H, N, D), q, k, v, out, lse),
                       plain_ms=cuda_ms(lambda: [fa.flash_attention_nhd_plain(
                           q[:, :, h:h + 4], k[:, :, h:h + 4], v[:, :, h:h + 4])
                           for h in range(0, H, 4)], 2))
        del fused, q, k, v, vc, q3, k3, v3, out
    q, k, v = (randn(2, 300, 4, D) for _ in range(3))
    errs["causal [2,300,4,64]"] = check(
        "flash nhd causal", fa.flash_attention_nhd(q, k, v, causal=True), q, k, v, causal=True)

    # gradients through the autograd Function (the [B, H, N, 64] backward
    # kernels on transposed copies) against autograd through the plain
    # version, at the training shape; and forward + backward through each
    # entry, timed
    fused = randn(4, 1025, 3 * H * D).requires_grad_()
    dout = randn(4, 1025, H, D)
    split = lambda: tuple(t.view(4, 1025, H, D) for t in fused.chunk(3, dim=-1))
    through = lambda fn: torch.autograd.grad((fn(*split()).float() * dout.float()).sum(), fused)[0]
    nhd = lambda q, k, v: fa.flash_attention_nhd(q, k, v, prefix_len=1)
    bhnd = lambda q, k, v: fa.flash_attention_prefix(
        *(t.transpose(1, 2) for t in (q, k, v)), 1)[0].transpose(1, 2)
    grad_err = rel_err("flash nhd autograd", through(nhd), through(
        lambda q, k, v: fa.flash_attention_nhd_plain(q, k, v, False, 1)[0]), BWD_REL_TOL)
    ab["fwd_bwd [4,1025,24,64]"] = dict(nhd_ms=cuda_ms(lambda: through(nhd), 10),
                                        prefix_with_copies_ms=cuda_ms(lambda: through(bhnd), 10))
    rec.update(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/flash_fwd.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/flash_attention.py:757",
        shape="q,k [2,6145,24,64] bf16 contiguous, v a view of the fused [2,6145,4608], prefix 1",
        max_abs_err=max(errs.values()), errs=errs, autograd_rel_err=grad_err,
        tol="2 bf16 ulps at max|ref| (out), "
            f"{BWD_REL_TOL} x max|plain| (gradient of the fused projection)",
        ms=ab[6145]["nhd_ms"], library="F.scaled_dot_product_attention",
        library_ms=ab[6145]["sdpa_ms"], ab={str(k): v for k, v in ab.items()})
    return rec


def long_bwd_checks(fa, randn, F) -> dict:
    """Row 6's kernels at SA-2.0's training shape [4, 24, 6145, 64] (what row
    8's Function calls there: 97 key tiles a query tile), both routes against
    the plain f32 backward 4 heads at a time; timed beside the plain version
    and SDPA's backward."""
    B, H, N, D, heads = 4, 24, 6145, 64, 4
    q, k, v, dout = (randn(B, H, N, D) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v)
    plain = lambda: [fa.flash_attention_prefix_bwd_plain(
        *(t[:, h:h + heads] for t in (q, k, v, out, lse, dout))) for h in range(0, H, heads)]
    want = [torch.cat(g, 1) for g in zip(*plain())]
    routes = {}
    for route in fa.BWD_ROUTES:
        run = lambda route=route: fa.flash_attention_prefix_bwd(q, k, v, out, lse, dout,
                                                                route=route)
        got = run()
        routes[route] = dict(
            max_rel_err=max(rel_err(f"flash bwd [4,24,6145,64] {route} d{n}", a, b, BWD_REL_TOL)
                            for n, a, b in zip("qkv", got, want)),
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)),
            ms=cuda_ms(run, 5))
        del got
    del want
    same = deterministic(fa, "[4,24,6145,64]", q, k, v, out, lse, dout)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*qkv)
    rec = dict(shape="q,k,v,dO [4,24,6145,64] bf16, lse f32, unmasked", routes=routes,
               deterministic=same,
               ms=routes[fa.BWD_ROUTE]["ms"], max_rel_err=routes[fa.BWD_ROUTE]["max_rel_err"],
               plain_ms=cuda_ms(plain, 1),
               library="autograd through F.scaled_dot_product_attention (backward only)",
               library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, qkv, dout,
                                                              retain_graph=True), 5),
               **bound(attn_flops(B, H, N, D, 5), q, k, v, out, lse, dout, q, k, v))
    del q, k, v, dout, out, lse, qkv, lib_out
    return rec


# (B, N, H, D, rot_dim, causal, window) of `flash_attention_fused_qkv`
# checked beside the training shape: the JAX test's four cases
# (tests/test_flash_attention.py:199), D = 128, and a ragged N
FUSED_CASES = (
    (1, 512, 2, 64, 32, True, None), (1, 512, 2, 64, 32, False, None),
    (1, 512, 2, 64, 0, False, (63, 64)), (1, 512, 2, 64, 0, True, None),
    (1, 1000, 4, 128, 64, True, None), (2, 1537, 24, 64, 32, False, None))


def fused_qkv_checks(fa, randn, F) -> dict:
    """`flash_attention_fused_qkv` (row 8: the rotary pass, then the attention kernel)
    against its plain version (unpack, rotary, plain attention) at SA-2.0's
    training shape [4, 6145, 24, 64] with rotary 32 and at FUSED_CASES; its
    autograd Function (forward kernel; rotary re-run, row 6's backward and the
    rotary's VJP) against autograd through the plain version, at the training
    shape too; timed beside SDPA on pre-rotated q, k, v (no PyTorch call
    computes rotary + attention) and against the rotary pass +
    `flash_attention_nhd` in turns (A B B A): at the training shape forward,
    forward + backward and memory, at the generation shape [2, 6145, 24, 64]
    the forward that generation runs."""
    from stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs, rotary_tables, rotate_nhd

    def operands(B, N, H, D, rot):
        qkv = randn(B, N, 3 * H * D)
        cos, sin = rotary_tables(rotary_freqs(N, rot, device=qkv.device)) if rot else (None, None)
        return qkv, cos, sin

    def plain_heads(qkv, cos, sin, H, causal, window, heads):
        """The plain version `heads` heads at a time (6145^2 f32 logits for
        all 96 (batch, head) pairs would take 14.5 GB, and more again)."""
        B, N, _ = qkv.shape
        per = qkv.view(B, N, 3, H, -1)
        for h in range(0, H, heads):
            sub = per[:, :, :, h:h + heads].reshape(B, N, -1)
            yield h, fa.flash_attention_fused_qkv_plain(sub, cos, sin, sub.shape[-1] // (
                3 * per.shape[-1]), causal, window)

    def check(name, B, N, H, D, rot, causal=False, window=None, heads=4):
        qkv, cos, sin = operands(B, N, H, D, rot)
        out, lse = fa._launch_fused(qkv, cos, sin, H, causal, window)
        errs = []
        for h, (ref, ref_lse) in plain_heads(qkv, cos, sin, H, causal, window, heads):
            errs.append(compare(f"{name} heads {h}+", out[:, :, h:h + heads], ref, bf16_tol(ref)))
            compare(f"{name} lse heads {h}+", lse[:, h:h + heads], ref_lse, 1e-3)
        return max(errs), (qkv, cos, sin, out, lse)

    def fused_route(x, cos, sin, H):
        return fa.flash_attention_fused_qkv(x, cos, sin, H)

    def nhd_route(x, cos, sin, H):
        """The rotary pass + the NHD entry: what generation runs, and what
        training would run without row 8."""
        B, N, _ = x.shape
        q, k, v = (t.view(B, N, H, -1) for t in x.chunk(3, dim=-1))
        return fa.flash_attention_nhd(rotate_nhd(q, cos, sin), rotate_nhd(k, cos, sin), v,
                                      prefix_len=1)

    errs = {}
    for B, N, H, D, rot, causal, window in FUSED_CASES:
        name = f"[{B},{N},{H},{D}] rot {rot} {'causal' if causal else window or 'unmasked'}"
        errs[name] = check(f"fused_qkv {name}", B, N, H, D, rot, causal, window)[0]
    B, N, H, D = 4, 6145, 24, 64
    errs["[4,6145,24,64] rot 32"], (qkv, cos, sin, out, lse) = check(
        "fused_qkv training shape", B, N, H, D, 32)
    rec = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/flash_fwd.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/flash_attention.py:1040",
        shape="qkv [4,6145,4608] bf16 (24 heads of 64, [q | k | v]), cos/sin [6145,32] f32, "
              "unmasked (timed; " + ", ".join(errs) + " checked)",
        errs=errs, max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: fused_route(qkv, cos, sin, H), 10),
        plain_ms=cuda_ms(lambda: list(plain_heads(qkv, cos, sin, H, False, None, 4)), 2),
        **bound(attn_flops(B, H, N, D), qkv, cos, sin, out, lse))
    q, k, v = (t.view(B, N, H, D) for t in qkv.chunk(3, dim=-1))
    qr, kr = rotate_nhd(q, cos, sin), rotate_nhd(k, cos, sin)
    rec.update(library="none (no PyTorch call computes rotary + attention); "
                       "F.scaled_dot_product_attention on pre-rotated q, k, v",
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   *(t.transpose(1, 2) for t in (qr, kr, v))), 10))
    del q, k, v, qr, kr, out, lse

    # the training A/B: forward, forward + backward through each Function,
    # and the memory each keeps from its forward for its backward (the fused
    # route keeps no rotated q, k) and adds at its peak
    w = qkv.detach().requires_grad_()
    dout = randn(B, N, H, D)

    def memory_mib(route):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o = route(w, cos, sin, H)
        kept = torch.cuda.memory_allocated() - base
        torch.autograd.grad(o, w, dout)
        return dict(kept_after_forward_mib=kept / 2 ** 20,
                    peak_fwd_bwd_mib=(torch.cuda.max_memory_allocated() - base) / 2 ** 20)

    with torch.no_grad():
        compare("fused_qkv vs rotary + nhd [4,6145,24,64]", fused_route(qkv, cos, sin, H),
                nhd_route(qkv, cos, sin, H), bf16_tol(nhd_route(qkv, cos, sin, H)))
    turns = (fused_route, nhd_route, nhd_route, fused_route)
    fwd = [cuda_ms(lambda r=r: r(w, cos, sin, H), 10) for r in turns]
    both = [cuda_ms(lambda r=r: torch.autograd.grad(r(w, cos, sin, H), w, dout)[0], 3)
            for r in turns]
    rec["fwd_bwd_ms"] = (both[0] + both[3]) / 2
    rec["ab"] = {"[4,6145,24,64] rot 32, training": dict(
        fused_qkv_ms=[fwd[0], fwd[3]], rotary_plus_nhd_ms=[fwd[1], fwd[2]],
        fused_qkv_fwd_bwd_ms=[both[0], both[3]], rotary_plus_nhd_fwd_bwd_ms=[both[1], both[2]],
        fused_qkv_memory=memory_mib(fused_route), rotary_plus_nhd_memory=memory_mib(nhd_route))}

    # the Function's gradient of the projection against autograd through the
    # plain version, f32 sums: at the training shape (row 6's dQ sums over
    # 97 key tiles; the plain version 4 heads at a time, heads being
    # independent), at SA-2.0's heads and rotary at 2049 rows, and causal at
    # D 128
    heads, dout = 4, dout.float()
    got = torch.autograd.grad((fused_route(w, cos, sin, H).float() * dout).sum(), w)[0]
    per, want = qkv.view(B, N, 3, H, D), torch.empty((B, N, 3, H, D), device=qkv.device)
    for h in range(0, H, heads):
        sub = per[:, :, :, h:h + heads].reshape(B, N, -1).requires_grad_()
        (g,) = torch.autograd.grad((fa.flash_attention_fused_qkv_plain(sub, cos, sin, heads)[0]
                                    .float() * dout[:, :, h:h + heads]).sum(), sub)
        want[:, :, :, h:h + heads] = g.view(B, N, 3, heads, D)
    grad_errs = {"[4,6145,24,64] rot 32": rel_err("fused_qkv autograd [4,6145,24,64]", got,
                                                  want.view(B, N, -1), BWD_REL_TOL)}
    del qkv, w, dout, got, want, per, sub, g
    for B, N, H, D, rot, causal in ((1, 2049, 24, 64, 32, False), (1, 700, 4, 128, 64, True)):
        qkv, cos, sin = operands(B, N, H, D, rot)
        w = qkv.detach().requires_grad_()
        dout = randn(B, N, H, D).float()
        got = torch.autograd.grad((fa.flash_attention_fused_qkv(
            w, cos, sin, H, causal).float() * dout).sum(), w)[0]
        want = torch.autograd.grad((fa.flash_attention_fused_qkv_plain(
            w, cos, sin, H, causal)[0].float() * dout).sum(), w)[0]
        grad_errs[f"[{B},{N},{H},{D}] rot {rot}{' causal' if causal else ''}"] = rel_err(
            f"fused_qkv autograd [{B},{N},{H},{D}]", got, want, BWD_REL_TOL)
    rec.update(autograd_rel_err=max(grad_errs.values()), autograd_errs=grad_errs,
               tol="2 bf16 ulps at max|ref| (out), 1e-3 (lse); gradient of the projection "
                   f"{BWD_REL_TOL} x max|plain|")

    # the generation A/B (forward only)
    B, N, H, D = 2, 6145, 24, 64
    qkv, cos, sin = operands(B, N, H, D, 32)
    with torch.no_grad():
        compare("fused_qkv vs rotary + nhd [2,6145,24,64]", fused_route(qkv, cos, sin, H),
                nhd_route(qkv, cos, sin, H), bf16_tol(nhd_route(qkv, cos, sin, H)))
        turns = [cuda_ms(lambda r=r: r(qkv, cos, sin, H), 10)
                 for r in (fused_route, nhd_route, nhd_route, fused_route)]
        rec["ab"]["[2,6145,24,64] rot 32"] = dict(
            fused_qkv_ms=[turns[0], turns[3]], rotary_plus_nhd_ms=[turns[1], turns[2]],
            rotary_pass_ms=cuda_ms(lambda: [rotate_nhd(t.view(B, N, H, D), cos, sin)
                                            for t in qkv.chunk(3, dim=-1)[:2]], 10),
            kernel_rotary_pass_ms=cuda_ms(lambda: fa._rope_pass(
                "flash_attention_fused_qkv", *(t.view(B, N, H, D) for t in
                                               qkv.chunk(3, dim=-1)[:2]), cos, sin), 10))
    del qkv
    return rec


# (name, B, H, N, D, causal, window) of `flash_attention` and its banded
# backward: the LM's causal shapes (training at batch 4 over the first 500
# steps of the pattern sequence, and the 503 steps the issue names;
# `lm_generate` with CFG at 10 s and at 30 s) and TAAE's windowed first level
# (2 heads of 128 at 8192 latents, windows (31, 32) and (63, 64), and a
# ragged N); the first is the one timed into the kernels line
FLASH_SHAPES = (
    ("lm_training", 4, 16, 500, 64, True, None),
    ("lm_training_503", 4, 16, 503, 64, True, None),
    ("lm_generate_cfg", 2, 16, 503, 64, True, None),
    ("lm_generate_30s_cfg", 2, 16, 1503, 64, True, None),
    ("taae_w31", 1, 2, 8192, 128, False, (31, 32)),
    ("taae_w63", 1, 2, 8192, 128, False, (63, 64)),
    ("taae_w31_ragged", 1, 2, 8191, 128, False, (31, 32)),
)


def band_pairs(fa, N: int, causal: bool, window) -> int:
    """(query, key) pairs of an [N, N] band that are visible: the work a
    banded kernel must do, counted from these inputs."""
    import numpy as np

    left, right = fa.band(causal, window)
    i = np.arange(N)
    lo = np.maximum(i - left, 0) if left >= 0 else np.zeros(N, np.int64)
    hi = np.minimum(i + right, N - 1) if right >= 0 else np.full(N, N - 1)
    return int((hi - lo + 1).sum())


def flash_checks(fa, randn, F):
    """`flash_attention` (row 5's forward) and the banded backward (row 6's
    kernels under the causal / window mask, both routes) against their plain
    versions at FLASH_SHAPES; each shape's kernel, plain and library times
    (SDPA with is_causal, or with the band as a boolean mask) and bound. The
    plain versions run one head at a time (8192^2 f32 logits per head). Then
    `flash_attention_nhd`'s causal backward (these kernels under the causal
    band on transposed copies) at [1, 4096, 16, 64] through autograd."""
    fwd, bwd, errs, grad_errs = {}, {}, {}, {}
    for name, B, H, N, D, causal, window in FLASH_SHAPES:
        q, k, v, dout = (randn(B, H, N, D) for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, causal, window)
        heads = [fa.flash_attention_plain(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], causal,
                                          window) for h in range(H)]
        ref, ref_lse = torch.cat([o for o, _ in heads], 1), torch.cat([s for _, s in heads], 1)
        errs[name] = compare(f"flash_attention {name}", out, ref, bf16_tol(ref))
        compare(f"flash_attention {name} lse", lse, ref_lse, 1e-3)
        mask = None if causal else fa.band_mask(N, causal, window, q.device)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                         is_causal=mask is None)
        pairs = B * H * band_pairs(fa, N, causal, window)
        iters = 20 if N * H * B < 50000 else 5
        fwd[name] = dict(
            profiled=profiled_us(lambda: fa.flash_attention(q, k, v, causal, window)),
            library_profiled=profiled_us(library),
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal, window), iters),
            plain_ms=cuda_ms(lambda: [fa.flash_attention_plain(
                q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], causal, window) for h in range(H)], 2),
            library_ms=cuda_ms(library, iters), max_abs_err=errs[name],
            visible_pairs=pairs, **bound(4.0 * D * pairs, q, k, v, out, lse))
        del heads, ref, ref_lse
        want = [torch.cat(g, 1) for g in zip(*(fa.flash_attention_prefix_bwd_plain(
            *(t[:, h:h + 1] for t in (q, k, v, out, lse, dout)), causal, window)
            for h in range(H)))]
        rec = dict(routes={}, visible_pairs=pairs,
                   **bound(10.0 * D * pairs, q, k, v, out, lse, dout, q, k, v))
        for route in fa.BWD_ROUTES:
            run = lambda route=route: fa.flash_attention_prefix_bwd(
                q, k, v, out, lse, dout, route=route, causal=causal, window=window)
            rel = max(rel_err(f"flash bwd {name} {route} d{n}", a, b, BWD_REL_TOL)
                      for n, a, b in zip("qkv", run(), want))
            rec["routes"][route] = dict(max_rel_err=rel, ms=cuda_ms(run, iters))
        grad_errs[name] = max(r["max_rel_err"] for r in rec["routes"].values())
        rec["plain_ms"] = cuda_ms(lambda: [fa.flash_attention_prefix_bwd_plain(
            *(t[:, h:h + 1] for t in (q, k, v, out, lse, dout)), causal, window)
            for h in range(H)], 2)
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*qkv, attn_mask=mask, is_causal=mask is None)
        rec["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(lib_out, qkv, dout, retain_graph=True), iters)
        bwd[name] = rec
        del q, k, v, dout, out, lse, want, qkv, lib_out, mask

    # the autograd Function on the card against autograd through the plain
    # version, at the LM training shape
    q, k, v = (randn(4, 16, 500, 64).requires_grad_() for _ in range(3))
    dout = randn(4, 16, 500, 64)
    got = torch.autograd.grad((fa.flash_attention(q, k, v, True)[0].float()
                               * dout.float()).sum(), (q, k, v))
    want = torch.autograd.grad((fa.flash_attention_plain(q, k, v, True)[0].float()
                                * dout.float()).sum(), (q, k, v))
    autograd_err = max(rel_err(f"flash_attention autograd d{n}", a, b, BWD_REL_TOL)
                       for n, a, b in zip("qkv", got, want))
    del q, k, v, dout, got, want

    # flash_attention_nhd's causal backward: fused-projection views in, the
    # gradient of the projection out, against autograd through the plain
    # version four heads at a time
    fused = randn(1, 4096, 3 * 16 * 64).requires_grad_()
    dout = randn(1, 4096, 16, 64)
    split = lambda: tuple(t.view(1, 4096, 16, 64) for t in fused.chunk(3, dim=-1))
    through = lambda fn: torch.autograd.grad((fn(*split()).float() * dout.float()).sum(),
                                             fused)[0]
    nhd = lambda q, k, v: fa.flash_attention_nhd(q, k, v, causal=True)
    plain = lambda q, k, v: torch.cat([fa.flash_attention_nhd_plain(
        q[:, :, h:h + 4], k[:, :, h:h + 4], v[:, :, h:h + 4], True)[0] for h in range(0, 16, 4)], 2)
    nhd_causal = dict(shape="q,k,v [1,4096,16,64] views of the fused projection, causal",
                      grad_rel_err=rel_err("flash nhd causal autograd", through(nhd),
                                           through(plain), BWD_REL_TOL),
                      fwd_bwd_ms=cuda_ms(lambda: through(nhd), 10),
                      plain_fwd_bwd_ms=cuda_ms(lambda: through(plain), 2))
    del fused, dout

    main = fwd[FLASH_SHAPES[0][0]]
    forward = dict(
        route="cuda", source="stable_audio_tools_tpu_torch/csrc/flash_fwd.cu",
        replaces="stable_audio_tools_tpu/ops/kernels/flash_attention.py:128",
        shape="q,k,v [4,16,500,64] bf16 causal (timed; " + ", ".join(
            f"{n} [{B},{H},{N},{D}] {'causal' if c else w}"
            for n, B, H, N, D, c, w in FLASH_SHAPES) + " checked)",
        max_abs_err=max(errs.values()), errs=errs, autograd_rel_err=autograd_err,
        tol="2 bf16 ulps at max|ref| (out), 1e-3 (lse); gradients through the Function "
            f"{BWD_REL_TOL} x max|plain|",
        ms=main["ms"], plain_ms=main["plain_ms"],
        library="F.scaled_dot_product_attention (is_causal, or the band as a bool mask)",
        library_ms=main["library_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        profiled=main["profiled"], library_profiled=main["library_profiled"], shapes=fwd)
    banded = dict(shapes=bwd, max_rel_err=max(grad_errs.values()), nhd_causal=nhd_causal,
                  tol=f"max|err| <= {BWD_REL_TOL} x max|plain| per gradient, both routes")
    return forward, banded


def counters():
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs
    from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa
    from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln
    from stable_audio_tools_tpu_torch.ops.kernels import snake as sn

    return {"flash_attention": fa.flash_attention,
            "flash_attention_prefix": fa.flash_attention_prefix,
            "flash_attention_prefix_bwd": fa.flash_attention_prefix_bwd,
            "flash_attention_nhd": fa.flash_attention_nhd,
            "flash_attention_fused_qkv": fa.flash_attention_fused_qkv,
            "fused_layer_norm": ln.fused_layer_norm,
            "snake_conv1d": cs.snake_conv1d,
            "snake_conv1d_res": cs.snake_conv1d_res,
            "snake_fused": sn.snake_fused,
            "snake_fused_bwd": sn.snake_fused_bwd,
            "snake_conv1d_dx": cs.snake_conv1d_dx,
            "snake_conv1d_wgrad": cs.snake_conv1d_wgrad,
            "conv1d_wgrad": cs.conv1d_wgrad}


GENERATION_KERNELS = ("flash_attention_prefix", "fused_layer_norm", "snake_conv1d",
                      "snake_conv1d_res", "snake_fused")
TRAINING_KERNELS = GENERATION_KERNELS + ("flash_attention_prefix_bwd",)
SA2_KERNELS = ("flash_attention_nhd", "fused_layer_norm", "snake_conv1d", "snake_conv1d_res",
               "snake_fused")


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


def tiny_model():
    """The tiny SA-Open-shaped model with seeded random weights, its T5 set to
    compute in f32: the T5 has no kernel, and its bf16 roundings, which
    differ between the card's and the CPU's GEMMs, would otherwise dominate
    what the card-vs-CPU checks measure (the kernels against their plain
    versions). Its tokenizer hashes words with CRC-32 in place of Python's
    per-process salted `hash`, so every run sees the same token ids: the
    card-vs-CPU error depends on the prompt embedding, and over 25 token
    draws at cfg 6 it spans 0.027 to 0.055 (H100 against an x86 CPU)."""
    import zlib

    from stable_audio_tools_tpu_torch.models.conditioners import FallbackTokenizer
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = init_random_(create_model_from_config(tiny_config(), "cpu"),
                         torch.Generator().manual_seed(1))
    t5 = model.conditioner.conditioners["prompt"]
    t5.model.compute_dtype = torch.float32
    t5.tokenizer = FallbackTokenizer(t5.tokenizer.max_length,
                                     word_hash=lambda w: zlib.crc32(w.encode("utf-8")))
    return model


@torch.inference_mode()
def small_check(dev) -> float:
    """Largest relative error (max|card - CPU| / max|CPU|) of a tiny
    SA-Open-shaped model's conditioning + CFG denoiser call and VAE decode,
    with the kernels on the card against the plain versions on the CPU.
    Both run bf16 compute; 5% is a few bf16 roundings through 2 DiT layers
    and the decoder. The T5 computes in f32 here (see tiny_model)."""
    cpu = tiny_model().eval()
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
def stage_breakdown(model, dev, prompt=PROMPT, sample_size=SAMPLE_SIZE) -> dict:
    """Where a generation path's time goes, per layer: conditioning (the text
    tower + number conditioners), one sampler step (a CFG denoiser call on
    the doubled batch), the VAE decode; host clock around synchronised work.
    Then torch.profiler over one step and one decode: device-busy share
    (kernel time / wall) and the largest kernels by device time."""
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

    cond_ms, tensors = timed(lambda: model.conditioner(prompt, dev), 3)
    cond = model.get_conditioning_inputs(tensors)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 64, sample_size // 2048, generator=g, device=dev)
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
    model = create_model_from_config(sa_open_config(), dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    run = lambda steps, seed: generate_diffusion_cond(
        model, steps=steps, cfg_scale=6.0, conditioning=PROMPT, batch_size=1,
        sample_size=SAMPLE_SIZE, seed=seed, sampler_type="dpmpp-3m-sde",
        sigma_min=0.3, sigma_max=500.0)
    run(2, 0)  # warm-up: cuDNN plans at the full shapes
    torch.cuda.synchronize()
    kernels = {n: fn for n, fn in counters().items() if n in GENERATION_KERNELS}
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


TRAIN_BATCH = 4
WARM_STEPS, TIMED_STEPS = 2, 5
N_WAVS, WAV_SECONDS, SR = 8, 50, 44100  # clip i lasts WAV_SECONDS + 5 i seconds
META_MODULE = """
def get_custom_metadata(info, audio):
    return {"prompt": "synthetic partials, clip " + info["relpath"]}
"""


def write_dataset(root: str, n_wavs: int = N_WAVS, seconds: int = WAV_SECONDS,
                  step: float = 5, sr: int = SR, channels: int = 2) -> str:
    """`n_wavs` seeded synthetic WAVs (stereo 44.1 kHz by default) of
    `seconds` + `step` i seconds (by default 8 of 50 to 85 s; four partials
    under a slow envelope, over noise) written with the port's WAV writer, a
    metadata module that gives each a prompt, and the `audio_dir` dataset
    config; returns the config's path. The default clips outlast the 47.6 s
    crop by 2.4 to 37.4 s, so the random crops' `seconds_start` is rarely 0
    for a whole batch (which would leave that number embedder without a
    gradient)."""
    import numpy as np

    from stable_audio_tools_tpu_torch.data.wav import save_wav

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "wavs"))
    for i in range(n_wavs):
        t = np.arange((seconds + step * i) * sr, dtype=np.float32) / sr
        tone = sum(np.sin(2 * np.pi * f * t + ph) for f, ph in
                   zip(rng.uniform(60, 3000, 4), rng.uniform(0, 2 * np.pi, 4))) / 6
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.05, 1.0) * t)
        audio = np.stack([tone * env, np.roll(tone, i + 1) * env])[:channels]
        audio += 0.02 * rng.standard_normal(audio.shape).astype(np.float32)
        save_wav(os.path.join(root, "wavs", f"clip{i}.wav"), audio, sr)
    with open(os.path.join(root, "metadata.py"), "w") as f:
        f.write(META_MODULE)
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as f:
        json.dump({"dataset_type": "audio_dir", "random_crop": True, "datasets": [
            {"id": "synthetic", "path": os.path.join(root, "wavs"),
             "custom_metadata_module": os.path.join(root, "metadata.py")}]}, f)
    return path


def small_train_check(dev) -> dict:
    """One training step of a tiny SA-Open-shaped model (bf16 DiT with block
    rematerialisation, bf16 VAE encode, AdamW + InverseLR, EMA) with the
    kernels on the card against the plain versions on the CPU: the same
    weights, batch, t, noise, VAE noise and CFG-dropout mask (one of two
    samples dropped). Returns the loss's relative error and the largest
    max|card - CPU| / max|CPU| over the DiT's gradients. The T5 computes in
    f32 (see tiny_model)."""
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    cfg = tiny_config()
    cpu = tiny_model()
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(2)
    B, T = 2, 32 * 128
    batch = dict(t=torch.rand(B, generator=g), noise=torch.randn(B, 16, 128, generator=g),
                 encode_noise=torch.randn(B, 16, 128, generator=g),
                 cfg_dropout_mask=torch.tensor([False, True]))
    audio = 0.3 * torch.randn(B, 2, T, generator=g)
    meta = [PROMPT[0], dict(PROMPT[0], seconds_start=7)]
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        w = create_training_wrapper_from_config(cfg, model)
        aux = w.train_step(audio.to(d), meta, **{k: v.to(d) for k, v in batch.items()})
        out[name] = (float(aux["loss"]), w)
    (lc, wc), (lg, wg) = out["cpu"], out["card"]
    if not (math.isfinite(lc) and math.isfinite(lg)):
        raise AssertionError(f"small training step: loss cpu {lc} card {lg}")
    errs = {}
    for n, p in wc.params.items():
        if n.startswith("model.model."):
            gg = wg.params[n].grad
            if gg is None or not torch.isfinite(gg).all():
                raise AssertionError(f"small training step: {n} has no finite gradient on the card")
            errs[n] = ((gg.float().cpu() - p.grad).abs().max() / p.grad.abs().max()).item()
    worst = max(errs, key=errs.get)
    return dict(loss_rel_err=abs(lg - lc) / abs(lc), grad_rel_err=errs[worst], worst_grad=worst)


def step_split(trainer, loader) -> dict:
    """One training step in its pieces, host clock around synchronised work:
    data (next batch), conditioning (T5 + number conditioners), encode (the
    frozen VAE, no grad), forward+backward, optimizer (AdamW + LR schedule),
    EMA. Then torch.profiler over one forward+backward of the same batch:
    device-busy share and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w = trainer.wrapper
    out, t = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out[f"{name}_ms"] = (t[-1] - t[-2]) * 1e3

    audio, meta = next(iter(loader))
    audio = trainer.prepare_batch(audio)
    lap("data")
    gen = w.generator(w.step)
    w.model.train()
    w.optimizer.zero_grad(set_to_none=True)
    cond = w.condition(meta)
    lap("conditioning")
    latents = w.encode(audio, generator=gen)
    lap("encode")
    mask = w.padding_mask(meta, latents.shape[2])
    loss, _ = w.loss(latents, cond, generator=gen, counter=w.step, padding_mask=mask)
    loss.backward()
    lap("forward_backward")
    w.optimizer_step()
    lap("optimizer")
    w.ema_step()
    lap("ema")
    w.step += 1
    out["step_ms"] = (t[-1] - t[0]) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = w.loss(latents, w.condition(meta), generator=gen, counter=w.step,
                         padding_mask=mask)
        loss.backward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    w.optimizer.zero_grad(set_to_none=True)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    out["fwd_bwd_profiled_ms"] = wall_us / 1e3
    out["fwd_bwd_device_busy"] = busy_us / wall_us
    out["fwd_bwd_top_kernels_ms"] = {
        e.key[:60]: round(e.self_device_time_total / 1e3, 3)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]}
    return out


def phase_training(dev) -> dict:
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    small = small_train_check(dev)
    small_tol = 0.05  # as the generation check: a few bf16 roundings through 2 blocks
    if not (small["loss_rel_err"] <= small_tol and small["grad_rel_err"] <= small_tol):
        raise AssertionError(f"small training step card vs CPU: {small} > {small_tol}")

    rec = dict(small=small, small_tol=small_tol)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        cfg_path = os.path.join(tmp, "model.json")
        with open(cfg_path, "w") as f:
            json.dump(sa_open_config(), f)
        args = train.parse_args([
            "--model-config", cfg_path, "--dataset-config", write_dataset(tmp),
            "--batch-size", str(TRAIN_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(WARM_STEPS + TIMED_STEPS), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        t0 = time.perf_counter()
        trainer, loader = train.build(args, device=dev)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        w = trainer.wrapper
        before = {n: p.detach().clone() for n, p in w.params.items()}
        trainer.fit(loader, max_steps=1, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        if bad:
            raise AssertionError(f"after step 1, {len(bad)} trainable parameters have no finite "
                                 f"nonzero gradient: {bad[:8]}")
        trainer.fit(loader, max_steps=WARM_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        kernels = {n: fn for n, fn in counters().items() if n in TRAINING_KERNELS}
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader, max_steps=WARM_STEPS + TIMED_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        idle = [n for n, c in rec["launches"].items() if c == 0]
        if idle:
            raise AssertionError(f"kernels not launched by the training path: {idle}")
        losses = [h["train/loss"] for h in trainer.history]
        if len(losses) != WARM_STEPS + TIMED_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"training losses: {losses}")
        walls = [1e3 / h["train/steps_per_sec"] for h in trainer.history[WARM_STEPS:]]
        unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
        ema_unmoved = [n for n, e in w.ema.items() if torch.equal(e, before[n])]
        if unmoved or ema_unmoved:
            raise AssertionError(f"parameters that did not move: {unmoved[:8]}; "
                                 f"EMA entries that did not move: {ema_unmoved[:8]}")
        del before
        trainable = sum(p.numel() for p in w.params.values())
        rec.update(
            losses=losses, step_ms=walls, step_ms_median=statistics.median(walls),
            audio_s_per_s=TRAIN_BATCH * SAMPLE_SIZE / SR / (statistics.median(walls) / 1e3),
            trainable_params=trainable,
            params=sum(p.numel() for p in w.model.parameters()),
            memory_gib=dict(  # f32 state reckoned from the shapes
                weights=sum(p.numel() * p.element_size() for p in w.model.parameters()) / 2 ** 30,
                grads=4 * trainable / 2 ** 30, adam=8 * trainable / 2 ** 30,
                ema=4 * trainable / 2 ** 30))
        rec["split"] = step_split(trainer, loader)

        t0 = time.perf_counter()
        path = trainer.save(w.step)
        rec["save_s"] = time.perf_counter() - t0
        rec["ckpt_gib"] = os.path.getsize(path) / 2 ** 30
        t0 = time.perf_counter()
        state = torch.load(path, map_location="cpu", weights_only=True)
        fresh = create_model_from_config(state["model_config"], "meta")
        fresh.load_state_dict(state["state_dict"], strict=True, assign=True)
        current = w.model.state_dict()
        differ = [n for n, v in fresh.state_dict().items() if not torch.equal(v, current[n].cpu())]
        if differ or state["step"] != w.step or set(state["ema"]) != set(w.ema):
            raise AssertionError(f"checkpoint reload: {len(differ)} tensors differ "
                                 f"({differ[:5]}), step {state['step']} vs {w.step}")
        rec["reload_s"] = time.perf_counter() - t0
    return rec


def write_clap_checkpoint(path: str, arch=None, seed: int = 0) -> None:
    """A seeded random CLAP text branch as a checkpoint file: the port's
    RoBERTa (default: RoBERTa-base's shape, vocabulary 50265, 768 wide, 12
    layers, 3072 feed-forward, 514 positions) under laion-clap's
    `module.text_branch.*` names, and the 512-wide `text_projection`."""
    from stable_audio_tools_tpu_torch.models.factory import init_random_
    from stable_audio_tools_tpu_torch.models.roberta import RobertaArch, RobertaModel

    g = torch.Generator().manual_seed(seed)
    arch = arch or RobertaArch()
    tower = init_random_(RobertaModel(arch), g)
    proj = init_random_(torch.nn.Sequential(torch.nn.Linear(arch.hidden_size, 512),
                                            torch.nn.ReLU(), torch.nn.Linear(512, 512)), g)
    with torch.no_grad():
        tower.embeddings.word_embeddings.weight.mul_(0.05)
        tower.embeddings.position_embeddings.weight.mul_(0.05)
        tower.embeddings.token_type_embeddings.weight.mul_(0.05)
    sd = {f"module.text_branch.{k}": v for k, v in tower.state_dict().items()}
    sd.update({f"module.text_projection.{k}": v for k, v in proj.state_dict().items()})
    torch.save({"state_dict": sd}, path)


def sa2_config(clap_path: str, model_type: str = "diffusion_cond"):
    """The shipped SA-2.0 config, nothing cut: its CLAP checkpoint path (a
    placeholder in the file) pointed at `clap_path`, and the chunked decode
    the long output needs."""
    with open(SA2) as f:
        cfg = json.load(f)
    cfg["model_type"] = model_type
    cfg["model"]["pretransform"]["chunked"] = True
    for c in cfg["model"]["conditioning"]["configs"]:
        if c["type"] == "clap_text":
            c["config"]["clap_ckpt_path"] = clap_path
    return cfg


def tiny_sa2_model(clap_path: str, model_type: str = "diffusion_cond"):
    """SA-2.0's shape at toy size on the CPU: the same blocks, conditioners
    and kernels (head dim 64, prefix 1, the strided-layout attention entry
    through the attention modules' `nhd_min_seq` set to 0), 2 DiT layers of 128, a 2-level VAE decoding in
    chunks, the CLAP tower of `clap_path`; CRC-32 word hashing as
    `tiny_model()`."""
    import zlib

    from stable_audio_tools_tpu_torch.models.conditioners import FallbackTokenizer
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    cfg = sa2_config(clap_path, model_type)
    m = cfg["model"]
    m["conditioning"]["cond_dim"] = 64
    m["diffusion"]["config"].update(embed_dim=128, depth=2, num_heads=2, cond_token_dim=64,
                                    global_cond_dim=128, io_channels=16)
    if model_type == "diffusion_cond_inpaint":
        m["diffusion"]["config"]["input_concat_dim"] = 17
    m["io_channels"] = 16
    ae = m["pretransform"]["config"]
    ae["encoder"]["config"].update(channels=32, c_mults=[1, 2], strides=[4, 8], latent_dim=32)
    ae["decoder"]["config"].update(channels=32, c_mults=[1, 2], strides=[4, 8], latent_dim=16)
    ae.update(latent_dim=16, downsampling_ratio=32)
    model = create_model_from_config(cfg, "cpu")
    for block in model.model.model.transformer.layers:
        block.self_attn.nhd_min_seq = 0
    clap = model.conditioner.conditioners["prompt"]
    init_random_(model, torch.Generator().manual_seed(1), skip=[clap.model, clap.text_projection])
    clap.tokenizer = FallbackTokenizer(clap.tokenizer.max_length,
                                       word_hash=lambda w: zlib.crc32(w.encode("utf-8")))
    return model


@torch.inference_mode()
def small_sa2_check(dev, clap_path: str) -> dict:
    """A tiny SA-2.0-shaped model with the kernels on the card against the
    plain versions on the CPU, stage by stage on the same inputs (largest
    max|card - CPU| / max|CPU|): conditioning with the f32 CLAP tower, a CFG
    denoiser call with a negative prompt on 1 + 288 tokens through
    `flash_attention_nhd`, and the chunked VAE decode (288 latents, three
    chunks). Then an init-audio request and an inpainting request on the
    card return finite audio of the right shape."""
    from stable_audio_tools_tpu_torch.inference.generation import (
        generate_diffusion_cond, generate_diffusion_cond_inpaint)
    from stable_audio_tools_tpu_torch.ops.kernels.flash_attention import flash_attention_nhd

    cpu = tiny_sa2_model(clap_path).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(2)
    x, z = torch.randn(1, 16, 288, generator=g), torch.randn(1, 16, 288, generator=g)
    t = torch.tensor([0.5])
    negative = [dict(SA2_PROMPT[0], prompt="harsh distorted noise")]

    def denoise(m, d):
        cond = m.get_conditioning_inputs(m.conditioner(SA2_PROMPT, d))
        cond.update(m.get_conditioning_inputs(m.conditioner(negative, d), negative=True))
        return m(x.to(d), t.to(d), cfg_scale=6.0, **cond)

    errs = {}
    before = flash_attention_nhd.launches
    for name, run in (("conditioning", lambda m, d: m.conditioner(SA2_PROMPT, d)["prompt"][0]),
                      ("denoiser", denoise),
                      ("decode", lambda m, d: m.pretransform.decode(z.to(d)))):
        want, got = run(cpu, "cpu").float(), run(gpu, dev).float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"small SA-2.0 {name}: non-finite output on the card")
        errs[name] = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-6)
    if flash_attention_nhd.launches - before != 2:  # one per DiT layer
        raise AssertionError("small SA-2.0 denoiser: the card did not take flash_attention_nhd")

    size = 288 * 32
    init = (44100, 0.3 * torch.randn(2, size, generator=g))
    kw = dict(steps=4, cfg_scale=6.0, conditioning=SA2_PROMPT, sample_size=size, seed=3)
    audio = generate_diffusion_cond(gpu, init_audio=init, init_noise_level=5.0, **kw)
    inpaint = copy.deepcopy(tiny_sa2_model(clap_path, "diffusion_cond_inpaint").eval()).to(dev)
    painted = generate_diffusion_cond_inpaint(
        inpaint, init_audio=init, mask_args={"maskstart": size // 4, "maskend": size // 2,
                                             "softnessL": 0.02, "softnessR": 0.02}, **kw)
    for name, a in (("init_audio", audio), ("inpaint", painted)):
        if tuple(a.shape) != (1, 2, size) or not torch.isfinite(a).all():
            raise AssertionError(f"small SA-2.0 {name} request: audio {tuple(a.shape)} "
                                 f"finite={bool(torch.isfinite(a).all())}")
    return errs


def phase_sa2(dev) -> dict:
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.roberta import RobertaArch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sa2_") as tmp:
        small_clap = os.path.join(tmp, "clap_small.pt")
        write_clap_checkpoint(small_clap, RobertaArch(vocab_size=32002, hidden_size=64,
                                                      num_layers=2, num_heads=1,
                                                      intermediate_size=128, max_positions=80))
        small, small_tol = small_sa2_check(dev, small_clap), 0.05
        if max(small.values()) > small_tol:
            raise AssertionError(f"small SA-2.0-shaped model: card vs CPU relative errors "
                                 f"{small} > {small_tol}")

        # full width: SA-2.0 from the shipped config, its CLAP tower read from a file
        clap_path = os.path.join(tmp, "clap.pt")
        t0 = time.perf_counter()
        write_clap_checkpoint(clap_path)
        model = create_model_from_config(sa2_config(clap_path), dev)
        clap = model.conditioner.conditioners["prompt"]
        init_random_(model, torch.Generator(device=dev).manual_seed(0),
                     skip=[clap.model, clap.text_projection]).eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        saved = torch.load(clap_path, weights_only=True)["state_dict"]
        name = "encoder.layer.11.output.dense.weight"
        if not torch.equal(clap.model.state_dict()[name].cpu(), saved[f"module.text_branch.{name}"]):
            raise AssertionError("SA-2.0: the CLAP tower does not hold the checkpoint's weights")
    if next(model.parameters()).device.type != "cuda":
        raise AssertionError("SA-2.0: the factory did not build the model on the card")
    n_params = sum(p.numel() for p in model.parameters())
    run = lambda steps, seed: generate_diffusion_cond(
        model, steps=steps, cfg_scale=6.0, conditioning=SA2_PROMPT, batch_size=1,
        sample_size=SA2_SAMPLE_SIZE, seed=seed, sampler_type="dpmpp-3m-sde",
        sigma_min=0.3, sigma_max=500.0)
    run(2, 0)  # warm-up: cuDNN plans at the full shapes
    torch.cuda.synchronize()
    kernels = {n: fn for n, fn in counters().items()
               if n in SA2_KERNELS or n in ("flash_attention_prefix", "flash_attention_fused_qkv")}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    audio = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    if tuple(audio.shape) != (1, 2, SA2_SAMPLE_SIZE) or not torch.isfinite(audio).all():
        raise AssertionError(f"SA-2.0 audio {tuple(audio.shape)} "
                             f"finite={bool(torch.isfinite(audio).all())}")
    idle = [n for n in SA2_KERNELS if launches[n] == 0]
    if (idle or launches["flash_attention_nhd"] != 24 * STEPS or launches["flash_attention_prefix"]
            or launches["flash_attention_fused_qkv"]):
        raise AssertionError(f"SA-2.0 launches {launches}: expected {24 * STEPS} of "
                             f"flash_attention_nhd, none of flash_attention_prefix or "
                             f"flash_attention_fused_qkv (training's route), and some of every "
                             f"other kernel (idle: {idle})")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del audio
    return dict(wall_s=wall, steps=STEPS, audio_s=SA2_SAMPLE_SIZE / 44100.0,
                audio_s_per_s=SA2_SAMPLE_SIZE / 44100.0 / wall, launches=launches,
                params=n_params, build_s=build_s, small=small, small_tol=small_tol,
                peak_gib=peak_gib,
                breakdown=stage_breakdown(model, dev, SA2_PROMPT, SA2_SAMPLE_SIZE))


SA2_VAE = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "autoencoders", "stable_audio_2_0_vae.json")
# generator + discriminator pairs of the GAN phases (6, 13, 14): warm-up
# and timed
GAN_WARM_PAIRS, GAN_TIMED_PAIRS = 2, 5
# kernel launches of one generator and one discriminator step of the SA-2.0
# VAE, counted from the model: 5 encoder and 5 decoder blocks; 3 residual
# units each (a k = 7 snake-conv, a k = 1 one with the residual); the
# encoder's and the decoder's conv_out (snake-conv), conv_in (plain conv);
# a snake before each strided and transposed conv. The discriminator step
# runs the autoencoder forward under no_grad, so its forward kernels only.
AE_GEN_LAUNCHES = {"snake_conv1d": 32, "snake_conv1d_res": 30, "snake_fused": 10,
                   "snake_conv1d_dx": 62, "snake_conv1d_wgrad": 62, "conv1d_wgrad": 2,
                   "snake_fused_bwd": 10}
AE_DISC_LAUNCHES = {"snake_conv1d": 32, "snake_conv1d_res": 30, "snake_fused": 10}
AE_KERNELS = tuple(AE_GEN_LAUNCHES)


def sa2_vae_config():
    with open(SA2_VAE) as f:
        return json.load(f)


def tiny_ae_config(compute_dtype: str = "bfloat16") -> dict:
    """The SA-2.0 VAE config at toy size: the same blocks, losses and
    kernels (snake-convs at k 7 / 1 / 3, the plain conv_in), channels 32,
    c_mults [1, 2], strides [2, 4], latent 8, a discriminator of 8 filters
    over two STFT scales, three MRSTFT resolutions, `compute_dtype`."""
    cfg = sa2_vae_config()
    cfg["sample_size"] = 4096
    m = cfg["model"]
    m["encoder"]["config"].update(channels=32, c_mults=[1, 2], strides=[2, 4], latent_dim=16)
    m["decoder"]["config"].update(channels=32, c_mults=[1, 2], strides=[2, 4], latent_dim=8)
    m.update(latent_dim=8, downsampling_ratio=8)
    cfg["training"]["compute_dtype"] = compute_dtype
    losses = cfg["training"]["loss_configs"]
    losses["discriminator"]["config"] = dict(filters=8, n_ffts=[256, 128], hop_lengths=[64, 32],
                                             win_lengths=[256, 128])
    losses["spectral"]["config"].update(fft_sizes=[256, 64, 32], hop_sizes=[64, 16, 8],
                                        win_lengths=[256, 64, 32])
    return cfg


# the weight-norm gains of the tiny card-vs-CPU GAN checks are scaled by
# this after the random init (see `small_gan_check`)
SMALL_AE_GAIN = 0.3
# at the init's own gains, the card's bf16 gradient of a tiny GAN step may
# lie at most this many times as far from the CPU's f32 one as the CPU's
# bf16 one does
GAN_SPREAD = 2.0


def tiny_gan_trainer(cfg: dict, dev, disc: dict | None = None, gain: float = 1.0):
    """`cfg`'s trainer on `dev`, its weights made on the CPU from seed 1, the
    weight-norm gains times `gain` (the discriminator's weights from `disc`
    where given, else its own seeded init)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    model = init_random_(create_model_from_config(copy.deepcopy(cfg), "cpu"),
                         torch.Generator().manual_seed(1))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("weight_g"):
                p.mul_(gain)
    w = create_training_wrapper_from_config(copy.deepcopy(cfg), model.to(dev))
    if disc is not None:
        w.discriminator.load_state_dict(disc)
    return w


def tiny_gan_batch(cfg: dict):
    """A tiny GAN check's audio [2, C, sample_size] (std 0.3) and the VAE
    noise of its two steps [2, latent_dim, sample_size / ratio], seed 2."""
    g = torch.Generator().manual_seed(2)
    m = cfg["model"]
    audio = 0.3 * torch.randn(2, cfg["audio_channels"], cfg["sample_size"], generator=g)
    shape = (2, m["latent_dim"], cfg["sample_size"] // m["downsampling_ratio"])
    return audio, [torch.randn(*shape, generator=g) for _ in range(2)]


def grad_rel_errs(got: dict, want: dict) -> tuple:
    """||got - want|| / ||want|| of each parameter's gradient: (the worst
    tensor's name, its error, the error of all of them together)."""
    diff = norm = 0.0
    per_tensor = {}
    for n, p in want.items():
        q = got[n].grad
        if q is None or not torch.isfinite(q).all():
            raise AssertionError(f"{n} has no finite gradient")
        d = (q.float().cpu() - p.grad.cpu()).square().sum().item()
        n2 = p.grad.square().sum().item()
        diff, norm = diff + d, norm + n2
        per_tensor[n] = math.sqrt(d / n2) if n2 > 0 else (0.0 if d == 0 else math.inf)
    worst = max(per_tensor, key=per_tensor.get)
    return worst, per_tensor[worst], math.sqrt(diff / norm)


def small_gan_check(dev, make_cfg) -> dict:
    """One generator and one discriminator step of a tiny VAE-GAN
    (`make_cfg(compute_dtype)`) with the kernels on the card against the
    plain versions on the CPU: the same weights, batch and VAE noise on
    every side, under `torch.use_deterministic_algorithms(True,
    warn_only=True)`. Returns the largest relative error of each step's
    named losses and of its side's gradient, ||card - CPU|| / ||CPU||: for
    the generator (whose backward runs the kernels) the worst single
    parameter tensor, for the discriminator (cuDNN and autograd only) all
    its parameters together, since its last biases' gradients are sums
    whose terms cancel (39% apart per tensor between bf16 and f32 on the
    CPU, 1.3% over the whole side, at the SA-2.0 VAE's tiny twin).

    For that comparison the weight-norm gains are scaled by SMALL_AE_GAIN
    after the random init: at the init's own scale the stack amplifies
    audio of std 0.3 to a decoded std of 26, where bf16 cannot resolve the
    snake's period (spacing 0.125 at |x| ~ 26 against sin(alpha x)), and two
    bf16 runs that round in other places give generator gradients as far
    apart as their size; at 0.3 bf16 stays within 1.2% of f32 per tensor
    (both readings are
    tests/test_torch_ae_training.py::test_tiny_ae_check_needs_the_reduced_gain).
    So the init's scale is read as well, against the CPU's f32 steps: each
    side's bf16 gradient on the card must lie no farther than GAN_SPREAD
    times the CPU's bf16 one from it, over the whole side. The kernels'
    snake terms at full swing are held in phase 2 (x of std 2)."""
    cfg = make_cfg("bfloat16")
    audio, noises = tiny_gan_batch(cfg)
    pick = {"gen": lambda w: w.params, "disc": lambda w: w.disc_params}
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cpu = tiny_gan_trainer(cfg, "cpu", gain=SMALL_AE_GAIN)
        card = tiny_gan_trainer(cfg, dev, cpu.discriminator.state_dict(), gain=SMALL_AE_GAIN)
        for side, noise in zip(("gen", "disc"), noises):
            ac, ag = (w.train_step(audio.to(w.device), noise=noise.to(w.device))
                      for w in (cpu, card))
            if not all(math.isfinite(float(v)) for v in ag.values()):
                raise AssertionError(f"small GAN {side} step: losses {ag}")
            out[f"{side}_loss_rel_err"] = max(
                abs(float(ag[k]) - float(v)) / max(abs(float(v)), 1e-6) for k, v in ac.items())
            worst, worst_err, whole = grad_rel_errs(pick[side](card), pick[side](cpu))
            out[f"{side}_worst_tensor"] = [worst, worst_err]
            out[f"{side}_grad_rel_err"] = worst_err if side == "gen" else whole

        ref = tiny_gan_trainer(make_cfg("float32"), "cpu")
        disc = ref.discriminator.state_dict()
        cpu16 = tiny_gan_trainer(cfg, "cpu", disc)
        card = tiny_gan_trainer(cfg, dev, disc)
        for side, noise in zip(("gen", "disc"), noises):
            for w in (ref, cpu16, card):
                w.train_step(audio.to(w.device), noise=noise.to(w.device))
            spreads = [grad_rel_errs(pick[side](w), pick[side](ref)) for w in (cpu16, card)]
            out[f"{side}_init_scale"] = dict(cpu_bf16_vs_f32=spreads[0],
                                             card_vs_cpu_f32=spreads[1])
            if not spreads[1][2] <= GAN_SPREAD * spreads[0][2]:
                raise AssertionError(f"small GAN {side} step at the init's gains: the card's "
                                     f"gradient is {spreads[1][2]:.3g} from the CPU's f32 one, "
                                     f"more than {GAN_SPREAD} x the CPU's bf16 "
                                     f"{spreads[0][2]:.3g}")
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def gen_step_split(trainer, loader) -> dict:
    """One generator step of the trainer in its pieces, read from the step
    itself (`AutoencoderTrainer.gen_split`: host clock, the card
    synchronised at each boundary): the autoencoder forward, the
    discriminator (its loss() on reals and fakes), the losses (MRSTFT with
    the A-weighting FIR, KL, their sum with the GAN terms), backward,
    optimizer (clip, AdamW, LR schedule), EMA; beside it the data (the next
    batch of a running loader, to the card). Then torch.profiler over the
    next whole generator step: device-busy share and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w = trainer.wrapper
    batches = iter(loader)
    next(batches)  # starts the workers
    t0 = time.perf_counter()
    audio = trainer.prepare_batch(next(batches)[0])
    torch.cuda.synchronize()
    out = {"data_ms": (time.perf_counter() - t0) * 1e3}
    while w.uses_disc(w.step):
        w.train_step(audio)
    w.gen_split = {}
    t0 = time.perf_counter()
    w.train_step(audio)
    torch.cuda.synchronize()
    out.update(w.gen_split, step_ms=(time.perf_counter() - t0) * 1e3)
    w.gen_split = None
    while w.uses_disc(w.step):
        w.train_step(audio)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w.train_step(audio)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    out["gen_step_profiled_ms"] = wall_us / 1e3
    out["gen_step_device_busy"] = busy_us / wall_us
    out["gen_step_top_kernels_ms"] = {
        e.key[:60]: round(e.self_device_time_total / 1e3, 3)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]}
    # rows 10 and 11, each instance by name
    out["gen_step_snake_conv_bwd_ms"] = {
        e.key[:70]: round(e.self_device_time_total / 1e3, 3) for e in kernels
        if "conv1d_wgrad_kernel" in e.key or "snake_conv1d_dx_kernel" in e.key}
    return out


def resume_check(trainer, loader, path: str, steps: int) -> dict:
    """The checkpoint at `path` read back into a model built on `meta`
    (every tensor identical, the step, the EMA's names), then restored into
    the trainer, which trains `steps` more steps from it with finite
    losses."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    w = trainer.wrapper
    t0 = time.perf_counter()
    state = torch.load(path, map_location="cpu", weights_only=True)
    fresh = create_model_from_config(state["model_config"], "meta")
    fresh.load_state_dict(state["state_dict"], strict=True, assign=True)
    current = w.model.state_dict()
    differ = [n for n, v in fresh.state_dict().items() if not torch.equal(v, current[n].cpu())]
    if getattr(w, "discriminator", None) is not None:
        disc = w.discriminator.state_dict()
        differ += [n for n, v in state["discriminator"].items()
                   if not torch.equal(v, disc[n].cpu())]
    if differ or state["step"] != w.step or set(state["ema"]) != set(w.ema):
        raise AssertionError(f"checkpoint {path}: {len(differ)} tensors differ ({differ[:5]}), "
                             f"step {state['step']} vs {w.step}")
    del state, fresh
    reload_s = time.perf_counter() - t0
    step = w.step
    trainer.restore(path)
    trainer.fit(loader, max_steps=step + steps, save_at_end=False)
    resumed = [h for h in trainer.history if h["step"] > step]
    if w.step != step + steps or len(resumed) != steps or not all(
            math.isfinite(v) for h in resumed for v in h.values()):
        raise AssertionError(f"resumed from {path}: step {w.step}, log {resumed}")
    return dict(reload_s=reload_s, resumed_steps=steps)


def gan_training(dev, cfg: dict, tmp: str, dataset: str, gen_launches: dict,
                 disc_launches: dict) -> dict:
    """A shipped autoencoder GAN config at full width, batch AE_BATCH,
    through `train.build` and `Trainer.fit`: GAN_WARM_PAIRS + GAN_TIMED_PAIRS generator +
    discriminator pairs, finite losses, every parameter of each side with a
    finite nonzero gradient in its first step, parameters and EMA moved,
    the kernels launched exactly as given a pair, the pair and step times,
    one generator step's pieces and its profile (`gen_step_split`), a
    checkpoint and a resumed pair (`resume_check`)."""
    from stable_audio_tools_tpu_torch import train

    cfg_path = os.path.join(tmp, "model.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    n_steps = 2 * (GAN_WARM_PAIRS + GAN_TIMED_PAIRS)
    args = train.parse_args([
        "--model-config", cfg_path, "--dataset-config", dataset, "--batch-size", str(AE_BATCH),
        "--num-workers", "4", "--seed", "0", "--max-steps", str(n_steps),
        "--checkpoint-every", "0", "--save-dir", os.path.join(tmp, "run")])
    rec = {}
    t0 = time.perf_counter()
    trainer, loader = train.build(args, device=dev)
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    w = trainer.wrapper
    if (w.compute_dtype != torch.bfloat16
            or next(w.model.parameters()).device.type != torch.device(dev).type):
        raise AssertionError("GAN training: not built on the card with bf16 compute")
    before = {n: p.detach().clone() for n, p in w.params.items()}
    disc_before = {n: p.detach().clone() for n, p in w.disc_params.items()}
    for step, params in ((1, w.params), (2, w.disc_params)):
        trainer.fit(loader, max_steps=step, save_at_end=False)
        # a scale's last bias may take an exact 0: the hinge's +-1/N over
        # reals and fakes cancel where no output passes +-1 (a fresh
        # discriminator's outputs are small)
        bad = [n for n, p in params.items()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or not (p.grad.abs().max() > 0 or n.endswith("conv_post.bias"))]
        if bad:
            raise AssertionError(f"after step {step}, {len(bad)} parameters have no finite "
                                 f"nonzero gradient: {bad[:8]}")
    trainer.fit(loader, max_steps=2 * GAN_WARM_PAIRS, save_at_end=False)
    torch.cuda.synchronize()
    kernels = {n: fn for n, fn in counters().items() if n in AE_KERNELS}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(loader, max_steps=n_steps, save_at_end=False)
    torch.cuda.synchronize()
    rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {n: GAN_TIMED_PAIRS * (gen_launches.get(n, 0) + disc_launches.get(n, 0))
            for n in AE_KERNELS}
    if rec["launches"] != want:
        raise AssertionError(f"GAN training launches {rec['launches']}, expected {want}")
    hist = trainer.history
    if len(hist) != n_steps or not all(math.isfinite(v) for h in hist for v in h.values()):
        raise AssertionError(f"GAN training log: {hist}")
    walls = [1e3 / h["train/steps_per_sec"] for h in hist[2 * GAN_WARM_PAIRS:]]
    pairs = [walls[i] + walls[i + 1] for i in range(0, len(walls), 2)]
    unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
    unmoved += [n for n, p in w.disc_params.items() if torch.equal(p.detach(), disc_before[n])
                and not n.endswith("conv_post.bias")]  # zero-initialised, maybe no gradient
    ema_unmoved = [n for n, e in w.ema.items() if torch.equal(e, before[n])]
    if unmoved or ema_unmoved:
        raise AssertionError(f"parameters that did not move: {unmoved[:8]}; "
                             f"EMA entries that did not move: {ema_unmoved[:8]}")
    del before, disc_before
    losses = {k: [h[k] for h in hist if k in h]
              for k in sorted({k for h in hist for k in h if k.startswith("train/")})}
    pair_ms = statistics.median(pairs)
    rec.update(
        pair_ms=pairs, pair_ms_median=pair_ms, gen_ms_median=statistics.median(walls[0::2]),
        disc_ms_median=statistics.median(walls[1::2]),
        audio_s_per_s=AE_BATCH * cfg["sample_size"] / cfg["sample_rate"] / (pair_ms / 1e3),
        gen_losses={k: v for k, v in losses.items() if k in (
            "train/loss", "train/mrstft_loss", "train/kl_loss", "train/quantizer_loss",
            "train/loss_adv", "train/feature_matching_loss")},
        disc_losses=losses.get("train/discriminator_loss"),
        params=sum(p.numel() for p in w.params.values()),
        disc_params=sum(p.numel() for p in w.disc_params.values()))
    rec["split"] = gen_step_split(trainer, loader)
    t0 = time.perf_counter()
    path = trainer.save(w.step)
    rec["save_s"] = time.perf_counter() - t0
    rec["ckpt_gib"] = os.path.getsize(path) / 2 ** 30
    rec.update(resume_check(trainer, loader, path, 2))
    return rec


def gan_phase(dev, cfg: dict, make_tiny, counts: dict) -> dict:
    """A VAE-GAN's phase: `small_gan_check` of its tiny twin
    (`make_tiny(compute_dtype)`, within 5%), then `gan_training` of the
    shipped `cfg` on 40 synthetic WAVs of 3-7 s, its launches a pair
    `counts` ({"gen": ..., "disc": ...})."""
    small = small_gan_check(dev, make_tiny)
    small_tol = 0.05
    if not max(v for k, v in small.items() if k.endswith("_rel_err")) <= small_tol:
        raise AssertionError(f"small GAN steps card vs CPU: {small} > {small_tol}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp:
        data = write_dataset(tmp, 40, 3, 0.1, sr=cfg["sample_rate"],
                             channels=cfg["audio_channels"])
        rec = gan_training(dev, cfg, tmp, data, counts["gen"], counts["disc"])
    rec.update(small=small, small_tol=small_tol, counts=counts)
    return rec


def phase_ae_training(dev) -> dict:
    """Phase 6: `gan_phase` of the shipped SA-2.0 VAE, its launches
    AE_GEN_LAUNCHES / AE_DISC_LAUNCHES."""
    return gan_phase(dev, sa2_vae_config(), tiny_ae_config,
                     dict(gen=AE_GEN_LAUNCHES, disc=AE_DISC_LAUNCHES))


LM_CONFIG = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs", "lm",
                         "musicgen_small_rvq.json")
LM_SR, LM_SAMPLES, LM_FRAMES = 32000, 320000, 500  # 10 s at hop 640
LM_PROMPT = [{"prompt": "A cheerful pop tune with bright synths and a steady beat"}]
# the defaults of scripts/bench_lm_decode.py
LM_CFG, LM_TOP_K = 3.0, 250
LM_BATCH, LM_WARM_STEPS, LM_TIMED_STEPS = 4, 2, 5


def lm_config():
    with open(LM_CONFIG) as f:
        cfg = json.load(f)
    for c in cfg["model"]["conditioning"]["configs"]:
        if c["type"] == "t5":
            c["config"]["allow_random_init"] = True
    return cfg


def tiny_lm():
    """MusicGen's shape at toy size, seeded random weights: the same codec
    kinds (SEANet with LSTMs, RVQ of 4 codebooks), pattern, causal backbone
    with heads of 64 in bf16 and T5 conditioning; its T5 computes in f32 and
    tokenizes with CRC-32 (see tiny_model)."""
    import zlib

    from stable_audio_tools_tpu_torch.models.conditioners import FallbackTokenizer
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    cfg = lm_config()
    m = cfg["model"]
    m["conditioning"]["configs"][0]["config"].update(max_length=16,
                                                     arch=[64, 128, 2, 2, 32, False])
    m["conditioning"]["cond_dim"] = 64
    ae = m["pretransform"]["config"]
    for side, ratios in (("encoder", [2, 4]), ("decoder", [4, 2])):
        ae[side]["config"].update(n_filters=8, dimension=32, ratios=ratios)
    ae["bottleneck"]["config"].update(dim=32, codebook_size=64)
    ae.update(latent_dim=32, downsampling_ratio=8)
    m["lm"]["config"].update(embed_dim=128, depth=2, num_heads=2, cross_attn_cond_dim=64)
    cfg["sample_size"] = 8 * 32
    model = init_random_(create_model_from_config(cfg, "cpu"), torch.Generator().manual_seed(4))
    t5 = model.conditioner.conditioners["prompt"]
    t5.model.compute_dtype = torch.float32
    t5.tokenizer = FallbackTokenizer(16, word_hash=lambda w: zlib.crc32(w.encode("utf-8")))
    return cfg, model


@torch.inference_mode()
def cached_logits(model, seq, cond):
    """Teacher-forced logits [B, K, S, card] of the KV-cached decode step (the
    pieces `lm_generate_cached` runs: summed embeddings, the backbone's
    cached step over per-layer caches with the cross-attention K/V
    projected once, the heads), fed the pattern sequence `seq` [B, K, S]."""
    from stable_audio_tools_tpu_torch.ops.attention import init_kv_cache

    lm, bb = model.lm, model.lm.backbone
    kvs = bb.compute_cross_kv(model.get_conditioning_inputs(cond)["cross_attn_cond"])
    caches = [init_kv_cache(seq.shape[0], bb.num_heads, seq.shape[2],
                            bb.embed_dim // bb.num_heads, bb.compute_dtype, seq.device)
              for _ in range(bb.depth)]
    out = []
    for s in range(seq.shape[2]):
        x = sum(e(seq[:, i, s]) for i, e in enumerate(lm.embeds))[:, None]
        h = bb(x, caches=caches, cache_index=s, cross_kvs=kvs)[:, 0]
        out.append(torch.stack([head(h) for head in lm.quantizer_heads], 1))
    return torch.stack(out, 2).float()


def small_lm_generation_check(dev) -> dict:
    """The tiny LM's teacher-forced logits, card (kernels) against CPU (plain
    versions): the KV-cached decode over a 27-step pattern sequence and the
    full forward (`flash_attention` on the card), bf16, the same codes and
    prompt; max|card - CPU| / max|CPU| of each."""
    _, cpu = tiny_lm()
    cpu.eval()
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(0, 64, (2, 4, 24), generator=g)
    seq = cpu.pattern_provider.get_pattern(24).build_pattern_sequence(codes, 64)[0]
    out = {}
    for name, run in (("cached", lambda m, d, c: cached_logits(m, seq.to(d), c)),
                      ("full", lambda m, d, c: m(seq.to(d), cond_tensors=c).float())):
        with torch.inference_mode():
            want = run(cpu, "cpu", cpu.conditioner(LM_PROMPT * 2, "cpu"))
            got = run(gpu, dev, gpu.conditioner(LM_PROMPT * 2, dev)).cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"small LM {name} logits: non-finite on the card")
        out[f"{name}_rel_err"] = ((got - want).abs().max() / want.abs().max()).item()
    return out


# CUDA runtime calls that the profiler records on the host: the launches,
# and the copies and waits that make the host stop for the device
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaMemsetAsync", "cudaFuncSetAttribute")


def profile_reading(events, wall_us: float, steps: int = 1) -> dict:
    """One profiled window read per step from its `key_averages()`: device
    time (kernels, copies and fills), kernels launched, the count and host
    time of each CUDA runtime call in RUNTIME_CALLS, the device-busy share of
    the window's wall, the largest kernels and the host ops with the most
    self time."""
    from torch.autograd import DeviceType

    # a scheduled profile also puts each step's span on the device timeline
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    kernels = [e for e in device if not e.key.startswith(("Memcpy", "Memset"))]
    device_us = sum(e.self_device_time_total for e in device)
    runtime = {e.key: dict(count=e.count / steps, host_ms=e.self_cpu_time_total / steps / 1e3)
               for e in events if e.key in RUNTIME_CALLS}
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    return dict(
        wall_ms=wall_us / steps / 1e3, device_ms=device_us / steps / 1e3,
        device_busy=device_us / wall_us, kernel_launches=sum(e.count for e in kernels) / steps,
        runtime_calls=runtime,
        top_kernels_ms={e.key[:60]: round(e.self_device_time_total / steps / 1e3, 4)
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]},
        top_host_ops_ms={e.key: round(e.self_cpu_time_total / steps / 1e3, 4)
                         for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]})


# decode steps run before the profiled window of a generation request, and
# the steps in it
LM_PROFILE_WAIT, LM_PROFILE_STEPS = 20, 10


class _ProfileDone(Exception):
    """Ends a profiled generation request once its window is recorded."""


def lm_decode_profile(model, generate) -> dict:
    """torch.profiler over LM_PROFILE_STEPS decode steps of a full-size
    request, after LM_PROFILE_WAIT unrecorded ones: `generate()` runs the
    request, and a hook at each call of the backbone (one per step, on
    either path) marks the step boundaries and ends the request once the
    window is read. The window covers whole steps: backbone, heads, CFG and
    the sampler."""
    from torch.profiler import ProfilerActivity, profile, schedule

    marks, readings = [], []
    # profiler step s + 1 starts at the hook of decode step s: the recorded
    # steps are decode steps first .. last - 1, between their hooks' marks
    first, last = LM_PROFILE_WAIT, LM_PROFILE_WAIT + LM_PROFILE_STEPS

    def hook(*_):
        marks.append(time.perf_counter())
        prof.step()
        if readings:
            raise _ProfileDone

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=first, warmup=1, active=LM_PROFILE_STEPS, repeat=1),
                 on_trace_ready=lambda p: readings.append(p.key_averages())) as prof:
        handle = model.lm.backbone.register_forward_pre_hook(hook)
        try:
            generate()
        except _ProfileDone:
            pass
        finally:
            handle.remove()
    if len(marks) != last + 1 or len(readings) != 1:
        raise AssertionError(f"LM decode profile: {len(marks)} steps marked, "
                             f"{len(readings)} windows read")
    return profile_reading(readings[0], (marks[last] - marks[first]) * 1e6, LM_PROFILE_STEPS)


def phase_lm_generation(dev) -> dict:
    """Phase 7: the tiny card-vs-CPU check, then the shipped MusicGen-small
    config at full width (seeded random weights) generating 10 s from a
    prompt with `lm_generate_audio`: KV-cached (the default), then the full
    forward at every step (`use_cache=False`)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.lm import lm_generate_audio

    small = small_lm_generation_check(dev)
    small_tol = 0.05
    if not max(small.values()) <= small_tol:
        raise AssertionError(f"small LM card vs CPU: {small} > {small_tol}")
    t0 = time.perf_counter()
    model = create_model_from_config(lm_config(), dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()
    torch.cuda.synchronize()
    rec = dict(small=small, small_tol=small_tol, build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()))
    cond = model.conditioner(LM_PROMPT, dev)
    gen = lambda frames, seed, cache=True: lm_generate_audio(
        model, cond, use_cache=cache, max_gen_len=frames, batch_size=1, cfg_scale=LM_CFG,
        top_k=LM_TOP_K, generator=torch.Generator(device=dev).manual_seed(seed))
    gen(8, 0)  # warm-up: cuDNN plans
    gen(8, 0, cache=False)
    S = model.pattern_provider.get_pattern(LM_FRAMES).S
    depth = model.lm.backbone.depth
    names = ("flash_attention", "flash_attention_nhd", "flash_attention_prefix",
             "fused_layer_norm")
    kernels = {n: fn for n, fn in counters().items() if n in names}
    for cache in (True, False):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        audio = gen(LM_FRAMES, 1, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        if tuple(audio.shape) != (1, 1, LM_SAMPLES) or not torch.isfinite(audio).all():
            raise AssertionError(f"LM audio {tuple(audio.shape)} "
                                 f"finite={bool(torch.isfinite(audio).all())}")
        # pinned from the model: every step runs 3 norms a block; the full
        # forward's causal self-attention launches the kernel once a block
        # a step, the cached step none
        want = {"flash_attention": 0 if cache else depth * (S - 1), "flash_attention_nhd": 0,
                "flash_attention_prefix": 0, "fused_layer_norm": 3 * depth * (S - 1)}
        if launches != want:
            raise AssertionError(f"LM generation (cache={cache}) launches {launches}, "
                                 f"expected {want}")
        rec["cached" if cache else "full"] = dict(
            wall_s=wall, steps=S - 1, ms_per_step=wall / (S - 1) * 1e3,
            audio_s_per_s=LM_SAMPLES / LM_SR / wall,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=launches,
            profile=lm_decode_profile(model, lambda: gen(LM_FRAMES, 1, cache)))
    # the codec's decode of 500 frames alone (random codes), host clock
    # around synchronised work; the rest of a request's wall is the tokens
    codes = torch.randint(0, model.codebook_size, (1, model.num_quantizers, LM_FRAMES),
                          generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    model.pretransform_decode_tokens(codes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.pretransform_decode_tokens(codes)
    torch.cuda.synchronize()
    rec["decode_ms"] = (time.perf_counter() - t0) * 1e3
    return rec


def small_lm_train_check(dev) -> dict:
    """One training step of the tiny LM (bf16 backbone with block
    rematerialisation, AdamW), kernels on the card against plain versions on
    the CPU, on the same codes (the codec's f32 convs run in TF32 on the
    card, and one flipped RVQ code would change the targets) and prompts:
    the loss's relative error and the largest max|card - CPU| / max|CPU|
    over the LM's gradients."""
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    cfg, cpu = tiny_lm()
    gpu = copy.deepcopy(cpu).to(dev)
    audio = 0.3 * torch.randn(2, 1, 8 * 32, generator=torch.Generator().manual_seed(6))
    codes = cpu.pretransform_tokenize(audio)
    meta = [LM_PROMPT[0], {"prompt": "rain on a window"}]
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        w = create_training_wrapper_from_config(cfg, model)
        w.pre_tokenized = True
        out[name] = (float(w.train_step(codes.to(d), meta)["loss"]), w)
    (lc, wc), (lg, wg) = out["cpu"], out["card"]
    errs = {}
    for n, p in wc.params.items():
        gg = wg.params[n].grad
        if gg is None or not torch.isfinite(gg).all():
            raise AssertionError(f"small LM step: {n} has no finite gradient on the card")
        errs[n] = ((gg.float().cpu() - p.grad).abs().max() / p.grad.abs().max()).item()
    worst = max(errs, key=errs.get)
    return dict(loss_rel_err=abs(lg - lc) / abs(lc), grad_rel_err=errs[worst], worst_grad=worst)


def lm_step_split(trainer, loader) -> dict:
    """One LM training step in its pieces, host clock around synchronised
    work: data (the next batch of a fresh loader iterator), tokenize (the
    frozen codec), conditioning (T5), forward+backward, optimizer. Then
    torch.profiler over one forward+backward of the same batch."""
    from torch.profiler import ProfilerActivity, profile

    w = trainer.wrapper
    out, t = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out[f"{name}_ms"] = (t[-1] - t[-2]) * 1e3

    audio, meta = next(iter(loader))
    audio = trainer.prepare_batch(audio)
    lap("data")
    w.model.train()
    w.optimizer.zero_grad(set_to_none=True)
    codes = w.tokenize(audio)
    lap("tokenize")
    cond = w.condition(meta)
    lap("conditioning")
    loss, _ = w.loss(codes, cond)
    loss.backward()
    lap("forward_backward")
    w.optimizer_step()
    lap("optimizer")
    w.step += 1
    out["step_ms"] = (t[-1] - t[0]) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = w.loss(codes, cond)
        loss.backward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    w.optimizer.zero_grad(set_to_none=True)
    out["fwd_bwd_profiled_ms"] = wall_us / 1e3
    out["fwd_bwd_profile"] = profile_reading(prof.key_averages(), wall_us)
    return out


def phase_lm_training(dev) -> dict:
    """Phase 8: the tiny card-vs-CPU step, then the shipped MusicGen-small
    config at full width through `train.build` and `Trainer.fit`: batch 4 x
    320,000 samples of seeded synthetic mono 32 kHz WAVs with prompts, 2
    warm-up and 5 timed steps, the pieces of one step, a checkpoint and its
    reload."""
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    small = small_lm_train_check(dev)
    small_tol = 0.05
    if not (small["loss_rel_err"] <= small_tol and small["grad_rel_err"] <= small_tol):
        raise AssertionError(f"small LM step card vs CPU: {small} > {small_tol}")
    rec = dict(small=small, small_tol=small_tol)
    n_steps = LM_WARM_STEPS + LM_TIMED_STEPS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        cfg_path = os.path.join(tmp, "model.json")
        with open(cfg_path, "w") as f:
            json.dump(lm_config(), f)
        args = train.parse_args([
            # 16 mono clips of 12-19.5 s: an epoch of 4 batches
            "--model-config", cfg_path, "--dataset-config",
            write_dataset(tmp, 16, 12, 0.5, sr=LM_SR, channels=1),
            "--batch-size", str(LM_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(n_steps), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        t0 = time.perf_counter()
        trainer, loader = train.build(args, device=dev)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        w = trainer.wrapper
        bb = w.model.lm.backbone
        if bb.compute_dtype != torch.bfloat16 or w.device != dev:
            raise AssertionError(f"MusicGen-small: built on {w.device} with "
                                 f"{bb.compute_dtype} compute, not on {dev} in bf16")
        before = {n: p.detach().clone() for n, p in w.params.items()}
        trainer.fit(loader, max_steps=1, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        if bad:
            raise AssertionError(f"after step 1, {len(bad)} trainable parameters have no finite "
                                 f"nonzero gradient: {bad[:8]}")
        trainer.fit(loader, max_steps=LM_WARM_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        names = ("flash_attention", "flash_attention_prefix_bwd", "fused_layer_norm",
                 "flash_attention_nhd", "flash_attention_prefix")
        kernels = {n: fn for n, fn in counters().items() if n in names}
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader, max_steps=n_steps, save_at_end=False)
        torch.cuda.synchronize()
        rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # pinned from the model: a step runs each block's causal
        # self-attention forward twice (remat) and its backward once, and
        # its 3 norms twice; nothing takes the NHD or prefix entries
        d = bb.depth
        want = {"flash_attention": LM_TIMED_STEPS * 2 * d,
                "flash_attention_prefix_bwd": LM_TIMED_STEPS * d,
                "fused_layer_norm": LM_TIMED_STEPS * 2 * 3 * d,
                "flash_attention_nhd": 0, "flash_attention_prefix": 0}
        if rec["launches"] != want:
            raise AssertionError(f"LM training launches {rec['launches']}, expected {want}")
        hist = trainer.history
        if len(hist) != n_steps or not all(math.isfinite(v) for h in hist for v in h.values()):
            raise AssertionError(f"LM training log: {hist}")
        walls = [1e3 / h["train/steps_per_sec"] for h in hist[LM_WARM_STEPS:]]
        unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
        if unmoved:
            raise AssertionError(f"parameters that did not move: {unmoved[:8]}")
        del before
        trainable = sum(p.numel() for p in w.params.values())
        rec.update(
            losses=[h["train/loss"] for h in hist],
            ce=[[h[f"train/ce_q{i}"] for i in range(4)] for h in hist[-1:]][0],
            step_ms=walls, step_ms_median=statistics.median(walls),
            audio_s_per_s=LM_BATCH * LM_SAMPLES / LM_SR / (statistics.median(walls) / 1e3),
            trainable_params=trainable, params=sum(p.numel() for p in w.model.parameters()))
        rec["split"] = lm_step_split(trainer, loader)

        t0 = time.perf_counter()
        path = trainer.save(w.step)
        rec["save_s"] = time.perf_counter() - t0
        rec["ckpt_gib"] = os.path.getsize(path) / 2 ** 30
        state = torch.load(path, map_location="cpu", weights_only=True)
        fresh = create_model_from_config(state["model_config"], "meta")
        fresh.load_state_dict(state["state_dict"], strict=True, assign=True)
        current = w.model.state_dict()
        differ = [n for n, v in fresh.state_dict().items() if not torch.equal(v, current[n].cpu())]
        if differ or state["step"] != w.step:
            raise AssertionError(f"LM checkpoint reload: {len(differ)} tensors differ "
                                 f"({differ[:5]}), step {state['step']} vs {w.step}")
    return rec


SA2_TRAIN_BATCH = 4
SA2_LATENTS = SA2_SAMPLE_SIZE // 2048
# 8 clips of 290 to 300 s: longer than the 285.3 s crop, so the random crops
# (pre-encoding keeps the dataset's) give the clips' latents several
# `seconds_start` values
SA2_WAVS, SA2_WAV_SECONDS, SA2_WAV_STEP = 8, 290, 10 / 7
SA2_AUDIO_WARM, SA2_AUDIO_TIMED = 1, 2
# snake-conv launches of one Oobleck encoder pass, counted from the model:
# 3 residual units a level (5 levels), each with one k = 7 conv without the
# residual (row 12) and one k = 1 conv with it (row 3), and the conv_out (row 12)
ENCODE_LAUNCHES = {"snake_conv1d": 16, "snake_conv1d_res": 15}


def sa2_train_config(clap_path: str, pre_encoded: bool) -> dict:
    """The shipped SA-2.0 config, nothing cut (no chunked codec: training
    encodes whole clips), its CLAP checkpoint at `clap_path`, and the
    trainer's `pre_encoded` and `mask_padding` on."""
    with open(SA2) as f:
        cfg = json.load(f)
    for c in cfg["model"]["conditioning"]["configs"]:
        if c["type"] == "clap_text":
            c["config"]["clap_ckpt_path"] = clap_path
    cfg["training"].update(pre_encoded=pre_encoded, mask_padding=True)
    return cfg


def small_sa2_train_check(dev, clap_path: str) -> dict:
    """One training step of a tiny SA-2.0-shaped model (rotary self-attention
    on the fused-QKV entry, block remat, bf16 DiT, pre-encoded latents with a
    padding mask, AdamW + InverseLR, EMA) with the kernels on the card against
    the plain versions on the CPU: the same weights, latents, masks, t, noise
    and CFG-dropout mask. Returns the loss's relative error and the largest
    max|card - CPU| / max|CPU| over the DiT's gradients."""
    from stable_audio_tools_tpu_torch.ops.kernels.flash_attention import flash_attention_fused_qkv
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    cfg = sa2_train_config(clap_path, pre_encoded=True)
    cpu = tiny_sa2_model(clap_path)
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(4)
    B, T = 2, 288
    batch = dict(t=torch.rand(B, generator=g), noise=torch.randn(B, 16, T, generator=g),
                 cfg_dropout_mask=torch.tensor([False, True]))
    latents = torch.randn(B, 16, T, generator=g)
    meta = [dict(SA2_PROMPT[0], padding_mask=torch.arange(T).lt(200).float().numpy()),
            dict(SA2_PROMPT[0], seconds_start=7, padding_mask=torch.ones(T).numpy())]
    out = {}
    before = flash_attention_fused_qkv.launches
    for name, model, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        w = create_training_wrapper_from_config(cfg, model)
        aux = w.train_step(latents.to(d), meta, **{k: v.to(d) for k, v in batch.items()})
        out[name] = (float(aux["loss"]), w)
    if flash_attention_fused_qkv.launches - before != 2 * 2:  # 2 blocks, forward + recompute
        raise AssertionError("small SA-2.0 training step: the card did not take the fused entry")
    (lc, wc), (lg, wg) = out["cpu"], out["card"]
    if not (math.isfinite(lc) and math.isfinite(lg)):
        raise AssertionError(f"small SA-2.0 training step: loss cpu {lc} card {lg}")
    errs = {}
    for n, p in wc.params.items():
        if n.startswith("model.model."):
            gg = wg.params[n].grad
            if gg is None or not torch.isfinite(gg).all():
                raise AssertionError(f"small SA-2.0 training step: {n} has no finite gradient "
                                     "on the card")
            errs[n] = ((gg.float().cpu() - p.grad).abs().max() / p.grad.abs().max()).item()
    worst = max(errs, key=errs.get)
    return dict(loss_rel_err=abs(lg - lc) / abs(lc), grad_rel_err=errs[worst], worst_grad=worst)


def sa2_training_launches(model, steps: int) -> dict:
    """Kernel launches of `steps` SA-2.0 training steps from latents,
    counted from the model: every DiT block's self-attention takes the
    fused-QKV forward twice a step (the forward and the remat recompute) and
    row 6's backward once; the DiT's LayerNorms run twice inside the
    blocks, once outside; no snake kernel (the pretransform does not run) and
    no other attention entry."""
    from stable_audio_tools_tpu_torch.ops.norms import LayerNorm

    dit = model.model.model
    blocks = len(dit.transformer.layers)
    in_blocks = sum(isinstance(m, LayerNorm) for m in dit.transformer.layers.modules())
    outside = sum(isinstance(m, LayerNorm) for m in dit.modules()) - in_blocks
    zero = ("flash_attention", "flash_attention_prefix", "flash_attention_nhd", "snake_conv1d",
            "snake_conv1d_res", "snake_fused", "snake_fused_bwd", "snake_conv1d_dx",
            "snake_conv1d_wgrad", "conv1d_wgrad")
    return dict({n: 0 for n in zero}, flash_attention_fused_qkv=2 * blocks * steps,
                flash_attention_prefix_bwd=blocks * steps,
                fused_layer_norm=(2 * in_blocks + outside) * steps)


def encode_profile(dev, vae_ckpt: str) -> dict:
    """The pre-encode's encoder (the SA-2.0 VAE from `vae_ckpt`, bf16, no
    grad) on one seeded clip of SA2_SAMPLE_SIZE samples under the profiler
    after a warm-up: wall, device busy share and the largest kernels, so the
    share of the snake-conv forwards in an encode is read, not assumed."""
    from torch.profiler import ProfilerActivity, profile

    from stable_audio_tools_tpu_torch.io.checkpoints import load_model_state
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    with open(SA2_VAE) as f:
        model = create_model_from_config(json.load(f), dev)
    load_model_state(vae_ckpt, model)
    model.eval().requires_grad_(False)
    clip = (torch.randn(1, 2, SA2_SAMPLE_SIZE, generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev) * 0.3).to(torch.bfloat16)
    encode = lambda: model.encode(clip, generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        encode()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encode()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    out = profile_reading(prof.key_averages(), wall_us)
    return {k: out[k] for k in ("wall_ms", "device_ms", "device_busy", "kernel_launches",
                                "top_kernels_ms")}


def phase_sa2_training(dev) -> dict:
    """9a: pre-encode the WAVs with the SA-2.0 model's pretransform; 9b: train
    from the latents at batch 4 x 6144; 9c: train from audio at batch 1 x
    12,582,912 samples (the in-step encode)."""
    from stable_audio_tools_tpu_torch import pre_encode, train
    from stable_audio_tools_tpu_torch.data.dataset import create_dataloader_from_config
    from stable_audio_tools_tpu_torch.io.checkpoints import load_model_state, save_model_state
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.roberta import RobertaArch

    import numpy as np

    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sa2_train_") as tmp:
        small_clap = os.path.join(tmp, "clap_small.pt")
        write_clap_checkpoint(small_clap, RobertaArch(vocab_size=32002, hidden_size=64,
                                                      num_layers=2, num_heads=1,
                                                      intermediate_size=128, max_positions=80))
        small, small_tol = small_sa2_train_check(dev, small_clap), 0.05
        if not (small["loss_rel_err"] <= small_tol and small["grad_rel_err"] <= small_tol):
            raise AssertionError(f"small SA-2.0 training step card vs CPU: {small} > {small_tol}")
        rec.update(small=small, small_tol=small_tol)

        clap_path = os.path.join(tmp, "clap.pt")
        write_clap_checkpoint(clap_path)
        t0 = time.perf_counter()
        audio_cfg = write_dataset(tmp, SA2_WAVS, SA2_WAV_SECONDS, SA2_WAV_STEP)
        rec["write_wavs_s"] = time.perf_counter() - t0

        # 9a: the SA-2.0 model's pretransform saved as a port checkpoint, then
        # `python -m stable_audio_tools_tpu_torch.pre_encode` over the WAVs
        model = create_model_from_config(sa2_train_config(clap_path, True), dev)
        clap = model.conditioner.conditioners["prompt"]
        init_random_(model, torch.Generator(device=dev).manual_seed(0),
                     skip=[clap.model, clap.text_projection])
        vae_ckpt = os.path.join(tmp, "vae.ckpt")
        with open(SA2_VAE) as f:
            save_model_state(vae_ckpt, model.pretransform.model, json.load(f))
        del model, clap
        torch.cuda.empty_cache()
        with open(audio_cfg) as f:
            data = json.load(f)
        latent_dir = os.path.join(tmp, "latents")
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        enc = pre_encode.main(["--model-config", SA2_VAE, "--ckpt-path", vae_ckpt,
                               "--dataset-config", audio_cfg, "--output-path", latent_dir,
                               "--batch-size", "1", "--sample-size", str(SA2_SAMPLE_SIZE),
                               "--num-workers", "2"])
        wall = time.perf_counter() - t0
        enc_launches = {n: fn.launches for n, fn in counters().items() if fn.launches}
        rec["pre_encode"] = dict(
            items=enc["items"], wall_s=wall, encode_ms=enc["encode_ms"],
            encode_ms_median=statistics.median(enc["encode_ms"]),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            resident_before_gib=resident / 2 ** 30, launches=enc_launches)
        # one encoder pass a clip, with no grad: the snake convs' forward
        # kernels and the snakes before the strided convs, nothing else
        want = {n: SA2_WAVS * c for n, c in ENCODE_LAUNCHES.items()}
        if {n: enc_launches.get(n, 0) for n in want} != want or not enc_launches.get(
                "snake_fused") or set(enc_launches) - set(want) - {"snake_fused"}:
            raise AssertionError(f"pre-encode of {SA2_WAVS} clips launched {enc_launches}, "
                                 f"expected {want} and snake_fused")
        rec["pre_encode"]["clip_profile"] = encode_profile(dev, vae_ckpt)
        torch.cuda.empty_cache()
        files = sorted(f for f in os.listdir(enc["out_dir"]) if f.endswith(".npy"))
        if enc["items"] != SA2_WAVS or len(files) != SA2_WAVS:
            raise AssertionError(f"pre-encode wrote {files}, expected {SA2_WAVS} latents")
        for name in files:
            lat = np.load(os.path.join(enc["out_dir"], name))
            with open(os.path.join(enc["out_dir"], name[:-4] + ".json")) as f:
                mask = json.load(f)["padding_mask"]
            if lat.shape != (64, SA2_LATENTS) or not np.isfinite(lat).all() or len(mask) != \
                    SA2_LATENTS:
                raise AssertionError(f"pre-encoded {name}: latents {lat.shape} finite="
                                     f"{bool(np.isfinite(lat).all())}, mask of {len(mask)}")

        # 9b: train from the latents through the train entry's code path
        model_cfg = os.path.join(tmp, "model.json")
        with open(model_cfg, "w") as f:
            json.dump(sa2_train_config(clap_path, True), f)
        lat_cfg = os.path.join(tmp, "latent_dataset.json")
        with open(lat_cfg, "w") as f:
            json.dump({"dataset_type": "pre_encoded", "latent_crop_length": SA2_LATENTS,
                       "random_crop": True, "datasets": [{"id": "lat", "path": latent_dir}]}, f)
        args = train.parse_args([
            "--model-config", model_cfg, "--dataset-config", lat_cfg,
            "--batch-size", str(SA2_TRAIN_BATCH), "--num-workers", "2", "--seed", "0",
            "--max-steps", str(WARM_STEPS + TIMED_STEPS), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        t0 = time.perf_counter()
        trainer, loader = train.build(args, device=dev)
        w = trainer.wrapper
        # the latents' own encoder, for 9c's in-step encode
        load_model_state(vae_ckpt, w.model.pretransform.model)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        before = {n: p.detach().clone() for n, p in w.params.items()}
        trainer.fit(loader, max_steps=1, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        if bad:
            raise AssertionError(f"SA-2.0 training, step 1: {len(bad)} trainable parameters have "
                                 f"no finite nonzero gradient: {bad[:8]}")
        trainer.fit(loader, max_steps=WARM_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        kernels = counters()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader, max_steps=WARM_STEPS + TIMED_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = sa2_training_launches(w.model, TIMED_STEPS)
        wrong = {n: (rec["launches"][n], c) for n, c in want.items() if rec["launches"][n] != c}
        if wrong:
            raise AssertionError(f"SA-2.0 training launches (got, want): {wrong}")
        losses = [h["train/loss"] for h in trainer.history]
        if len(losses) != WARM_STEPS + TIMED_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"SA-2.0 training losses: {losses}")
        walls = [1e3 / h["train/steps_per_sec"] for h in trainer.history[WARM_STEPS:]]
        unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
        ema_unmoved = [n for n, e in w.ema.items() if torch.equal(e, before[n])]
        if unmoved or ema_unmoved:
            raise AssertionError(f"SA-2.0: parameters that did not move: {unmoved[:8]}; "
                                 f"EMA entries that did not move: {ema_unmoved[:8]}")
        del before
        trainable = sum(p.numel() for p in w.params.values())
        rec.update(
            losses=losses, step_ms=walls, step_ms_median=statistics.median(walls),
            audio_s_per_s=SA2_TRAIN_BATCH * SA2_SAMPLE_SIZE / SR / (statistics.median(walls) / 1e3),
            trainable_params=trainable, params=sum(p.numel() for p in w.model.parameters()))
        rec["split"] = step_split(trainer, loader)
        t0 = time.perf_counter()
        path = trainer.save(w.step)
        rec["save_s"] = time.perf_counter() - t0
        rec["ckpt_gib"] = os.path.getsize(path) / 2 ** 30
        state = torch.load(path, map_location="cpu", weights_only=True)
        fresh = create_model_from_config(state["model_config"], "meta")
        fresh.load_state_dict(state["state_dict"], strict=True, assign=True)
        current = w.model.state_dict()
        differ = [n for n, v in fresh.state_dict().items() if not torch.equal(v, current[n].cpu())]
        ema_differ = [n for n, v in state["ema"].items() if not torch.equal(v, w.ema[n].cpu())]
        if differ or ema_differ or state["step"] != w.step:
            raise AssertionError(f"SA-2.0 checkpoint reload: {len(differ)} tensors and "
                                 f"{len(ema_differ)} EMA entries differ ({differ[:5]}), step "
                                 f"{state['step']} vs {w.step}")
        del state, fresh, current
        os.remove(path)

        # 9c: from audio at batch 1 x 12,582,912 samples: the in-step encode
        # and its padding-mask sampling at the latent rate
        w.pre_encoded = False
        audio_loader = create_dataloader_from_config(
            data, batch_size=1, sample_size=SA2_SAMPLE_SIZE, sample_rate=SR, num_workers=2,
            seed=1)
        audio, meta = next(iter(audio_loader))
        audio = trainer.prepare_batch(audio)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            latents = w.encode(audio, generator=w.generator(0))
            mask = w.padding_mask(meta, latents.shape[2])
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        if tuple(latents.shape) != (1, 64, SA2_LATENTS) or not torch.isfinite(latents).all() \
                or tuple(mask.shape) != (1, SA2_LATENTS):
            raise AssertionError(f"SA-2.0 in-step encode: latents {tuple(latents.shape)}, "
                                 f"mask {tuple(mask.shape)}")
        del audio, latents, mask
        history = len(trainer.history)
        for fn in kernels.values():
            fn.launches = 0
        # one `fit` call: its first (warm-up) step also waits for the new
        # loader iterator's workers and first batch
        trainer.fit(audio_loader, max_steps=w.step + SA2_AUDIO_WARM + SA2_AUDIO_TIMED,
                    save_at_end=False)
        torch.cuda.synchronize()
        audio_launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        steps = trainer.history[history:]
        audio_losses = [h["train/loss"] for h in steps]
        audio_walls = [1e3 / h["train/steps_per_sec"] for h in steps[SA2_AUDIO_WARM:]]
        if len(audio_losses) != SA2_AUDIO_WARM + SA2_AUDIO_TIMED or not all(
                map(math.isfinite, audio_losses)):
            raise AssertionError(f"SA-2.0 training from audio: losses {audio_losses}")
        idle = [n for n in ("snake_conv1d", "snake_conv1d_res", "snake_fused",
                            "flash_attention_fused_qkv", "flash_attention_prefix_bwd")
                if not audio_launches.get(n)]
        if idle:
            raise AssertionError(f"SA-2.0 training from audio did not launch {idle}")
        rec["from_audio"] = dict(
            batch=1, samples=SA2_SAMPLE_SIZE, losses=audio_losses, step_ms=audio_walls,
            encode_ms=encode_ms, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=audio_launches)
        del trainer, loader, audio_loader, w
    torch.cuda.empty_cache()
    return rec


DANCE = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                     "dance_diffusion", "dance_diffusion_base_16k.json")
DANCE_SAMPLE_SIZE, DANCE_SR, DANCE_BATCH = 65536, 16000, 4
# the card's bf16 outputs and gradients of the tiny Dance checks may lie at
# most this many times as far from the CPU's f32 ones as the CPU's own bf16
# ones do (||a - f32|| / ||f32||)
DANCE_SPREAD = 2.0


def dance_config() -> dict:
    with open(DANCE) as f:
        return json.load(f)


def dance_wgrad_shapes(batch: int = DANCE_BATCH) -> dict:
    """{(Ci, Co, k, L, pad): launches} of the plain weight gradient in one
    training step of BASELINE (b), read from a forward of the shipped
    config's model on the meta device (each stride-1 conv's input length;
    the conv pads k // 2 on each side)."""
    import collections

    from stable_audio_tools_tpu_torch.models.dance_unet import Conv1d
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    model = create_model_from_config(dance_config(), "meta")
    shapes = collections.Counter()
    for m in model.modules():
        if isinstance(m, Conv1d):
            m.register_forward_hook(lambda m, i, o: shapes.update(
                [(m.in_channels, m.out_channels, m.kernel_size[0], i[0].shape[-1],
                  m.kernel_size[0] // 2)]))
    with torch.no_grad():
        model(torch.empty(batch, 2, DANCE_SAMPLE_SIZE, device="meta"),
              torch.empty(batch, device="meta"))
    if sum(shapes.values()) != model.model.conv_sites():
        raise AssertionError(f"{sum(shapes.values())} conv calls, {model.model.conv_sites()} "
                             "convs in the model")
    return dict(shapes)


def plain_wgrad_checks(cs, randn, shapes: dict, B: int = 4) -> dict:
    """Row 11 plain (`conv1d_wgrad`) at every distinct shape of a training
    step, `shapes` {(Ci, Co, k, L, pad): launches} with x [B, Ci, L] padded
    `pad` on each side: dW and db within GRAD_REL_TOL of their peaks against
    the plain version, each call moving the launch counter, each timed
    (CUDA events, back to back) beside `torch.nn.grad.conv1d_weight` (a
    yardstick only) and its bound, and summed with the step's launches."""
    levels, errs, abs_errs = [], [], []
    for (Ci, Co, k, L, pad), n in sorted(shapes.items(), key=lambda kv: (-kv[0][3], kv[0])):
        x, dy = randn(B, Ci, L), randn(B, Co, L + 2 * pad - k + 1)
        got = counted(cs.conv1d_wgrad, dy, x, k, pad, pad, 1)
        want = cs.conv1d_wgrad_plain(dy, x, k, pad, pad, 1)
        name = f"[{B},{Ci},{L}] -> {Co} k={k} pad={pad}"
        errs.append(max(rel_err(f"conv1d_wgrad {p} {name}", a, b, GRAD_REL_TOL)
                        for p, a, b in zip(("dW", "db"), got, want)))
        abs_errs.append(max((a - b).abs().max().item() for a, b in zip(got, want)))
        levels.append(dict(
            shape=name, launches=n,
            ms=cuda_ms(lambda: cs.conv1d_wgrad(dy, x, k, pad, pad, 1), 5),
            conv1d_weight_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
                x, (Co, Ci, k), dy, padding=pad), 5),
            **bound(2.0 * B * dy.shape[-1] * Ci * Co * k, dy, x, *got)))
        del x, dy, got, want
    step = {key: sum(c["launches"] * c[key] for c in levels)
            for key in ("ms", "conv1d_weight_ms", "bound_ms")}
    return dict(levels=levels, max_rel_err=max(errs), max_abs_err=max(abs_errs),
                launches=sum(c["launches"] for c in levels), **step,
                share_of_bound=step["bound_ms"] / step["ms"])


def tiny_dance_config(compute_dtype) -> dict:
    """A tiny DAU1d with the shipped config's blocks: 4 levels of 32-64
    channels, attention at levels 2-4 (2 heads at 64), 1024 samples."""
    cfg = dance_config()
    cfg["sample_size"] = 1024
    cfg["model"]["config"].update(depth=4, n_attn_layers=2, channels=[32, 32, 64, 64],
                                  strides=[2, 2, 2], compute_dtype=compute_dtype)
    return cfg


def tiny_dance(dev, compute_dtype):
    """The tiny model on `dev`, its weights made on the CPU from seed 1 (the
    same for every dtype)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = create_model_from_config(tiny_dance_config(compute_dtype), "cpu")
    return init_random_(model, torch.Generator().manual_seed(1)).to(dev)


def rel_dist(got, want) -> float:
    return ((got.float().cpu() - want).norm() / want.norm()).item()


def small_dance_check(dev) -> dict:
    """The tiny model with its weights, noise and batch the same everywhere:
    generation by dpmpp-2m-sde and v-DDIM (8 steps, the step noise replayed)
    and one training step (the same t and noise) on the card in bf16 against
    the CPU in f32, each beside the CPU's own bf16 run; the card's distance
    from the CPU's f32 result may be at most DANCE_SPREAD times the CPU's
    bf16 one (relative norms: the audio, the loss, the whole gradient)."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_uncond
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    g = torch.Generator().manual_seed(2)
    T, steps = 1024, 8
    noise = torch.randn(1, 2, T, generator=g)
    step_noises = [torch.randn(1, 2, T, generator=g) for _ in range(steps)]
    audio = 0.3 * torch.randn(2, 2, T, generator=g)
    t, train_noise = torch.rand(2, generator=g), torch.randn(2, 2, T, generator=g)
    runs = {"f32": ("cpu", None), "cpu_bf16": ("cpu", "bfloat16"), "card_bf16": (dev, "bfloat16")}
    out = {}
    for name, (d, dtype) in runs.items():
        model = tiny_dance(d, dtype).eval()
        res = {}
        for sampler in ("dpmpp-2m-sde", "v-ddim"):
            res[sampler] = generate_diffusion_uncond(
                model, steps=steps, sample_size=T, sampler_type=sampler, noise=noise.to(d),
                step_noise=lambda i, x: step_noises[i].to(x.device)).float().cpu()
        w = create_training_wrapper_from_config(tiny_dance_config(dtype), model)
        res["loss"] = w.train_step(audio.to(d), [{}, {}], t=t.to(d),
                                   noise=train_noise.to(d))["loss"].float().cpu()
        res["grad"] = torch.cat([p.grad.float().cpu().flatten() for p in w.params.values()])
        if not all(torch.isfinite(v).all() for v in res.values()):
            raise AssertionError(f"small Dance check: non-finite values in the {name} run")
        out[name] = res
    rec = {}
    for key in ("dpmpp-2m-sde", "v-ddim", "loss", "grad"):
        cpu, card = (rel_dist(out[n][key], out["f32"][key]) for n in ("cpu_bf16", "card_bf16"))
        rec[key] = dict(cpu_bf16_vs_f32=cpu, card_bf16_vs_cpu_f32=card)
        if not card <= DANCE_SPREAD * cpu:
            raise AssertionError(f"small Dance {key}: the card's bf16 lies {card:.3g} from the "
                                 f"CPU's f32, more than {DANCE_SPREAD} x the CPU's bf16 "
                                 f"{cpu:.3g}")
    return rec


def profiled_window(fn) -> dict:
    """torch.profiler over one call of fn (synchronised), read by
    `profile_reading`, and row 11's kernels' device ms in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    return dict(profile_reading(events, wall_us), conv1d_wgrad_ms=sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and "conv1d_wgrad" in e.key) / 1e3)


def dance_generation(dev) -> dict:
    """BASELINE (b): the shipped base_16k config, seeded random weights,
    batch 1, 65,536 samples, 100 dpmpp-2m-sde steps; then one sampler step
    (a denoiser call) timed and profiled."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_uncond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = create_model_from_config(dance_config(), dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()
    run = lambda steps, seed: generate_diffusion_uncond(
        model, steps=steps, batch_size=1, sample_size=DANCE_SAMPLE_SIZE, seed=seed,
        sampler_type="dpmpp-2m-sde", sigma_min=0.3, sigma_max=500.0)
    run(2, 0)  # warm-up: cuDNN plans at the full shapes
    torch.cuda.synchronize()
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    audio = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    if any(launches.values()):  # cuDNN's convs: no hand-written kernel runs a forward
        raise AssertionError(f"Dance generation launched {launches}")
    if tuple(audio.shape) != (1, 2, DANCE_SAMPLE_SIZE) or not torch.isfinite(audio).all():
        raise AssertionError(f"Dance audio {tuple(audio.shape)} "
                             f"finite={bool(torch.isfinite(audio).all())}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    x = torch.randn(1, 2, DANCE_SAMPLE_SIZE, device=dev)
    t = torch.full((1,), 0.5, device=dev)
    with torch.inference_mode():
        step = lambda: model(x, t)
        step_ms = cuda_ms(step, 5)
        profile = profiled_window(step)
    return dict(wall_s=wall, steps=STEPS, audio_s_per_s=DANCE_SAMPLE_SIZE / DANCE_SR / wall,
                peak_gib=peak_gib, launches=launches, step_ms=step_ms, step_profile=profile,
                params=sum(p.numel() for p in model.parameters()))


def dance_training(dev) -> dict:
    """BASELINE (b)'s config trained through `train.build` and
    `Trainer.fit` at batch 4 x 65,536 on seeded synthetic 16 kHz stereo
    WAVs: 2 warm-up and 5 timed steps, one forward+backward profiled, a
    checkpoint and its reload."""
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dance_") as tmp:
        cfg_path = os.path.join(tmp, "model.json")
        with open(cfg_path, "w") as f:
            json.dump(dance_config(), f)
        args = train.parse_args([
            # 16 clips of 5-12.5 s at 16 kHz: an epoch of 4 batches
            "--model-config", cfg_path,
            "--dataset-config", write_dataset(tmp, 16, 5, 0.5, sr=DANCE_SR),
            "--batch-size", str(DANCE_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(WARM_STEPS + TIMED_STEPS), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        trainer, loader = train.build(args, device=dev)
        w = trainer.wrapper
        unet = w.model.model
        if unet.compute_dtype != torch.bfloat16 or next(unet.parameters()).device != dev:
            raise AssertionError(f"Dance: not built on {dev} with bf16 compute")
        before = {n: p.detach().clone() for n, p in w.params.items()}
        trainer.fit(loader, max_steps=1, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        if bad:
            raise AssertionError(f"Dance step 1: {len(bad)} parameters have no finite nonzero "
                                 f"gradient: {bad[:8]}")
        trainer.fit(loader, max_steps=WARM_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        kernels = counters()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader, max_steps=WARM_STEPS + TIMED_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        sites = unet.conv_sites()
        want = {n: TIMED_STEPS * sites if n == "conv1d_wgrad" else 0 for n in kernels}
        if rec["launches"] != want:
            raise AssertionError(f"Dance training launches {rec['launches']}, expected {want} "
                                 f"({sites} stride-1 convs a forward)")
        losses = [h["train/loss"] for h in trainer.history]
        if len(losses) != WARM_STEPS + TIMED_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"Dance training losses: {losses}")
        walls = [1e3 / h["train/steps_per_sec"] for h in trainer.history[WARM_STEPS:]]
        unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
        ema_unmoved = [n for n, e in w.ema.items() if torch.equal(e, before[n])]
        if unmoved or ema_unmoved:
            raise AssertionError(f"Dance parameters that did not move: {unmoved[:8]}; EMA "
                                 f"entries that did not move: {ema_unmoved[:8]}")
        del before
        median = statistics.median(walls)
        rec.update(losses=losses, step_ms=walls, step_ms_median=median,
                   audio_s_per_s=DANCE_BATCH * DANCE_SAMPLE_SIZE / DANCE_SR / (median / 1e3),
                   params=sum(p.numel() for p in w.params.values()),
                   wgrad_launches_per_step=rec["launches"]["conv1d_wgrad"] // TIMED_STEPS,
                   conv_sites=sites)
        audio = trainer.prepare_batch(next(iter(loader))[0])

        def fwd_bwd():
            loss, _ = w.loss(audio, {}, counter=w.step)
            loss.backward()

        fwd_bwd()
        rec["fwd_bwd_profile"] = profiled_window(fwd_bwd)
        w.optimizer.zero_grad(set_to_none=True)

        path = trainer.save(w.step)
        rec["ckpt_gib"] = os.path.getsize(path) / 2 ** 30
        state = torch.load(path, map_location="cpu", weights_only=True)
        fresh = create_model_from_config(state["model_config"], "meta")
        fresh.load_state_dict(state["state_dict"], strict=True, assign=True)
        current = w.model.state_dict()
        differ = [n for n, v in fresh.state_dict().items() if not torch.equal(v, current[n].cpu())]
        if differ or state["step"] != w.step or set(state["ema"]) != set(w.ema):
            raise AssertionError(f"Dance checkpoint reload: {len(differ)} tensors differ "
                                 f"({differ[:5]}), step {state['step']} vs {w.step}")
    return rec


def phase_dance(dev) -> dict:
    """Phase 10: the tiny card-vs-CPU checks, BASELINE (b)'s generation, then
    its training at full width."""
    rec = dict(small=small_dance_check(dev), small_spread=DANCE_SPREAD)
    rec["generation"] = dance_generation(dev)
    torch.cuda.empty_cache()
    rec["training"] = dance_training(dev)
    return rec


SA1 = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                   "txt2audio", "stable_audio_1_0.json")
SA1_SAMPLE_SIZE = 4194304  # the shipped config's: 95.1 s at 44.1 kHz, 4096 latents
SA1_PROMPT = [{"prompt": "A cinematic orchestral swell with deep brass and timpani",
               "seconds_start": 0, "seconds_total": 95}]
SA1_KERNELS = ("fused_layer_norm", "snake_conv1d", "snake_conv1d_res", "snake_fused")


def sa1_config(clap_path: str) -> dict:
    """The shipped SA-1.0 config, nothing cut: its CLAP checkpoint path (a
    placeholder in the file) pointed at `clap_path`."""
    with open(SA1) as f:
        cfg = json.load(f)
    for c in cfg["model"]["conditioning"]["configs"]:
        if c["type"] == "clap_text":
            c["config"]["clap_ckpt_path"] = clap_path
    return cfg


def sa1_launches(model) -> dict:
    """Kernel launches counted from the model: row 2 a UNet forward (its
    biased LayerNorms), rows 12 / 3 / 4 a decode and an encode (a residual
    unit runs row 12 then row 3, the snake + conv_out row 12 once more, each
    up- or downsampling block row 4 once)."""
    from stable_audio_tools_tpu_torch.models.dac import (DACDecoderBlock, DACEncoderBlock,
                                                         DACResidualUnit)
    from stable_audio_tools_tpu_torch.ops.norms import BiasedLayerNorm

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    def tower(t, block):
        units = count(t, DACResidualUnit)
        return {"snake_conv1d": units + 1, "snake_conv1d_res": units,
                "snake_fused": count(t, block)}

    ae = model.pretransform.model
    return dict(unet_forward={"fused_layer_norm": count(model.model.model, BiasedLayerNorm)},
                decode=tower(ae.decoder, DACDecoderBlock),
                encode=tower(ae.encoder, DACEncoderBlock))


def tiny_sa1_model(clap_path: str):
    """SA-1.0's shape at toy size on the CPU: the same conditioners (the CLAP
    tower of `clap_path`, CRC-32 word hashing as `tiny_model()`), a 3-level
    UNetCFG1d (64 / 64 / 96 channels, factors 1 and 2, 16 groups, attention
    at every level, 2 heads), a DAC VAE at ratio 8 in bf16 (`model_half`, as
    shipped): encoder 16 -> 32 -> 64 channels, decoder 96 -> 48 -> 24."""
    import zlib

    from stable_audio_tools_tpu_torch.models.conditioners import FallbackTokenizer
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    cfg = sa1_config(clap_path)
    m = cfg["model"]
    m["conditioning"]["cond_dim"] = 64
    m["diffusion"]["config"].update(
        in_channels=4, context_embedding_features=64, channels=32, multipliers=[2, 2, 3],
        factors=[1, 2], num_blocks=[1, 2], attentions=[1, 1, 1], attention_heads=2)
    m["io_channels"] = 4
    ae = m["pretransform"]["config"]
    ae["encoder"]["config"].update(latent_dim=8, d_model=16, strides=[2, 4])
    ae["decoder"]["config"].update(latent_dim=4, channels=96, rates=[4, 2])
    ae.update(latent_dim=4, downsampling_ratio=8)
    model = create_model_from_config(cfg, "cpu")
    clap = model.conditioner.conditioners["prompt"]
    init_random_(model, torch.Generator().manual_seed(1), skip=[clap.model, clap.text_projection])
    clap.tokenizer = FallbackTokenizer(clap.tokenizer.max_length,
                                       word_hash=lambda w: zlib.crc32(w.encode("utf-8")))
    return model


@torch.inference_mode()
def small_sa1_check(dev, clap_path: str) -> dict:
    """A tiny SA-1.0-shaped model on the card (kernels) against the CPU (plain
    versions), on the same inputs: the conditioning and a CFG 6 denoiser call
    with a negative prompt and the rescale (the f32 UNet: the largest
    max|card - CPU| / max|CPU|, within 5%); the bf16 decode and encode (DAC
    VAE) against the CPU's f32 run, beside the CPU's own bf16 distance from
    it (relative norms; the card's may be at most DANCE_SPREAD times the
    CPU's); then a 4-step request with init audio on the card."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond

    cpu = tiny_sa1_model(clap_path).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    f32 = copy.deepcopy(cpu)
    f32.pretransform.model_half = False
    g = torch.Generator().manual_seed(2)
    x, z = torch.randn(1, 4, 256, generator=g), torch.randn(1, 4, 256, generator=g)
    audio, noise = 0.3 * torch.randn(1, 2, 2048, generator=g), torch.randn(1, 4, 256, generator=g)
    t = torch.tensor([0.5])
    negative = [dict(SA1_PROMPT[0], prompt="harsh distorted noise")]

    def denoise(m, d):
        cond = m.get_conditioning_inputs(m.conditioner(SA1_PROMPT, d))
        cond.update(m.get_conditioning_inputs(m.conditioner(negative, d), negative=True))
        return m(x.to(d), t.to(d), cfg_scale=6.0, scale_phi=0.4, **cond)

    out = {}
    for name, run in (("conditioning", lambda m, d: m.conditioner(SA1_PROMPT, d)["prompt"][0]),
                      ("denoiser", denoise)):
        want, got = run(cpu, "cpu").float(), run(gpu, dev).float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError(f"small SA-1.0 {name}: non-finite output on the card")
        out[name] = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-6)
    for name, run in (("decode", lambda m, d: m.pretransform.decode(z.to(d))),
                      ("encode", lambda m, d: m.pretransform.encode(audio.to(d),
                                                                    noise=noise.to(d)))):
        want = run(f32, "cpu").float()
        card, cpu_bf16 = run(gpu, dev).float(), run(cpu, "cpu").float()
        if not torch.isfinite(card).all():
            raise AssertionError(f"small SA-1.0 {name}: non-finite output on the card")
        out[f"{name}_card_vs_f32"] = rel_dist(card, want)
        out[f"{name}_cpu_bf16_vs_f32"] = rel_dist(cpu_bf16, want)
    size = 2048
    request = generate_diffusion_cond(
        gpu, steps=4, cfg_scale=6.0, conditioning=SA1_PROMPT, sample_size=size, seed=3,
        init_audio=(44100, 0.3 * torch.randn(2, size, generator=g)), init_noise_level=5.0)
    if (tuple(request.shape) != (1, 2, size) or not torch.isfinite(request).all()
            or request.abs().max() > 1):
        raise AssertionError(f"small SA-1.0 init-audio request: audio {tuple(request.shape)}")
    return out


def phase_sa1(dev) -> dict:
    """Phase 11: the tiny card-vs-CPU checks, then the shipped SA-1.0 config:
    one request (launches pinned from the model), the sampler step and the
    decode back to back and profiled, and the DAC encode of one clip."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.roberta import RobertaArch

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sa1_") as tmp:
        small_clap = os.path.join(tmp, "clap_small.pt")
        write_clap_checkpoint(small_clap, RobertaArch(vocab_size=32002, hidden_size=64,
                                                      num_layers=2, num_heads=1,
                                                      intermediate_size=128, max_positions=80))
        small = small_sa1_check(dev, small_clap)
        small_tol = 0.05
        bad = {k: small[k] for k in ("conditioning", "denoiser") if small[k] > small_tol}
        bad.update({k: small[f"{k}_card_vs_f32"] for k in ("decode", "encode")
                    if small[f"{k}_card_vs_f32"] > DANCE_SPREAD * small[f"{k}_cpu_bf16_vs_f32"]})
        if bad:
            raise AssertionError(f"small SA-1.0-shaped model: card vs CPU {small} (tol "
                                 f"{small_tol}; the codec within {DANCE_SPREAD}x the CPU's bf16)")

        # full width: the shipped config, its CLAP tower read from a file
        clap_path = os.path.join(tmp, "clap.pt")
        t0 = time.perf_counter()
        write_clap_checkpoint(clap_path)
        model = create_model_from_config(sa1_config(clap_path), dev)
        clap = model.conditioner.conditioners["prompt"]
        init_random_(model, torch.Generator(device=dev).manual_seed(0),
                     skip=[clap.model, clap.text_projection]).eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    if next(model.parameters()).device.type != "cuda":
        raise AssertionError("SA-1.0: the factory did not build the model on the card")
    counts = sa1_launches(model)
    pinned = dict(unet_forward={"fused_layer_norm": 92},
                  decode={"snake_conv1d": 13, "snake_conv1d_res": 12, "snake_fused": 4},
                  encode={"snake_conv1d": 13, "snake_conv1d_res": 12, "snake_fused": 4})
    if counts != pinned:
        raise AssertionError(f"SA-1.0 launches counted from the model {counts} != {pinned}")
    unet = model.model.model
    params = dict(unet=sum(p.numel() for p in unet.parameters()),
                  encoder=sum(p.numel() for p in model.pretransform.model.encoder.parameters()),
                  decoder=sum(p.numel() for p in model.pretransform.model.decoder.parameters()),
                  total=sum(p.numel() for p in model.parameters()))
    run = lambda steps, seed: generate_diffusion_cond(
        model, steps=steps, cfg_scale=6.0, conditioning=SA1_PROMPT, batch_size=1,
        sample_size=SA1_SAMPLE_SIZE, seed=seed, sampler_type="dpmpp-3m-sde",
        sigma_min=0.3, sigma_max=500.0)
    run(2, 0)  # warm-up: cuDNN plans at the full shapes
    torch.cuda.synchronize()
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    calls = []
    hook = unet.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        audio = run(STEPS, 1)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if (tuple(audio.shape) != (1, 2, SA1_SAMPLE_SIZE) or not torch.isfinite(audio).all()
            or audio.abs().max().item() > 1.0):
        raise AssertionError(f"SA-1.0 audio {tuple(audio.shape)} finite="
                             f"{bool(torch.isfinite(audio).all())} peak {audio.abs().max().item()}")
    # one UNet call a step at batch 1 (the UNet doubles it for CFG)
    want = {n: 0 for n in kernels}
    want.update(counts["decode"], fused_layer_norm=92 * len(calls))
    if calls != [1] * STEPS or launches != want:
        raise AssertionError(f"SA-1.0 request: UNet calls {len(calls)} (batches "
                             f"{sorted(set(calls))}), launches {launches} != {want}")
    del audio

    # the sampler step (a CFG 6 denoiser call) and the decode: back to back
    # (CUDA events) and under the profiler
    g = torch.Generator(device=dev).manual_seed(3)
    latents = torch.randn(1, 64, SA1_SAMPLE_SIZE // 1024, generator=g, device=dev)
    t = torch.full((1,), 0.5, device=dev)
    with torch.inference_mode():
        cond = model.get_conditioning_inputs(model.conditioner(SA1_PROMPT, dev))
        step = lambda: model(latents, t, cfg_scale=6.0, **cond)
        decode = lambda: model.pretransform.decode(latents)
        step_ms, step_profile = cuda_ms(step, 5), profiled_window(step)
        decode_ms, decode_profile = cuda_ms(decode, 2), profiled_window(decode)

    # the DAC encode of one clip (init audio, pre-encoding), its launches pinned
    clip = 0.3 * torch.randn(1, 2, SA1_SAMPLE_SIZE, generator=g, device=dev)
    encode = lambda: model.pretransform_encode(clip, generator=g)
    for fn in kernels.values():
        fn.launches = 0
    z = encode()
    torch.cuda.synchronize()
    enc_launches = {n: fn.launches for n, fn in kernels.items()}
    want = {n: 0 for n in kernels}
    want.update(counts["encode"])
    if tuple(z.shape) != (1, 64, SA1_SAMPLE_SIZE // 1024) or not torch.isfinite(z).all():
        raise AssertionError(f"SA-1.0 encode: latents {tuple(z.shape)} "
                             f"finite={bool(torch.isfinite(z).all())}")
    if enc_launches != want:
        raise AssertionError(f"SA-1.0 encode launches {enc_launches} != {want}")
    encode_ms, encode_profile = cuda_ms(encode, 2), profiled_window(encode)
    for prof in (step_profile, decode_profile, encode_profile):
        prof.pop("conv1d_wgrad_ms", None)
    return dict(wall_s=wall, steps=STEPS, audio_s=SA1_SAMPLE_SIZE / 44100.0,
                audio_s_per_s=SA1_SAMPLE_SIZE / 44100.0 / wall, peak_gib=peak_gib,
                launches=launches, counts=counts, unet_calls=len(calls), params=params,
                build_s=build_s, small=small, small_tol=small_tol, step_ms=step_ms,
                step_profile=step_profile, decode_ms=decode_ms, decode_profile=decode_profile,
                encode=dict(ms=encode_ms, profile=encode_profile, launches=enc_launches),
                phase_s=time.perf_counter() - t_phase)


# SA-1.0 training (phase 12): batch 4 x 4,194,304 samples (95.1 s) on 8
# synthetic stereo WAVs of 96-131 s
SA1_TRAIN_BATCH = 4


def small_sa1_train_check(dev, clap_path: str) -> dict:
    """One SA-1.0 training step's loss and gradients, the tiny model on the
    card against the CPU: the same weights, latents (encoded once on the
    CPU: the DAC encode is phase 11's check), conditioning, t, noise and
    CFG-dropout mask (one of two items dropped), through the trainer's
    `loss` and backward in f32 (the card's convs in cuDNN's TF32, its
    default). Returns the loss's relative error and the largest
    max|card - CPU| / max|CPU| over the trainable gradients (the UNet's,
    the int tables', CLAP's proj_out)."""
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    cfg = sa1_config(clap_path)
    cfg["training"]["cfg_dropout_prob"] = 0.5
    cpu = tiny_sa1_model(clap_path)
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(4)
    B = 2
    audio = 0.3 * torch.randn(B, 2, 2048, generator=g)
    meta = [SA1_PROMPT[0], dict(SA1_PROMPT[0], seconds_start=7)]
    with torch.no_grad():
        latents = cpu.pretransform_encode(audio, noise=torch.randn(B, 4, 256, generator=g))
    inj = dict(t=torch.rand(B, generator=g), noise=torch.randn(B, 4, 256, generator=g),
               cfg_dropout_mask=torch.tensor([False, True]))
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        w = create_training_wrapper_from_config(cfg, model)
        w.model.train()
        loss, _ = w.loss(latents.to(d), w.condition(meta), **{k: v.to(d) for k, v in inj.items()})
        loss.backward()
        out[name] = (float(loss.detach()), w)
    (lc, wc), (lg, wg) = out["cpu"], out["card"]
    if not (math.isfinite(lc) and math.isfinite(lg)):
        raise AssertionError(f"small SA-1.0 training step: loss cpu {lc} card {lg}")
    errs = {}
    for n, p in wc.params.items():
        gg = wg.params[n].grad
        if p.grad is None:
            if gg is not None and gg.abs().max() > 0:
                raise AssertionError(f"small SA-1.0 training step: {n} has a gradient on the "
                                     "card only")
            continue
        if gg is None or not torch.isfinite(gg).all():
            raise AssertionError(f"small SA-1.0 training step: {n} has no finite gradient on "
                                 "the card")
        peak = p.grad.abs().max().item()
        errs[n] = (gg.float().cpu() - p.grad).abs().max().item() / peak if peak > 0 else 0.0
    worst = max(errs, key=errs.get)
    return dict(loss_rel_err=abs(lg - lc) / abs(lc), grad_rel_err=errs[worst], worst_grad=worst,
                grads=len(errs))


def sa1_step_split(trainer, loader) -> dict:
    """One SA-1.0 training step in its pieces (host clock around synchronised
    work: data, conditioning, the frozen DAC encode, forward+backward,
    optimizer, EMA), then its forward+backward under the profiler (busy
    share, kernels, top kernels) with its launches of row 2 (the UNet's
    LayerNorms) counted, then three whole steps on the same batch back to
    back, and the caching allocator's retries so far."""
    from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln

    w = trainer.wrapper
    out, t = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out[f"{name}_ms"] = (t[-1] - t[-2]) * 1e3

    audio, meta = next(iter(loader))
    audio = trainer.prepare_batch(audio)
    lap("data")
    gen = w.generator(w.step)
    w.model.train()
    w.optimizer.zero_grad(set_to_none=True)
    cond = w.condition(meta)
    lap("conditioning")
    latents = w.encode(audio, generator=gen)
    lap("encode")
    loss, _ = w.loss(latents, cond, generator=gen)
    loss.backward()
    lap("forward_backward")
    w.optimizer_step()
    lap("optimizer")
    w.ema_step()
    lap("ema")
    w.step += 1
    out["step_ms"] = (t[-1] - t[0]) * 1e3

    def fwd_bwd():
        loss, _ = w.loss(latents, w.condition(meta), generator=gen)
        loss.backward()

    ln.fused_layer_norm.launches = 0
    out["fwd_bwd_profile"] = profiled_window(fwd_bwd)
    out["fwd_bwd_profile"].pop("conv1d_wgrad_ms", None)
    out["fwd_bwd_layer_norm_launches"] = ln.fused_layer_norm.launches
    w.optimizer.zero_grad(set_to_none=True)
    # whole steps on the batch held on the card, back to back: the step
    # without the loader (the CLI loop's walls above include its waits)
    held = []
    for _ in range(3):
        t0 = time.perf_counter()
        w.train_step(audio, meta)
        torch.cuda.synchronize()
        held.append((time.perf_counter() - t0) * 1e3)
    out["held_batch_step_ms"] = held
    out["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    return out


def phase_sa1_training(dev) -> dict:
    """Phase 12: the tiny card-vs-CPU step, then the shipped SA-1.0 config
    through `train.build` and `Trainer.fit` (its CLAP tower read from the
    seeded RoBERTa-base file), batch SA1_TRAIN_BATCH x 4,194,304."""
    from stable_audio_tools_tpu_torch import train
    from stable_audio_tools_tpu_torch.models.roberta import RobertaArch

    t_phase = time.perf_counter()
    kernels = {n: fn for n, fn in counters().items()
               if n in ("fused_layer_norm", "snake_conv1d", "snake_conv1d_res", "snake_fused")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sa1t_") as tmp:
        small_clap = os.path.join(tmp, "clap_small.pt")
        write_clap_checkpoint(small_clap, RobertaArch(vocab_size=32002, hidden_size=64,
                                                      num_layers=2, num_heads=1,
                                                      intermediate_size=128, max_positions=80))
        small = small_sa1_train_check(dev, small_clap)
        small_tol = 0.05
        if not (small["loss_rel_err"] <= small_tol and small["grad_rel_err"] <= small_tol):
            raise AssertionError(f"small SA-1.0 training step card vs CPU: {small} > {small_tol}")
        rec = dict(small=small, small_tol=small_tol)

        clap_path = os.path.join(tmp, "clap.pt")
        write_clap_checkpoint(clap_path)
        cfg_path = os.path.join(tmp, "model.json")
        with open(cfg_path, "w") as f:
            json.dump(sa1_config(clap_path), f)
        n_steps = WARM_STEPS + TIMED_STEPS
        args = train.parse_args([
            "--model-config", cfg_path, "--dataset-config", write_dataset(tmp, 8, 96),
            "--batch-size", str(SA1_TRAIN_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(n_steps), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        t0 = time.perf_counter()
        trainer, loader = train.build(args, device=dev)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        w = trainer.wrapper
        unet = w.model.model.model
        if next(unet.parameters()).dtype != torch.float32 or not w.params:
            raise AssertionError("SA-1.0 training: the UNet is not f32 or nothing trains")
        counts = sa1_launches(w.model)
        before = {n: p.detach().clone() for n, p in w.params.items()}
        trainer.fit(loader, max_steps=1, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        # the null context learns only from dropped items (cfg_dropout_prob
        # 0.1): its gradient may be zero in a step that dropped none
        bad = [n for n in bad if "fixed_embedding" not in n]
        if bad:
            raise AssertionError(f"SA-1.0 after step 1, {len(bad)} trainable parameters have "
                                 f"no finite nonzero gradient: {bad[:8]}")
        trainer.fit(loader, max_steps=WARM_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader, max_steps=n_steps, save_at_end=False)
        torch.cuda.synchronize()
        rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # a step: the UNet forward's LayerNorms, each clip's DAC encode
        # (the pretransform iterates over the batch)
        want = {"fused_layer_norm": TIMED_STEPS * counts["unet_forward"]["fused_layer_norm"]}
        want.update({n: TIMED_STEPS * SA1_TRAIN_BATCH * c for n, c in counts["encode"].items()})
        if rec["launches"] != want:
            raise AssertionError(f"SA-1.0 training launches {rec['launches']} != {want}")
        losses = [h["train/loss"] for h in trainer.history]
        if len(losses) != n_steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"SA-1.0 training losses: {losses}")
        walls = [1e3 / h["train/steps_per_sec"] for h in trainer.history[WARM_STEPS:]]
        unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
        ema_unmoved = [n for n, e in w.ema.items() if torch.equal(e, before[n])]
        if unmoved or ema_unmoved:
            raise AssertionError(f"SA-1.0: parameters that did not move: {unmoved[:8]}; EMA "
                                 f"entries that did not move: {ema_unmoved[:8]}")
        del before
        median = statistics.median(walls)
        rec.update(losses=losses, step_ms=walls, step_ms_median=median,
                   audio_s_per_s=SA1_TRAIN_BATCH * SA1_SAMPLE_SIZE / SR / (median / 1e3),
                   trainable_params=sum(p.numel() for p in w.params.values()),
                   params=sum(p.numel() for p in w.model.parameters()), counts=counts)
        rec["split"] = sa1_step_split(trainer, loader)
        if rec["split"]["fwd_bwd_layer_norm_launches"] != counts["unet_forward"]["fused_layer_norm"]:
            raise AssertionError(f"SA-1.0 forward+backward: row 2 launched "
                                 f"{rec['split']['fwd_bwd_layer_norm_launches']} times")
        t0 = time.perf_counter()
        path = trainer.save(w.step)
        rec["save_s"] = time.perf_counter() - t0
        rec["ckpt_gib"] = os.path.getsize(path) / 2 ** 30
        rec.update(resume_check(trainer, loader, path, 1))
        del trainer, loader, w, unet
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def tiny_dac_vae_config(name: str, compute_dtype: str = "bfloat16") -> dict:
    """A shipped DAC VAE config at toy size (the same blocks and losses):
    the encoder's d_model 16, strides [2, 4]; the decoder 96 channels (the
    96-wide last level), rates [4, 2]; latent 4; the discriminator's 8
    filters over two STFT scales, three MRSTFT resolutions."""
    cfg = dac_vae_config(name)
    cfg["sample_size"] = 4096
    m = cfg["model"]
    m["encoder"]["config"].update(d_model=16, strides=[2, 4], latent_dim=8)
    m["decoder"]["config"].update(channels=96, rates=[4, 2], latent_dim=4)
    m.update(latent_dim=4, downsampling_ratio=8)
    tr = cfg["training"]
    tr["compute_dtype"] = compute_dtype
    tr["loss_configs"]["discriminator"]["config"] = dict(
        filters=8, n_ffts=[256, 128], hop_lengths=[64, 32], win_lengths=[256, 128])
    tr["loss_configs"]["spectral"]["config"].update(
        fft_sizes=[256, 64, 32], hop_sizes=[64, 16, 8], win_lengths=[256, 64, 32])
    return cfg


def phase_dac_training(dev) -> dict:
    """Phase 13: for each DAC VAE-GAN, `gan_phase` with its launches
    counted from the model (`dac_gen_launches`)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    t_phase = time.perf_counter()
    rec = {}
    for name in DAC_VAES:
        cfg = dac_vae_config(name)
        counts = dac_gen_launches(create_model_from_config(cfg, "meta"))
        rec[name] = gan_phase(dev, cfg, lambda dtype: tiny_dac_vae_config(name, dtype), counts)
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


ENCODEC = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "autoencoders", "encodec_musicgen_rvq.json")


def codec_config() -> dict:
    with open(ENCODEC) as f:
        return json.load(f)


def tiny_codec_config() -> dict:
    """The shipped codec config at toy size, f32: SEANet of 8 filters at
    ratios [2, 4] into 16 dimensions (its 2-layer LSTM, weight norm), an RVQ
    of 2 x 32 codes (decay 0.99, dead-code threshold 2, the k-means init),
    the discriminator's 8 filters over two STFT scales."""
    cfg = codec_config()
    cfg["sample_size"] = 4096
    m = cfg["model"]
    for side in ("encoder", "decoder"):
        m[side]["config"].update(n_filters=8, ratios=[2, 4], dimension=16)
    m["bottleneck"]["config"].update(num_quantizers=2, codebook_size=32, dim=16)
    m.update(latent_dim=16, downsampling_ratio=8)
    tr = cfg["training"]
    tr["compute_dtype"] = "float32"
    tr["loss_configs"]["discriminator"]["config"] = dict(
        filters=8, n_ffts=[256, 128], hop_lengths=[64, 32], win_lengths=[256, 128])
    tr["loss_configs"]["spectral"]["config"].update(
        fft_sizes=[256, 64, 32], hop_sizes=[64, 16, 8], win_lengths=[256, 64, 32])
    return cfg


def small_codec_check(dev) -> dict:
    """Two generator steps (the k-means init, then the EMA update and
    dead-code revival) and a discriminator step of the tiny codec on the
    card against the CPU, f32 on both with cuDNN's TF32 off: the same
    batch and revival rows, and before each step the card takes the CPU's
    weights and quantizer state (so that each step is read alone: Lloyd
    iterations and nearest-code picks are discontinuous, and a vector about
    as near two centers as f32 rounding can tell goes either way, which
    later steps would carry on). Returned: the losses' largest relative
    error; each side's gradient (||card - CPU|| / ||CPU|| over the side);
    the share of the quantizer's codewords (with their EMA sums and counts)
    within 1e-3 of the CPU's, relative to the tensor's peak, at the worst
    step (a vector that changes its code moves two codewords); then, with
    the CPU's weights on both sides and each side's codebooks, an encode's
    latents before the quantizer (max|card - CPU| / max|CPU|) and the share
    of equal codes."""
    cfg = tiny_codec_config()
    g = torch.Generator().manual_seed(5)
    audio = 0.3 * torch.randn(2, 1, 4096, generator=g)
    revive = torch.randint(0, 2 * 4096 // 8, (2, 32), generator=g)
    cpu = tiny_gan_trainer(cfg, "cpu")
    card = tiny_gan_trainer(cfg, dev, cpu.discriminator.state_dict())
    out = dict(loss_rel_err=0.0, grad_rel_err=0.0, state_close_share=1.0)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for step in range(3):
            card.model.load_state_dict(cpu.model.state_dict())
            card.discriminator.load_state_dict(cpu.discriminator.state_dict())
            auxs = [w.train_step(audio.to(w.device), revive_indices=revive.to(w.device))
                    for w in (cpu, card)]
            if not all(math.isfinite(float(v)) for v in auxs[1].values()):
                raise AssertionError(f"small codec step {step}: losses {auxs[1]}")
            out["loss_rel_err"] = max(out["loss_rel_err"], *(
                abs(float(auxs[1][k]) - float(v)) / max(abs(float(v)), 1e-6)
                for k, v in auxs[0].items()))
            pick = (lambda w: w.disc_params) if step == 1 else (lambda w: w.params)
            out["grad_rel_err"] = max(out["grad_rel_err"], grad_rel_errs(pick(card), pick(cpu))[2])
            qc, qg = (w.model.bottleneck.quantizer for w in (cpu, card))
            if not bool(qg.initted):
                raise AssertionError("small codec: the card's quantizer is not initted")
            for n in ("codebooks", "ema_sums", "ema_counts"):
                want, got = getattr(qc, n), getattr(qg, n).cpu()
                err = (got - want).abs()
                if err.dim() == 3:
                    err = err.amax(dim=-1)
                close = (err <= 1e-3 * want.abs().max()).float().mean().item()
                out["state_close_share"] = min(out["state_close_share"], close)
        card.model.load_state_dict({k: v for k, v in cpu.model.state_dict().items()
                                    if ".quantizer." not in k}, strict=False)
        with torch.no_grad():
            ec, eg = (w.model.encoder(audio.to(w.device)).cpu() for w in (cpu, card))
            ic, ig = (w.model.encode(audio.to(w.device), return_info=True)[1]
                      ["quantizer_indices"].cpu() for w in (cpu, card))
        out["encoded_rel_err"] = (eg - ec).abs().max().item() / ec.abs().max().item()
        out["codes_equal_share"] = (ic == ig).float().mean().item()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def codec_wgrad_shapes(batch: int = 4) -> dict:
    """{(Ci, Co, k, L, 0): launches} of row 11 plain in one codec generator
    step at batch x the config's sample_size, read from the shipped model
    on the meta device under the bf16 compute dtype: each tower runs bf16 up
    to its LSTM, and each stride-1 conv there (the encoder's conv_in and its
    residual blocks' convs and shortcuts, the decoder's conv_in on the bf16
    latents) pads x itself and takes `conv1d_wgrad` for its weight gradient;
    the strided and transposed convs and the f32 layers after the LSTMs are
    cuDNN's (models/seanet.py). The discriminator step launches no
    hand-written kernel."""
    import collections

    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
    from stable_audio_tools_tpu_torch.models.seanet import EncodecConv1d

    cfg = codec_config()
    model = create_model_from_config(cfg, "meta")
    shapes = collections.Counter()

    def hook(m, i, o):
        if m.stride == 1 and i[0].dtype == torch.bfloat16:
            if m.dilation != 1:
                raise AssertionError(f"a dilated conv ({m.dilation}) in the codec")
            k = m.kernel_size
            shapes.update([(*m.conv.weight_v.shape[1::-1], k, i[0].shape[-1] + k - 1, 0)])

    for m in model.modules():
        if isinstance(m, EncodecConv1d):
            m.register_forward_hook(hook)
    bf16 = dict(device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        latents = model.encoder(torch.empty(batch, 1, cfg["sample_size"], **bf16))
        model.decoder(latents.to(torch.bfloat16))
    return dict(shapes)


def phase_codec_training(dev) -> dict:
    """Phase 14: the tiny codec card vs CPU (the codebook update included),
    then the shipped EnCodec config at full width, batch 4 x 32,000."""
    t_phase = time.perf_counter()
    small = small_codec_check(dev)
    # f32 on both sides, other summation orders: the losses and the
    # encoder's output within 1e-3, the gradients (through the A-weighted
    # STFT losses, which amplify f32 differences) within 1e-2; every
    # codeword within 1e-3 at every step (each step starts from the CPU's
    # state), and 99% of the codes equal
    small_tol = dict(loss_rel_err=1e-3, encoded_rel_err=1e-3, grad_rel_err=1e-2)
    if not (all(small[k] <= t for k, t in small_tol.items())
            and small["state_close_share"] == 1.0 and small["codes_equal_share"] >= 0.99):
        raise AssertionError(f"small codec card vs CPU (f32, TF32 off): {small} > {small_tol}, "
                             "or a codeword not close or fewer than 99% of the codes equal")
    cfg = codec_config()
    counts = dict(gen={"conv1d_wgrad": sum(codec_wgrad_shapes().values())}, disc={})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codec_") as tmp:
        data = write_dataset(tmp, 40, 2, 0.1, sr=cfg["sample_rate"], channels=1)
        rec = gan_training(dev, cfg, tmp, data, counts["gen"], counts["disc"])
    rec.update(small=small, small_tol=small_tol, counts=counts,
               phase_s=time.perf_counter() - t_phase)
    return rec


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
        + "".join(f" [route {k}: {v['ms']:.4f} ms, rel err {v['max_rel_err']:.3g}]"
                  for k, v in r.get("routes", {}).items())
        for n, r in rec.items()), flush=True)
    bwd = rec["flash_attention_prefix_bwd"]
    print("phase 2 flash backward (ms; bound; SDPA's backward in this call): " + "; ".join(
        f"{r['shape'].split(' bf16')[0]} " + ", ".join(
            f"{k} {v['ms']:.4f}" for k, v in r["routes"].items())
        + f" ({r['bound_ms']:.4f} by {r['bound_by']}; SDPA {r['library_ms']:.4f})"
        for r in (bwd, bwd["sa2_training_shape"]))
        + f"; route {bwd['main_route']} bit-identical on two runs: "
        f"{bwd['deterministic'] and bwd['sa2_training_shape']['deterministic']}; ptxas "
        + ", ".join(f"{n} {r['registers']} regs {r['spill_stores']} B spilled"
                    for n, r in bwd["ptxas"].items()) + f" on {card}", flush=True)
    print("phase 2 flash forward: ptxas " + ", ".join(f"{n} {r['registers']} regs {r['spill_stores']} B spilled"
                                 for n, r in rec["flash_attention"]["ptxas"].items())
        + f"; launch-sized rows, profiler device us a call (library): " + ", ".join(
            f"{n} {rec[n]['profiled']['device_us']:.2f} ({rec[n]['library_profiled']['device_us']:.2f})"
            for n in ("flash_attention_prefix", "flash_attention", "fused_layer_norm"))
        + f"; fused_layer_norm host us a call {rec['fused_layer_norm']['host_us']:.1f} "
        f"(F.layer_norm {rec['fused_layer_norm']['library_host_us']:.1f}) on {card}", flush=True)
    carry = rec["snake_conv1d"]
    print("phase 2 snake-conv A/B (k=7, ms; row 3 | row 12 | row 12 | row 3; F.conv1d alone on "
          "the pre-snaked input; bound): " + "; ".join(
              f"{r['shape']} {r['row3_ms'][0]:.4f} | {r['carry_ms'][0]:.4f} | "
              f"{r['carry_ms'][1]:.4f} | {r['row3_ms'][1]:.4f}; {r['conv_only_ms']:.4f}; "
              f"{r['bound_ms']:.4f} (strips of {r['strip_tiles']} tiles, carry {r['carried']})"
              for r in [carry["ab"]["timed"], *carry["ab"]["sa2_levels"]])
          + f"; row 12 vs row 3: {json.dumps(carry['vs_row3'])} on {card}", flush=True)
    print("phase 2 snake-conv row 3, k=1 + residual at SA-2.0's decode levels (ms; F.conv1d "
          "k=1 on the pre-snaked input + the residual; byte bound): " + "; ".join(
              f"{r['shape']} {r['ms']:.4f}; {r['conv_plus_res_ms']:.4f}; {r['bound_ms']:.4f}"
              for r in rec["snake_conv1d_res"]["sa2_levels"])
          + "; ptxas " + ", ".join(f"{n} {r['registers']} regs {r['spill_stores']} B spilled"
                                   for n, r in carry["ptxas"].items()) + f" on {card}",
          flush=True)
    dxr, wr = rec["snake_conv1d_dx"], rec["snake_conv1d_wgrad"]
    print("phase 2 snake-conv backward at the VAE generator step's shapes (ms; row 10 | row 11; "
          "cuDNN's conv1d_input | conv1d_weight on the pre-snaked input; bounds; launches a "
          "step): " + "; ".join(
              f"{p['shape']} {p['dx_ms']:.4f} | {q['wgrad_ms']:.4f}; {p['conv1d_input_ms']:.4f} | "
              f"{q['conv1d_weight_ms']:.4f}; {p['dx_bound_ms']:.4f} | {q['wgrad_bound_ms']:.4f}; "
              f"x{p['launches']}" for p, q in zip(dxr["levels"], wr["levels"]))
          + "; a generator step: row 10 {ms:.3f} ({conv1d_input_ms:.3f}, bound {bound_ms:.3f}), "
          .format(**dxr["generator_step"])
          + "row 11 {ms:.3f} ({conv1d_weight_ms:.3f}, bound {bound_ms:.3f}), shares ".format(
              **wr["generator_step"])
          + f"{dxr['generator_step']['share_of_bound']:.3f} | "
          f"{wr['generator_step']['share_of_bound']:.3f} on {card}", flush=True)

    for step, what in (("dance_step", "a Dance"), ("codec_step", "a codec generator")):
        dw = rec["conv1d_wgrad"][step]
        print(f"phase 2 row 11 plain (conv1d_wgrad) at {what} training step's shapes, batch 4 "
              "(ms back to back; torch.nn.grad.conv1d_weight; bound; launches a step): "
              + "; ".join(f"{c['shape']} {c['ms']:.4f}; {c['conv1d_weight_ms']:.4f}; "
                          f"{c['bound_ms']:.4f}; x{c['launches']}" for c in dw["levels"])
              + f"; a step ({dw['launches']} launches): {dw['ms']:.3f} ms (conv1d_weight "
              f"{dw['conv1d_weight_ms']:.3f}, bound {dw['bound_ms']:.3f}, share "
              f"{dw['share_of_bound']:.3f}); max rel err {dw['max_rel_err']:.3g} (tol "
              f"{GRAD_REL_TOL}); every call launched its kernel; on {card}", flush=True)

    sf, sb = rec["snake_fused"], rec["snake_fused_bwd"]
    print("phase 2 snake (rows 9 | 4) at the VAE generator step's sites (ms back to back; "
          "kernel ms by the profiler; byte bounds; launches a step): " + "; ".join(
              f"{s['shape']} {s['bwd_ms']:.4f} | {s['fwd_ms']:.4f}; {s['bwd_device_ms']:.4f} | "
              f"{s['fwd_device_ms']:.4f}; {s['bwd_bound_ms']:.4f} | {s['fwd_bound_ms']:.4f}; "
              f"x{s['launches']}" for s in sb["levels"])
          + "; a generator step: row 9 {ms:.4f}, kernels {device_ms:.4f} (bound {bound_ms:.4f}, "
          "shares {share_of_bound:.3f}, {device_share_of_bound:.3f}), ".format(
              **sb["generator_step"])
          + "row 4 {ms:.4f}, kernels {device_ms:.4f} (bound {bound_ms:.4f}, shares "
          "{share_of_bound:.3f}, {device_share_of_bound:.3f}); ".format(**sf["generator_step"])
          + "row 4 a decode group {ms:.4f} (bound {bound_ms:.4f}, share "
          "{share_of_bound:.3f}); two backward calls bit-identical at every site on ".format(
              **sf["decode_group"]) + card, flush=True)

    def sa1_cases(entry):
        return "; ".join(
            f"{path}: " + ", ".join(f"{c['shape']} {c['ms']:.4f}" for c in p["cases"])
            + " (sum of {launches} launches {ms:.3f} ms, bound {bound_ms:.3f}, share "
            "{share_of_bound:.3f})".format(**p["total"]) for path, p in entry.items())

    lnr = rec["fused_layer_norm"]["sa1_f32"]
    print("phase 2 SA-1.0 shapes (ms back to back): row 12 " + sa1_cases(rec["snake_conv1d"]["sa1"])
          + "; row 3 " + sa1_cases(rec["snake_conv1d_res"]["sa1"]) + "; row 4 (beta = alpha) "
          + sa1_cases(rec["snake_fused"]["sa1"]) + "; row 2 f32 " + ", ".join(
              f"{c['shape'].split(' f32')[0]} {c['ms']:.4f} (F.layer_norm {c['library_ms']:.4f}, "
              f"bound {c['bound_ms']:.4f}, x{c['launches']})" for c in lnr["cases"])
          + " (a UNet forward's {launches} launches {ms:.3f} ms, F.layer_norm {library_ms:.3f}, "
          "bound {bound_ms:.3f})".format(**lnr["unet_forward"]) + f" on {card}", flush=True)

    def dac_sums(name):
        dx, wg = (rec[k]["dac"][name]["generator_step"]
                  for k in ("snake_conv1d_dx", "snake_conv1d_wgrad"))
        pl, s9 = rec["conv1d_wgrad"]["dac"][name], rec["snake_fused_bwd"]["dac"][name]
        return (f"{name}: row 10 x{dx['launches']} {dx['dx_ms']:.3f} ms (conv1d_input "
                f"{dx['conv1d_input_ms']:.3f}, bound {dx['dx_bound_ms']:.3f}, share "
                f"{dx['share_of_bound']:.3f}), row 11 x{wg['launches']} {wg['wgrad_ms']:.3f} "
                f"(conv1d_weight {wg['conv1d_weight_ms']:.3f}, bound {wg['wgrad_bound_ms']:.3f}, "
                f"share {wg['share_of_bound']:.3f}), row 11 plain x{pl['launches']} "
                f"{pl['ms']:.4f} (conv1d_weight {pl['conv1d_weight_ms']:.4f}, bound "
                f"{pl['bound_ms']:.4f}), row 9 x{s9['launches']} {s9['bwd_ms']:.4f} (bound "
                f"{s9['bwd_bound_ms']:.4f}, share {s9['share_of_bound']:.3f})")

    print("phase 2 DAC VAE-GAN generator-step shapes, batch 4 x 65536, alpha as beta (summed "
          "over a step's launches, ms back to back): " + "; ".join(dac_sums(n) for n in DAC_VAES)
          + "; cases (row 10 | row 11; conv1d_input | conv1d_weight) " + ", ".join(
              f"{c['shape']} {c['dx_ms']:.4f} | {q['wgrad_ms']:.4f}; {c['conv1d_input_ms']:.4f}"
              f" | {q['conv1d_weight_ms']:.4f}" for c, q in zip(
                  rec["snake_conv1d_dx"]["dac"]["cases"], rec["snake_conv1d_wgrad"]["dac"]["cases"]))
          + f"; every call launched its kernel; on {card}", flush=True)

    main_rec = phase_main_path(dev)
    print(f"phase 3 generation: SA-Open {main_rec['params'] / 1e9:.3f}B params, {STEPS} steps "
          f"dpmpp-3m-sde cfg 6, {SAMPLE_SIZE} samples: wall {main_rec['wall_s']:.3f} s, "
          f"{main_rec['audio_s_per_s']:.3f} audio-s/s, peak {main_rec['peak_gib']:.2f} GiB, "
          f"launches {json.dumps(main_rec['launches'])}, small card-vs-CPU rel err "
          f"{main_rec['small_err']:.3g} (tol {main_rec['small_tol']:.3g}) on {card}", flush=True)
    torch.cuda.empty_cache()

    train_rec = phase_training(dev)
    split = train_rec["split"]
    print(f"phase 4 training: SA-Open {train_rec['trainable_params'] / 1e9:.3f}B trainable of "
          f"{train_rec['params'] / 1e9:.3f}B, batch {TRAIN_BATCH} x {SAMPLE_SIZE} samples: step "
          f"{train_rec['step_ms_median']:.1f} ms median of {TIMED_STEPS} "
          f"({', '.join(f'{x:.1f}' for x in train_rec['step_ms'])}), "
          f"{train_rec['audio_s_per_s']:.2f} audio-s trained/s, peak {train_rec['peak_gib']:.2f} GiB, "
          f"losses {', '.join(f'{x:.4g}' for x in train_rec['losses'])}; split ms "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in split.items()
                      if k.endswith("_ms") and isinstance(v, float))
          + f"; fwd+bwd device busy {split['fwd_bwd_device_busy']:.1%}; launches "
          f"{json.dumps(train_rec['launches'])}; checkpoint {train_rec['ckpt_gib']:.2f} GiB saved "
          f"{train_rec['save_s']:.1f} s, reloaded identical {train_rec['reload_s']:.1f} s; small "
          f"card-vs-CPU step: loss rel err {train_rec['small']['loss_rel_err']:.3g}, grad rel err "
          f"{train_rec['small']['grad_rel_err']:.3g} (tol {train_rec['small_tol']}) on {card}",
          flush=True)

    torch.cuda.empty_cache()

    sa2_rec = phase_sa2(dev)
    bd = sa2_rec["breakdown"]
    print(f"phase 5 SA-2.0 generation: {sa2_rec['params'] / 1e9:.3f}B params, {STEPS} steps "
          f"dpmpp-3m-sde cfg 6, {SA2_SAMPLE_SIZE} samples (6144 latents, chunked decode): wall "
          f"{sa2_rec['wall_s']:.3f} s, {sa2_rec['audio_s_per_s']:.3f} audio-s/s, peak "
          f"{sa2_rec['peak_gib']:.2f} GiB; conditioning {bd['cond_ms']:.1f} ms, sampler step "
          f"{bd['step_ms']:.1f} ms (device busy {bd['step_device_busy']:.1%}), decode "
          f"{bd['decode_ms']:.1f} ms (device busy {bd['decode_device_busy']:.1%}); step's top "
          f"kernels ms {json.dumps(bd['step_top_kernels_ms'])}; launches "
          f"{json.dumps(sa2_rec['launches'])}; small card-vs-CPU rel errs "
          f"{json.dumps({k: round(v, 4) for k, v in sa2_rec['small'].items()})} "
          f"(tol {sa2_rec['small_tol']}) on {card}", flush=True)

    torch.cuda.empty_cache()

    def gan_line(r):
        sp = r["split"]
        return (f"{r['params'] / 1e6:.1f}M params + discriminator {r['disc_params'] / 1e6:.2f}M: "
                f"pair {r['pair_ms_median']:.1f} ms median of {GAN_TIMED_PAIRS} "
                f"({', '.join(f'{x:.1f}' for x in r['pair_ms'])}), gen step "
                f"{r['gen_ms_median']:.1f} ms, disc step {r['disc_ms_median']:.1f} ms, "
                f"{r['audio_s_per_s']:.2f} audio-s trained/s, peak {r['peak_gib']:.2f} GiB; "
                "gen step split ms " + ", ".join(
                    f"{k[:-3]} {v:.1f}" for k, v in sp.items()
                    if k.endswith("_ms") and isinstance(v, float))
                + f"; gen step device busy {sp['gen_step_device_busy']:.1%}, top kernels ms "
                f"{json.dumps(sp['gen_step_top_kernels_ms'])}; launches "
                f"{json.dumps({k: v for k, v in r['launches'].items() if v})}; checkpoint "
                f"{r['ckpt_gib']:.2f} GiB reloaded identical, resumed {r['resumed_steps']} steps")

    ae_rec = phase_ae_training(dev)
    print(f"phase 6 AE training: stable_audio_2_0_vae.json, batch {AE_BATCH} x 65536, bf16: "
          f"{gan_line(ae_rec)}; small card-vs-CPU {json.dumps(ae_rec['small'])} (tol "
          f"{ae_rec['small_tol']} at gains x {SMALL_AE_GAIN}; at the init's, the card within "
          f"{GAN_SPREAD}x the CPU's bf16 distance from f32) on {card}", flush=True)

    torch.cuda.empty_cache()

    lmg = phase_lm_generation(dev)
    print(f"phase 7 LM generation: MusicGen-small {lmg['params'] / 1e9:.3f}B params, batch 1, "
          f"cfg {LM_CFG}, top_k {LM_TOP_K}, {LM_FRAMES} frames = {LM_SAMPLES} samples at "
          f"{LM_SR} Hz: " + "; ".join(
              f"{k} {r['wall_s']:.3f} s wall, {r['ms_per_step']:.2f} ms/step over {r['steps']} "
              f"steps, {r['audio_s_per_s']:.3f} audio-s/s, peak {r['peak_gib']:.2f} GiB, "
              f"launches {json.dumps(r['launches'])}; under the profiler "
              f"{r['profile']['wall_ms']:.2f} ms/step, device {r['profile']['device_ms']:.2f} "
              f"ms/step (busy {r['profile']['device_busy']:.1%}), "
              f"{r['profile']['kernel_launches']:.0f} kernels/step, runtime calls/step "
              f"{json.dumps({n: round(c['count'], 1) for n, c in r['profile']['runtime_calls'].items()})}"
              for k, r in ((k, lmg[k]) for k in ("cached", "full")))
          + f"; the codec's decode of {LM_FRAMES} frames {lmg['decode_ms']:.1f} ms; small "
          f"card-vs-CPU "
          f"{json.dumps({k: round(v, 4) for k, v in lmg['small'].items()})} "
          f"(tol {lmg['small_tol']}) on {card}", flush=True)

    torch.cuda.empty_cache()

    lmt = phase_lm_training(dev)
    split = lmt["split"]
    print(f"phase 8 LM training: MusicGen-small {lmt['trainable_params'] / 1e9:.3f}B trainable "
          f"of {lmt['params'] / 1e9:.3f}B, batch {LM_BATCH} x {LM_SAMPLES} samples, bf16: step "
          f"{lmt['step_ms_median']:.1f} ms median of {LM_TIMED_STEPS} "
          f"({', '.join(f'{x:.1f}' for x in lmt['step_ms'])}), "
          f"{lmt['audio_s_per_s']:.2f} audio-s trained/s, peak {lmt['peak_gib']:.2f} GiB, "
          f"losses {', '.join(f'{x:.4g}' for x in lmt['losses'])}; split ms "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in split.items()
                      if k.endswith("_ms") and isinstance(v, float))
          + f"; fwd+bwd device busy {split['fwd_bwd_profile']['device_busy']:.1%}, "
          f"{split['fwd_bwd_profile']['kernel_launches']:.0f} kernels; top kernels ms "
          f"{json.dumps(split['fwd_bwd_profile']['top_kernels_ms'])}; launches "
          f"{json.dumps(lmt['launches'])}; checkpoint {lmt['ckpt_gib']:.2f} GiB reloaded "
          f"identical; small card-vs-CPU step {json.dumps(lmt['small'])} "
          f"(tol {lmt['small_tol']}) on {card}", flush=True)

    torch.cuda.empty_cache()

    sa2t = phase_sa2_training(dev)
    split, enc, aud = sa2t["split"], sa2t["pre_encode"], sa2t["from_audio"]
    print(f"phase 9 SA-2.0 training: {sa2t['trainable_params'] / 1e9:.3f}B trainable of "
          f"{sa2t['params'] / 1e9:.3f}B; 9a pre-encode {enc['items']} clips of "
          f"{SA2_SAMPLE_SIZE} samples: {enc['encode_ms_median']:.1f} ms/clip median "
          f"({', '.join(f'{x:.1f}' for x in enc['encode_ms'])}), wall {enc['wall_s']:.1f} s, "
          f"peak {enc['peak_gib']:.2f} GiB, one clip under the profiler "
          f"{enc['clip_profile']['wall_ms']:.1f} ms, busy {enc['clip_profile']['device_busy']:.3f}, "
          f"top kernels ms {json.dumps(enc['clip_profile']['top_kernels_ms'])}; "
          f"9b from latents, batch {SA2_TRAIN_BATCH} x "
          f"{SA2_LATENTS} latents, mask_padding: step {sa2t['step_ms_median']:.1f} ms median of "
          f"{TIMED_STEPS} ({', '.join(f'{x:.1f}' for x in sa2t['step_ms'])}), "
          f"{sa2t['audio_s_per_s']:.2f} audio-s trained/s, peak {sa2t['peak_gib']:.2f} GiB, "
          f"losses {', '.join(f'{x:.4g}' for x in sa2t['losses'])}; split ms "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in split.items()
                      if k.endswith("_ms") and isinstance(v, float))
          + f"; fwd+bwd device busy {split['fwd_bwd_device_busy']:.1%}; top kernels ms "
          f"{json.dumps(split['fwd_bwd_top_kernels_ms'])}; launches "
          f"{json.dumps({k: v for k, v in sa2t['launches'].items() if v})}; checkpoint "
          f"{sa2t['ckpt_gib']:.2f} GiB saved {sa2t['save_s']:.1f} s, reloaded identical; 9c from "
          f"audio, batch 1 x {SA2_SAMPLE_SIZE}: encode {aud['encode_ms']:.1f} ms, step "
          f"{', '.join(f'{x:.1f}' for x in aud['step_ms'])} ms, peak {aud['peak_gib']:.2f} GiB, "
          f"losses {', '.join(f'{x:.4g}' for x in aud['losses'])}; small card-vs-CPU step "
          f"{json.dumps(sa2t['small'])} (tol {sa2t['small_tol']}) on {card}", flush=True)

    torch.cuda.empty_cache()

    dance = phase_dance(dev)
    dg, dt = dance["generation"], dance["training"]
    print(f"phase 10 Dance Diffusion: BASELINE (b) dance_diffusion_base_16k "
          f"{dg['params'] / 1e6:.1f}M params, bf16; generation batch 1, {STEPS} steps "
          f"dpmpp-2m-sde, {DANCE_SAMPLE_SIZE} samples at {DANCE_SR} Hz: wall "
          f"{dg['wall_s']:.3f} s, {dg['audio_s_per_s']:.3f} audio-s/s, peak "
          f"{dg['peak_gib']:.2f} GiB, sampler step {dg['step_ms']:.2f} ms (profiled "
          f"{dg['step_profile']['wall_ms']:.2f} ms, device busy "
          f"{dg['step_profile']['device_busy']:.1%}, "
          f"{dg['step_profile']['kernel_launches']:.0f} kernels; top kernels ms "
          f"{json.dumps(dg['step_profile']['top_kernels_ms'])}); training batch {DANCE_BATCH} x "
          f"{DANCE_SAMPLE_SIZE}: step {dt['step_ms_median']:.1f} ms median of {TIMED_STEPS} "
          f"({', '.join(f'{x:.1f}' for x in dt['step_ms'])}), {dt['audio_s_per_s']:.2f} "
          f"audio-s trained/s, peak {dt['peak_gib']:.2f} GiB, losses "
          f"{', '.join(f'{x:.4g}' for x in dt['losses'])}; conv1d_wgrad "
          f"{dt['wgrad_launches_per_step']} launches a step = {dt['conv_sites']} stride-1 convs "
          f"of the model; fwd+bwd profiled {dt['fwd_bwd_profile']['wall_ms']:.1f} ms, device "
          f"busy {dt['fwd_bwd_profile']['device_busy']:.1%}, "
          f"{dt['fwd_bwd_profile']['kernel_launches']:.0f} kernels, row 11 "
          f"{dt['fwd_bwd_profile']['conv1d_wgrad_ms']:.2f} ms, top kernels ms "
          f"{json.dumps(dt['fwd_bwd_profile']['top_kernels_ms'])}; checkpoint "
          f"{dt['ckpt_gib']:.2f} GiB reloaded identical; small card-vs-CPU "
          f"{json.dumps(dance['small'])} (spread {DANCE_SPREAD}) on {card}", flush=True)

    torch.cuda.empty_cache()

    sa1 = phase_sa1(dev)
    prof, dprof, enc = sa1["step_profile"], sa1["decode_profile"], sa1["encode"]
    print(f"phase 11 SA-1.0 generation: stable_audio_1_0.json, UNet "
          f"{sa1['params']['unet'] / 1e6:.1f}M params (f32), DAC decoder "
          f"{sa1['params']['decoder'] / 1e6:.1f}M / encoder {sa1['params']['encoder'] / 1e6:.1f}M "
          f"(bf16), {STEPS} steps dpmpp-3m-sde cfg 6, {SA1_SAMPLE_SIZE} samples (4096 latents): "
          f"wall {sa1['wall_s']:.3f} s, {sa1['audio_s_per_s']:.3f} audio-s/s, peak "
          f"{sa1['peak_gib']:.2f} GiB, {sa1['unet_calls']} UNet calls; sampler step "
          f"{sa1['step_ms']:.2f} ms back to back (profiled {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy']:.1%}, {prof['kernel_launches']:.0f} kernels; top kernels ms "
          f"{json.dumps(prof['top_kernels_ms'])}); decode {sa1['decode_ms']:.2f} ms (profiled "
          f"{dprof['wall_ms']:.2f} ms, busy {dprof['device_busy']:.1%}, top kernels ms "
          f"{json.dumps(dprof['top_kernels_ms'])}); encode of one clip {enc['ms']:.2f} ms "
          f"(profiled {enc['profile']['wall_ms']:.2f} ms, busy "
          f"{enc['profile']['device_busy']:.1%}); launches a request "
          f"{json.dumps({k: v for k, v in sa1['launches'].items() if v})}, an encode "
          f"{json.dumps({k: v for k, v in enc['launches'].items() if v})} (counted from the "
          f"model: {json.dumps(sa1['counts'])}); small card-vs-CPU "
          f"{json.dumps({k: round(v, 4) for k, v in sa1['small'].items()})} (tol "
          f"{sa1['small_tol']}; the codec within {DANCE_SPREAD}x the CPU's bf16); phase "
          f"{sa1['phase_s']:.1f} s on {card}", flush=True)

    torch.cuda.empty_cache()

    sa1t = phase_sa1_training(dev)
    split, prof = sa1t["split"], sa1t["split"]["fwd_bwd_profile"]
    print(f"phase 12 SA-1.0 training: stable_audio_1_0.json, "
          f"{sa1t['trainable_params'] / 1e6:.1f}M trainable of {sa1t['params'] / 1e6:.1f}M "
          f"(the UNet f32), batch {SA1_TRAIN_BATCH} x {SA1_SAMPLE_SIZE} samples: step "
          f"{sa1t['step_ms_median']:.1f} ms median of {TIMED_STEPS} "
          f"({', '.join(f'{x:.1f}' for x in sa1t['step_ms'])}), "
          f"{sa1t['audio_s_per_s']:.2f} audio-s trained/s, peak {sa1t['peak_gib']:.2f} GiB, "
          f"losses {', '.join(f'{x:.4g}' for x in sa1t['losses'])}; split ms "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in split.items()
                      if k.endswith("_ms") and isinstance(v, float))
          + f"; the step on a held batch {', '.join(f'{x:.1f}' for x in split['held_batch_step_ms'])}"
          f" ms (allocator retries {split['alloc_retries']})"
          + f"; fwd+bwd profiled {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy']:.1%}, {prof['kernel_launches']:.0f} kernels, top kernels ms "
          f"{json.dumps(prof['top_kernels_ms'])}; launches {json.dumps(sa1t['launches'])} "
          f"(a step: row 2 {sa1t['counts']['unet_forward']['fused_layer_norm']}, rows 12 / 3 / "
          f"4 x {SA1_TRAIN_BATCH} clips); checkpoint {sa1t['ckpt_gib']:.2f} GiB saved "
          f"{sa1t['save_s']:.1f} s, reloaded identical {sa1t['reload_s']:.1f} s, resumed "
          f"{sa1t['resumed_steps']} step; small card-vs-CPU step {json.dumps(sa1t['small'])} "
          f"(tol {sa1t['small_tol']}); phase {sa1t['phase_s']:.1f} s on {card}", flush=True)

    torch.cuda.empty_cache()

    dac = phase_dac_training(dev)
    print("phase 13 DAC VAE-GAN training, batch 4 x 65536, bf16: " + "; ".join(
        f"{n}: {gan_line(dac[n])}; small card-vs-CPU {json.dumps(dac[n]['small'])} (tol "
        f"{dac[n]['small_tol']} at gains x {SMALL_AE_GAIN}; at the init's, the card within "
        f"{GAN_SPREAD}x the CPU's bf16 distance from f32)" for n in DAC_VAES)
        + f"; phase {dac['phase_s']:.1f} s on {card}", flush=True)

    torch.cuda.empty_cache()

    codec = phase_codec_training(dev)
    print(f"phase 14 codec training: encodec_musicgen_rvq.json, batch 4 x 32000, bf16 to the "
          f"LSTM: {gan_line(codec)}; hand-written kernels a generator step "
          f"{json.dumps(codec['counts']['gen'])}, none in the discriminator step; small "
          f"card-vs-CPU (f32, TF32 off) {json.dumps(codec['small'])} (tol "
          f"{codec['small_tol']}); phase {codec['phase_s']:.1f} s on {card}", flush=True)

    torch.cuda.empty_cache()

    kernels = []
    for n, r in rec.items():
        by_path = {"generation": main_rec["launches"].get(n, 0),
                   "training": train_rec["launches"].get(n, 0),
                   "sa2_generation": sa2_rec["launches"].get(n, 0),
                   "ae_training": ae_rec["launches"].get(n, 0),
                   "lm_generation_cached": lmg["cached"]["launches"].get(n, 0),
                   "lm_generation_full": lmg["full"]["launches"].get(n, 0),
                   "lm_training": lmt["launches"].get(n, 0),
                   "sa2_training": sa2t["launches"].get(n, 0),
                   "sa2_pre_encode": sa2t["pre_encode"]["launches"].get(n, 0),
                   "dance_generation": dg["launches"].get(n, 0),
                   "dance_training": dt["launches"].get(n, 0),
                   "sa1_generation": sa1["launches"].get(n, 0),
                   "sa1_encode": sa1["encode"]["launches"].get(n, 0),
                   "sa1_training": sa1t["launches"].get(n, 0),
                   **{f"{name}_training": dac[name]["launches"].get(n, 0) for name in DAC_VAES},
                   "codec_training": codec["launches"].get(n, 0)}
        kernels.append(dict(name=n, route=r["route"], source=r["source"], replaces=r["replaces"],
                            launches=sum(by_path.values()), launches_by_path=by_path,
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], library=r["library"],
                            shape=r["shape"], **{k: r[k] for k in (
                                "also_replaces", "main_route", "routes", "max_rel_err",
                                "autograd_rel_err", "errs", "ab", "shapes", "banded", "vs_row3",
                                "autograd_errs", "fwd_bwd_ms", "sa2_training_shape",
                                "deterministic", "ptxas", "profiled", "library_profiled",
                                "host_us", "library_host_us", "no_grad_bit_identical",
                                "levels", "generator_step", "decode_group", "dance_step",
                                "sa1", "sa1_f32", "dac")
                                if k in r}))
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    if unlaunched:
        raise AssertionError(f"kernels that no main path launched: {unlaunched}")
    print(json.dumps({"kernels": kernels, "card": card, "generation": {
        k: main_rec[k] for k in ("wall_s", "steps", "audio_s_per_s", "peak_gib", "breakdown")},
        "training": {k: v for k, v in train_rec.items() if k != "launches"},
        "sa2_generation": {k: sa2_rec[k] for k in (
            "wall_s", "steps", "audio_s_per_s", "peak_gib", "breakdown", "small")},
        "ae_training": {k: v for k, v in ae_rec.items() if k != "launches"},
        "lm_generation": lmg, "lm_training": {k: v for k, v in lmt.items() if k != "launches"},
        "sa2_training": {k: v for k, v in sa2t.items() if k != "launches"},
        "dance": {"small": dance["small"],
                  "generation": {k: v for k, v in dg.items() if k != "launches"},
                  "training": {k: v for k, v in dt.items() if k != "launches"}},
        "sa1_generation": {k: v for k, v in sa1.items() if k != "launches"},
        "sa1_training": {k: v for k, v in sa1t.items() if k != "launches"},
        "dac_training": {n: {k: v for k, v in dac[n].items() if k != "launches"}
                         for n in DAC_VAES},
        "codec_training": {k: v for k, v in codec.items() if k != "launches"}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
