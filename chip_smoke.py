"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 2,4,6]

Runs from the repository root on a machine with a CUDA card and `nvcc`;
needs no network, no Triton and no JAX. Eighteen phases, each printing one
line (phases 2, 17 and 18 several); any failure raises and the exit code is nonzero.
`--phases` (for development runs) runs phase 1 and the phases named, with
all their checks, and ends on `{"ok": true, "partial": [...]}`, the phases
run; without it every phase runs, and the kernels' record, the check that
every kernel launched on some path and the device line close the run:

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
   mask, and `flash_attention_nhd`'s causal backward at [1, 4096, 16, 64];
   at the TAAE's four windowed training shapes (TAAE_FLASH_SHAPES, batch 4,
   1 to 8 heads of 128 over 32,768 to 128 rows, window (31, 32)) rows 5 and
   6 (both routes) against a banded plain version that walks the queries
   in chunks, timed beside it, SDPA with the band as a mask (up to 8,192
   rows) and the bound.
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
   1 warm-up step and 3 timed ones. Every loss must be finite, every
   trainable parameter's gradient finite and not all zero, the parameters
   and the EMA must move, and every kernel of the path must launch (the
   flash backward among them). Then the training entry as users
   run it, on the same trainer through `train.parse_args` / `configure`: a
   further `fit` with validation on the WAVs every 2 steps, a checkpoint
   every 2 steps with `--save-top-k 1` (exactly one file left) and the
   config's own demo (its prompt, cfg 3 / 6 / 9, 2,097,152 samples;
   DEMO_STEPS sampler steps) every 2 steps: the demo's launches pinned
   (rows 1 / 2 24 / 72 a sampler step, rows 12 / 3 / 4 16 / 15 / 5 a
   decode, a cfg scale each), its wavs finite and not silent, `val/` in the
   log and no `demo/error`; `--recover` after one more step restores the
   newest checkpoint bit for bit and trains on; `unwrap_model` writes the
   EMA model and a fresh full-width build loads it through
   `--pretrained-ckpt-path` (0 skipped, every tensor equal) and its VAE
   through `--pretransform-ckpt-path`.

5. SA-2.0 generation: a tiny SA-2.0-shaped model (CLAP text tower read from
   a checkpoint, strided-layout attention, chunked decode over three chunks)
   must agree between the card and the CPU, and serve an inpainting and an
   init-audio request; then the shipped stable_audio_2_0.json at full width
   with `pretransform.chunked`, its CLAP tower read from a seeded random
   RoBERTa-base state dict written to a temporary file, runs one request:
   cfg 6, dpmpp-3m-sde, 100 steps, 12,582,912 samples (6144 latents, 64
   decode chunks). The audio must be finite [1, 2, 12582912], the path must
   launch `flash_attention_nhd` 2400 times and every other forward kernel,
   and must not launch `flash_attention_prefix`. Then the Oobleck decode's
   bf16 distance from f32 (`oobleck_bf16_check`: the SA-2.0 VAE decoder's
   five levels at channels 32 with seeded weights, bf16 on the card against
   f32 on the CPU) must stay within twice the JAX package's own
   (OOBLECK_BF16_JAX, measured by tests/test_torch_taae.py).

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
   65,536 samples: 1 warm-up and 3 timed generator + discriminator pairs,
   the pieces of one generator step as the step itself times them, one
   generator step under the profiler, a checkpoint that reloads identical
   and resumes for a pair. Losses must be finite, every
   parameter of each side must get a finite nonzero gradient in its step,
   the parameters and the EMA must move, and the kernels must launch exactly
   as counted from the model. Then the VAE's demo (a batch of reals
   through the EMA autoencoder, the discriminator's sensitivity) and one
   validation pass over the 40 clips (STFT, SI-SDR, mel), each forward
   moving rows 12 / 3 / 4 by 32 / 30 / 10.

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
   with prompts, batch 4 x 320,000 samples: 1 warm-up and 3 timed steps, the
   pieces of one step, its forward+backward under the profiler, a checkpoint
   and its reload. Every LM parameter must get a finite nonzero gradient and
   move, and the kernels must launch exactly as counted from the model.
   Then the config's demo, LM_DEMO_FRAMES frames: finite, not silent.

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
   batch 4 x 6144 latents: 1 warm-up and 3 timed steps, the pieces of one
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
   synthetic 16 kHz stereo WAVs, batch 4 x 65,536: 1 warm-up and 3 timed
   steps, one forward+backward profiled, a checkpoint and its reload. Losses
   and gradients finite, every gradient nonzero, parameters and EMA moved,
   and `conv1d_wgrad` launched once per stride-1 conv of the model a step.
   Then the config's demo (4 clips, DEMO_STEPS steps): finite, not silent,
   no hand-written kernel launched.

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
   s, batch 4 x 4,194,304 samples: 1 warm-up and 3 timed steps, finite
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

15. Rectified flow and ARC at SA-Open's width: the shipped
   stable_audio_open_1_0.json changed in memory only (its objective set to
   `rf_denoiser` or `rectified_flow`, `distribution_shift_options` set to
   the class defaults RF_SHIFT, for inpainting `diffusion_cond_inpaint` with
   input_concat_dim 64 + 1). The four flow samplers of a tiny SA-Open-shaped
   flow model (2 steps each) agree between the card and the CPU within 5%;
   then batch 1, 2,097,152 samples: `rf_denoiser` pingpong 8 steps at cfg 1,
   `rectified_flow` euler 50 at cfg 7, rk4 and dpmpp 4 each, their launches
   pinned (rows 1 / 2 24 / 72 a DiT call, four calls a step for rk4; rows
   12 / 3 / 4 16 / 15 / 5 a decode), and one pingpong request with
   `preview` (8 taps). Then phase 4's set-up (batch 4 x 2,097,152 from the
   synthetic WAVs, remat) under `rectified_flow` with the shift,
   p_one_shot 0.1 and log_loss_info for 1 + 3 steps (rows 1 / 6 / 2 48 /
   24 / 144 a step; every per-sigma bucket finite), the
   `diffusion_cond_inpaint` variant for 2 + 3 steps and its demo at
   DEMO_STEPS steps (its three kinds of output; rows 1 / 2 pinned), and ARC
   from seeded latents [4, 64, 1024] with the config's T5 and number
   conditioning, student and discriminator both the full-width rf DiT: 2
   ODE warm-up steps (8 teacher steps, refreshed each step), generator,
   discriminator, generator, discriminator with the conv head, then one
   discriminator step with the ConvNeXt head; each step's ms, peak GiB,
   finite losses and launches pinned (counted from training/arc.py), and
   row 11 held at the ConvNeXt head's stride-1 conv shapes against its
   plain version.

16. The transformer autoencoder (TAAE): the shipped SA-2.0 VAE config with
   TAAE towers at the JAX classes' defaults (`taae_config`: 156.3 M
   parameters, 24 blocks of heads of 128 under the window (31, 32), ratio
   512), seeded random weights, bf16: (a) one request, encode + decode of
   2,097,152 samples unchunked (4,096 latents), and one of its dithered-FSQ
   variant with the codes decoded by `decode_tokens`: wall, audio-s/s, peak
   GiB, busy share and top kernels, launches pinned (rows 5 / 2 24 / 96);
   (c) tiny card-vs-CPU steps within 5%: the latent mask, the frozen
   encoder and a teacher in one trainer, the dithered FSQ and the
   Wasserstein bottlenecks, and a tiny DiT's forward with the config keys
   no shipped config sets (adaLN, memory tokens, patch_size 2, the
   timestep by input_concat, LayerScale, qk-norm, a window); (b) `gan_phase` of the full config at batch 4 x
   65,536, 1 + 3 pairs (rows 5 / 2 / 6 / 11 plain 24 / 96 / 24 / 4 a
   generator step, 24 / 96 a discriminator step).

17. The diffusion autoencoder and the DAC RVQ codec, built in memory (no
   shipped config names either): (a) `diffae_oobleck_dau` (`diffae_config`:
   the SA-2.0 VAE's Oobleck encoder and VAE bottleneck, bf16 on the card,
   and Dance's 44 kHz DAU1d with cond_dim 64, ratio 2048): one request,
   encode + `decode` in 100 steps of a 65,536-sample stereo clip (rows 12 /
   3 / 4 16 / 15 / 5 an encode; the DAU1d's convs are cuDNN's), training
   at batch 4 x 65,536 through the entry, 2 + 5 steps (rows 12 / 3 / 4 /
   10 / 11 / 9 16 / 15 / 5 / 31 / 31 / 5 and row 11 plain 260 a step), one
   demo at the callback's defaults (2 clips, 50 steps); (b)
   `dac_rvq_2048_32` (`dac_rvq_config`: dac_2048_32_vae.json's towers with
   the 44 kHz DAC's quantizer, 9 codebooks of 1024 x 8): a round trip of
   2,097,152 mono samples through the codes and `decode_tokens`, and
   `gan_training` at batch 4 x 65,536, 2 + 5 pairs, launches counted from the
   towers (`dac_gen_launches`); (c) tiny card-vs-CPU checks within 5%
   (`small_slice19_checks`): a generator and a discriminator step with the
   `rvq_vae`, `dac_rvq_vae`, `dac_rvq` (quantize_on_decode) bottlenecks and
   each decoder's noise augmentation (softnorm with `noise_regularize`), and
   of the DAC towers with a DAC RVQ, a
   training step and a 10-step decode of a tiny diffusion AE on DAU1d
   (cond_noise_aug), `adp_1d` and `dit`, a training step and a 10-step
   request of the unconditional `adp_uncond_1d` and `dit`.
18. The other pretransforms and conditioners: (a) SA-Open with an audio
   prompt through its own VAE (`pretransform`, `use_model_pretransform`,
   `input_concat_dim` 768) and a `list` label (`audio_prompt_config`): one
   request of a 47.6 s stereo prompt, 100 steps, cfg 6 (rows 12 / 3 / 4 in
   the prompt's encode and the decode, rows 1 / 2 in the DiT), and 1 + 3
   training steps at batch 4 through the entry with a metadata module that
   gives 4 clips a prompt and a genre (row 6 too), launches pinned from
   the model (`audio_prompt_launches`); (b) `dac_pretrained` 44 kHz, in
   bf16 on the card: 47.6 s of mono through encode -> decode (chunked) and
   tokenize -> decode_tokens, launches pinned from its towers, and the bf16
   codec held against f32 on the CPU (`dac_f32_divergence`); (c)
   MusicGen-small over `audiocraft_pretrained` encodec_32khz: 5 s
   KV-cached (row 2 pinned); (d) `clap_audio` on HTSAT-base: 4 x 10 s at 48
   kHz, the card against the CPU in f32, no kernel of the port launched;
   (e) `patched`, `pqmf` (16 bands) and `wavelet` (bior4.4, bior3.5) round
   trips of 47.6 s of stereo; (f) the tiny twin's prompt encode, its
   denoiser on the card's own conditioning and on the CPU's, and its decode
   (5%), a 10-step request (twice the CPU's bf16 distance from f32) and a
   training step (5%), card against CPU.

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
    a window in which it recorded no kernel at all, or a number of launches
    that is not a whole multiple of `iters` (it dropped some: 41 of 50 once,
    PR 16 call 4), is read again, up to `tries` windows (`windows` says how
    many were read)."""
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
        if ks and sum(e.count for e in ks) % iters == 0:
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
    taae = taae_flash_checks(fa, randn, F)
    rec["flash_attention"]["taae"] = {n: r["forward"] for n, r in taae.items()}
    rec["flash_attention_prefix_bwd"]["taae"] = {n: r["backward"] for n, r in taae.items()}

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
    # the TAAE's rows at its training batch (4 x 65,536 samples): each
    # block's bias-less pre_norm / ff_norm at epsilon 1e-2 over [4, N, C],
    # and the "ln" qk-norm (scale and bias, epsilon 1e-6) over the split
    # heads [4, C / 128, N, 128] (TAAE_FLASH_SHAPES' [B, H, N], C = 128 H)
    taae = []
    for b, h, n in TAAE_FLASH_SHAPES:
        for shape, beta, eps in (((b, n, 128 * h), False, 1e-2), ((b, h, n, 128), True, 1e-6)):
            xe = randn(*shape, scale=3.0)
            g_ = randn(shape[-1], dtype=torch.float32)
            b_ = randn(shape[-1], dtype=torch.float32) if beta else None
            run = lambda xe=xe, g_=g_, b_=b_, eps=eps: ln.fused_layer_norm(xe, g_, b_, eps)
            ref = ln.fused_layer_norm_plain(xe, g_, b_, eps)
            errs.append(compare(f"TAAE layer norm {list(shape)}", run(), ref, bf16_tol(ref)))
            taae.append(dict(
                shape=f"x {list(shape)} bf16, gamma{' + beta' if beta else ''} f32, eps {eps}",
                max_abs_err=errs[-1], ms=cuda_ms(run, 50),
                plain_ms=cuda_ms(lambda: ln.fused_layer_norm_plain(xe, g_, b_, eps), 20),
                library_ms=cuda_ms(lambda: F.layer_norm(xe, shape[-1:], g_.to(bf),
                                                        None if b_ is None else b_.to(bf), eps),
                                   50),
                **bound(8.0 * xe.numel(), xe, g_, b_, ref)))
    rec["fused_layer_norm"]["taae"] = taae
    rec["fused_layer_norm"]["max_abs_err"] = max(errs)
    rec["fused_layer_norm"]["shape"] += ("; [2,6145,1536], bf16 gamma + beta, [5,1000], [3,100], "
                                         "[7,16384] and the TAAE's rows checked")
    del x2, ref, xe
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
    dac_pretrained_kernel_checks(rec, cs, sn, randn, hold_row3)
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


def dac_pretrained_shapes() -> dict:
    """The forward kernels' shapes of phase 18b's `dac_pretrained` 44 kHz
    codec (`dac_step_shapes` of the port factory's architecture and default
    widths: encoder d_model 64, decoder 1536 channels, latent 1024), batch ->
    shapes: the chunked encode and decode run groups of 8 chunks of 65,536
    samples, tokenize and decode_tokens the whole 2,097,152 at batch 1."""
    from stable_audio_tools_tpu_torch.models.factory import _DAC_ARCHS

    arch = _DAC_ARCHS["44khz"]
    cfg = {"model": {
        "encoder": {"config": {"in_channels": 1, "d_model": 64, "strides": arch["strides"]}},
        "decoder": {"config": {"latent_dim": 1024, "channels": 1536, "rates": arch["dec_rates"],
                               "out_channels": 1}}}}
    return {8: dac_step_shapes(cfg, 128 * arch["ratio"]), 1: dac_step_shapes(cfg, SAMPLE_SIZE)}


def dac_pretrained_kernel_checks(rec, cs, sn, randn, hold_row3) -> None:
    """Rows 12, 3 and 4 at every shape of the 44 kHz DAC codec's passes
    (`dac_pretrained_shapes`: the encoder's 64-channel level takes the
    64-channel output tile, the decoder's conv_out one channel), each
    against its plain version on the card within 2 bf16 ulps, row 12 also
    against row 3; DAC's snake passes alpha as beta. Adds a
    `dac_pretrained` entry (cases, max_abs_err) to each record and folds the
    errors into its max_abs_err."""
    entries = {n: dict(cases=[], max_abs_err=0.0)
               for n in ("snake_conv1d", "snake_conv1d_res", "snake_fused")}

    def note(name, shape, err):
        e = entries[name]
        e["cases"].append(shape)
        e["max_abs_err"] = max(e["max_abs_err"], err)

    for B, shapes in dac_pretrained_shapes().items():
        for C, Co, L, kk, d in sorted(shapes["snake_conv"]):
            res = kk == 1
            x = randn(B, C, L)
            w = randn(Co, C, kk, scale=(C * kk) ** -0.5)
            bias_t = randn(Co, dtype=torch.float32) * 0.1
            a = randn(C, dtype=torch.float32).exp()
            r = randn(B, Co, L) if res else None
            pad = d * (kk - 1) // 2
            ref = cs.snake_conv1d_plain(x, w, bias_t, a, a, pad, pad, d, r)
            out = (counted(cs.snake_conv1d_res, x, w, bias_t, a, a, r, pad, pad, d) if res
                   else counted(cs.snake_conv1d, x, w, bias_t, a, a, pad, pad, d))
            shape = f"[{B},{C},{L}] -> {Co} k={kk} d={d}"
            name = f"dac_pretrained snake_conv1d {shape} res={res}"
            note("snake_conv1d_res" if res else "snake_conv1d", shape,
                 compare(name, out, ref, bf16_tol(ref)))
            if not res:
                hold_row3(name, x, w, bias_t, a, a, pad, d, out)
            del x, w, r, ref, out
        for C, L in sorted(shapes["snake"]):
            x = randn(B, C, L, scale=2.0)
            a = randn(C, dtype=torch.float32).exp()
            ref = sn.snake_fused_plain(x, a, a)
            note("snake_fused", f"[{B},{C},{L}]",
                 compare(f"dac_pretrained snake [{B},{C},{L}]", counted(sn.snake_fused, x, a, a),
                         ref, bf16_tol(ref)))
            del x, ref
    for name, entry in entries.items():
        rec[name]["dac_pretrained"] = entry
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], entry["max_abs_err"])


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


# (B, H, N) of the TAAE's windowed self-attention at head dim 128 in a
# training step at batch 4 x 65,536 (`taae_config`: widths 128 / 256 / 512 /
# 1024 at 32,768 / 8,192 / 1,024 / 128 rows), the window (31, 32)
TAAE_FLASH_SHAPES = ((4, 1, 32768), (4, 2, 8192), (4, 4, 1024), (4, 8, 128))
TAAE_WINDOW = (31, 32)
# SDPA with the band as a boolean [N, N] mask is timed up to this N
SDPA_MASK_MAX_N = 8192


def banded_plain(q, k, v, window, chunk: int = 4096):
    """`flash_attention_plain` under `window` one query chunk at a time, each
    against its band of keys (the [N, N] logits of N = 32,768 would not fit):
    (out in q's dtype, lse f32)."""
    left, right = window
    N, scale = q.shape[2], q.shape[-1] ** -0.5
    outs, lses = [], []
    for a in range(0, N, chunk):
        b, lo = min(N, a + chunk), max(0, a - left)
        hi = min(N, b + right)
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(lo, hi, device=q.device)[None, :]
        logits = (q[:, :, a:b].float() @ k[:, :, lo:hi].float().transpose(-1, -2)) * scale
        logits = logits.masked_fill(~((j >= i - left) & (j <= i + right)), float("-inf"))
        lse = torch.logsumexp(logits, dim=-1)
        outs.append(torch.exp(logits - lse[..., None]) @ v[:, :, lo:hi].float())
        lses.append(lse)
    return torch.cat(outs, 2).to(q.dtype), torch.cat(lses, 2)


def banded_plain_bwd(q, k, v, out, lse, dout, window, chunk: int = 4096):
    """`flash_attention_prefix_bwd_plain` under `window`, a query chunk at a
    time: (dq, dk, dv) in the inputs' dtypes."""
    left, right = window
    N, scale = q.shape[2], q.shape[-1] ** -0.5
    dq = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    dk, dv = (torch.zeros(t.shape, device=q.device, dtype=torch.float32) for t in (k, v))
    for a in range(0, N, chunk):
        b, lo = min(N, a + chunk), max(0, a - left)
        hi = min(N, b + right)
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(lo, hi, device=q.device)[None, :]
        qf, kf, vf = q[:, :, a:b].float(), k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        gf = dout[:, :, a:b].float()
        p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[:, :, a:b, None])
        p = p.masked_fill(~((j >= i - left) & (j <= i + right)), 0.0)
        dsum = (gf * out[:, :, a:b].float()).sum(-1, keepdim=True)
        ds = p * (gf @ vf.transpose(-1, -2) - dsum) * scale
        dq[:, :, a:b] = ds @ kf
        dk[:, :, lo:hi] += ds.transpose(-1, -2) @ qf
        dv[:, :, lo:hi] += p.transpose(-1, -2) @ gf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def taae_flash_checks(fa, randn, F) -> dict:
    """Rows 5 and 6 (both backward routes) at TAAE_FLASH_SHAPES, head dim 128,
    window (31, 32): each against `banded_plain` / `banded_plain_bwd`, timed
    beside them, beside SDPA with the band as a boolean mask (forward, and
    autograd's backward) where N <= SDPA_MASK_MAX_N, and beside the bound
    from the visible pairs."""
    out_rec = {}
    for B, H, N in TAAE_FLASH_SHAPES:
        name, D = f"[{B},{H},{N},128]", 128
        q, k, v, dout = (randn(B, H, N, D) for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, False, TAAE_WINDOW)
        ref, ref_lse = banded_plain(q, k, v, TAAE_WINDOW)
        err = compare(f"flash_attention taae {name}", out, ref, bf16_tol(ref))
        compare(f"flash_attention taae {name} lse", lse, ref_lse, 1e-3)
        pairs = B * H * band_pairs(fa, N, False, TAAE_WINDOW)
        iters = 20 if B * H * N <= 65536 else 5
        mask = fa.band_mask(N, False, TAAE_WINDOW, q.device) if N <= SDPA_MASK_MAX_N else None
        fwd = dict(ms=cuda_ms(lambda: fa.flash_attention(q, k, v, False, TAAE_WINDOW), iters),
                   plain_ms=cuda_ms(lambda: banded_plain(q, k, v, TAAE_WINDOW), 1),
                   library_ms=None if mask is None else cuda_ms(
                       lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters),
                   max_abs_err=err, visible_pairs=pairs,
                   **bound(4.0 * D * pairs, q, k, v, out, lse))
        want = banded_plain_bwd(q, k, v, out, lse, dout, TAAE_WINDOW)
        bwd = dict(routes={}, **bound(10.0 * D * pairs, q, k, v, out, lse, dout, q, k, v))
        for route in fa.BWD_ROUTES:
            run = lambda route=route: fa.flash_attention_prefix_bwd(
                q, k, v, out, lse, dout, route=route, window=TAAE_WINDOW)
            rel = max(rel_err(f"flash bwd taae {name} {route} d{n}", a, b, BWD_REL_TOL)
                      for n, a, b in zip("qkv", run(), want))
            bwd["routes"][route] = dict(max_rel_err=rel, ms=cuda_ms(run, iters))
        bwd.update(ms=bwd["routes"][fa.BWD_ROUTE]["ms"],
                   max_rel_err=bwd["routes"][fa.BWD_ROUTE]["max_rel_err"],
                   plain_ms=cuda_ms(lambda: banded_plain_bwd(q, k, v, out, lse, dout,
                                                             TAAE_WINDOW), 1))
        bwd["library_ms"] = None
        if mask is not None:
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*qkv, attn_mask=mask)
            bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, qkv, dout,
                                                                    retain_graph=True), iters)
            del qkv, lib_out
        out_rec[name] = dict(forward=fwd, backward=bwd)
        del q, k, v, dout, out, lse, ref, ref_lse, want, mask
        torch.cuda.empty_cache()
    return out_rec


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


# demo lengths cut for the chip's time limit (step and frame counts only: each
# config's prompts, cfg scales and sample sizes stay as shipped)
DEMO_STEPS = 10  # SA-Open's and Dance's demo_steps (shipped: 100 and 250)
LM_DEMO_FRAMES = 50  # MusicGen-small's demo_max_gen_len (shipped: the 500 of its sample size)
# launches of one SA-Open demo request a cfg scale, counted from the model:
# a sampler step is one DiT call at CFG batch 2 (24 blocks: row 1 once, row 2
# three times each), the decode 16 / 15 / 5 of rows 12 / 3 / 4 (PERF.md)
SA_OPEN_STEP_LAUNCHES = {"flash_attention_prefix": 24, "fused_layer_norm": 72}
DECODE_LAUNCHES = {"snake_conv1d": 16, "snake_conv1d_res": 15, "snake_fused": 5}


def log_records(trainer) -> list:
    with open(trainer.logger.path) as f:
        return [json.loads(line) for line in f]


def demo_audio_checks(callback, what: str) -> dict:
    """The last demo's outputs and wavs: finite and not silent (peak over
    1e-4) each; returns {name: [peak of the output, wav files]}."""
    import numpy as np

    from stable_audio_tools_tpu_torch.data.wav import load_wav

    out = {}
    for name, audio in callback.outputs.items():
        if name == "disc_sensitivity":
            continue
        peak = float(abs(audio).max()) if audio.size else 0.0
        if not (math.isfinite(peak) and peak > 1e-4):
            raise AssertionError(f"{what} demo {name}: peak {peak}")
        wavs = [f for f in os.listdir(callback.demo_dir) if f.startswith(f"{name}_step")
                and f.endswith(".wav")]
        for f in wavs:
            wav, _ = load_wav(os.path.join(callback.demo_dir, f))
            if not (np.isfinite(wav).all() and abs(wav).max() > 1e-4):
                raise AssertionError(f"{what} demo wav {f} is not finite or is silent")
        if len(wavs) < audio.shape[0]:
            raise AssertionError(f"{what} demo {name}: {len(wavs)} wavs for {audio.shape[0]}")
        out[name] = [peak, len(wavs)]
    return out


def one_demo(trainer, argv: list, dataset_config: dict, what: str) -> dict:
    """One demo of the trainer's config through `train.parse_args` and
    `train.configure` (the entry's own wiring) and `Trainer.demo`, its
    launches counted and its seconds timed; no `demo/error` may be logged.
    Returns the record and the validation loader the flags give."""
    from stable_audio_tools_tpu_torch import train

    args = train.parse_args(argv)
    val_loader = train.configure(trainer, args, dataset_config)
    kernels = counters()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.demo(trainer.wrapper.step)
    torch.cuda.synchronize()
    rec = dict(demo_s=time.perf_counter() - t0,
               launches={n: fn.launches for n, fn in kernels.items() if fn.launches})
    errors = [r for r in log_records(trainer) if "demo/error" in r]
    if errors:
        raise AssertionError(f"{what} demo failed: {errors}")
    rec["outputs"] = demo_audio_checks(trainer.demo_callback, what)
    return rec, val_loader


def one_validation(trainer, val_loader, what: str) -> dict:
    """One validation pass (`Trainer.validate`), its launches counted and
    seconds timed; every `val/` mean finite and logged."""
    kernels = counters()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    means = trainer.validate(val_loader, trainer.wrapper.step)
    torch.cuda.synchronize()
    rec = dict(val_s=time.perf_counter() - t0, means=means,
               launches={n: fn.launches for n, fn in kernels.items() if fn.launches})
    logged = [r for r in log_records(trainer) if any(k.startswith("val/") for k in r)]
    if not means or not all(map(math.isfinite, means.values())) or not logged:
        raise AssertionError(f"{what} validation: {means}, logged {logged}")
    return rec


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
# warm-up and timed steps of the full-size training phases 4-15 (few, to keep
# the whole script within the call's time; phase 17 has its own)
WARM_STEPS, TIMED_STEPS = 1, 3
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

    small = small_train_check(dev)
    small_tol = 0.05  # as the generation check: a few bf16 roundings through 2 blocks
    if not (small["loss_rel_err"] <= small_tol and small["grad_rel_err"] <= small_tol):
        raise AssertionError(f"small training step card vs CPU: {small} > {small_tol}")

    rec = dict(small=small, small_tol=small_tol)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        cfg_path = os.path.join(tmp, "model.json")
        cfg = sa_open_config()
        cfg["training"]["demo"]["demo_steps"] = DEMO_STEPS
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        data = write_dataset(tmp)
        args = train.parse_args([
            "--model-config", cfg_path, "--dataset-config", data,
            "--batch-size", str(TRAIN_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(WARM_STEPS + TIMED_STEPS), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        t0 = time.perf_counter()
        trainer, loader, _ = train.build(args, device=dev)
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
        # the checkpoint is held by the entry check: saved every 2 steps,
        # restored by --recover bit for bit, exported by unwrap_model into a
        # fresh build (a save and reload here would add ~33 s of 18 GB I/O)
        rec["entry"] = sa_open_entry_check(dev, trainer, loader, tmp, cfg_path, data)
    return rec


def sa_open_entry_check(dev, trainer, loader, tmp: str, cfg_path: str, data: str) -> dict:
    """Phase 4's training entry as users run it, on the phase's trainer at
    full width: a further `fit` configured through `train.parse_args` and
    `train.configure` with validation on the phase's WAVs every 2 steps, a
    checkpoint every 2 steps keeping the newest (`--save-top-k 1`) and the
    config's own demo (its prompt, cfg scales 3 / 6 / 9 and sample size;
    DEMO_STEPS sampler steps) every 2 steps. Then `--recover` resolves the
    newest checkpoint after one more step and restores it (the weights and
    the EMA equal the saved ones bit for bit) and trains a step; then
    `unwrap_model` writes the EMA model and a fresh full-width build loads
    that file through `--pretrained-ckpt-path` (0 skipped, every tensor
    equal) and its VAE through `--pretransform-ckpt-path`."""
    from stable_audio_tools_tpu_torch import train, unwrap_model
    from stable_audio_tools_tpu_torch.io.checkpoints import load_ckpt_state_dict
    from stable_audio_tools_tpu_torch.training.trainer import step_checkpoints

    w = trainer.wrapper
    run = trainer.save_dir
    end = (w.step // 2 + 1) * 2  # the next step that checkpoints, validates and demos
    # the validation loader reads in this process: 4 spawn workers took ~14 s
    # to start (PR 16 call 1), two batches take well under one
    argv = ["--model-config", cfg_path, "--dataset-config", data, "--batch-size",
            str(TRAIN_BATCH), "--num-workers", "0", "--seed", "0", "--save-dir", run,
            "--checkpoint-every", "2", "--save-top-k", "1", "--val-dataset-config", data,
            "--val-every", "2", "--demo-every", "2"]
    with open(data) as f:
        dataset_config = json.load(f)
    val_loader = train.configure(trainer, train.parse_args(argv), dataset_config)
    kernels = counters()
    rec = dict(demo_launches=[], demo_scale_s=[], val_s=[], save_s=[])
    demo, validate, save = trainer.demo_callback, trainer.validate, trainer.save
    marks = []
    real_save = demo._save

    def timed_save(audio, name, step, **kw):  # a cfg scale's request ends in its _save
        marks.append(time.perf_counter())
        return real_save(audio, name, step, **kw)

    def counted_demo(wrapper, step):
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        marks[:] = [time.perf_counter()]
        demo(wrapper, step)
        torch.cuda.synchronize()
        rec["demo_launches"].append({n: fn.launches for n, fn in kernels.items() if fn.launches})
        rec["demo_scale_s"].append([b - a for a, b in zip(marks, marks[1:])])

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out
        return call

    demo._save = timed_save
    trainer.demo_callback = counted_demo
    trainer.validate, trainer.save = timed(validate, "val_s"), timed(save, "save_s")
    trainer.fit(loader, max_steps=end, save_at_end=False, val_dataloader=val_loader)
    trainer.validate, trainer.save = validate, save
    trainer.demo_callback = demo
    demo._save = real_save

    log = log_records(trainer)
    if any("demo/error" in r for r in log):
        raise AssertionError(f"SA-Open demo failed: {[r for r in log if 'demo/error' in r]}")
    if not any(k.startswith("val/") for r in log for k in r):
        raise AssertionError("SA-Open: no val/ record in train_log.jsonl")
    if not all(math.isfinite(v) for h in trainer.val_history for v in h.values()):
        raise AssertionError(f"SA-Open validation: {trainer.val_history}")
    ckpts = step_checkpoints(run)
    if [s for s, _ in ckpts] != [end]:
        raise AssertionError(f"--save-top-k 1 left {ckpts}")
    cfg_scales = trainer.model_config["training"]["demo"]["demo_cfg_scales"]
    per_scale = {n: DEMO_STEPS * c for n, c in SA_OPEN_STEP_LAUNCHES.items()}
    per_scale.update(DECODE_LAUNCHES)
    want = {n: len(cfg_scales) * c for n, c in per_scale.items()}
    if rec["demo_launches"] != [want]:
        raise AssertionError(f"SA-Open demo launches {rec['demo_launches']}, expected [{want}] "
                             f"(per cfg scale {per_scale})")
    rec.update(demo_outputs=demo_audio_checks(demo, "SA-Open"), cfg_scales=cfg_scales,
               demo_per_scale_launches=per_scale, val=trainer.val_history[-1],
               ckpt_gib=os.path.getsize(ckpts[-1][1]) / 2 ** 30)

    # --recover after one more step (not saved): the newest checkpoint back
    saved = {k: v.detach().to("cpu", copy=True) for k, v in w.model.state_dict().items()}
    saved_ema = {k: v.to("cpu", copy=True) for k, v in w.ema.items()}
    trainer.fit(loader, max_steps=end + 1, save_at_end=False)
    t0 = time.perf_counter()
    path = train.recover_path(train.parse_args(argv + ["--recover"]))
    if path != ckpts[-1][1]:
        raise AssertionError(f"--recover resolved {path!r}, not {ckpts[-1][1]!r}")
    trainer.restore(path)
    torch.cuda.synchronize()
    rec["load_s"] = time.perf_counter() - t0
    differ = [k for k, v in w.model.state_dict().items() if not torch.equal(v.cpu(), saved[k])]
    differ += [k for k, v in w.ema.items() if not torch.equal(v.cpu(), saved_ema[k])]
    if differ or w.step != end:
        raise AssertionError(f"--recover: {len(differ)} tensors differ ({differ[:5]}), step "
                             f"{w.step}")
    del saved, saved_ema
    trainer.fit(loader, max_steps=end + 1, save_at_end=False)
    torch.cuda.synchronize()
    rec["recover_to_first_step_s"] = time.perf_counter() - t0

    # unwrap the EMA model, then a fresh full-width build loads it
    t0 = time.perf_counter()
    exported = unwrap_model.main(["--ckpt-path", path, "--name", os.path.join(tmp, "sa_open")])
    rec["unwrap_s"] = time.perf_counter() - t0
    rec["unwrapped_gib"] = os.path.getsize(exported) / 2 ** 30
    for old in step_checkpoints(run):
        os.remove(old[1])  # the card's machine's disk: one 18 GB file at a time
    t0 = time.perf_counter()
    fresh, report = train.build_model(train.parse_args(argv + [
        "--pretrained-ckpt-path", exported, "--pretransform-ckpt-path", exported]),
        sa_open_config(), dev)
    torch.cuda.synchronize()
    rec["pretrained_build_s"] = time.perf_counter() - t0
    sd = load_ckpt_state_dict(exported)
    differ = [k for k, v in fresh.state_dict().items() if not torch.equal(v.cpu(), sd[k])]
    pretransform = {k for k in sd if k.startswith("pretransform.model.")}
    if (report["pretrained_skipped"] or report["pretrained_loaded"] != len(sd) or differ
            or report["pretransform_loaded"] != len(pretransform)):
        raise AssertionError(f"--pretrained-ckpt-path: {report['pretrained_loaded']} loaded of "
                             f"{len(sd)}, skipped {report['pretrained_skipped'][:5]}, "
                             f"{len(differ)} differ ({differ[:5]}); pretransform "
                             f"{report['pretransform_loaded']} of {len(pretransform)}")
    ema_differ = [k for k, v in w.ema.items() if not torch.equal(sd[k], v.cpu())]
    if w.step != end + 1 or not ema_differ:
        # the file holds step end's EMA; the trainer has moved on a step
        raise AssertionError("unwrap: the exported EMA matches the live one after a step")
    rec.update(pretrained_loaded=report["pretrained_loaded"],
               pretransform_loaded=report["pretransform_loaded"])
    del fresh, sd
    os.remove(exported)
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
                breakdown=stage_breakdown(model, dev, SA2_PROMPT, SA2_SAMPLE_SIZE),
                oobleck_bf16=oobleck_bf16_check(dev))


SA2_VAE = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                       "autoencoders", "stable_audio_2_0_vae.json")
# generator + discriminator pairs of the GAN phases (6, 13, 14, 16): warm-up
# and timed (few, for the script's time; phase 17 passes 2 + 5 to
# `gan_training`)
GAN_WARM_PAIRS, GAN_TIMED_PAIRS = 1, 3
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


# a TAAE's LayerScale gains in the tiny card-vs-CPU checks (their init, 1e-5,
# would leave the transformer blocks' kernels out of the outputs compared)
SMALL_LAYER_SCALE = 0.1


@torch.no_grad()
def scale_gains(model, gain: float) -> None:
    """The weight-norm gains times `gain`; LayerScales set to
    SMALL_LAYER_SCALE."""
    from stable_audio_tools_tpu_torch.ops.norms import LayerScale

    for n, p in model.named_parameters():
        if n.endswith("weight_g"):
            p.mul_(gain)
    for m in model.modules():
        if isinstance(m, LayerScale):
            m.scale.fill_(SMALL_LAYER_SCALE)


def tiny_gan_trainer(cfg: dict, dev, disc: dict | None = None, gain: float = 1.0):
    """`cfg`'s trainer on `dev`, its weights made on the CPU from seed 1, the
    gains set by `scale_gains` (the discriminator's weights from `disc`
    where given, else its own seeded init)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    model = init_random_(create_model_from_config(copy.deepcopy(cfg), "cpu"),
                         torch.Generator().manual_seed(1))
    scale_gains(model, gain)
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
                 disc_launches: dict, entry: bool = False, warm: int = GAN_WARM_PAIRS,
                 timed: int = GAN_TIMED_PAIRS) -> dict:
    """A shipped autoencoder GAN config at full width, batch AE_BATCH,
    through `train.build` and `Trainer.fit`: `warm` + `timed` generator +
    discriminator pairs, finite losses, every parameter of each side with a
    finite nonzero gradient in its first step, parameters and EMA moved,
    the kernels launched exactly as given a pair, the pair and step times,
    one generator step's pieces and its profile (`gen_step_split`), a
    checkpoint and a resumed pair (`resume_check`)."""
    from stable_audio_tools_tpu_torch import train

    cfg_path = os.path.join(tmp, "model.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    n_steps = 2 * (warm + timed)
    args = train.parse_args([
        "--model-config", cfg_path, "--dataset-config", dataset, "--batch-size", str(AE_BATCH),
        "--num-workers", "4", "--seed", "0", "--max-steps", str(n_steps),
        "--checkpoint-every", "0", "--save-dir", os.path.join(tmp, "run")])
    rec = {}
    t0 = time.perf_counter()
    trainer, loader, _ = train.build(args, device=dev)
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
    trainer.fit(loader, max_steps=2 * warm, save_at_end=False)
    torch.cuda.synchronize()
    counted = set(AE_KERNELS) | set(gen_launches) | set(disc_launches)
    kernels = {n: fn for n, fn in counters().items() if n in counted}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(loader, max_steps=n_steps, save_at_end=False)
    torch.cuda.synchronize()
    rec["launches"] = {n: fn.launches for n, fn in kernels.items()}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {n: timed * (gen_launches.get(n, 0) + disc_launches.get(n, 0))
            for n in kernels}
    if rec["launches"] != want:
        raise AssertionError(f"GAN training launches {rec['launches']}, expected {want}")
    hist = trainer.history
    if len(hist) != n_steps or not all(math.isfinite(v) for h in hist for v in h.values()):
        raise AssertionError(f"GAN training log: {hist}")
    walls = [1e3 / h["train/steps_per_sec"] for h in hist[2 * warm:]]
    pairs = [walls[i] + walls[i + 1] for i in range(0, len(walls), 2)]
    # A one-element parameter may come back to its own bits. The shipped
    # schedules' InverseLR warm-up (0.999) scales the first steps' rates by
    # 1 - 0.999^k: the discriminator's 3e-4 gives 3e-7 to 1.2e-6, a few ulps
    # of a weight_g near 0.58 a step. A scale's conv_post.weight_g takes the
    # gradient (mean fake - mean real logit) / g, whose sign a fresh
    # discriminator draws from batch to batch, so the steps can cancel
    # (sizes 1, 2, 3, 4 with signs + - - +). Such a parameter passes if
    # AdamW holds a nonzero second moment for it, i.e. it took gradients.
    # A scale's last bias may take exact zeros (see above): it is exempt.
    def stepped_in_place(p, opt):
        state = opt.state.get(p, {})
        return p.numel() == 1 and bool(state) and state["exp_avg_sq"].item() > 0

    unmoved, cancelled = [], []
    for params, before_, opt in ((w.params, before, w.optimizer),
                                 (w.disc_params, disc_before, w.disc_optimizer)):
        for n, p in params.items():
            if not torch.equal(p.detach(), before_[n]) or n.endswith("conv_post.bias"):
                continue
            (cancelled if stepped_in_place(p, opt) else unmoved).append(n)
    ema_unmoved = [n for n, e in w.ema.items()
                   if torch.equal(e, before[n]) and n not in cancelled]
    if unmoved or ema_unmoved:
        raise AssertionError(f"parameters that did not move: {unmoved[:8]}; "
                             f"EMA entries that did not move: {ema_unmoved[:8]}")
    rec["stepped_back_to_own_bits"] = cancelled
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
    if entry:
        rec["entry"] = ae_entry_check(trainer, cfg_path, dataset, disc_launches)
    return rec


def ae_entry_check(trainer, cfg_path: str, dataset: str, forward_launches: dict) -> dict:
    """An autoencoder's demo (`AutoencoderDemoCallback`: a batch of the
    dataset's reals encoded and decoded with the EMA weights, the
    discriminator's sensitivity through autograd) and one validation pass
    over the dataset (the STFT, SI-SDR and mel distances of the eval-mode
    forward), both through the entry's flags, at full width: each forward
    moves rows 12 / 3 / 4 by `forward_launches` (an encode and a decode)."""
    argv = ["--model-config", cfg_path, "--dataset-config", dataset, "--batch-size",
            str(AE_BATCH), "--num-workers", "0", "--seed", "0", "--save-dir",
            trainer.save_dir, "--val-dataset-config", dataset, "--val-every", "1",
            "--demo-every", "1"]
    with open(dataset) as f:
        dataset_config = json.load(f)
    rec, val_loader = one_demo(trainer, argv, dataset_config, "VAE")
    if rec["launches"] != forward_launches:
        raise AssertionError(f"VAE demo launches {rec['launches']}, expected {forward_launches}")
    g = trainer.demo_callback.outputs["disc_sensitivity"]
    if not (g.shape == trainer.demo_callback.outputs["recon"].shape
            and math.isfinite(float(g.max())) and float(g.max()) > 0):
        raise AssertionError(f"VAE demo: discriminator sensitivity {g.shape} max {g.max()}")
    val = one_validation(trainer, val_loader, "VAE")
    n_batches = len(val_loader.dataset) // AE_BATCH
    want = {n: n_batches * c for n, c in forward_launches.items()}
    if val["launches"] != want:
        raise AssertionError(f"VAE validation launches {val['launches']}, expected {want} "
                             f"({n_batches} batches)")
    rec.update(val=val, val_batches=n_batches)
    return rec


def gan_phase(dev, cfg: dict, make_tiny, counts: dict, entry: bool = False) -> dict:
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
        rec = gan_training(dev, cfg, tmp, data, counts["gen"], counts["disc"], entry)
    rec.update(small=small, small_tol=small_tol, counts=counts)
    return rec


def phase_ae_training(dev) -> dict:
    """Phase 6: `gan_phase` of the shipped SA-2.0 VAE, its launches
    AE_GEN_LAUNCHES / AE_DISC_LAUNCHES, then its demo and a validation pass
    (`ae_entry_check`)."""
    return gan_phase(dev, sa2_vae_config(), tiny_ae_config,
                     dict(gen=AE_GEN_LAUNCHES, disc=AE_DISC_LAUNCHES), entry=True)


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
    320,000 samples of seeded synthetic mono 32 kHz WAVs with prompts, 1
    warm-up and 3 timed steps, the pieces of one step, a checkpoint and its
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
        trainer, loader, _ = train.build(args, device=dev)
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
        # the config's demo (its default prompt, no CFG), LM_DEMO_FRAMES frames
        # KV-cached, then the codec's decode
        trainer.model_config["training"]["demo"]["demo_max_gen_len"] = LM_DEMO_FRAMES
        with open(args.dataset_config) as f:
            dataset_config = json.load(f)
        rec["demo"], _ = one_demo(trainer, [
            "--model-config", cfg_path, "--dataset-config", args.dataset_config,
            "--save-dir", trainer.save_dir, "--demo-every", "1"], dataset_config, "LM")
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
        trainer, loader, _ = train.build(args, device=dev)
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
    WAVs: 1 warm-up and 3 timed steps, one forward+backward profiled, a
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
        trainer, loader, _ = train.build(args, device=dev)
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
        # the config's demo (num_demos 4 at the sample size), DEMO_STEPS steps:
        # the DAU1d launches no hand-written kernel
        trainer.model_config["training"]["demo"]["demo_steps"] = DEMO_STEPS
        with open(args.dataset_config) as f:
            dataset_config = json.load(f)
        rec["demo"], _ = one_demo(trainer, [
            "--model-config", cfg_path, "--dataset-config", args.dataset_config,
            "--save-dir", trainer.save_dir, "--demo-every", "1"], dataset_config, "Dance")
        if rec["demo"]["launches"]:
            raise AssertionError(f"Dance demo launched {rec['demo']['launches']}")
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
        trainer, loader, _ = train.build(args, device=dev)
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


# Phase 15: rectified flow and ARC at SA-Open's width. The shipped SA-Open
# config changed in memory only: its objective set to a flow one, the
# timestep shift's options set to the class defaults (an empty dict is no
# shift), and for inpainting `diffusion_cond_inpaint` with input_concat_dim
# 64 + 1.
# the transformer autoencoder (phase 16): the shipped SA-2.0 VAE config with
# TAAE towers at the JAX classes' defaults (depths [3, 3, 3, 3], window
# (31, 32), ELU, heads of 128) over strides [2, 4, 8, 8] (ratio 512)
TAAE_TOWER = {"channels": 128, "c_mults": [1, 2, 4, 8], "strides": [2, 4, 8, 8]}
TAAE_DITHERED_FSQ = {"type": "dithered_fsq", "config": {"dim": 4, "levels": 5,
                                                         "num_codebooks": 16}}


def taae_config(fsq: bool = False) -> dict:
    """`taae_vae_gan` (the VAE bottleneck) or, with `fsq`, `taae_dithered_fsq`
    (16 codebooks of 4 dims at 5 levels over the 64 latent channels; the
    encoder's latent_dim 64, no bottleneck loss weights): everything but the
    towers, the ratio and that bottleneck as shipped."""
    cfg = sa2_vae_config()
    m = cfg["model"]
    m["encoder"] = {"type": "taae", "config": dict(TAAE_TOWER, in_channels=2,
                                                   latent_dim=64 if fsq else 128)}
    m["decoder"] = {"type": "taae", "config": dict(TAAE_TOWER, out_channels=2, latent_dim=64)}
    m["downsampling_ratio"] = 512
    if fsq:
        m["bottleneck"] = copy.deepcopy(TAAE_DITHERED_FSQ)
        cfg["training"]["loss_configs"].pop("bottleneck", None)
    return cfg


def tiny_taae_config(compute_dtype: str = "bfloat16", fsq: bool = False) -> dict:
    """`taae_config` at toy size for the card-vs-CPU checks: channels 64,
    c_mults [2, 4], strides [2, 4] (one head of 128, then two: row 5 and row
    6 at head dim 128), depths [1, 1] under the window (31, 32), latent 8,
    `tiny_ae_config`'s discriminator and MRSTFT, `compute_dtype`."""
    cfg = taae_config(fsq)
    small = tiny_ae_config(compute_dtype)
    cfg["sample_size"] = small["sample_size"]
    cfg["training"] = small["training"]
    if fsq:
        cfg["training"]["loss_configs"].pop("bottleneck", None)
    m = cfg["model"]
    tower = dict(channels=64, c_mults=[2, 4], strides=[2, 4], transformer_depths=[1, 1])
    m["encoder"]["config"].update(tower, latent_dim=8 if fsq else 16)
    m["decoder"]["config"].update(tower, latent_dim=8)
    m.update(latent_dim=8, downsampling_ratio=8)
    if fsq:
        m["bottleneck"]["config"].update(num_codebooks=2)
    return cfg


# the JAX package's own bf16-vs-f32 distance of `oobleck_bf16_case`'s decode
# (||bf16 - f32|| / ||f32||, CPU; tests/test_torch_taae.py measures it and
# holds this record to it); phase 16 holds the card's to twice it
OOBLECK_BF16_JAX = 0.11165536


def oobleck_bf16_case():
    """(config, latents [1, 64, 16]): the shipped SA-2.0 VAE with its
    decoder's five levels at channels 32 (2 -> 512 channels), the latents
    from torch's CPU generator at seed 0."""
    cfg = sa2_vae_config()
    cfg["model"]["decoder"]["config"]["channels"] = 32
    cfg["model"]["encoder"]["config"]["channels"] = 32
    return cfg, torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(0)).numpy()


def oobleck_bf16_decoder(cfg: dict, dev="cpu"):
    """`oobleck_bf16_case`'s decoder, its weights from `init_random_` on the
    CPU at seed 0 (the same on every machine), on `dev`."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = init_random_(create_model_from_config(cfg, "cpu"), torch.Generator().manual_seed(0))
    return model.decoder.eval().to(dev)


RF_SHIFT = {"base_shift": 0.5, "max_shift": 1.15, "min_length": 256, "max_length": 4096}
# (objective, sampler, steps, cfg scale): the JAX UI's defaults for each
# objective (rf_denoiser: pingpong 8 at cfg 1; rectified_flow: euler 50 at
# cfg 7), then rk4 and dpmpp at 4 steps
RF_CASES = (("rf_denoiser", "pingpong", 8, 1.0), ("rectified_flow", "euler", 50, 7.0),
            ("rectified_flow", "rk4", 4, 7.0), ("rectified_flow", "dpmpp", 4, 7.0))
RF_P_ONE_SHOT = 0.1
INPAINT_TIMED_STEPS = 3
ARC_BATCH, ARC_LATENTS = 4, 1024
ARC_CONFIG = {"ode_warmup": {"warmup_steps": 2, "refresh_rate": 1, "n_sampling_steps": 8},
              "gan": {"grad_penalties": True, "contrastive": True, "head": {"type": "conv"}}}
ARC_PROMPTS = [{"prompt": p, "seconds_start": 0, "seconds_total": 30} for p in (
    "An upbeat electronic track with a driving bassline", "A solo piano ballad",
    "Rain on a tin roof", "A brass band marching in the street")]


def rf_sa_open_config(objective: str = "rectified_flow", inpaint: bool = False) -> dict:
    cfg = sa_open_config()
    diffusion = cfg["model"]["diffusion"]
    diffusion["diffusion_objective"] = objective
    diffusion["distribution_shift_options"] = dict(RF_SHIFT)
    if inpaint:
        cfg["model_type"] = "diffusion_cond_inpaint"
        diffusion["config"]["input_concat_dim"] = diffusion["config"]["io_channels"] + 1
    return cfg


def set_objective(model, objective: str) -> None:
    """The wrapper's objective (the sampler family) and its DiT's (what the
    CFG interval gates on), as the factory sets them from the config."""
    model.diffusion_objective = objective
    model.model.model.diffusion_objective = objective


def dit_calls(forward: int = 0, trained: int = 0, depth: int = 24) -> dict:
    """Rows 1 / 6 / 2 of `forward` DiT calls without a backward and
    `trained` with one (each block rematerialised: its forward runs twice),
    each block one self-attention and three LayerNorms."""
    runs = forward + 2 * trained
    return {"flash_attention_prefix": depth * runs, "flash_attention_prefix_bwd": depth * trained,
            "fused_layer_norm": 3 * depth * runs}


def rf_request_launches(sampler: str, steps: int, depth: int = 24) -> dict:
    """Rows 1 / 2 of one request (a DiT call a sampler step, four for rk4;
    CFG doubles the batch, not the calls) and the decode's rows 12 / 3 / 4."""
    launches = dit_calls(forward=steps * (4 if sampler == "rk4" else 1), depth=depth)
    del launches["flash_attention_prefix_bwd"]
    return {**launches, **DECODE_LAUNCHES}


def arc_step_launches(kind: str, depth: int = 24, teacher_steps: int = 8) -> dict:
    """Rows 1 / 6 / 2 of one ARC step, counted from training/arc.py: the ODE
    step = the teacher's calls without grad + the student's forward and
    backward; the generator step = the student's + the discriminator's on
    the fakes (the gradient to its input) + its forward on the reals without
    grad; the discriminator step = the student without grad + the
    discriminator's five scored inputs (reals, fakes, the two noised for
    R1/R2, the reals under rolled prompts)."""
    forward, trained = {"ode": (teacher_steps, 1), "gen": (1, 2), "disc": (1, 5)}[kind]
    return dit_calls(forward, trained, depth)


def convnext_head_wgrad_shapes(in_channels: int, N: int, scored: int = 5) -> dict:
    """{(Ci, Co, k, L, pad): launches} of row 11 plain in one discriminator
    step with the ConvNeXt head on N hidden states of `in_channels`, recorded
    from the head's own convs: the head as ARC builds it runs once in bf16 on
    the meta device, and each stride-1 conv that `models/convnext.py`
    hands to `conv1d` (conv_in, each block's 1 x 1 up and down, conv_out) is
    noted; each launches row 11 once a backward of the `scored` inputs."""
    import collections
    from unittest import mock

    import torch.nn.functional as F

    from stable_audio_tools_tpu_torch.models import convnext
    from stable_audio_tools_tpu_torch.models.arc import ConvNeXtDiscriminator

    shapes = collections.Counter()

    def record(x, w, bias=None, padding=0):
        shapes[(x.shape[1], w.shape[0], w.shape[-1], x.shape[-1], padding)] += scored
        return F.conv1d(x, w, bias, padding=padding)

    with torch.device("meta"):
        head = ConvNeXtDiscriminator(in_channels)
    with mock.patch.object(convnext, "conv1d", record), torch.no_grad():
        head(torch.empty(1, N, in_channels, device="meta", dtype=torch.bfloat16))
    return dict(shapes)


@torch.inference_mode()
def small_rf_check(dev) -> dict:
    """Largest relative error (max|card - CPU| / max|CPU|) of the final
    latents of each flow sampler (2 steps; rk4 makes 8 calls) on the tiny
    SA-Open-shaped model made a flow model with the shift, the kernels on the
    card against the plain versions on the CPU, with the same initial and
    pingpong noise: at cfg 1 (`{sampler} cfg 1`, the gate) and at the
    RF_CASES' scale where it is another (`{sampler} cfg 7`): CFG scales the
    difference of the two outputs, and with it their bf16 roundings."""
    cpu = tiny_model().eval()
    cpu.distribution_shift_options = dict(RF_SHIFT)
    gpu = copy.deepcopy(cpu).to(dev)
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond

    g = torch.Generator().manual_seed(5)
    noise = torch.randn(1, 16, 128, generator=g)
    steps_noise = [torch.randn(1, 16, 128, generator=g) for _ in range(2)]
    errs = {}
    for objective, sampler, _, scale in RF_CASES:
        for cfg_scale in sorted({1.0, scale}):
            outs = []
            for model, d in ((cpu, "cpu"), (gpu, dev)):
                set_objective(model, objective)
                outs.append(generate_diffusion_cond(
                    model, steps=2, cfg_scale=cfg_scale, conditioning=PROMPT, batch_size=1,
                    sample_size=4096, sampler_type=sampler, return_latents=True,
                    noise=noise.to(d), step_noise=lambda i, x: steps_noise[i].to(x.device)
                ).float().cpu())
            want, got = outs
            if not torch.isfinite(got).all():
                raise AssertionError(f"small rf {sampler}: non-finite latents on the card")
            errs[f"{sampler} cfg {cfg_scale:g}"] = ((got - want).abs().max().item()
                                                    / max(want.abs().max().item(), 1e-6))
    return errs


def rf_generation(dev) -> dict:
    """(a): the four flow samplers at SA-Open's width, batch 1, 2,097,152
    samples, each request's wall, audio-s/s, peak GiB and launches (pinned),
    then one pingpong request with `preview`."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    t0 = time.perf_counter()
    model = create_model_from_config(rf_sa_open_config("rf_denoiser"), dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()
    torch.cuda.synchronize()
    rec = dict(build_s=time.perf_counter() - t0, requests={})
    kernels = {n: fn for n, fn in counters().items() if n in GENERATION_KERNELS}
    depth, io = model.model.model.depth, model.io_channels
    latents = SAMPLE_SIZE // model.pretransform.downsampling_ratio

    def request(objective, sampler, steps, cfg_scale, seed, **kw):
        set_objective(model, objective)
        return generate_diffusion_cond(model, steps=steps, cfg_scale=cfg_scale,
                                       conditioning=PROMPT, batch_size=1,
                                       sample_size=SAMPLE_SIZE, seed=seed,
                                       sampler_type=sampler, **kw)

    request("rectified_flow", "euler", 2, 7.0, 0)  # warm-up: cuDNN plans at the full shapes
    for objective, sampler, steps, cfg_scale in RF_CASES:
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        audio = request(objective, sampler, steps, cfg_scale, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        want = rf_request_launches(sampler, steps, depth)
        if launches != want:
            raise AssertionError(f"rf {sampler}: launches {launches}, expected {want}")
        if tuple(audio.shape) != (1, 2, SAMPLE_SIZE) or not torch.isfinite(audio).all():
            raise AssertionError(f"rf {sampler}: audio {tuple(audio.shape)} "
                                 f"finite={bool(torch.isfinite(audio).all())}")
        rec["requests"][sampler] = dict(
            objective=objective, steps=steps, cfg_scale=cfg_scale, wall_s=wall,
            audio_s_per_s=SAMPLE_SIZE / 44100.0 / wall,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=launches)
        del audio
    t0 = time.perf_counter()
    request("rf_denoiser", "pingpong", 8, 1.0, 2, preview=True)
    torch.cuda.synchronize()
    buf = model._preview_buffer
    if len(buf) != 8 or not all(d.shape == (1, io, latents) and math.isfinite(float(abs(d).max()))
                                for d, _ in buf):
        raise AssertionError(f"preview: {len(buf)} entries, shapes {[d.shape for d, _ in buf]}")
    rec["preview"] = dict(wall_s=time.perf_counter() - t0, entries=len(buf),
                          sigmas=[s for _, s in buf])
    rec["launches"] = {n: sum(r["launches"].get(n, 0) for r in rec["requests"].values())
                       for n in kernels}
    rec["params"] = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    return rec


def counted_fit(trainer, loader, steps: int, names) -> tuple:
    """`steps` more steps through `Trainer.fit`, the launches of `names`
    counted and the peak memory read over them; returns (launches, peak GiB)."""
    kernels = {n: fn for n, fn in counters().items() if n in names}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(loader, max_steps=trainer.wrapper.step + steps, save_at_end=False)
    torch.cuda.synchronize()
    return ({n: fn.launches for n, fn in kernels.items()},
            torch.cuda.max_memory_allocated() / 2 ** 30)


def rf_training_run(dev, tmp: str, data: str, inpaint: bool, timed: int) -> dict:
    """(b) / (c): SA-Open at full width trained from the WAVs through the
    code path of `python -m stable_audio_tools_tpu_torch.train` under the
    rectified-flow objective with the shift, p_one_shot and log_loss_info
    (and, for (c), the inpainting model, its masks drawn within the batch's
    padding masks), WARM_STEPS + `timed` steps, batch TRAIN_BATCH."""
    from stable_audio_tools_tpu_torch import train

    cfg = rf_sa_open_config("rectified_flow", inpaint=inpaint)
    cfg["training"].update(p_one_shot=RF_P_ONE_SHOT, log_loss_info=True)
    cfg["training"]["demo"]["demo_steps"] = DEMO_STEPS
    name = "inpaint" if inpaint else "rf"
    cfg_path = os.path.join(tmp, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["--model-config", cfg_path, "--dataset-config", data, "--batch-size",
            str(TRAIN_BATCH), "--num-workers", "4", "--seed", "0", "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, name)]
    t0 = time.perf_counter()
    trainer, loader, _ = train.build(train.parse_args(argv), device=dev)
    torch.cuda.synchronize()
    rec = dict(build_s=time.perf_counter() - t0)
    w = trainer.wrapper
    if (w.diffusion_objective, w.p_one_shot, w.log_loss_info, w.dist_shift is None,
            w.inpainting_config) != ("rectified_flow", RF_P_ONE_SHOT, True, False,
                                     {} if inpaint else None):
        raise AssertionError(f"{name}: the trainer did not take the config's options")
    trainer.fit(loader, max_steps=WARM_STEPS, save_at_end=False)
    launches, rec["peak_gib"] = counted_fit(trainer, loader, timed, TRAINING_KERNELS)
    depth = w.model.model.model.depth
    want = dit_calls(trained=timed, depth=depth)
    if any(launches[n] != c for n, c in want.items()) or not all(
            launches[n] for n in ("snake_conv1d", "snake_conv1d_res")):
        raise AssertionError(f"{name} training launches {launches}: expected {want} and the "
                             "encode's rows 12 / 3")
    rec["launches"] = launches
    hist = trainer.history
    losses = [h["train/loss"] for h in hist]
    buckets = [{k[len("train/loss_all_"):]: v for k, v in h.items()
                if k.startswith("train/loss_all_")} for h in hist]
    if (len(losses) != WARM_STEPS + timed or not all(map(math.isfinite, losses))
            or any(len(b) != 10 or not all(map(math.isfinite, b.values())) for b in buckets)
            or not any(v > 0 for b in buckets for v in b.values())):
        raise AssertionError(f"{name} training: losses {losses}, buckets {buckets}")
    walls = [1e3 / h["train/steps_per_sec"] for h in hist[WARM_STEPS:]]
    rec.update(losses=losses, buckets=buckets, step_ms=walls,
               step_ms_median=statistics.median(walls),
               audio_s_per_s=TRAIN_BATCH * SAMPLE_SIZE / SR / (statistics.median(walls) / 1e3))
    if inpaint:
        with open(data) as f:
            dataset_config = json.load(f)
        demo, _ = one_demo(trainer, argv + ["--demo-every", "1"], dataset_config,
                           "SA-Open inpainting")
        names = sorted(demo["outputs"])
        scales = cfg["training"]["demo"]["demo_cfg_scales"]
        if names != sorted(["inpaint_reals", "inpaint_masked_input"]
                           + [f"inpaint_cfg{s}" for s in scales]):
            raise AssertionError(f"inpainting demo outputs {names}")
        want = dit_calls(forward=DEMO_STEPS * len(scales), depth=depth)
        if any(demo["launches"].get(n, 0) != want[n]
               for n in ("flash_attention_prefix", "fused_layer_norm")):
            raise AssertionError(f"inpainting demo launches {demo['launches']}: expected rows "
                                 f"1 / 2 of {want}")
        rec["demo"] = demo
    del trainer, loader, w
    torch.cuda.empty_cache()
    return rec


def arc_run(dev) -> dict:
    """(d): ARC from seeded latents [4, 64, 1024] with SA-Open's T5 and
    number conditioning, the student and the discriminator SA-Open's rf DiT
    at full width (the factory's: the discriminator a copy of the student,
    the teacher the student's weights): 2 ODE warm-up steps (8 teacher steps,
    refreshed each step), then generator, discriminator, generator,
    discriminator steps with the conv head (R1/R2 by input noise, the
    contrastive term on the prompts rolled by one), then one discriminator
    step with the ConvNeXt head. Each step's ms, peak GiB, finite losses and
    launches (pinned)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.arc import ARCTrainer
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    cfg = rf_sa_open_config("rectified_flow")
    cfg["training"] = {"learning_rate": 1e-5, "arc": copy.deepcopy(ARC_CONFIG)}
    t0 = time.perf_counter()
    model = init_random_(create_model_from_config(cfg, dev), torch.Generator(device=dev)
                         .manual_seed(0))
    trainer = create_training_wrapper_from_config(cfg, model)
    torch.cuda.synchronize()
    rec = dict(build_s=time.perf_counter() - t0, steps=[])
    io, depth = model.io_channels, model.model.model.depth
    if not isinstance(trainer, ARCTrainer) or trainer.head.convs[0].in_channels != io:
        raise AssertionError(f"ARC: the factory did not build the trainer with a head over "
                             f"the {io} channels of exit layer -1")
    g = torch.Generator(device=dev).manual_seed(3)
    latents = torch.randn(ARC_BATCH, io, ARC_LATENTS, generator=g, device=dev)
    with torch.no_grad():
        cond = model.conditioner(ARC_PROMPTS, dev)
        rolled = model.conditioner(ARC_PROMPTS[1:] + ARC_PROMPTS[:1], dev)
    names = ("flash_attention_prefix", "flash_attention_prefix_bwd", "fused_layer_norm",
             "conv1d_wgrad")
    kernels = {n: fn for n, fn in counters().items() if n in names}

    def step(tr, kind, **kw):
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aux = tr.train_step(latents, cond, rolled_cond_tensors=rolled, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {n: fn.launches for n, fn in kernels.items()}
        losses = {k: float(v) for k, v in aux.items()}
        if not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"ARC {kind} step: losses {losses}")
        rec["steps"].append(dict(kind=kind, ms=ms, launches=launches, losses=losses,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
        return launches

    for kind in ("ode", "ode", "gen", "disc", "gen", "disc"):
        launches = step(trainer, kind)
        want = dict(arc_step_launches(kind, depth), conv1d_wgrad=0)
        if launches != want:
            raise AssertionError(f"ARC {kind} step launches {launches}, expected {want}")
    trainable = sum(p.numel() for p in trainer.params.values())
    disc_trainable = sum(p.numel() for p in trainer.disc_params.values())
    rec["memory_gib"] = dict(  # f32 state reckoned from the shapes: weights, gradients,
        # AdamW's two moments, and the student's EMA
        student=20 * trainable / 2 ** 30, discriminator=16 * disc_trainable / 2 ** 30)

    # the ConvNeXt head: a trainer over the same student and discriminator
    arc_cfg = copy.deepcopy(ARC_CONFIG)
    arc_cfg["gan"]["head"] = {"type": "convnext"}
    disc = trainer.discriminator
    del trainer
    torch.cuda.empty_cache()
    opt = {"optimizer": {"type": "AdamW", "config": {"lr": 1e-5}}}
    convnext = ARCTrainer(model, disc, arc_cfg, {"diffusion": opt, "discriminator": opt},
                          cfg_dropout_prob=0.1)
    wgrad = convnext_head_wgrad_shapes(io, 1 + ARC_LATENTS)
    launches = step(convnext, "disc_convnext", step=3)
    want = dict(arc_step_launches("disc", depth), conv1d_wgrad=sum(wgrad.values()))
    if launches != want:
        raise AssertionError(f"ARC ConvNeXt discriminator step launches {launches}, "
                             f"expected {want}")
    rec["launches"] = {n: sum(s["launches"][n] for s in rec["steps"]) for n in names}
    rec["convnext_wgrad_shapes"] = wgrad
    rec["step_launches"] = {k: arc_step_launches(k, depth) for k in ("ode", "gen", "disc")}
    rec.update(trainable=trainable, disc_trainable=disc_trainable)
    del convnext, model, disc, cond, rolled, latents
    torch.cuda.empty_cache()
    return rec


def phase_rf(dev) -> dict:
    """Phase 15: rectified flow and ARC at SA-Open's width: (a) generation
    by the four flow samplers (after the tiny card-vs-CPU check of each), (b)
    rf training from audio, (c) inpainting training and its demo, (d) ARC's
    ODE, generator and discriminator steps, (e) row 11 held at the ConvNeXt
    head's shapes (the other rows of this phase run at phase 2's shapes)."""
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs

    t_phase = time.perf_counter()
    small, small_tol = small_rf_check(dev), 0.05
    if max(v for k, v in small.items() if k.endswith(" cfg 1")) > small_tol:
        raise AssertionError(f"small rf samplers card vs CPU at cfg 1: {small} > {small_tol}")
    rec = dict(small=small, small_tol=small_tol, generation=rf_generation(dev))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rf_") as tmp:
        data = write_dataset(tmp)
        rec["training"] = rf_training_run(dev, tmp, data, inpaint=False, timed=TIMED_STEPS)
        rec["inpaint"] = rf_training_run(dev, tmp, data, inpaint=True,
                                         timed=INPAINT_TIMED_STEPS)
    rec["arc"] = arc_run(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    rec["convnext_wgrad"] = plain_wgrad_checks(cs, randn, rec["arc"].pop("convnext_wgrad_shapes"),
                                               ARC_BATCH)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


TAAE_REQUEST_SAMPLES = 2097152  # 47.6 s of 44.1 kHz stereo: 4,096 latents at ratio 512


def taae_launches(model) -> dict:
    """Launches counted from a TAAE autoencoder: a forward (encode + decode)
    runs row 5 once a transformer block (its windowed self-attention) and
    row 2 for each of its LayerNorms (pre_norm, ff_norm and the "ln"
    qk-norm's two); a generator step adds row 6 once a block (the
    attention's backward) and row 11 plain once a stride-1 conv (each
    tower's conv_in and conv_out; a stage's conv is strided or transposed,
    cuDNN's); a discriminator step runs the forward under no_grad."""
    from stable_audio_tools_tpu_torch.ops.transformer import TransformerBlock

    blocks = [m for m in model.modules() if isinstance(m, TransformerBlock)]
    forward = {"flash_attention": len(blocks),
               "fused_layer_norm": sum(2 + 2 * (b.self_attn.qk_norm == "ln") for b in blocks)}
    gen = dict(forward, flash_attention_prefix_bwd=len(blocks),
               conv1d_wgrad=2 * len((model.encoder, model.decoder)))
    return {"forward": forward, "gen": gen, "disc": dict(forward)}


def taae_request(dev, fsq: bool) -> dict:
    """One request of `taae_config(fsq)` at full width, seeded random weights,
    bf16 compute: encode then decode one stereo clip of TAAE_REQUEST_SAMPLES
    unchunked (the FSQ's codes decoded back by `decode_tokens`), after a
    warm-up round trip at the same size (the allocator's growth and the
    libraries' algorithm choices at these shapes stay out of the timed
    one): wall s, audio-s/s, peak GiB, the
    launches (pinned to `taae_launches`), then the same round trip under
    the profiler (device-busy share, top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = init_random_(create_model_from_config(taae_config(fsq), dev),
                         torch.Generator(device=dev).manual_seed(16)).eval()
    want = taae_launches(model)["forward"]
    g = torch.Generator(device=dev).manual_seed(17)
    audio = (0.3 * torch.randn(1, 2, TAAE_REQUEST_SAMPLES, generator=g, device=dev)).to(
        torch.bfloat16)

    def round_trip(x):
        latents, info = model.encode(x, generator=g, return_info=True)
        if fsq:
            return latents, info, model.decode_tokens(info["quantizer_indices"],
                                                      dtype=torch.bfloat16)
        return latents, info, model.decode(latents)

    kernels = counters()
    with torch.no_grad():
        round_trip(audio)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents, info, decoded = round_trip(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        latent_shape = (1, 64, TAAE_REQUEST_SAMPLES // 512)
        if (tuple(latents.shape) != latent_shape or tuple(decoded.shape) != tuple(audio.shape)
                or not torch.isfinite(decoded.float()).all()):
            raise AssertionError(f"TAAE request: latents {tuple(latents.shape)}, audio "
                                 f"{tuple(decoded.shape)}, finite "
                                 f"{bool(torch.isfinite(decoded.float()).all())}")
        if launches != want:
            raise AssertionError(f"TAAE request launches {launches}, expected {want}")
        rec = {}
        if fsq:
            codes = model.bottleneck.decode_tokens(info["quantizer_indices"])
            if not torch.equal(codes.to(latents.dtype), latents):
                raise AssertionError("TAAE FSQ: decode_tokens of the codes is not the latents")
            rec["codes"] = list(info["quantizer_indices"].shape)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            round_trip(audio)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("TAAE request: the profiler saw no kernel")
    rec.update(params=sum(p.numel() for p in model.parameters()), wall_s=wall,
               audio_s_per_s=TAAE_REQUEST_SAMPLES / 44100 / wall, peak_gib=peak,
               launches=launches, profiled_wall_ms=wall_us / 1e3, device_busy=busy_us / wall_us,
               top_kernels_ms={e.key[:60]: round(e.self_device_time_total / 1e3, 3) for e in
                               sorted(events, key=lambda e: -e.self_device_time_total)[:6]})
    del model, audio, latents, info, decoded, prof
    torch.cuda.empty_cache()
    return rec


def small_taae_option_checks(dev) -> dict:
    """Tiny TAAE trainers (bf16, gains as `small_gan_check`'s reduced ones)
    with the kernels on the card against the plain versions on the CPU, the
    same weights, batch and draws on both sides, deterministic algorithms
    on: "options" (`latent_mask_ratio` 0.5, `encoder_freeze_on_warmup`
    after a one-step warm-up and a teacher: generator, discriminator, frozen
    generator), "dithered_fsq" and "wasserstein" (a generator and a
    discriminator step). Each step's largest relative error of its named
    losses and ||card - CPU|| / ||CPU|| of its side's whole gradient."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.autoencoders import AutoencoderTrainer

    wasserstein = tiny_taae_config()  # the encoder's 8 channels are the latents
    wasserstein["model"]["bottleneck"] = {"type": "wasserstein"}
    wasserstein["model"]["encoder"]["config"]["latent_dim"] = 8
    cases = {"options": (tiny_taae_config(), True),
             "dithered_fsq": (tiny_taae_config(fsq=True), False),
             "wasserstein": (wasserstein, False)}

    def model_on(cfg, seed, where):
        model = init_random_(create_model_from_config(copy.deepcopy(cfg), "cpu"),
                             torch.Generator().manual_seed(seed))
        scale_gains(model, SMALL_AE_GAIN)
        return model.to(where)

    def moved(x, where):
        return {k: v.to(where) for k, v in x.items()} if isinstance(x, dict) else x.to(where)

    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, (cfg, options) in cases.items():
            tr = cfg["training"]
            sides = []
            for where in ("cpu", dev):
                kw = {}
                if options:
                    kw = dict(latent_mask_ratio=0.5, encoder_freeze_on_warmup=True,
                              warmup_steps=1, teacher_model=model_on(cfg, 2, where))
                w = AutoencoderTrainer(model_on(cfg, 1, where), sample_rate=cfg["sample_rate"],
                                       loss_config=tr["loss_configs"],
                                       optimizer_configs=tr.get("optimizer_configs"),
                                       lr=tr.get("learning_rate"),
                                       compute_dtype=tr.get("compute_dtype"), **kw)
                if sides:
                    w.discriminator.load_state_dict(sides[0].discriminator.state_dict())
                sides.append(w)
            cpu, card = sides
            g = torch.Generator().manual_seed(3)
            audio = 0.3 * torch.randn(2, cfg["audio_channels"], cfg["sample_size"], generator=g)
            m = cfg["model"]
            shape = (2, m["latent_dim"], cfg["sample_size"] // m["downsampling_ratio"])
            rec = {}
            for step in range(3 if options else 2):
                noise = ({"keep": torch.tensor([True, False]), "apply": torch.tensor([False, True]),
                          "dither": torch.rand(*shape, generator=g)}
                         if name == "dithered_fsq" else torch.randn(*shape, generator=g))
                draws = {"latent_mask": torch.rand(*shape, generator=g),
                         "teacher_noise": torch.randn(*shape, generator=g)}
                ac = cpu.train_step(audio, noise=noise, draws=draws)
                ag = card.train_step(audio.to(dev), noise=moved(noise, dev),
                                     draws=moved(draws, dev))
                if not all(math.isfinite(float(v)) for v in ag.values()):
                    raise AssertionError(f"small TAAE {name} step {step}: losses {ag}")
                side = "disc" if step == 1 else "gen"
                pick = (lambda w: w.disc_params) if side == "disc" else (lambda w: w.params)
                rec[f"step{step}_{side}_loss_rel_err"] = max(
                    abs(float(ag[k]) - float(v)) / max(abs(float(v)), 1e-6) for k, v in ac.items())
                rec[f"step{step}_{side}_grad_rel_err"] = grad_rel_errs(pick(card), pick(cpu))[2]
            out[name] = rec
    finally:
        torch.use_deterministic_algorithms(False)
    return out


# the DiT's config keys no shipped config sets, at toy size (heads of 64
# under a window, so row 5 runs; bf16)
SMALL_DIT_OPTIONS = dict(io_channels=8, embed_dim=128, depth=2, num_heads=2, cond_token_dim=16,
                         global_cond_dim=12, patch_size=2, global_cond_type="adaLN",
                         timestep_cond_type="input_concat", timestep_embed_dim=24,
                         layer_scale=True, qk_norm="ln", ff_mult=2, num_memory_tokens=2,
                         sliding_window=(31, 32), compute_dtype="bfloat16",
                         use_checkpointing=False)


def small_dit_options_check(dev) -> dict:
    """A tiny DiT with adaLN, memory tokens, patch_size 2, the timestep by
    input_concat, LayerScale (set to SMALL_LAYER_SCALE), the "ln" qk-norm
    and a window: its forward on the card (row 5 once a block, row 2 for
    each norm) against the CPU's, the same seeded weights and inputs:
    ||card - CPU|| / ||CPU|| and the launches."""
    from stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
    from stable_audio_tools_tpu_torch.models.factory import init_random_

    g = torch.Generator().manual_seed(4)
    x, t = torch.randn(2, 8, 512, generator=g), torch.rand(2, generator=g)
    ctx, glob = torch.randn(2, 5, 16, generator=g), torch.randn(2, 12, generator=g)
    outs, launches = [], {}
    for where in ("cpu", dev):
        model = init_random_(DiffusionTransformer(**SMALL_DIT_OPTIONS),
                             torch.Generator().manual_seed(5))
        scale_gains(model, 1.0)
        model = model.to(where).eval()
        kernels = counters()
        for fn in kernels.values():
            fn.launches = 0
        with torch.no_grad():
            outs.append(model(x.to(where), t.to(where), cross_attn_cond=ctx.to(where),
                              global_embed=glob.to(where)).float().cpu())
        launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
    # a block: one windowed self-attention; pre_norm, cross_attend_norm,
    # ff_norm and the two attentions' q and k norms
    want = {"flash_attention": 2, "fused_layer_norm": 2 * 7}
    if launches != want:
        raise AssertionError(f"small DiT options: launches {launches}, expected {want}")
    err = float((outs[1] - outs[0]).norm() / outs[0].norm())
    return dict(rel_err=err, launches=launches)


def oobleck_bf16_check(dev) -> dict:
    """`oobleck_bf16_case`'s decode in bf16 on the card (the kernels) against
    the port's f32 decode on the CPU (the plain versions) with the same
    weights: ||card - f32|| / ||f32|| may be at most twice the JAX
    package's own bf16 distance, OOBLECK_BF16_JAX."""
    cfg, z = oobleck_bf16_case()
    z = torch.from_numpy(z)
    with torch.no_grad():
        want = oobleck_bf16_decoder(cfg)(z)
        got = oobleck_bf16_decoder(cfg, dev)(z.to(dev, torch.bfloat16)).float().cpu()
    dist = float((got - want).norm() / want.norm())
    if not dist <= 2 * OOBLECK_BF16_JAX:
        raise AssertionError(f"the card's bf16 Oobleck decode lies {dist:.4g} from f32, more "
                             f"than 2 x the JAX package's {OOBLECK_BF16_JAX}")
    return dict(card_bf16_vs_f32=dist, jax_bf16_vs_f32=OOBLECK_BF16_JAX, samples=got.shape[-1])


def phase_taae(dev) -> dict:
    """Phase 16: the transformer autoencoder at full width: (a) a request of
    `taae_vae_gan` and of `taae_dithered_fsq`; (c) the tiny option checks
    and the tiny DiT's;
    (b) `gan_phase` of `taae_vae_gan` (its tiny twin's `small_gan_check`,
    then 1 + 3 pairs at batch 4 x 65,536), launches pinned from
    `taae_launches` (rows 5 / 2 24 / 96 a forward, rows 6 / 11 plain 24 / 4
    more a generator step). Rows 5 and 6 at the training shapes: phase 2."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    t_phase = time.perf_counter()
    counts = taae_launches(create_model_from_config(taae_config(), "meta"))
    pinned = {"flash_attention": 24, "fused_layer_norm": 96, "flash_attention_prefix_bwd": 24,
              "conv1d_wgrad": 4}
    if counts["gen"] != pinned:
        raise AssertionError(f"TAAE launches {counts['gen']}, pinned {pinned}")
    rec = {"request": taae_request(dev, fsq=False), "fsq_request": taae_request(dev, fsq=True)}
    options, tol = small_taae_option_checks(dev), 0.05
    options["dit"] = small_dit_options_check(dev)
    worst = max(v for r in options.values() for k, v in r.items() if k.endswith("rel_err"))
    if not worst <= tol:
        raise AssertionError(f"small TAAE option steps card vs CPU: {options} > {tol}")
    rec["training"] = gan_phase(dev, taae_config(), tiny_taae_config,
                                dict(gen=counts["gen"], disc=counts["disc"]))
    rec.update(options=options, options_tol=tol, counts=counts,
               phase_s=time.perf_counter() - t_phase)
    return rec

# -- phase 17: the diffusion autoencoder and the DAC RVQ codec ----------------

DANCE_44K = os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                         "dance_diffusion", "dance_diffusion_base_44k.json")
DIFFAE_SAMPLES, DIFFAE_SR, DIFFAE_BATCH = 65536, 44100, 4
DIFFAE_WARM_STEPS, DIFFAE_TIMED_STEPS = 2, 5
DAC_RVQ_SAMPLES = 2097152  # 47.6 s of 44.1 kHz mono: 1,024 latents at ratio 2048
# the kernels of an encode of `diffae_config()` (the SA-2.0 VAE's encoder: 15
# residual units, 5 blocks) and of one training step (its backward, and row 11
# plain at the encoder's conv_in and the DAU1d's 259 stride-1 convs)
DIFFAE_ENCODE_LAUNCHES = {"snake_conv1d": 16, "snake_conv1d_res": 15, "snake_fused": 5}
DIFFAE_STEP_LAUNCHES = dict(DIFFAE_ENCODE_LAUNCHES, snake_conv1d_dx=31, snake_conv1d_wgrad=31,
                            snake_fused_bwd=5, conv1d_wgrad=260)


def diffae_config() -> dict:
    """`diffae_oobleck_dau`, built in memory (no shipped config names a
    diffusion autoencoder): the encoder and VAE bottleneck of
    autoencoders/stable_audio_2_0_vae.json (Oobleck, 128 channels, mults
    1-2-4-8-16, strides 2-4-4-8-8, 128 -> 64 latents), the DAU1d of
    dance_diffusion/dance_diffusion_base_44k.json (depth 14, 128-512
    channels, 5 attention layers, strides 2 x 13, bf16) with cond_dim 64,
    ratio 2048, 65,536 samples of 44.1 kHz stereo, the demo at the JAX
    callback's defaults. `encoder_compute_dtype` bfloat16: the card's snake
    kernels take bf16 only (the JAX package encodes in f32;
    tests/test_torch_diffae.py pins the distance)."""
    vae = sa2_vae_config()["model"]
    with open(DANCE_44K) as f:
        dau = json.load(f)["model"]["config"]
    return {"model_type": "diffusion_autoencoder", "sample_size": DIFFAE_SAMPLES,
            "sample_rate": DIFFAE_SR, "audio_channels": 2,
            "model": {"encoder": vae["encoder"], "bottleneck": vae["bottleneck"],
                      "diffusion": {"type": "DAU1d", "config": dict(dau, cond_dim=64)},
                      "io_channels": 2, "latent_dim": 64, "downsampling_ratio": 2048,
                      "encoder_compute_dtype": "bfloat16"},
            "training": {"learning_rate": 1e-4, "demo": {"demo_every": 2000}}}


def diffae_launches(model) -> dict:
    """Launches counted from a diffusion AE with an Oobleck encoder: an
    encode runs rows 12 / 3 a residual unit (k = 7, k = 1 + skip), row 12
    the snake + conv_out, row 4 before each strided conv; a training step
    adds each snake-conv's rows 10 and 11, each snake's row 9 and row 11
    plain at the conv_in and at each stride-1 conv of a DAU1d (cuDNN runs
    its forward: a request's decode launches none)."""
    from stable_audio_tools_tpu_torch.models.autoencoders import EncoderBlock, ResidualUnit

    units = sum(isinstance(m, ResidualUnit) for m in model.encoder.modules())
    blocks = sum(isinstance(m, EncoderBlock) for m in model.encoder.modules())
    encode = {"snake_conv1d": units + 1, "snake_conv1d_res": units, "snake_fused": blocks}
    return {"encode": encode, "step": dict(
        encode, snake_conv1d_dx=2 * units + 1, snake_conv1d_wgrad=2 * units + 1,
        snake_fused_bwd=blocks, conv1d_wgrad=1 + model.diffusion.model.conv_sites())}


def diffae_request(dev) -> dict:
    """One request of `diffae_config()` at full width, seeded random
    weights: encode one stereo clip of DIFFAE_SAMPLES, then `decode` in
    STEPS v-DDIM steps, after a 2-step warm-up at the same size: wall s,
    ms a sampler step, peak GiB, launches (pinned), then one sampler step
    (a denoiser call) timed back to back and profiled, and one encode
    profiled (device-busy shares)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = init_random_(create_model_from_config(diffae_config(), dev),
                         torch.Generator(device=dev).manual_seed(19)).eval()
    g = torch.Generator(device=dev).manual_seed(20)
    audio = 0.3 * torch.randn(1, 2, DIFFAE_SAMPLES, generator=g, device=dev)

    def request(steps):
        latents = model.encode(audio, generator=g)
        return latents, model.decode(latents, steps, generator=g)

    kernels = counters()
    with torch.inference_mode():
        request(2)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents, out = request(STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if (tuple(latents.shape) != (1, model.latent_dim, DIFFAE_SAMPLES // model.min_length)
                or tuple(out.shape) != (1, 2, DIFFAE_SAMPLES) or not torch.isfinite(out).all()):
            raise AssertionError(f"diffusion AE request: latents {tuple(latents.shape)}, audio "
                                 f"{tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        if launches != DIFFAE_ENCODE_LAUNCHES:
            raise AssertionError(f"diffusion AE request launches {launches}, expected "
                                 f"{DIFFAE_ENCODE_LAUNCHES}")
        x = torch.randn(1, 2, DIFFAE_SAMPLES, generator=g, device=dev)
        t = torch.full((1,), 0.5, device=dev)
        step = lambda: model.diffusion_forward(x, t, latents, generator=g)
        step_ms = cuda_ms(step, 5)
        step_profile = profiled_window(step)
        encode_profile = profiled_window(lambda: model.encode(audio, generator=g))
    rec = dict(params=sum(p.numel() for p in model.parameters()), wall_s=wall, steps=STEPS,
               audio_s_per_s=DIFFAE_SAMPLES / DIFFAE_SR / wall, peak_gib=peak,
               launches=launches, step_ms=step_ms, step_profile=step_profile,
               encode_profile=encode_profile)
    del model, audio, latents, out
    torch.cuda.empty_cache()
    return rec


def diffae_training(dev) -> dict:
    """`diffae_config()` trained through `train.build` and `Trainer.fit`
    at batch 4 x 65,536 on seeded synthetic 44.1 kHz stereo WAVs: 2 warm-up
    and 5 timed steps, every parameter with a finite gradient in the first
    step (the encoder's through the latents), the launches pinned, the
    parameters and the EMA moved, one forward+backward profiled; then one
    demo at the callback's defaults through the entry's wiring."""
    from stable_audio_tools_tpu_torch import train

    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_diffae_") as tmp:
        cfg_path = os.path.join(tmp, "model.json")
        with open(cfg_path, "w") as f:
            json.dump(diffae_config(), f)
        dataset = write_dataset(tmp, 16, 3, 0.25, sr=DIFFAE_SR)
        args = train.parse_args([
            "--model-config", cfg_path, "--dataset-config", dataset,
            "--batch-size", str(DIFFAE_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(DIFFAE_WARM_STEPS + DIFFAE_TIMED_STEPS), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        trainer, loader, _ = train.build(args, device=dev)
        w = trainer.wrapper
        if diffae_launches(w.model)["step"] != DIFFAE_STEP_LAUNCHES:
            raise AssertionError(f"diffusion AE launches {diffae_launches(w.model)['step']}, "
                                 f"pinned {DIFFAE_STEP_LAUNCHES}")
        before = {n: p.detach().clone() for n, p in w.params.items()}
        trainer.fit(loader, max_steps=1, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or (n.startswith("encoder.") and not p.grad.abs().max() > 0)]
        if bad:
            raise AssertionError(f"diffusion AE step 1: {len(bad)} parameters without a finite "
                                 f"(encoder: nonzero) gradient: {bad[:8]}")
        trainer.fit(loader, max_steps=DIFFAE_WARM_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        kernels = counters()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader, max_steps=DIFFAE_WARM_STEPS + DIFFAE_TIMED_STEPS, save_at_end=False)
        torch.cuda.synchronize()
        rec["launches"] = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {n: DIFFAE_TIMED_STEPS * c for n, c in DIFFAE_STEP_LAUNCHES.items()}
        if rec["launches"] != want:
            raise AssertionError(f"diffusion AE training launches {rec['launches']}, "
                                 f"expected {want}")
        losses = [h["train/loss"] for h in trainer.history]
        if len(losses) != DIFFAE_WARM_STEPS + DIFFAE_TIMED_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"diffusion AE training losses: {losses}")
        unmoved = [n for n, p in w.params.items() if torch.equal(p.detach(), before[n])]
        unmoved += [f"ema {n}" for n, e in w.ema.items() if torch.equal(e, before[n])]
        if unmoved:
            raise AssertionError(f"diffusion AE: tensors that did not move: {unmoved[:8]}")
        del before
        walls = [1e3 / h["train/steps_per_sec"] for h in trainer.history[DIFFAE_WARM_STEPS:]]
        median = statistics.median(walls)
        rec.update(losses=losses, step_ms=walls, step_ms_median=median,
                   audio_s_per_s=DIFFAE_BATCH * DIFFAE_SAMPLES / DIFFAE_SR / (median / 1e3),
                   params=sum(p.numel() for p in w.params.values()))
        audio = trainer.prepare_batch(next(iter(loader))[0])

        def fwd_bwd():
            loss, _ = w.loss(audio, w.generator(w.step))
            loss.backward()

        fwd_bwd()
        rec["fwd_bwd_profile"] = profiled_window(fwd_bwd)
        w.optimizer.zero_grad(set_to_none=True)
        with open(dataset) as f:
            dataset_config = json.load(f)
        rec["demo"], _ = one_demo(trainer, [
            "--model-config", cfg_path, "--dataset-config", dataset, "--batch-size",
            str(DIFFAE_BATCH), "--save-dir", trainer.save_dir, "--demo-every", "1"],
            dataset_config, "diffusion AE")
        if rec["demo"]["launches"] != DIFFAE_ENCODE_LAUNCHES:
            raise AssertionError(f"diffusion AE demo launches {rec['demo']['launches']}, "
                                 f"expected {DIFFAE_ENCODE_LAUNCHES}")
        del trainer, loader, w
    torch.cuda.empty_cache()
    return rec


def dac_rvq_config() -> dict:
    """`dac_rvq_2048_32`, built in memory: autoencoders/dac_2048_32_vae.json's
    DAC towers with the encoder's latent_dim 32 and a `dac_rvq` bottleneck
    of the quantizer settings of descript-audio-codec's published 44 kHz
    model (conf/final/44khz.yml: 9 codebooks of 1024 x 8), the shipped
    loss weights plus the bottleneck's codebook 1.0 and commitment 0.25."""
    cfg = dac_vae_config("dac_2048_32_vae")
    m = cfg["model"]
    m["encoder"]["config"]["latent_dim"] = 32
    m["bottleneck"] = {"type": "dac_rvq", "config": {
        "input_dim": 32, "n_codebooks": 9, "codebook_size": 1024, "codebook_dim": 8}}
    cfg["training"]["loss_configs"]["bottleneck"]["weights"].update(codebook=1.0,
                                                                    commitment=0.25)
    return cfg


def tiny_dac_rvq_config(compute_dtype: str = "bfloat16") -> dict:
    """`dac_rvq_config()`'s tiny twin: `tiny_dac_vae_config`'s towers with a
    DAC RVQ of 2 codebooks of 16 x 4 over 4 latents (a small codebook:
    a code that bf16 rounding flips moves a large share of few positions'
    gradient otherwise)."""
    cfg = tiny_dac_vae_config("dac_2048_32_vae", compute_dtype)
    m = cfg["model"]
    m["encoder"]["config"]["latent_dim"] = 4
    m["bottleneck"] = {"type": "dac_rvq", "config": {
        "input_dim": 4, "n_codebooks": 2, "codebook_size": 16, "codebook_dim": 4}}
    cfg["training"]["loss_configs"]["bottleneck"]["weights"].update(codebook=1.0,
                                                                    commitment=0.25)
    return cfg


def dac_rvq_round_trip(dev) -> dict:
    """`dac_rvq_config()` at full width, seeded random weights, bf16 towers:
    encode DAC_RVQ_SAMPLES of mono into the codes [1, 9, 1024], then
    `decode_tokens` of them (after a warm-up round trip at the same size):
    wall s, audio-s/s, peak GiB, launches (pinned: an encode's and a
    decode's forward kernels), the codes' decode equal to the encode's
    quantized latents (1e-4 of their peak), the round trip profiled."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = init_random_(create_model_from_config(dac_rvq_config(), dev),
                         torch.Generator(device=dev).manual_seed(21)).eval()
    want = dac_gen_launches(model)["disc"]
    g = torch.Generator(device=dev).manual_seed(22)
    audio = (0.3 * torch.randn(1, 1, DAC_RVQ_SAMPLES, generator=g, device=dev)).to(
        torch.bfloat16)

    def round_trip():
        z, info = model.encode(audio, return_info=True)
        return z, info["codes"], model.decode_tokens(info["codes"], dtype=torch.bfloat16)

    kernels = counters()
    with torch.inference_mode():
        round_trip()
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        z, codes, out = round_trip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        latents = DAC_RVQ_SAMPLES // model.downsampling_ratio
        if (tuple(codes.shape) != (1, model.bottleneck.n_codebooks, latents)
                or tuple(out.shape) != (1, 1, DAC_RVQ_SAMPLES)
                or not torch.isfinite(out.float()).all()):
            raise AssertionError(f"DAC RVQ round trip: codes {tuple(codes.shape)}, audio "
                                 f"{tuple(out.shape)}")
        if launches != want:
            raise AssertionError(f"DAC RVQ round trip launches {launches}, expected {want}")
        from_codes = model.bottleneck.decode_tokens(codes)
        err = float((from_codes - z).abs().max() / z.abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"DAC RVQ: decode_tokens of the codes lies {err:.3g} from "
                                 "the encode's quantized latents")
        profile = profiled_window(round_trip)
    rec = dict(params=sum(p.numel() for p in model.parameters()), wall_s=wall,
               audio_s_per_s=DAC_RVQ_SAMPLES / 44100 / wall, peak_gib=peak, launches=launches,
               codes=list(codes.shape), codes_vs_latents=err, profile=profile)
    del model, audio, z, codes, out
    torch.cuda.empty_cache()
    return rec


# the tiny bottleneck cases of `small_slice19_checks` on `tiny_ae_config`'s
# towers (the encoder's latent_dim, the bottleneck, the decoder's latent_dim;
# a softnorm's `noise` is a dict)
SMALL_BOTTLENECKS = {
    # the codebooks from the seeded init, not k-means: Lloyd's iterations
    # turn the two sides' bf16 differences into other centers and many
    # other codes (the k-means itself: tests/test_torch_dac_rvq.py, phase 14)
    "rvq_vae": (16, {"type": "rvq_vae", "config": {"dim": 8, "codebook_size": 16,
                                                    "num_quantizers": 2,
                                                    "kmeans_init": False}}, 8),
    "dac_rvq_vae": (16, {"type": "dac_rvq_vae", "config": {
        "input_dim": 8, "n_codebooks": 2, "codebook_size": 16, "codebook_dim": 4}}, 8),
    "dac_rvq_quantize_on_decode": (8, {"type": "dac_rvq", "config": {
        "input_dim": 8, "n_codebooks": 2, "codebook_size": 16, "codebook_dim": 4,
        "quantize_on_decode": True}}, 8),
    "dac_rvq_noise_augment": (8, {"type": "dac_rvq", "config": {
        "input_dim": 8, "n_codebooks": 2, "codebook_size": 16, "codebook_dim": 4,
        "noise_augment_dim": 2}}, 10),
    "softnorm_noise": (8, {"type": "softnorm", "config": {
        "dim": 8, "noise_augment_dim": 2, "noise_regularize": True}}, 10),
    "wasserstein_noise_augment": (8, {"type": "wasserstein", "config": {
        "noise_augment_dim": 2}}, 10),
    "fsq_noise_augment": (8, {"type": "fsq", "config": {
        "levels": [5, 5, 5, 5], "num_codebooks": 2, "noise_augment_dim": 2}}, 10),
}


def small_bottleneck_configs() -> dict:
    """The tiny AE trainers of `small_slice19_checks`: `tiny_ae_config` with
    each SMALL_BOTTLENECKS case, and `tiny_dac_rvq_config` (the DAC towers
    with a DAC RVQ)."""
    out = {}
    for name, (enc_dim, bottleneck, dec_dim) in SMALL_BOTTLENECKS.items():
        cfg = tiny_ae_config()
        m = cfg["model"]
        m["encoder"]["config"]["latent_dim"] = enc_dim
        m["decoder"]["config"]["latent_dim"] = dec_dim
        m["bottleneck"] = copy.deepcopy(bottleneck)
        m["latent_dim"] = 8
        out[name] = cfg
    out["dac_towers_dac_rvq"] = tiny_dac_rvq_config()
    return out


def tiny_diffae_config(kind: str) -> dict:
    """A tiny diffusion AE of `kind` ("DAU1d" with cond_noise_aug, "adp_1d",
    "dit"): `tiny_ae_config`'s Oobleck encoder (channels 32, bf16 through
    `encoder_compute_dtype`) with a VAE to 8 latents at ratio 8, the
    diffusion model in bf16 (the DAU1d, for row 11 plain; the DiT, heads of
    64) or f32 (the ADP UNet), 4,096 samples."""
    enc = tiny_ae_config()["model"]["encoder"]
    diffusion = {
        "DAU1d": {"type": "DAU1d", "config": {
            "io_channels": 2, "depth": 3, "n_attn_layers": 1, "channels": [32, 32, 64],
            "strides": [2, 2], "cond_dim": 8, "cond_noise_aug": True,
            "compute_dtype": "bfloat16"}},
        "adp_1d": {"type": "adp_1d", "config": {
            "in_channels": 2, "channels": 16, "multipliers": [1, 2, 2], "factors": [2, 2],
            "num_blocks": [1, 1], "attentions": [0, 0, 1], "resnet_groups": 8,
            "attention_heads": 2, "attention_features": 32, "context_channels": [8]}},
        "dit": {"type": "dit", "config": {
            "io_channels": 2, "embed_dim": 128, "depth": 2, "num_heads": 2,
            "input_concat_dim": 8, "compute_dtype": "bfloat16", "use_checkpointing": False}},
    }[kind]
    return {"model_type": "diffusion_autoencoder", "sample_size": 4096, "sample_rate": 44100,
            "audio_channels": 2,
            "model": {"encoder": enc, "bottleneck": {"type": "vae"}, "diffusion": diffusion,
                      "io_channels": 2, "latent_dim": 8, "downsampling_ratio": 8,
                      "encoder_compute_dtype": "bfloat16"},
            "training": {"learning_rate": 1e-4}}


def tiny_uncond_config(kind: str) -> dict:
    """A tiny unconditional `adp_uncond_1d` (f32) or `dit` (bf16, heads of
    64), 1,024 samples of stereo (the DiT's 1,025 rows take row 1, the tiny
    diffusion AE's 4,097 the NHD route, rows 7 / 8)."""
    cfg = {"adp_uncond_1d": {"in_channels": 2, "channels": 16, "multipliers": [1, 2, 2],
                             "factors": [2, 2], "num_blocks": [1, 1], "attentions": [0, 0, 1],
                             "resnet_groups": 8, "attention_heads": 2,
                             "attention_features": 32},
           "dit": {"io_channels": 2, "embed_dim": 128, "depth": 2, "num_heads": 2,
                   "compute_dtype": "bfloat16", "use_checkpointing": False}}[kind]
    return {"model_type": "diffusion_uncond", "sample_size": 1024, "sample_rate": 16000,
            "audio_channels": 2, "model": {"type": kind, "config": cfg},
            "training": {"learning_rate": 1e-4}}


def small_slice19_checks(dev) -> dict:
    """Phase 17 (c): tiny models with the kernels on the card against the
    plain versions on the CPU, the same seeded weights, batch and draws, the
    deterministic algorithms on: for each of `small_bottleneck_configs` a
    generator and a discriminator step (gains x SMALL_AE_GAIN, the VAE / MMD
    noise and the decode-side draws given);
    for each tiny diffusion AE (`tiny_diffae_config`) a training step (t,
    the noises and the DAU1d's conditioning augmentation given) and a
    10-step decode; for each tiny unconditional model a training step and
    10-step `generate_diffusion_uncond` requests (its noises given): the
    ADP UNet's (f32) by dpmpp-2m-sde, the bf16 DiT's by v-DDIM and
    dpmpp-2m-sde held to DANCE_SPREAD x the CPU's own bf16 distance from
    f32. Each entry: the
    largest relative error of the named losses, ||card - CPU|| / ||CPU|| of
    the whole trained side's gradient and of an output, and the card's
    launches."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_uncond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    def rel(a, b):
        return float((a.float().cpu() - b.float()).norm() / b.float().norm())

    def loss_err(ac, ag):
        return max(abs(float(ag[k]) - float(v)) / max(abs(float(v)), 1e-6) for k, v in ac.items())

    def moved(x, where):
        return {k: moved(v, where) for k, v in x.items()} if isinstance(x, dict) else x.to(where)

    def counted(fn):
        kernels = counters()
        for k in kernels.values():
            k.launches = 0
        out = fn()
        return out, {n: k.launches for n, k in kernels.items() if k.launches}

    def pair(cfg, seed, gain=None):
        out = []
        for where in ("cpu", dev):
            model = init_random_(create_model_from_config(copy.deepcopy(cfg), "cpu"),
                                 torch.Generator().manual_seed(seed))
            if gain is not None:
                scale_gains(model, gain)
            out.append(create_training_wrapper_from_config(copy.deepcopy(cfg), model.to(where)))
        return out

    rec = {}
    g = torch.Generator().manual_seed(23)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, cfg in small_bottleneck_configs().items():
            m = cfg["model"]
            cpu, card = pair(cfg, 24, SMALL_AE_GAIN)
            card.discriminator.load_state_dict(cpu.discriminator.state_dict())
            audio = 0.3 * torch.randn(2, cfg["audio_channels"], cfg["sample_size"], generator=g)
            frames = cfg["sample_size"] // m["downsampling_ratio"]
            r = {}
            for side in ("gen", "disc"):
                noise = torch.randn(2, 8, frames, generator=g)
                aug = torch.randn(2, 2, frames, generator=g)
                decode_noise = ({"regularize": torch.randn(2, 8, frames, generator=g),
                                 "augment": aug} if m["bottleneck"]["type"] == "softnorm"
                                else aug)
                draws = {"decode_noise": decode_noise}
                ac = cpu.train_step(audio, noise=noise, draws=draws)
                ag, launches = counted(lambda: card.train_step(
                    audio.to(dev), noise=noise.to(dev), draws=moved(draws, dev)))
                if not all(math.isfinite(float(v)) for v in ag.values()):
                    raise AssertionError(f"small {name} {side} step: losses {ag}")
                pick = (lambda w: w.params) if side == "gen" else (lambda w: w.disc_params)
                r[f"{side}_loss_rel_err"] = loss_err(ac, ag)
                r[f"{side}_grad_rel_err"] = grad_rel_errs(pick(card), pick(cpu))[2]
                r[f"{side}_launches"] = launches
            rec[name] = r

        for kind in ("DAU1d", "adp_1d", "dit"):
            cfg = tiny_diffae_config(kind)
            cpu, card = pair(cfg, 25, SMALL_AE_GAIN)
            T = cfg["sample_size"]
            audio = 0.3 * torch.randn(2, 2, T, generator=g)
            draws = dict(t=torch.rand(2, generator=g), noise=torch.randn(2, 2, T, generator=g),
                         encode_noise=torch.randn(2, 8, T // 8, generator=g))
            if kind == "DAU1d":
                draws.update(aug_level=torch.rand(2, generator=g),
                             cond_noise=torch.randn(2, 8, T, generator=g))
            ac = cpu.train_step(audio, **draws)
            ag, launches = counted(lambda: card.train_step(audio.to(dev), **moved(draws, dev)))
            r = dict(loss_rel_err=loss_err(ac, ag), grad_rel_err=grad_rel_errs(
                card.params, cpu.params)[2], step_launches=launches)
            latents = torch.randn(2, 8, T // 8, generator=g)
            fixed = {k: draws[k] for k in ("aug_level", "cond_noise") if k in draws}
            outs = []
            for w in (cpu, card):
                w.model.eval()
                with torch.no_grad():
                    outs.append(w.model.decode(latents.to(w.device), 10,
                                               noise=draws["noise"].to(w.device),
                                               **moved(fixed, w.device)))
            r["decode_rel_err"] = rel(outs[1], outs[0])
            rec[f"diffae_{kind}"] = r

        for kind in ("adp_uncond_1d", "dit"):
            cfg = tiny_uncond_config(kind)
            cpu, card = pair(cfg, 26)
            T = cfg["sample_size"]
            audio = 0.5 * torch.randn(3, 2, T, generator=g)
            noise = torch.randn(3, 2, T, generator=g)
            ac = cpu.train_step(audio, [{}] * 3, noise=noise)
            ag, launches = counted(lambda: card.train_step(audio.to(dev), [{}] * 3,
                                                           noise=noise.to(dev)))
            r = dict(loss_rel_err=loss_err(ac, ag), grad_rel_err=grad_rel_errs(
                card.params, cpu.params)[2], step_launches=launches)
            start = torch.randn(1, 2, T, generator=g)
            step_noise = [torch.randn(1, 2, T, generator=g) for _ in range(10)]

            def request(model, sampler):
                return generate_diffusion_uncond(
                    model.eval(), steps=10, sample_size=T, seed=0, sampler_type=sampler,
                    noise=start, step_noise=lambda i, x: step_noise[i].to(x.device))

            if kind != "dit":
                r["request_rel_err"] = rel(request(card.model, "dpmpp-2m-sde"),
                                           request(cpu.model, "dpmpp-2m-sde"))
            else:
                # a bf16 DiT's 10-step request drifts from f32 by several %
                # (7-12% on the CPU at these seeded weights, its forward by
                # 1%): the card is held to DANCE_SPREAD x the CPU's own bf16
                # distance from the f32 model's request, as phase 10 holds Dance
                f32_cfg = copy.deepcopy(cfg)
                f32_cfg["model"]["config"].pop("compute_dtype")
                f32 = create_model_from_config(f32_cfg, "cpu")
                f32.load_state_dict(cpu.model.state_dict())  # the weights after the step
                for sampler in ("v-ddim", "dpmpp-2m-sde"):
                    want = request(f32, sampler)
                    spread = [rel(request(w.model, sampler), want) for w in (cpu, card)]
                    r[f"{sampler}_request"] = dict(cpu_bf16_vs_f32=spread[0],
                                                   card_vs_cpu_f32=spread[1])
                    if not spread[1] <= DANCE_SPREAD * spread[0]:
                        raise AssertionError(
                            f"small uncond dit {sampler} request: the card lies "
                            f"{spread[1]:.3g} from the CPU's f32, more than {DANCE_SPREAD} x "
                            f"the CPU's bf16 {spread[0]:.3g}")
            rec[f"uncond_{kind}"] = r
    finally:
        torch.use_deterministic_algorithms(False)
    for name in ("diffae_dit", "uncond_dit"):
        if not {"flash_attention_prefix", "fused_layer_norm"} & set(rec[name]["step_launches"]):
            raise AssertionError(f"small {name}: no attention or LayerNorm kernel launched "
                                 f"({rec[name]['step_launches']})")
    if not rec["diffae_DAU1d"]["step_launches"].get("conv1d_wgrad"):
        raise AssertionError(f"small diffae_DAU1d launched {rec['diffae_DAU1d']['step_launches']}")
    return rec


def phase_diffae(dev) -> dict:
    """Phase 17: (c) the tiny card-vs-CPU checks (within 5%), (a) the
    diffusion AE's request, training and demo, (b) the DAC RVQ codec's
    round trip and `gan_training` (2 + 5 pairs at batch 4 x 65,536),
    launches counted from its towers."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    t_phase = time.perf_counter()
    counts = diffae_launches(create_model_from_config(diffae_config(), "meta"))
    if counts != {"encode": DIFFAE_ENCODE_LAUNCHES, "step": DIFFAE_STEP_LAUNCHES}:
        raise AssertionError(f"diffusion AE launches {counts}, pinned "
                             f"{DIFFAE_ENCODE_LAUNCHES} / {DIFFAE_STEP_LAUNCHES}")
    small, tol = small_slice19_checks(dev), 0.05
    worst = max(v for r in small.values() for k, v in r.items() if k.endswith("rel_err"))
    if not worst <= tol:
        raise AssertionError(f"phase 17 tiny checks card vs CPU: {small} > {tol}")
    rec = dict(small=small, small_tol=tol, request=diffae_request(dev))
    rec["training"] = diffae_training(dev)
    rec["dac_rvq_round_trip"] = dac_rvq_round_trip(dev)
    # gan_training without gan_phase's `small_gan_check`: its worst single
    # tensor reads the few codes that bf16 rounding flips between the card
    # and the CPU (6.3% at a decoder snake's alpha); the DAC towers' step is
    # held there in phase 13, and with the DAC RVQ over the whole side in (c)
    cfg = dac_rvq_config()
    dac = dac_gen_launches(create_model_from_config(cfg, "meta"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dac_rvq_") as tmp:
        data = write_dataset(tmp, 40, 3, 0.1, sr=cfg["sample_rate"],
                             channels=cfg["audio_channels"])
        rec["dac_rvq_training"] = gan_training(dev, cfg, tmp, data, dac["gen"], dac["disc"],
                                               warm=2, timed=5)
    rec["dac_rvq_training"]["counts"] = dac
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# -- phase 18: the other pretransforms and conditioners -------------------------------------

AP_GENRES = ("ambient", "rock", "jazz", "folk", "techno", "classical", "hiphop", "pop")
AP_META_MODULE = """
import zlib
GENRES = %r
def get_custom_metadata(info, audio):
    # the clip reversed in time as its audio prompt, a genre from its name
    return {"prompt": "synthetic partials, clip " + info["relpath"],
            "audio_prompt": audio[:, ::-1].copy(),
            "genre": GENRES[zlib.crc32(info["relpath"].encode()) %% len(GENRES)]}
""" % (AP_GENRES,)
# phase 18's step counts: generation as phase 3; training 1 + 3 steps as phase 4
# on 4 of phase 4's clips; the LM over encodec_32khz 250 frames (5 s; its ms a
# step is phase 7's metric), cut from 10 s to keep the script within 950 s
AP_WARM_STEPS, AP_TIMED_STEPS = 1, 3
AP_WAVS, AP_LM_FRAMES = 4, 250
DAC_PRETRAINED = {"type": "dac_pretrained", "config": {"model_type": "44khz"}}
ENCODEC_PRETRAINED = {"type": "audiocraft_pretrained",
                      "config": {"model_type": "facebook/encodec_32khz"}}
CLAP_CLIPS, CLAP_SR, CLAP_SAMPLES = 4, 48000, 480000  # 4 x 10 s at 48 kHz
CLAP_TOL = 1e-3  # card vs CPU, f32 (TF32 off), max|card - CPU| / max|CPU| of the embeddings
SIGNAL_PRETRANSFORMS = {
    "patched": {"type": "patched", "config": {"patch_size": 64, "io_channels": 2}},
    "pqmf_16": {"type": "pqmf", "config": {"attenuation": 100, "num_bands": 16}},
    "wavelet_bior4.4": {"type": "wavelet", "config": {"channels": 2, "levels": 3,
                                                      "wavelet": "bior4.4"}},
    "wavelet_bior3.5": {"type": "wavelet", "config": {"channels": 2, "levels": 3,
                                                      "wavelet": "bior3.5"}},
}
# round-trip bounds: patching is exact; the wavelet banks reconstruct
# perfectly (f32 roundings over 3 levels); the PQMF bank is near-perfect (its
# design's aliasing; relative L2 away from the ends, as the JAX package's test)
SIGNAL_TOL = {"patched": 0.0, "pqmf_16": 1e-2, "wavelet_bior4.4": 1e-5, "wavelet_bior3.5": 1e-5}


def audio_prompt_config() -> dict:
    """SA-Open's shipped config with two conditioners added in memory: an
    audio prompt through the model's own VAE (`pretransform`,
    `use_model_pretransform`) projected to cond_dim 768 and concatenated to
    the DiT's input (`input_concat_ids`, `input_concat_dim` 768), and a
    `list` label of AP_GENRES cross-attended beside the prompt and the
    numbers. Its demo section goes (a demo would need an audio prompt, which
    JSON cannot carry)."""
    cfg = sa_open_config()
    m = cfg["model"]
    dim = m["conditioning"]["cond_dim"]
    m["conditioning"]["configs"] += [
        {"id": "audio_prompt", "type": "pretransform",
         "config": {"use_model_pretransform": True, "sample_rate": cfg["sample_rate"]}},
        {"id": "genre", "type": "list", "config": {"options": list(AP_GENRES)}}]
    d = m["diffusion"]
    d["cross_attention_cond_ids"] = d["cross_attention_cond_ids"] + ["genre"]
    d["input_concat_ids"] = ["audio_prompt"]
    d["config"]["input_concat_dim"] = dim
    cfg["training"].pop("demo", None)
    return cfg


def tower_launches(tower, unit_cls, block_cls) -> dict:
    """Snake-conv launches of one pass of an Oobleck or DAC tower, counted
    from it: each residual unit row 12 (k = 7) and row 3 (k = 1 + skip), the
    final snake + conv row 12, the snake before each strided or transposed
    conv row 4."""
    units = sum(isinstance(m, unit_cls) for m in tower.modules())
    blocks = sum(isinstance(m, block_cls) for m in tower.modules())
    return {"snake_conv1d": units + 1, "snake_conv1d_res": units, "snake_fused": blocks}


def add_launches(*parts, scale: int = 1) -> dict:
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + scale * v
    return {k: v for k, v in out.items() if v}


def audio_prompt_launches(model) -> dict:
    """The audio-prompted SA-Open's launches counted from the model: a DiT
    forward runs row 1 once a block and row 2 at each of its LayerNorms; a
    request encodes the prompt once (the VAE encoder), runs STEPS forwards
    (CFG at batch 2 in one call) and one decode; a training step encodes the
    batch and its prompts (two encoder passes), runs the DiT forward twice
    (block rematerialisation) and row 6 once a block."""
    from stable_audio_tools_tpu_torch.models.autoencoders import (DecoderBlock, EncoderBlock,
                                                                  ResidualUnit)
    from stable_audio_tools_tpu_torch.ops.norms import LayerNorm
    from stable_audio_tools_tpu_torch.ops.transformer import TransformerBlock

    dit, ae = model.model.model, model.pretransform.model
    blocks = sum(isinstance(m, TransformerBlock) for m in dit.modules())
    fwd = {"flash_attention_prefix": blocks,
           "fused_layer_norm": sum(isinstance(m, LayerNorm) for m in dit.modules())}
    enc = tower_launches(ae.encoder, ResidualUnit, EncoderBlock)
    dec = tower_launches(ae.decoder, ResidualUnit, DecoderBlock)
    return dict(encode=enc, request=add_launches(enc, dec, add_launches(fwd, scale=STEPS)),
                step=add_launches(enc, enc, add_launches(fwd, scale=2),
                                  {"flash_attention_prefix_bwd": blocks}))


def prompt_clip(n: int, seed: int, channels: int = 2):
    """A seeded synthetic clip [channels, n] (partials under an envelope
    over noise), f32 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / 44100
    tone = sum(np.sin(2 * np.pi * f * t + ph) for f, ph in
               zip(rng.uniform(60, 3000, 4), rng.uniform(0, 2 * np.pi, 4))) / 6
    audio = np.stack([np.roll(tone, 7 * c) for c in range(channels)])
    return (audio + 0.02 * rng.standard_normal(audio.shape)).astype(np.float32)


def audio_prompt_generation(dev) -> dict:
    """`audio_prompt_config()` at full width, seeded random weights: one
    request (batch 1, a 47.6 s stereo prompt, cfg 6, STEPS dpmpp-3m-sde
    steps) after a 2-step warm-up: wall s, audio-s/s, peak GiB, launches
    (pinned from the model), and the prompt's encode alone (the
    conditioner's VAE encode, warm) in ms."""
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    model = init_random_(create_model_from_config(audio_prompt_config(), dev),
                         torch.Generator(device=dev).manual_seed(30)).eval()
    want = audio_prompt_launches(model)
    meta = [dict(PROMPT[0], audio_prompt=prompt_clip(SAMPLE_SIZE, 31), genre="jazz")]
    run = lambda steps, seed: generate_diffusion_cond(
        model, steps=steps, cfg_scale=6.0, conditioning=meta, batch_size=1,
        sample_size=SAMPLE_SIZE, seed=seed, sampler_type="dpmpp-3m-sde",
        sigma_min=0.3, sigma_max=500.0)
    run(2, 0)
    kernels = counters()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    audio = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if tuple(audio.shape) != (1, 2, SAMPLE_SIZE) or not torch.isfinite(audio).all():
        raise AssertionError(f"audio-prompted request: {tuple(audio.shape)}, finite "
                             f"{bool(torch.isfinite(audio).all())}")
    if launches != want["request"]:
        raise AssertionError(f"audio-prompted request launches {launches}, expected "
                             f"{want['request']}")
    prompt = model.conditioner.conditioners["audio_prompt"]
    with torch.inference_mode():
        encode_ms = cuda_ms(lambda: prompt([meta[0]["audio_prompt"]], dev), 3)
        cond = prompt([meta[0]["audio_prompt"]], dev)[0]
    dim = audio_prompt_config()["model"]["conditioning"]["cond_dim"]
    if tuple(cond.shape) != (1, dim, SAMPLE_SIZE // model.pretransform.downsampling_ratio):
        raise AssertionError(f"audio prompt conditioning {tuple(cond.shape)}")
    rec = dict(params=sum(p.numel() for p in model.parameters()), wall_s=wall, steps=STEPS,
               audio_s_per_s=SAMPLE_SIZE / SR / wall, peak_gib=peak, launches=launches,
               prompt_encode_ms=encode_ms, counts=want)
    del model, audio, cond
    torch.cuda.empty_cache()
    return rec


def audio_prompt_training(dev) -> dict:
    """`audio_prompt_config()` trained through `train.build` and
    `Trainer.fit` at batch TRAIN_BATCH x SAMPLE_SIZE on phase 4's synthetic
    WAVs, a `custom_metadata_module` giving each its prompt, an audio prompt
    (the clip reversed) and a genre: 1 warm-up step, then 3 timed; every
    trainable parameter's gradient finite and not all zero after the first
    (the list table's and the prompt projection's among them), none of the
    VAE's trainable; launches pinned from the model; then one step in its
    pieces (`step_split`: data, conditioning with the prompts' encode, the
    batch's encode, forward+backward, optimizer, EMA)."""
    from stable_audio_tools_tpu_torch import train

    cfg = audio_prompt_config()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_audio_prompt_") as tmp:
        cfg_path = os.path.join(tmp, "model.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        data = write_dataset(tmp, AP_WAVS)
        with open(os.path.join(tmp, "metadata.py"), "w") as f:
            f.write(AP_META_MODULE)
        args = train.parse_args([
            "--model-config", cfg_path, "--dataset-config", data,
            "--batch-size", str(TRAIN_BATCH), "--num-workers", "4", "--seed", "0",
            "--max-steps", str(AP_WARM_STEPS + AP_TIMED_STEPS), "--checkpoint-every", "0",
            "--save-dir", os.path.join(tmp, "run")])
        trainer, loader, _ = train.build(args, device=dev)
        w = trainer.wrapper
        names = list(w.params)
        for want_name in ("conditioner.conditioners.genre.embedder.weight",
                          "conditioner.conditioners.audio_prompt.proj_out.weight"):
            if want_name not in names:
                raise AssertionError(f"{want_name} does not train")
        if any(".pretransform." in n or n.startswith("pretransform.") for n in names):
            raise AssertionError("the VAE trains")
        want = audio_prompt_launches(w.model)["step"]
        trainer.fit(loader, max_steps=AP_WARM_STEPS, save_at_end=False)
        bad = [n for n, p in w.params.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        if bad:
            raise AssertionError(f"after step 1, {len(bad)} trainable parameters have no finite "
                                 f"nonzero gradient: {bad[:8]}")
        launches, peak = counted_fit(trainer, loader, AP_TIMED_STEPS, counters())
        launches = {n: c for n, c in launches.items() if c}
        if launches != add_launches(want, scale=AP_TIMED_STEPS):
            raise AssertionError(f"audio-prompted training launches {launches} over "
                                 f"{AP_TIMED_STEPS} steps, expected {want} a step")
        losses = [h["train/loss"] for h in trainer.history]
        if len(losses) != AP_WARM_STEPS + AP_TIMED_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"audio-prompted training losses: {losses}")
        walls = [1e3 / h["train/steps_per_sec"] for h in trainer.history[AP_WARM_STEPS:]]
        return dict(split=step_split(trainer, loader),
                    losses=losses, step_ms=walls, step_ms_median=statistics.median(walls),
                    audio_s_per_s=TRAIN_BATCH * SAMPLE_SIZE / SR / (statistics.median(walls) / 1e3),
                    peak_gib=peak, launches=launches, step_counts=want,
                    trainable_params=sum(p.numel() for p in w.params.values()))


def codec_pass_launches(pt, samples: int) -> dict:
    """A DAC codec pretransform's round trip counted from it: the chunked
    encode and decode run one tower pass a group of `chunk_batch` (8) chunks
    of 128 latents overlapping by 32; `tokenize` and `decode_tokens` one
    unchunked pass each."""
    from stable_audio_tools_tpu_torch.models.dac import (DACDecoderBlock, DACEncoderBlock,
                                                         DACResidualUnit)

    ae = pt.model
    ratio = ae.downsampling_ratio
    starts = ae._chunk_starts(samples, 128 * ratio, 96 * ratio)
    groups = -(-len(starts) // 8)
    enc = tower_launches(ae.encoder, DACResidualUnit, DACEncoderBlock)
    dec = tower_launches(ae.decoder, DACResidualUnit, DACDecoderBlock)
    return add_launches(add_launches(enc, dec, scale=groups), enc, dec)


def dac_pretrained_round_trip(dev) -> dict:
    """`dac_pretrained` 44 kHz (descript's published architecture, seeded
    random weights, bf16 as the factory builds it on the card, chunked as the JAX
    factory's default): 47.6 s of mono through encode -> decode (the DAC
    RVQ quantizing on decode) and through tokenize -> decode_tokens, after a
    warm-up round trip: wall s, audio-s/s, peak GiB, the busy share under
    the profiler, launches pinned from the towers."""
    from stable_audio_tools_tpu_torch.models.factory import (create_pretransform_from_config,
                                                             init_random_)

    pt = init_random_(create_pretransform_from_config(DAC_PRETRAINED, SR, dev),
                      torch.Generator(device=dev).manual_seed(32)).eval()
    audio = torch.from_numpy(prompt_clip(SAMPLE_SIZE, 33, channels=1))[None].to(dev)
    want = codec_pass_launches(pt, SAMPLE_SIZE)

    def round_trip():
        z = pt.encode(audio)
        codes = pt.tokenize(audio)
        return z, pt.decode(z), codes, pt.decode_tokens(codes)

    kernels = counters()
    with torch.inference_mode():
        round_trip()
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        z, out, codes, out_tokens = round_trip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        latents = SAMPLE_SIZE // pt.downsampling_ratio
        if (tuple(z.shape) != (1, pt.encoded_channels, latents)
                or tuple(codes.shape) != (1, pt.num_quantizers, latents)
                or any(tuple(o.shape) != (1, 1, SAMPLE_SIZE) or not torch.isfinite(o).all()
                       for o in (out, out_tokens))):
            raise AssertionError(f"dac_pretrained round trip: latents {tuple(z.shape)}, codes "
                                 f"{tuple(codes.shape)}, audio {tuple(out.shape)}")
        if launches != want:
            raise AssertionError(f"dac_pretrained round trip launches {launches}, expected {want}")
        profile = profiled_window(round_trip)
    rec = dict(params=sum(p.numel() for p in pt.parameters()), wall_s=wall,
               audio_s_per_s=SAMPLE_SIZE / SR / wall, peak_gib=peak, launches=launches,
               codes=list(codes.shape), device_busy=profile["device_busy"],
               profiled_wall_ms=profile["wall_ms"], top_kernels_ms=profile["top_kernels_ms"])
    del audio, z, out, codes, out_tokens
    rec["f32_divergence"] = dac_f32_divergence(pt, dev)
    del pt
    torch.cuda.empty_cache()
    return rec


DAC_F32_SAMPLES = 8192  # 16 latents: one unchunked pass
DAC_SPREAD = 2.0  # the card's bf16 distance from f32 over the CPU's bf16 distance


def dac_f32_divergence(pt, dev) -> dict:
    """The card's bf16 DAC codec (the factory's choice on the card) against
    the same weights in f32 on the CPU (the JAX package's dtype) on 8,192
    mono samples: relative L2 distance of the latents, of the audio decoded
    from the f32 run's latents (quantized on decode) and from its codes, and
    the share of codes that agree. Random weights at the published depth
    grow bf16's roundings (the decoder's gains into its tanh), so the CPU's
    own bf16 run of the same codec (the kernels' plain versions) measures
    what bf16 gives, and each card distance is held within DAC_SPREAD times it."""
    cpu = copy.deepcopy(pt).to("cpu")
    x = torch.from_numpy(prompt_clip(DAC_F32_SAMPLES, 34, channels=1))[None]

    def run(codec, x, z32, c32):
        d = x.device
        return (codec.encode(x), codec.tokenize(x), codec.decode(z32.to(d)),
                codec.decode_tokens(c32.to(d)))

    def rel2(got, want):
        got, want = got.double().cpu(), want.double()
        return ((got - want).norm() / want.norm()).item()

    with torch.inference_mode():
        cpu.model_half = False
        z32, c32 = cpu.encode(x), cpu.tokenize(x)
        f32 = (z32, c32, cpu.decode(z32), cpu.decode_tokens(c32))
        cpu.model_half = True
        cpu_bf16 = run(cpu, x, z32, c32)
        card = run(pt, x.to(dev), z32, c32)
    rec = {}
    for i, name in ((0, "latents"), (2, "decode"), (3, "decode_tokens")):
        rec[name] = dict(card=rel2(card[i], f32[i]), cpu_bf16=rel2(cpu_bf16[i], f32[i]))
        if not rec[name]["card"] <= DAC_SPREAD * rec[name]["cpu_bf16"]:
            raise AssertionError(f"dac_pretrained {name}: the card's bf16 is "
                                 f"{rec[name]['card']:.4g} from f32, past twice the CPU's bf16 "
                                 f"{rec[name]['cpu_bf16']:.4g}")
    rec["codes_agree"] = dict(card=(card[1].cpu() == c32).double().mean().item(),
                              cpu_bf16=(cpu_bf16[1] == c32).double().mean().item())
    rec["tol"] = f"card rel L2 from f32 <= {DAC_SPREAD} x the CPU's bf16"
    return rec


def audiocraft_lm_generation(dev) -> dict:
    """MusicGen-small (lm/musicgen_small_rvq.json) with its codec replaced by
    `audiocraft_pretrained` facebook/encodec_32khz (SEANet with identity
    skips + the EMA RVQ, f32, seeded random weights): AP_LM_FRAMES frames
    KV-cached, batch 1, cfg LM_CFG, top_k LM_TOP_K: wall, ms a step, peak
    GiB, row 2 pinned (3 norms a block a step)."""
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.models.lm import lm_generate_audio

    cfg = lm_config()
    cfg["model"]["pretransform"] = copy.deepcopy(ENCODEC_PRETRAINED)
    model = init_random_(create_model_from_config(cfg, dev),
                         torch.Generator(device=dev).manual_seed(34)).eval()
    cond = model.conditioner(LM_PROMPT, dev)
    gen = lambda frames, seed: lm_generate_audio(
        model, cond, max_gen_len=frames, batch_size=1, cfg_scale=LM_CFG, top_k=LM_TOP_K,
        generator=torch.Generator(device=dev).manual_seed(seed))
    gen(8, 0)
    S = model.pattern_provider.get_pattern(AP_LM_FRAMES).S
    want = {"fused_layer_norm": 3 * model.lm.backbone.depth * (S - 1)}
    kernels = counters()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    audio = gen(AP_LM_FRAMES, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
    samples = AP_LM_FRAMES * model.pretransform.downsampling_ratio
    if tuple(audio.shape) != (1, 1, samples) or not torch.isfinite(audio).all():
        raise AssertionError(f"LM over encodec_32khz: audio {tuple(audio.shape)}")
    if launches != want:
        raise AssertionError(f"LM over encodec_32khz launches {launches}, expected {want}")
    rec = dict(params=sum(p.numel() for p in model.parameters()),
               codec_params=sum(p.numel() for p in model.pretransform.parameters()),
               wall_s=wall, steps=S - 1, ms_per_step=wall / (S - 1) * 1e3,
               audio_s_per_s=samples / LM_SR / wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=launches)
    del model, cond, audio
    torch.cuda.empty_cache()
    return rec


def clap_audio_embed(dev) -> dict:
    """A `clap_audio` conditioner on HTSAT-base (enable_fusion at its
    default; seeded random weights, its BatchNorm statistics drawn too)
    embedding CLAP_CLIPS clips of 10 s at 48 kHz: ms of one call (warm), and
    the card against the CPU in f32 (TF32 off) within CLAP_TOL; it
    launches none of the port's kernels (the JAX tower is plain flax, the
    port's plain PyTorch)."""
    from stable_audio_tools_tpu_torch.models.conditioners import (
        create_multi_conditioner_from_conditioning_config)
    from stable_audio_tools_tpu_torch.models.factory import init_random_
    from stable_audio_tools_tpu_torch.ops.stft import _full_f32_convs

    cpu = create_multi_conditioner_from_conditioning_config({"cond_dim": 768, "configs": [
        {"id": "reference", "type": "clap_audio", "config": {"allow_random_init": True}}]},
        device="cpu")
    g = torch.Generator().manual_seed(35)
    init_random_(cpu, g)
    with torch.no_grad():
        for name, buf in cpu.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    card = copy.deepcopy(cpu).to(dev).eval()
    cpu.eval()
    meta = [{"reference": prompt_clip(CLAP_SAMPLES, 36 + i)} for i in range(CLAP_CLIPS)]
    kernels = counters()
    with torch.inference_mode():
        card(meta, dev)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        ms = cuda_ms(lambda: card(meta, dev), 3)
        launches = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        with _full_f32_convs():
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                got = card(meta, dev)["reference"][0].cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            want = cpu(meta, "cpu")["reference"][0]
    err = float((got - want).abs().max() / want.abs().max())
    if launches:
        raise AssertionError(f"clap_audio launched the port's kernels: {launches}")
    if tuple(got.shape) != (CLAP_CLIPS, 1, 768) or not err <= CLAP_TOL:
        raise AssertionError(f"clap_audio card vs CPU: shape {tuple(got.shape)}, rel err "
                             f"{err:.3g} (tol {CLAP_TOL})")
    rec = dict(params=sum(p.numel() for p in cpu.parameters()), ms=ms, clips=CLAP_CLIPS,
               card_vs_cpu=err, tol=CLAP_TOL)
    del cpu, card
    torch.cuda.empty_cache()
    return rec


def signal_round_trips(dev) -> dict:
    """Each signal-domain pretransform (SIGNAL_PRETRANSFORMS) on 47.6 s of
    stereo: the encode + decode's ms (CUDA events, after a warm-up), the
    reconstruction's error (max abs and relative L2, the PQMF's away from
    the ends) within SIGNAL_TOL, and the encode against the CPU's on the
    first 65,536 samples (1e-5 of the peak)."""
    from stable_audio_tools_tpu_torch.models.factory import create_pretransform_from_config

    x_np = prompt_clip(SAMPLE_SIZE, 37)
    x = torch.from_numpy(x_np)[None].to(dev)
    out = {}
    for name, cfg in SIGNAL_PRETRANSFORMS.items():
        pt = create_pretransform_from_config(cfg, SR, dev)
        ratio = pt.downsampling_ratio
        with torch.inference_mode():
            ms = cuda_ms(lambda: pt.decode(pt.encode(x)), 3)
            z = pt.encode(x)
            y = pt.decode(z)
            edge = min(4096, SAMPLE_SIZE // 8)  # the PQMF's filter length and more
            seg = slice(edge, SAMPLE_SIZE - edge) if name.startswith("pqmf") else slice(None)
            d = (y - x)[..., seg]
            rel_l2 = float(d.norm() / x[..., seg].norm())
            small = torch.from_numpy(x_np[:, :65536])[None]
            card_vs_cpu = float((pt.encode(small.to(dev)).cpu() - pt.encode(small)).abs().max()
                                / pt.encode(small).abs().max())
        if tuple(z.shape) != (1, 2 * ratio, SAMPLE_SIZE // ratio) or not rel_l2 <= SIGNAL_TOL[name] \
                or not card_vs_cpu <= 1e-5:
            raise AssertionError(f"{name}: latents {tuple(z.shape)}, round trip rel L2 {rel_l2:.3g} "
                                 f"(tol {SIGNAL_TOL[name]}), card vs CPU {card_vs_cpu:.3g}")
        out[name] = dict(ms=ms, max_abs_err=float(d.abs().max()), rel_l2=rel_l2,
                         latents=list(z.shape), card_vs_cpu=card_vs_cpu)
    return out


class PosteriorMean:
    """Within the block, a VAE bottleneck returns its posterior mean: the
    card and the CPU draw different noise, and the card-vs-CPU checks hold
    the kernels, not the random streams."""

    def __enter__(self):
        from stable_audio_tools_tpu_torch.models import bottleneck

        self.module, self.saved = bottleneck, bottleneck.vae_sample
        bottleneck.vae_sample = lambda x, generator=None, noise=None: (
            x.chunk(2, dim=1)[0], torch.zeros((), device=x.device))

    def __exit__(self, *exc):
        self.module.vae_sample = self.saved


def tiny_audio_prompt_config(dtype: str = "bfloat16") -> dict:
    """`tiny_config()` with `audio_prompt_config()`'s two conditioners: the
    prompt through the tiny VAE projected to cond_dim 64 and concatenated,
    the genre cross-attended; the DiT in `dtype`."""
    cfg = tiny_config()
    m = cfg["model"]
    m["conditioning"]["configs"] += [
        {"id": "audio_prompt", "type": "pretransform",
         "config": {"use_model_pretransform": True, "sample_rate": cfg["sample_rate"]}},
        {"id": "genre", "type": "list", "config": {"options": list(AP_GENRES)}}]
    d = m["diffusion"]
    d["cross_attention_cond_ids"] = d["cross_attention_cond_ids"] + ["genre"]
    d["input_concat_ids"] = ["audio_prompt"]
    d["config"].update(input_concat_dim=64, compute_dtype=dtype)
    cfg["training"].pop("demo", None)
    return cfg


def small_audio_prompt_checks(dev) -> dict:
    """Phase 18(f), the tiny audio-prompted SA-Open twin (seeded weights,
    bf16 DiT and VAE as SA-Open's) on the card against the CPU, within 5%
    as phase 3: the prompt's conditioning (the bf16 VAE encode; the CPU's
    own bf16 distance from its f32 encode is printed beside it), one CFG
    denoiser call on each side's own conditioning (the card's prompt encode
    flowing into the card's DiT) and one on the CPU's (the DiT's kernels
    alone), and the decode; a 10-step request held to twice the CPU's own
    bf16 distance from its f32 run (a random bf16 model compounds roundings
    over the steps, as in phases 5 and 17); one training step's loss and
    gradients (within 5%, as phase 4)."""
    import zlib

    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.conditioners import FallbackTokenizer
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    def build(dtype):
        model = init_random_(create_model_from_config(tiny_audio_prompt_config(dtype), "cpu"),
                             torch.Generator().manual_seed(38))
        t5 = model.conditioner.conditioners["prompt"]
        t5.model.compute_dtype = torch.float32
        t5.tokenizer = FallbackTokenizer(t5.tokenizer.max_length,
                                         word_hash=lambda w: zlib.crc32(w.encode("utf-8")))
        return model.eval()

    T = 32 * 128
    meta = [dict(PROMPT[0], audio_prompt=prompt_clip(T, 39), genre="folk")]
    cpu, cpu32 = build("bfloat16"), build("float32")
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(40)
    x, z = torch.randn(1, 16, 128, generator=g), torch.randn(1, 16, 128, generator=g)
    t = torch.tensor([0.5])
    rec = {}
    with PosteriorMean(), torch.inference_mode():
        # the prompt's conditioning: the bf16 VAE encode, and beside it the
        # CPU's own bf16 distance from its f32 encode
        prompt = lambda m, d: m.conditioner(meta, d)["audio_prompt"][0].float().cpu()
        cpu_f32 = copy.deepcopy(cpu)
        cpu_f32.pretransform.model_half = False
        want, want32, got = prompt(cpu, "cpu"), prompt(cpu_f32, "cpu"), prompt(gpu, dev)
        rec["prompt_rel_err"] = (got - want).abs().max().item() / want.abs().max().item()
        rec["cpu_prompt_bf16_vs_f32"] = (want - want32).abs().max().item() / want32.abs().max().item()
        # the denoiser on each side's own conditioning and on the CPU's (the
        # DiT's kernels alone), and the decode
        cond = cpu.get_conditioning_inputs(cpu.conditioner(meta, "cpu"))
        errs = {}
        for name, run in (
            ("denoiser_own_cond", lambda m, d: m(x.to(d), t.to(d), cfg_scale=6.0,
                                                 **m.get_conditioning_inputs(
                                                     m.conditioner(meta, d)))),
            ("denoiser", lambda m, d: m(x.to(d), t.to(d), cfg_scale=6.0, **{
                k: v.to(d) if torch.is_tensor(v) else v for k, v in cond.items()})),
            ("decode", lambda m, d: m.pretransform.decode(z.to(d))),
        ):
            want, got = run(cpu, "cpu").float(), run(gpu, dev).float().cpu()
            rec[f"{name}_rel_err"] = ((got - want).abs().max().item()
                                      / max(want.abs().max().item(), 1e-6))
        request = lambda m, d: generate_diffusion_cond(
            m, steps=10, cfg_scale=6.0, conditioning=meta, batch_size=1, sample_size=T,
            seed=0, sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=500.0,
            noise=torch.randn(1, 16, 128, generator=torch.Generator().manual_seed(41)).to(d),
            step_noise=lambda i, s: torch.randn(
                s.shape, generator=torch.Generator().manual_seed(100 + i)).to(s.device, s.dtype)
        ).float().cpu()
        want, want32, got = request(cpu, "cpu"), request(cpu32, "cpu"), request(gpu, dev)
        rec["request_rel_l2"] = float((got - want).norm() / want.norm())
        rec["cpu_bf16_vs_f32_rel_l2"] = float((want - want32).norm() / want32.norm())
    cfg = tiny_audio_prompt_config()
    gb = torch.Generator().manual_seed(42)
    B = 2
    batch = dict(t=torch.rand(B, generator=gb), noise=torch.randn(B, 16, 128, generator=gb),
                 cfg_dropout_mask=torch.tensor([False, True]))
    audio = 0.3 * torch.randn(B, 2, T, generator=gb)
    tmeta = [meta[0], dict(PROMPT[0], audio_prompt=prompt_clip(T, 43), genre="rock")]
    out = {}
    with PosteriorMean():
        for name, model, d in (("cpu", build("bfloat16").train(), "cpu"),
                               ("card", copy.deepcopy(cpu).train().to(dev), dev)):
            w = create_training_wrapper_from_config(cfg, model)
            aux = w.train_step(audio.to(d), tmeta, **{k: v.to(d) for k, v in batch.items()})
            out[name] = (float(aux["loss"]), w)
    (lc, wc), (lg, wg) = out["cpu"], out["card"]
    errs = {n: float((wg.params[n].grad.float().cpu() - p.grad).abs().max() / p.grad.abs().max())
            for n, p in wc.params.items() if p.grad is not None and p.grad.abs().max() > 0}
    worst = max(errs, key=errs.get)
    rec.update(loss_rel_err=abs(lg - lc) / abs(lc), grad_rel_err=errs[worst], worst_grad=worst)
    return rec


def phase_audio_prompt(dev) -> dict:
    """Phase 18: (f) the tiny card-vs-CPU checks, (a) the audio-prompted
    SA-Open's request and training, (b) `dac_pretrained` 44 kHz's round
    trip, (c) MusicGen-small over `audiocraft_pretrained` encodec_32khz, (d)
    `clap_audio` on HTSAT-base, (e) the signal-domain pretransforms."""
    t_phase = time.perf_counter()
    small, tol = small_audio_prompt_checks(dev), 0.05
    if not (all(small[k] <= tol for k in ("prompt_rel_err", "denoiser_own_cond_rel_err",
                                          "denoiser_rel_err", "decode_rel_err",
                                          "loss_rel_err", "grad_rel_err"))
            and small["request_rel_l2"] <= 2 * small["cpu_bf16_vs_f32_rel_l2"]):
        raise AssertionError(f"phase 18 tiny checks card vs CPU: {small} (tol {tol}; the "
                             "request within twice the CPU's bf16 distance from f32)")
    rec = dict(small=small, small_tol=tol)
    rec["request"] = audio_prompt_generation(dev)
    rec["training"] = audio_prompt_training(dev)
    torch.cuda.empty_cache()
    rec["dac_pretrained"] = dac_pretrained_round_trip(dev)
    rec["audiocraft_lm"] = audiocraft_lm_generation(dev)
    rec["clap_audio"] = clap_audio_embed(dev)
    rec["signal"] = signal_round_trips(dev)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


PHASES = tuple(range(1, 19))


def parse_phases(argv) -> set:
    """`--phases 2,4,6` runs phase 1 (the card and the build) and those; no
    argument runs every phase, as the plain `python3 chip_smoke.py` does."""
    import argparse

    p = argparse.ArgumentParser(description="chip smoke test of the PyTorch/CUDA port")
    p.add_argument("--phases", default=None,
                   help="comma-separated phase numbers for a development run (default: all)")
    args = p.parse_args(argv)
    if args.phases is None:
        return set(PHASES)
    phases = {int(x) for x in args.phases.split(",") if x.strip()} | {1}
    if not phases <= set(PHASES):
        p.error(f"phases are {PHASES[0]}-{PHASES[-1]}, got {sorted(phases)}")
    return phases


def main(argv=None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    want = phases.__contains__
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

    if want(2):
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

        print("phase 2 rows 12 / 3 / 4 at dac_pretrained 44 kHz's shapes (chunk groups [8, C, "
              "65536] and the unchunked [1, C, 2097152]; cases, max err within 2 bf16 ulps): "
              + "; ".join(f"{n} {len(rec[n]['dac_pretrained']['cases'])}, "
                          f"{rec[n]['dac_pretrained']['max_abs_err']:.3g}"
                          for n in ("snake_conv1d", "snake_conv1d_res", "snake_fused"))
              + f"; every call launched its kernel; on {card}", flush=True)

        fw, bw = rec["flash_attention"]["taae"], rec["flash_attention_prefix_bwd"]["taae"]
        fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
        print("phase 2 rows 5 | 6 at the TAAE's training shapes, head dim 128, window (31, 32) "
              "(ms; two-pass | fused backward; plain; SDPA with the band as a mask, forward | "
              "backward; bounds; max err | rel err): " + "; ".join(
                  f"{n} {f['ms']:.4f} | {b['routes']['two_pass']['ms']:.4f} | "
                  f"{b['routes']['fused']['ms']:.4f}; {f['plain_ms']:.3f} | {b['plain_ms']:.3f}; "
                  f"{fmt(f['library_ms'])} | {fmt(b['library_ms'])}; {f['bound_ms']:.4f} | "
                  f"{b['bound_ms']:.4f}; {f['max_abs_err']:.3g} | {b['max_rel_err']:.3g}"
                  for (n, f), b in zip(fw.items(), bw.values())) + f" on {card}", flush=True)
        print("phase 2 row 2 at the TAAE's rows (ms; plain; F.layer_norm; bound; max err): "
              + "; ".join(f"{c['shape']} {c['ms']:.4f}; {c['plain_ms']:.4f}; "
                          f"{c['library_ms']:.4f}; {c['bound_ms']:.4f}; {c['max_abs_err']:.3g}"
                          for c in rec["fused_layer_norm"]["taae"]) + f" on {card}", flush=True)

    if want(3):
        main_rec = phase_main_path(dev)
        print(f"phase 3 generation: SA-Open {main_rec['params'] / 1e9:.3f}B params, {STEPS} steps "
              f"dpmpp-3m-sde cfg 6, {SAMPLE_SIZE} samples: wall {main_rec['wall_s']:.3f} s, "
              f"{main_rec['audio_s_per_s']:.3f} audio-s/s, peak {main_rec['peak_gib']:.2f} GiB, "
              f"launches {json.dumps(main_rec['launches'])}, small card-vs-CPU rel err "
              f"{main_rec['small_err']:.3g} (tol {main_rec['small_tol']:.3g}) on {card}", flush=True)
        torch.cuda.empty_cache()

    if want(4):
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
              f"{json.dumps(train_rec['launches'])}; small "
              f"card-vs-CPU step: loss rel err {train_rec['small']['loss_rel_err']:.3g}, grad rel err "
              f"{train_rec['small']['grad_rel_err']:.3g} (tol {train_rec['small_tol']}) on {card}",
              flush=True)
        en = train_rec["entry"]
        print(f"phase 4 training entry: fit with --val-every 2 --checkpoint-every 2 --save-top-k 1 "
              f"--demo-every 2: demo (the config's prompt, cfg {en['cfg_scales']}, {SAMPLE_SIZE} "
              f"samples, {DEMO_STEPS} steps) s per cfg scale "
              + ", ".join(f"{x:.3f}" for x in en["demo_scale_s"][0])
              + f", launches {json.dumps(en['demo_launches'][0])} (a scale "
              f"{json.dumps(en['demo_per_scale_launches'])}), peaks "
              f"{json.dumps({k: round(v[0], 4) for k, v in en['demo_outputs'].items()})}; "
              f"validation pass {', '.join(f'{x:.2f}' for x in en['val_s'])} s, "
              f"{json.dumps({k: round(v, 4) for k, v in en['val'].items()})}; checkpoint "
              f"{en['ckpt_gib']:.2f} GiB saved {', '.join(f'{x:.1f}' for x in en['save_s'])} s, one "
              f"left; --recover load {en['load_s']:.1f} s, to the first step "
              f"{en['recover_to_first_step_s']:.1f} s, restored bit for bit; unwrap_model "
              f"{en['unwrap_s']:.1f} s ({en['unwrapped_gib']:.2f} GiB), fresh build through "
              f"--pretrained-ckpt-path ({en['pretrained_loaded']} tensors, 0 skipped, equal) and "
              f"--pretransform-ckpt-path ({en['pretransform_loaded']}) "
              f"{en['pretrained_build_s']:.1f} s on {card}", flush=True)

        torch.cuda.empty_cache()

    if want(5):
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
              f"(tol {sa2_rec['small_tol']}); the Oobleck decode's bf16 distance from f32 "
              f"(SA-2.0 VAE decoder at channels 32, {sa2_rec['oobleck_bf16']['samples']} "
              f"samples): card {sa2_rec['oobleck_bf16']['card_bf16_vs_f32']:.4g}, the JAX "
              f"package's {OOBLECK_BF16_JAX} (limit 2x) on {card}", flush=True)

        torch.cuda.empty_cache()

    def gan_line(r):
        sp = r["split"]
        return (f"{r['params'] / 1e6:.1f}M params + discriminator {r['disc_params'] / 1e6:.2f}M: "
                f"pair {r['pair_ms_median']:.1f} ms median of {len(r['pair_ms'])} "
                f"({', '.join(f'{x:.1f}' for x in r['pair_ms'])}), gen step "
                f"{r['gen_ms_median']:.1f} ms, disc step {r['disc_ms_median']:.1f} ms, "
                f"{r['audio_s_per_s']:.2f} audio-s trained/s, peak {r['peak_gib']:.2f} GiB; "
                "gen step split ms " + ", ".join(
                    f"{k[:-3]} {v:.1f}" for k, v in sp.items()
                    if k.endswith("_ms") and isinstance(v, float))
                + f"; gen step device busy {sp['gen_step_device_busy']:.1%}, top kernels ms "
                f"{json.dumps(sp['gen_step_top_kernels_ms'])}; launches "
                f"{json.dumps({k: v for k, v in r['launches'].items() if v})}; stepped back to "
                f"their own bits {r['stepped_back_to_own_bits']}; checkpoint "
                f"{r['ckpt_gib']:.2f} GiB reloaded identical, resumed {r['resumed_steps']} steps")

    if want(6):
        ae_rec = phase_ae_training(dev)
        print(f"phase 6 AE training: stable_audio_2_0_vae.json, batch {AE_BATCH} x 65536, bf16: "
              f"{gan_line(ae_rec)}; small card-vs-CPU {json.dumps(ae_rec['small'])} (tol "
              f"{ae_rec['small_tol']} at gains x {SMALL_AE_GAIN}; at the init's, the card within "
              f"{GAN_SPREAD}x the CPU's bf16 distance from f32) on {card}", flush=True)
        en = ae_rec["entry"]
        print(f"phase 6 VAE demo and validation: demo {en['demo_s']:.2f} s, launches "
              f"{json.dumps(en['launches'])}, peaks "
              f"{json.dumps({k: round(v[0], 4) for k, v in en['outputs'].items()})}; validation "
              f"{en['val_batches']} batches of {AE_BATCH} x 65536 {en['val']['val_s']:.2f} s, "
              f"launches {json.dumps(en['val']['launches'])}, "
              f"{json.dumps({k: round(v, 4) for k, v in en['val']['means'].items()})} on {card}",
              flush=True)

        torch.cuda.empty_cache()

    if want(7):
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

    if want(8):
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
        print(f"phase 8 LM demo: {LM_DEMO_FRAMES} frames KV-cached + the codec's decode "
              f"{lmt['demo']['demo_s']:.2f} s, launches {json.dumps(lmt['demo']['launches'])}, "
              f"peak {json.dumps({k: round(v[0], 4) for k, v in lmt['demo']['outputs'].items()})} "
              f"on {card}", flush=True)

        torch.cuda.empty_cache()

    if want(9):
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

    if want(10):
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
        dd = dt["demo"]
        print(f"phase 10 Dance demo: 4 clips of {DANCE_SAMPLE_SIZE} samples, {DEMO_STEPS} steps "
              f"{dd['demo_s']:.2f} s, launches {json.dumps(dd['launches'])}, peak "
              f"{json.dumps({k: round(v[0], 4) for k, v in dd['outputs'].items()})} on {card}",
              flush=True)

        torch.cuda.empty_cache()

    if want(11):
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

    if want(12):
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

    if want(13):
        dac = phase_dac_training(dev)
        print("phase 13 DAC VAE-GAN training, batch 4 x 65536, bf16: " + "; ".join(
            f"{n}: {gan_line(dac[n])}; small card-vs-CPU {json.dumps(dac[n]['small'])} (tol "
            f"{dac[n]['small_tol']} at gains x {SMALL_AE_GAIN}; at the init's, the card within "
            f"{GAN_SPREAD}x the CPU's bf16 distance from f32)" for n in DAC_VAES)
            + f"; phase {dac['phase_s']:.1f} s on {card}", flush=True)

        torch.cuda.empty_cache()

    if want(14):
        codec = phase_codec_training(dev)
        print(f"phase 14 codec training: encodec_musicgen_rvq.json, batch 4 x 32000, bf16 to the "
              f"LSTM: {gan_line(codec)}; hand-written kernels a generator step "
              f"{json.dumps(codec['counts']['gen'])}, none in the discriminator step; small "
              f"card-vs-CPU (f32, TF32 off) {json.dumps(codec['small'])} (tol "
              f"{codec['small_tol']}); phase {codec['phase_s']:.1f} s on {card}", flush=True)

        torch.cuda.empty_cache()

    if want(15):
        rf = phase_rf(dev)
        gen, tr, inp, arc = rf["generation"], rf["training"], rf["inpaint"], rf["arc"]
        print("phase 15 rectified flow at SA-Open's width (shift " + json.dumps(RF_SHIFT)
              + "): generation, batch 1 x 2097152: " + "; ".join(
                  f"{n} {r['steps']} steps cfg {r['cfg_scale']} ({r['objective']}) wall "
                  f"{r['wall_s']:.3f} s, {r['audio_s_per_s']:.2f} audio-s/s, peak "
                  f"{r['peak_gib']:.2f} GiB" for n, r in gen["requests"].items())
              + f"; preview {gen['preview']['entries']} taps in {gen['preview']['wall_s']:.3f} s"
              + f" (launches pinned, e.g. pingpong {json.dumps(gen['requests']['pingpong']['launches'])})"
              + f"; small card-vs-CPU {json.dumps({k: round(v, 4) for k, v in rf['small'].items()})}"
              f" (tol {rf['small_tol']} at cfg 1); rf training batch {TRAIN_BATCH} x {SAMPLE_SIZE} "
              f"(p_one_shot {RF_P_ONE_SHOT}, log_loss_info): step {tr['step_ms_median']:.1f} ms "
              f"median of {TIMED_STEPS} ({', '.join(f'{x:.1f}' for x in tr['step_ms'])}), "
              f"{tr['audio_s_per_s']:.2f} audio-s trained/s, peak {tr['peak_gib']:.2f} GiB, "
              f"losses {', '.join(f'{x:.4g}' for x in tr['losses'])}, launches "
              f"{json.dumps(tr['launches'])}; inpainting training: step "
              f"{inp['step_ms_median']:.1f} ms median of {INPAINT_TIMED_STEPS}, peak "
              f"{inp['peak_gib']:.2f} GiB, demo {inp['demo']['demo_s']:.2f} s at {DEMO_STEPS} "
              f"steps (launches {json.dumps(inp['demo']['launches'])}); ARC [4, 64, 1024]: "
              + ", ".join(f"{s['kind']} {s['ms']:.1f} ms (peak {s['peak_gib']:.2f} GiB, loss "
                          f"{s['losses']['loss']:.4g})" for s in arc["steps"])
              + f"; launches a step {json.dumps(arc['step_launches'])}, the ConvNeXt step's row 11 "
              f"{arc['steps'][-1]['launches']['conv1d_wgrad']}; f32 state reckoned "
              f"{json.dumps({k: round(v, 2) for k, v in arc['memory_gib'].items()})} GiB; row 11 at "
              f"the ConvNeXt head's {len(rf['convnext_wgrad']['levels'])} shapes: max rel err "
              f"{rf['convnext_wgrad']['max_rel_err']:.3g}, {rf['convnext_wgrad']['ms']:.3f} ms a "
              f"step vs conv1d_weight {rf['convnext_wgrad']['conv1d_weight_ms']:.3f} ms (bound "
              f"{rf['convnext_wgrad']['bound_ms']:.4f}); phase {rf['phase_s']:.1f} s on {card}",
              flush=True)

        torch.cuda.empty_cache()

    if want(16):
        taae = phase_taae(dev)
        req, fq = taae["request"], taae["fsq_request"]
        print(f"phase 16 TAAE: taae_vae_gan {req['params'] / 1e6:.1f}M params, bf16, one "
              f"request of {TAAE_REQUEST_SAMPLES} samples encode + decode unchunked: wall "
              f"{req['wall_s']:.3f} s, {req['audio_s_per_s']:.2f} audio-s/s, peak "
              f"{req['peak_gib']:.2f} GiB, profiled {req['profiled_wall_ms']:.1f} ms at "
              f"{req['device_busy']:.1%} busy, top kernels ms {json.dumps(req['top_kernels_ms'])}, "
              f"launches {json.dumps(req['launches'])}; taae_dithered_fsq (codes "
              f"{fq['codes']} through decode_tokens) wall {fq['wall_s']:.3f} s, "
              f"{fq['audio_s_per_s']:.2f} audio-s/s, peak {fq['peak_gib']:.2f} GiB, busy "
              f"{fq['device_busy']:.1%}; training: {gan_line(taae['training'])}; small "
              f"card-vs-CPU {json.dumps(taae['training']['small'])} (tol "
              f"{taae['training']['small_tol']} at gains x {SMALL_AE_GAIN}, LayerScale "
              f"{SMALL_LAYER_SCALE}); option steps "
              f"{json.dumps({k: {s: round(v, 4) if isinstance(v, float) else v for s, v in r.items()} for k, r in taae['options'].items()})}"
              f" (tol {taae['options_tol']}); phase {taae['phase_s']:.1f} s on {card}", flush=True)

        torch.cuda.empty_cache()

    if want(17):
        d17 = phase_diffae(dev)
        req, tr, rt, dr = (d17[k] for k in ("request", "training", "dac_rvq_round_trip",
                                            "dac_rvq_training"))
        print(f"phase 17a diffae_oobleck_dau: {req['params'] / 1e6:.1f}M params (encoder bf16, "
              f"DAU1d bf16), one request of {DIFFAE_SAMPLES} samples: encode + decode in "
              f"{req['steps']} steps wall {req['wall_s']:.3f} s, {req['audio_s_per_s']:.3f} "
              f"audio-s/s, peak {req['peak_gib']:.2f} GiB, launches "
              f"{json.dumps(req['launches'])}; sampler step {req['step_ms']:.2f} ms back to "
              f"back (profiled {req['step_profile']['wall_ms']:.2f} ms at "
              f"{req['step_profile']['device_busy']:.1%} busy, top kernels ms "
              f"{json.dumps(req['step_profile']['top_kernels_ms'])}); encode profiled "
              f"{req['encode_profile']['wall_ms']:.2f} ms at "
              f"{req['encode_profile']['device_busy']:.1%} busy on {card}", flush=True)
        print(f"phase 17a diffae training batch {DIFFAE_BATCH} x {DIFFAE_SAMPLES}: step "
              f"{tr['step_ms_median']:.1f} ms median of {DIFFAE_TIMED_STEPS} "
              f"({', '.join(f'{x:.1f}' for x in tr['step_ms'])}), {tr['audio_s_per_s']:.2f} "
              f"audio-s trained/s, peak {tr['peak_gib']:.2f} GiB, losses "
              f"{', '.join(f'{x:.4g}' for x in tr['losses'])}, launches "
              f"{json.dumps(tr['launches'])}; forward+backward profiled "
              f"{tr['fwd_bwd_profile']['wall_ms']:.1f} ms at "
              f"{tr['fwd_bwd_profile']['device_busy']:.1%} busy, row 11 "
              f"{tr['fwd_bwd_profile']['conv1d_wgrad_ms']:.1f} ms, top kernels ms "
              f"{json.dumps(tr['fwd_bwd_profile']['top_kernels_ms'])}; demo (2 clips, 50 "
              f"steps) {tr['demo']['demo_s']:.2f} s, launches {json.dumps(tr['demo']['launches'])}"
              f" on {card}", flush=True)
        print(f"phase 17b dac_rvq_2048_32: {rt['params'] / 1e6:.1f}M params, round trip of "
              f"{DAC_RVQ_SAMPLES} mono samples through codes {rt['codes']}: wall "
              f"{rt['wall_s']:.3f} s, {rt['audio_s_per_s']:.2f} audio-s/s, peak "
              f"{rt['peak_gib']:.2f} GiB, profiled {rt['profile']['wall_ms']:.1f} ms at "
              f"{rt['profile']['device_busy']:.1%} busy, launches {json.dumps(rt['launches'])}; "
              f"training: {gan_line(dr)} (its tiny twin's step: 17c) on {card}", flush=True)
        print(f"phase 17c tiny card-vs-CPU (tol {d17['small_tol']}): " + json.dumps(
            {k: {s: round(v, 4) if isinstance(v, float) else v for s, v in r.items()}
             for k, r in d17["small"].items()}) + f"; phase {d17['phase_s']:.1f} s on {card}",
            flush=True)

        torch.cuda.empty_cache()

    if want(18):
        d18 = phase_audio_prompt(dev)
        req, tr, dp, lm, clap = (d18[k] for k in ("request", "training", "dac_pretrained",
                                                  "audiocraft_lm", "clap_audio"))
        print(f"phase 18a audio-prompted SA-Open: {req['params'] / 1e9:.3f}B params, a "
              f"{SAMPLE_SIZE}-sample stereo prompt through its VAE (input_concat 768) + a list "
              f"label, {req['steps']} steps dpmpp-3m-sde cfg 6: wall {req['wall_s']:.3f} s, "
              f"{req['audio_s_per_s']:.3f} audio-s/s, peak {req['peak_gib']:.2f} GiB, the "
              f"prompt's encode {req['prompt_encode_ms']:.1f} ms, launches "
              f"{json.dumps(req['launches'])}; training batch {TRAIN_BATCH} x {SAMPLE_SIZE} "
              f"({tr['trainable_params'] / 1e9:.3f}B trainable): step {tr['step_ms_median']:.1f} "
              f"ms median of {AP_TIMED_STEPS} ({', '.join(f'{x:.1f}' for x in tr['step_ms'])}), "
              f"{tr['audio_s_per_s']:.2f} audio-s trained/s, peak {tr['peak_gib']:.2f} GiB, "
              f"losses {', '.join(f'{x:.4g}' for x in tr['losses'])}, launches a step "
              f"{json.dumps(tr['step_counts'])}; split ms " + ", ".join(
                  f"{k[:-3]} {v:.1f}" for k, v in tr["split"].items()
                  if k.endswith("_ms") and isinstance(v, float))
              + f"; fwd+bwd device busy {tr['split']['fwd_bwd_device_busy']:.1%} on {card}",
              flush=True)
        print(f"phase 18b dac_pretrained 44khz: {dp['params'] / 1e6:.1f}M params (bf16), "
              f"{SAMPLE_SIZE} mono samples through encode -> decode and tokenize -> "
              f"decode_tokens (codes {dp['codes']}): wall {dp['wall_s']:.3f} s, "
              f"{dp['audio_s_per_s']:.2f} audio-s/s, peak {dp['peak_gib']:.2f} GiB, profiled "
              f"{dp['profiled_wall_ms']:.1f} ms at {dp['device_busy']:.1%} busy, top kernels ms "
              f"{json.dumps(dp['top_kernels_ms'])}, launches {json.dumps(dp['launches'])}, "
              f"bf16 vs f32 (rel L2, card; CPU bf16) " + ", ".join(
                  f"{k} {v['card']:.4g}; {v['cpu_bf16']:.4g}"
                  for k, v in dp["f32_divergence"].items() if isinstance(v, dict)) + "; "
              f"18c MusicGen-small over encodec_32khz ({lm['codec_params'] / 1e6:.1f}M codec "
              f"params): {AP_LM_FRAMES} frames KV-cached {lm['wall_s']:.3f} s, {lm['ms_per_step']:.2f}"
              f" ms/step, {lm['audio_s_per_s']:.3f} audio-s/s, peak {lm['peak_gib']:.2f} GiB, "
              f"launches {json.dumps(lm['launches'])}; 18d clap_audio HTSAT-base "
              f"({clap['params'] / 1e6:.1f}M): {clap['clips']} x 10 s at 48 kHz {clap['ms']:.1f} "
              f"ms, card vs CPU f32 {clap['card_vs_cpu']:.3g} (tol {clap['tol']}) on {card}",
              flush=True)
        print("phase 18e signal pretransforms, 2 x " + str(SAMPLE_SIZE) + " samples (round trip "
              "ms; max abs err; rel L2; card vs CPU): " + "; ".join(
                  f"{n} {r['ms']:.3f}; {r['max_abs_err']:.3g}; {r['rel_l2']:.3g}; "
                  f"{r['card_vs_cpu']:.3g}" for n, r in d18["signal"].items())
              + f"; 18f tiny card-vs-CPU {json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in d18['small'].items()})}"
              f" (tol {d18['small_tol']}); phase {d18['phase_s']:.1f} s on {card}", flush=True)

        torch.cuda.empty_cache()

    if len(phases) < len(PHASES):
        print(f"phases run: {sorted(phases)} of 1-{len(PHASES)}; the kernels' record and the "
              "check that every kernel launched on some path need every phase", flush=True)
    else:
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
                       "codec_training": codec["launches"].get(n, 0),
                       "sa_open_demo": train_rec["entry"]["demo_launches"][0].get(n, 0),
                       "vae_demo": ae_rec["entry"]["launches"].get(n, 0),
                       "vae_validation": ae_rec["entry"]["val"]["launches"].get(n, 0),
                       "dance_demo": dance["training"]["demo"]["launches"].get(n, 0),
                       "lm_demo": lmt["demo"]["launches"].get(n, 0),
                       "rf_generation": rf["generation"]["launches"].get(n, 0),
                       "rf_training": rf["training"]["launches"].get(n, 0),
                       "rf_inpaint_training": rf["inpaint"]["launches"].get(n, 0),
                       "rf_inpaint_demo": rf["inpaint"]["demo"]["launches"].get(n, 0),
                       **{f"arc_{s['kind']}_{i}": s["launches"].get(n, 0)
                          for i, s in enumerate(rf["arc"]["steps"])},
                       "taae_request": taae["request"]["launches"].get(n, 0),
                       "taae_fsq_request": taae["fsq_request"]["launches"].get(n, 0),
                       "taae_training": taae["training"]["launches"].get(n, 0),
                       "diffae_request": d17["request"]["launches"].get(n, 0),
                       "diffae_training": d17["training"]["launches"].get(n, 0),
                       "diffae_demo": d17["training"]["demo"]["launches"].get(n, 0),
                       "dac_rvq_round_trip": d17["dac_rvq_round_trip"]["launches"].get(n, 0),
                       "dac_rvq_training": d17["dac_rvq_training"]["launches"].get(n, 0),
                       "audio_prompt_request": d18["request"]["launches"].get(n, 0),
                       "audio_prompt_training": d18["training"]["launches"].get(n, 0),
                       "dac_pretrained_round_trip": d18["dac_pretrained"]["launches"].get(n, 0),
                       "encodec_32khz_lm_generation": d18["audiocraft_lm"]["launches"].get(n, 0)}
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
                                    "sa1", "sa1_f32", "dac", "taae")
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
            "codec_training": {k: v for k, v in codec.items() if k != "launches"},
            "rf": rf, "taae": taae, "diffae": d17, "audio_prompt": d18}))
    print(card)
    if len(phases) < len(PHASES):  # a development run ends on what it ran, not on a pass
        print(json.dumps({"ok": True, "partial": sorted(phases)}))
    else:
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
