"""Time the PyTorch port's snake-conv forwards and the SA-2.0 VAE's decode and
encode in one checkout of the repo, to compare two commits on one CUDA card.

    python scripts/ab_snake_conv_torch.py --root DIR --label NAME --out OUT
    python scripts/ab_snake_conv_torch.py --root DIR --label NAME --out OUT --plain
    python scripts/ab_snake_conv_torch.py --compare OUT/A.pt OUT/B.pt

The first form imports `stable_audio_tools_tpu_torch` from DIR (a checkout,
for example a `git archive` of another commit unpacked there), so that the
same inputs go through that checkout's kernels. On seeded bf16 inputs it
times, with CUDA events after a warm-up:
- `snake_conv1d` at [1, 128, 2097152] k=7 d=9 and at the five decoder levels
  of one SA-2.0 chunk group (batch 8, d = 1, 3, 9);
- `snake_conv1d_res` at [1, 128, 2097152] k=7 d=9, and at k = 1 with the
  residual (the residual units' second conv) at the five decoder levels;
and, on the synchronised host clock, the SA-2.0 VAE (`stable_audio_2_0.json`'s
pretransform, random weights from a seed, chunked) decoding 6144 seeded
latents and encoding one seeded 12,582,912-sample clip (1 warm-up, 3 timed
calls each). It prints one JSON line and saves the decoded audio and the
latents to OUT/NAME.pt. With --plain it times no kernel and runs the decode
and the encode with every snake-conv forward replaced by its plain version
computed in f32 and rounded to bf16 (a reference for the summation orders
of two commits' kernels). The last form holds two such files against each
other and prints whether the outputs are equal, or their largest difference
over the first file's peak.

Run the checkouts in turns on one card, one after another (A, B, B, A),
and compare only numbers taken together in that way.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

SA2_CONFIG = ("stable_audio_tools_tpu", "configs", "model_configs", "txt2audio",
              "stable_audio_2_0.json")
LATENTS = 6144
SAMPLES = 12582912
LEVELS = ((1024, 1024), (512, 8192), (256, 32768), (128, 131072), (128, 262144))


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


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def conv_inputs(dev, B, C, L, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, C, L, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(C, C, 7, generator=g, device=dev) * (C * 7) ** -0.5).to(torch.bfloat16)
    bias = torch.randn(C, generator=g, device=dev) * 0.1
    a = torch.randn(C, generator=g, device=dev).exp()
    b = torch.randn(C, generator=g, device=dev).exp()
    return x, w, bias, a, b


def plain_f32(cs, conv):
    """Replace the snake-conv forwards that the model's convs call with their
    plain versions in f32, each output rounded to the input's dtype."""
    def fwd(x, w, bias, alpha, beta, pad_lo, pad_hi, d, residual=None):
        res = None if residual is None else residual.float()
        return cs.snake_conv1d_plain(x.float(), w.float(), bias, alpha, beta, pad_lo, pad_hi, d,
                                     res).to(x.dtype)

    torch.backends.cudnn.allow_tf32 = False  # a reference in f32, not TF32
    conv.snake_conv1d = fwd
    conv.snake_conv1d_res = lambda x, w, bias, alpha, beta, residual, lo, hi, d: fwd(
        x, w, bias, alpha, beta, lo, hi, d, residual)


def run(root: str, label: str, out_dir: str, plain: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import stable_audio_tools_tpu_torch as pkg
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    rec = dict(label=label, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])

    if plain:
        from stable_audio_tools_tpu_torch.ops import conv

        plain_f32(cs, conv)
    else:
        rec.update(kernel_times(cs, dev))
    decode_encode(root, dev, rec, out_dir, label)
    return rec


def kernel_times(cs, dev) -> dict:
    rec = {}
    x, w, bias, a, b = conv_inputs(dev, 1, 128, 2097152, 0)
    r = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    rec["snake_conv1d_ms"] = cuda_ms(lambda: cs.snake_conv1d(x, w, bias, a, b, 27, 27, 9), 5)
    rec["snake_conv1d_res_ms"] = cuda_ms(
        lambda: cs.snake_conv1d_res(x, w, bias, a, b, r, 27, 27, 9), 5)
    del x, w, bias, a, b, r
    rec["levels_ms"] = {}
    for i, (C, L) in enumerate(LEVELS):
        for d in (1, 3, 9):
            x, w, bias, a, b = conv_inputs(dev, 8, C, L, 10 + i)
            rec["levels_ms"][f"[8,{C},{L}] d={d}"] = cuda_ms(
                lambda: cs.snake_conv1d(x, w, bias, a, b, 3 * d, 3 * d, d), 3)
            del x, w, bias, a, b
    rec["res_levels_ms"] = {}
    for i, (C, L) in enumerate(LEVELS):
        x, w, bias, a, b = conv_inputs(dev, 8, C, L, 20 + i)
        w1 = w[:, :, :1].contiguous()
        r = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(30 + i),
                        device=dev).to(torch.bfloat16)
        rec["res_levels_ms"][f"[8,{C},{L}] k=1"] = cuda_ms(
            lambda: cs.snake_conv1d_res(x, w1, bias, a, b, r, 0, 0, 1), 3)
        del x, w, w1, bias, a, b, r
    return rec


def decode_encode(root, dev, rec, out_dir, label):
    from stable_audio_tools_tpu_torch.models.factory import (create_pretransform_from_config,
                                                             init_random_)

    with open(os.path.join(root, *SA2_CONFIG)) as f:
        cfg = json.load(f)
    pt = create_pretransform_from_config(dict(cfg["model"]["pretransform"], chunked=True),
                                         cfg["sample_rate"], dev)
    init_random_(pt, torch.Generator(device=dev).manual_seed(0)).eval()
    g = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn(1, pt.encoded_channels, LATENTS, generator=g, device=dev)
    clip = (torch.randn(1, 2, SAMPLES, generator=g, device=dev) * 0.3).to(torch.bfloat16)
    outs = {}
    with torch.inference_mode():
        decode = lambda: outs.__setitem__("audio", pt.decode(z))
        encode = lambda: outs.__setitem__("latents", pt.model.encode(
            clip, generator=torch.Generator(device=dev).manual_seed(0)))
        for name, fn in (("decode", decode), ("encode", encode)):
            fn()
            rec[f"{name}_ms"] = [host_ms(fn) for _ in range(3)]
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.cpu() for k, v in outs.items()}, os.path.join(out_dir, f"{label}.pt"))
    rec.update({f"{k}_shape": list(v.shape) for k, v in outs.items()})


def compare(path_a: str, path_b: str) -> dict:
    a, b = torch.load(path_a), torch.load(path_b)
    rec = {}
    for k, want in a.items():
        got = b[k]
        peak = want.float().abs().max().item()
        diff = (got.float() - want.float()).abs().max().item()
        rec[k] = dict(identical=bool(torch.equal(got, want)), max_abs_diff=diff,
                      rel_to_peak=diff / max(peak, 1e-30), peak=peak,
                      finite=bool(torch.isfinite(got.float()).all()))
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root")
    p.add_argument("--label")
    p.add_argument("--out")
    p.add_argument("--compare", nargs=2)
    p.add_argument("--plain", action="store_true",
                   help="the snake-conv forwards by their plain versions in f32; no kernel times")
    args = p.parse_args()
    if args.compare:
        print(json.dumps(dict(compare=args.compare, **compare(*args.compare))))
        return 0
    if not torch.cuda.is_available():
        print("ab_snake_conv_torch: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.root, args.label, args.out, args.plain)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
