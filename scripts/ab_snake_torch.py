"""Time the PyTorch port's snake activation kernels (row 4 forward, row 9
backward) and the paths they run on in one checkout of the repo, to compare
two commits on one CUDA card.

    python scripts/ab_snake_torch.py --root DIR --label NAME --out OUT
    python scripts/ab_snake_torch.py --compare OUT/A.pt OUT/B.pt

The first form imports `stable_audio_tools_tpu_torch` from DIR (a checkout,
for example a `git archive` of another commit unpacked there). On seeded bf16
inputs it times, with CUDA events after a warm-up:
- `snake_fused_bwd` (row 9) and `snake_fused` (row 4, as a decode calls it:
  no autograd), by CUDA events over back-to-back calls and by the profiler's
  kernel time a call (`device_ms`: without the host time that paces the
  small sites), at the SA-2.0 VAE's six snake sites at batch 4 x 65,536
  (`autoencoders/stable_audio_2_0_vae.json`: before the encoder's strided
  convs and the decoder's transposed ones) and their sums weighted by one
  generator step's 10 launches (1, 2, 2, 2, 2, 1), beside the summed byte
  bounds; row 4 at the five sites of one SA-2.0 decode group (batch 8, one
  launch each) summed, and at [1, 128, 1048576];
- the host microseconds of a backward call at the 2048 x 32 site;
and it checks that two backward calls give the same bits. Then, on the
synchronised host clock, the VAE-GAN trainer (`AutoencoderTrainer` as
`train.build` makes it: random weights from a seed, bf16, the EnCodec
discriminator) on one seeded batch under `torch.use_deterministic_algorithms
(True, warn_only=True)` (the step's reflection-pad backward has none): 2
warm-up pairs, 5 timed generator + discriminator pairs, and the generator
step's gradients from the same weights; and the SA-2.0 VAE's chunked decode
of 6144 seeded latents and encode of one 12,582,912-sample clip
(`ab_snake_conv_torch.decode_encode`: 1 warm-up, 3 timed calls each). It
prints one JSON line and saves the kernels' outputs, the gradients and the
decoded audio to OUT/NAME.pt and OUT/NAME_codec.pt. The last form holds the
second checkout's files against the first's: each kernel output's largest
difference over the first's peak beside its tolerance (2 bf16 ulps of the
peak for dx and y, 1e-2 for dalpha and dbeta, as chip_smoke.py's phase 2),
each gradient's ||B - A|| / ||A||, and the decode's and encode's outputs;
exit 1 past a kernel tolerance.

Run the checkouts in turns on one card, one after another (A, B, B, A),
and compare only numbers taken together in that way.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [SCRIPTS, os.path.dirname(SCRIPTS)]

import torch  # noqa: E402

import ab_snake_conv_bwd_torch as ab_bwd  # noqa: E402
import ab_snake_conv_torch as ab_fwd  # noqa: E402
from chip_smoke import profiled_us  # noqa: E402

B_AE, B_DECODE = 4, 8
# (C, L, launches in one generator step) of the VAE's snake_fused sites
AE_SITES = ((128, 65536, 1), (128, 32768, 2), (256, 8192, 2), (512, 2048, 2), (1024, 256, 2),
            (2048, 32, 1))
# (C, L) of the snake_fused sites of one SA-2.0 decode group of 8 chunks
DECODE_SITES = ((2048, 128), (1024, 1024), (512, 8192), (256, 32768), (128, 131072))
LONG = (1, 128, 1048576)
WARM_PAIRS, TIMED_PAIRS = 2, 5
ULPS, GRAD_TOL = 2, 1e-2


def bytes_ms(*tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 3.35e12 * 1e3


def inputs(dev, B, C, L, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(B, C, L, generator=g, device=dev) * 2).to(torch.bfloat16)
    cot = torch.randn(B, C, L, generator=g, device=dev).to(torch.bfloat16)
    return x, cot, torch.randn(C, generator=g, device=dev).exp(), torch.randn(
        C, generator=g, device=dev).exp()


def device_ms(fn) -> float:
    """The kernels' own time a call by the profiler, without the host time
    between launches that paces back-to-back calls at small sites
    (chip_smoke.py's `profiled_us`: a warm-up window discarded, a window
    in which the tracer recorded no kernel read again)."""
    return profiled_us(fn, 20)["device_us"] / 1e3


def kernel_sites(sn, dev) -> tuple:
    rec, outs = dict(ae_sites={}, decode_sites={}), {}
    step = dict(bwd_ms=0.0, fwd_ms=0.0, bwd_device_ms=0.0, fwd_device_ms=0.0, bwd_bound_ms=0.0,
                fwd_bound_ms=0.0)
    identical = True
    for i, (C, L, n) in enumerate(AE_SITES):
        x, g, a, b = inputs(dev, B_AE, C, L, 10 + i)
        with torch.no_grad():
            y = sn.snake_fused(x, a, b)
            dx, da, db = sn.snake_fused_bwd(x, a, b, g)
            again = sn.snake_fused_bwd(x, a, b, g)
            identical &= all(torch.equal(p, q) for p, q in zip((dx, da, db), again))
            name = f"[{B_AE},{C},{L}]"
            outs[name] = dict(y=y.cpu(), dx=dx.cpu(), dalpha=da.cpu(), dbeta=db.cpu())
            bwd, fwd = lambda: sn.snake_fused_bwd(x, a, b, g), lambda: sn.snake_fused(x, a, b)
            site = dict(launches=n, bwd_ms=ab_bwd.cuda_ms(bwd, 20),
                        fwd_ms=ab_bwd.cuda_ms(fwd, 20), bwd_device_ms=device_ms(bwd),
                        fwd_device_ms=device_ms(fwd),
                        bwd_bound_ms=bytes_ms(x, g, a, b, dx, da, db),
                        fwd_bound_ms=bytes_ms(x, a, b, y))
        rec["ae_sites"][name] = site
        for k in step:
            step[k] += n * site[k]
        if (C, L) == (2048, 32):
            rec["bwd_host_us_2048x32"] = host_us(lambda: sn.snake_fused_bwd(x, a, b, g))
        del x, g, y, dx, again
    rec["generator_step"] = dict(
        step, bwd_share=step["bwd_bound_ms"] / step["bwd_ms"],
        fwd_share=step["fwd_bound_ms"] / step["fwd_ms"],
        bwd_device_share=step["bwd_bound_ms"] / step["bwd_device_ms"],
        fwd_device_share=step["fwd_bound_ms"] / step["fwd_device_ms"])
    rec["bwd_bit_identical"] = identical
    group = dict(fwd_ms=0.0, fwd_device_ms=0.0, fwd_bound_ms=0.0)
    for i, (C, L) in enumerate(DECODE_SITES):
        x, _, a, b = inputs(dev, B_DECODE, C, L, 30 + i)
        with torch.no_grad():
            y = sn.snake_fused(x, a, b)
            outs[f"[{B_DECODE},{C},{L}]"] = dict(y=y.cpu())
            fwd = lambda: sn.snake_fused(x, a, b)
            site = dict(fwd_ms=ab_bwd.cuda_ms(fwd, 10), fwd_device_ms=device_ms(fwd),
                        fwd_bound_ms=bytes_ms(x, a, b, y))
        rec["decode_sites"][f"[{B_DECODE},{C},{L}]"] = site
        for k in group:
            group[k] += site[k]
        del x, y
    rec["decode_group"] = dict(group, fwd_share=group["fwd_bound_ms"] / group["fwd_ms"],
                               fwd_device_share=group["fwd_bound_ms"] / group["fwd_device_ms"])
    x, _, a, b = inputs(dev, *LONG, 40)
    with torch.no_grad():
        y = sn.snake_fused(x, a, b)
        rec["fwd_long"] = dict(shape=str(list(LONG)),
                               ms=ab_bwd.cuda_ms(lambda: sn.snake_fused(x, a, b), 20),
                               bound_ms=bytes_ms(x, a, b, y))
    return rec, outs


def host_us(fn, iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def vae_pair(root, dev) -> tuple:
    """The VAE-GAN pair's times and the generator step's gradients, both
    under deterministic algorithms."""
    w, audio = ab_bwd.trainer(root, dev)
    ab_bwd.grad_names_overlap(w)
    start = {n: p.detach().clone()
             for n, p in list(w.params.items()) + list(w.disc_params.items())}
    warnings.simplefilter("ignore")  # the deterministic mode's warn_only warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    for _ in range(2 * WARM_PAIRS):
        w.train_step(audio)
    pairs = []
    for _ in range(TIMED_PAIRS):
        while w.uses_disc(w.step):
            w.train_step(audio)
        pairs.append(ab_bwd.host_ms(lambda: (w.train_step(audio), w.train_step(audio))))
    grads = ab_bwd.gen_grads(w, audio, start)
    torch.use_deterministic_algorithms(False)
    rec = dict(pair_ms_deterministic=pairs,
               pair_ms_deterministic_median=statistics.median(pairs))
    return rec, {n: g.cpu() for n, g in grads.items()}


def run(root: str, label: str, out_dir: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import stable_audio_tools_tpu_torch as pkg
    from stable_audio_tools_tpu_torch.ops.kernels import snake as sn

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    rec = dict(label=label, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    saved = {}
    k, saved["kernels"] = kernel_sites(sn, dev)
    rec.update(k)
    pair, saved["grads"] = vae_pair(root, dev)
    rec.update(pair)
    torch.cuda.empty_cache()
    ab_fwd.decode_encode(root, dev, rec, out_dir, f"{label}_codec")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, f"{label}.pt"))
    return rec


def compare(path_a: str, path_b: str) -> dict:
    a, b = torch.load(path_a), torch.load(path_b)
    rec, ok = {"kernels": {}}, True
    for site, outs in a["kernels"].items():
        errs = {}
        for n, want in outs.items():
            peak = want.float().abs().max().item()
            tol = (ULPS * 2.0 ** -7 * max(1.0, peak) if n in ("dx", "y") else GRAD_TOL * peak)
            err = (b["kernels"][site][n].float() - want.float()).abs().max().item()
            errs[n] = [err, tol]
            ok &= err <= tol
        rec["kernels"][site] = errs
    ga, gb = a["grads"], b["grads"]
    per = {n: ((gb[n] - ga[n]).norm() / ga[n].norm().clamp_min(1e-30)).item() for n in ga}
    worst = max(per, key=per.get)
    rec["grads"] = dict(identical=all(torch.equal(ga[n], gb[n]) for n in ga),
                        worst=[worst, per[worst]], median=statistics.median(per.values()))
    codec = [p[:-len(".pt")] + "_codec.pt" for p in (path_a, path_b)]
    rec["codec"] = ab_fwd.compare(*codec)
    rec["kernels_within_tol"] = ok
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root")
    p.add_argument("--label")
    p.add_argument("--out")
    p.add_argument("--compare", nargs=2)
    args = p.parse_args()
    if args.compare:
        rec = compare(*args.compare)
        print(json.dumps(dict(compare=args.compare, **rec)))
        return 0 if rec["kernels_within_tol"] else 1
    if not torch.cuda.is_available():
        print("ab_snake_torch: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.root, args.label, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
