"""Time the PyTorch port's flash-attention backward and one SA-2.0 DiT
forward+backward in one checkout of the repo, to compare two commits on one
CUDA card.

    python scripts/ab_flash_bwd_torch.py --root DIR --label NAME --out OUT
    python scripts/ab_flash_bwd_torch.py --compare OUT/A.pt OUT/B.pt

The first form imports `stable_audio_tools_tpu_torch` from DIR (a checkout,
for example a `git archive` of another commit unpacked there). On seeded bf16
inputs it times, with CUDA events after a warm-up:
- `flash_attention_prefix_bwd` by each of its routes at [4, 24, 6145, 64]
  unmasked (SA-2.0's DiT training), [4, 24, 1025, 64] unmasked (SA-Open's)
  and [4, 16, 500, 64] causal (the LM's), from the forward's own output and
  logsumexp;
- autograd's backward through `F.scaled_dot_product_attention` on the same
  inputs, a yardstick only;
and, on the synchronised host clock, one forward+backward of SA-2.0's DiT
(`stable_audio_2_0.json`'s `diffusion.config`: 24 blocks of 1536, bf16, block
remat, random weights from a seed) on 4 x 6144 seeded latents with seeded
timesteps, cross-attention tokens [4, 130, 768] and global conditioning
(1 warm-up, 3 timed). It prints one JSON line and saves the training
route's gradients at the three shapes and the DiT's input gradient and its
first and last blocks' weight gradients to OUT/NAME.pt. The second form
holds two such files against each other: each tensor's largest difference
over the first file's peak, within `--tol` (default 2e-2, chip_smoke.py's
BWD_REL_TOL: the summation order differs between commits), exit 1 if not.

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
# (B, H, N, D, causal, timed iterations)
SHAPES = ((4, 24, 6145, 64, False, 5), (4, 24, 1025, 64, False, 20), (4, 16, 500, 64, True, 50))
DIT_BATCH, LATENTS, COND_TOKENS = 4, 6144, 130


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


def run(root: str, label: str, out_dir: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import stable_audio_tools_tpu_torch as pkg
    from stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
    from stable_audio_tools_tpu_torch.models.factory import init_random_
    from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    rec = dict(label=label, bwd_route=fa.BWD_ROUTE, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    saved = {}
    rec["flash_bwd_ms"] = {}
    for B, H, N, D, causal, iters in SHAPES:
        g = torch.Generator(device=dev).manual_seed(N)
        q, k, v, dout = (torch.randn((B, H, N, D), generator=g, device=dev).to(torch.bfloat16)
                         for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, causal)
        name = f"[{B},{H},{N},{D}]" + (" causal" if causal else "")
        times = {}
        for route in fa.BWD_ROUTES:
            run_bwd = lambda route=route: fa.flash_attention_prefix_bwd(
                q, k, v, out, lse, dout, route=route, causal=causal)
            times[route] = cuda_ms(run_bwd, iters)
        for n, t in zip("qkv", fa.flash_attention_prefix_bwd(q, k, v, out, lse, dout,
                                                             causal=causal)):
            saved[f"{name} d{n}"] = t.cpu()
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*qkv, is_causal=causal)
        times["sdpa_backward"] = cuda_ms(
            lambda: torch.autograd.grad(lib_out, qkv, dout, retain_graph=True), iters)
        rec["flash_bwd_ms"][name] = times
        del q, k, v, dout, out, lse, qkv, lib_out
        torch.cuda.empty_cache()

    with open(os.path.join(root, *SA2_CONFIG)) as f:
        cfg = json.load(f)["model"]["diffusion"]["config"]
    with dev:
        dit = DiffusionTransformer(**cfg)
    init_random_(dit, torch.Generator(device=dev).manual_seed(0)).train()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(DIT_BATCH, cfg["io_channels"], LATENTS, generator=g, device=dev)
    x.requires_grad_()
    t = torch.rand(DIT_BATCH, generator=g, device=dev)
    cond = torch.randn(DIT_BATCH, COND_TOKENS, cfg["cond_token_dim"], generator=g, device=dev)
    glob = torch.randn(DIT_BATCH, cfg["global_cond_dim"], generator=g, device=dev)
    target = torch.randn(DIT_BATCH, cfg["io_channels"], LATENTS, generator=g, device=dev)

    def fwd_bwd():
        dit.zero_grad(set_to_none=True)
        x.grad = None
        out = dit(x, t, cross_attn_cond=cond, global_embed=glob)
        ((out.float() - target) ** 2).mean().backward()

    fwd_bwd()
    before = fa.flash_attention_prefix_bwd.launches
    rec["dit_fwd_bwd_ms"] = [host_ms(fwd_bwd) for _ in range(3)]
    rec["dit_flash_bwd_launches"] = fa.flash_attention_prefix_bwd.launches - before
    layers = dit.transformer.layers
    saved["dit dx"] = x.grad.cpu()
    for i in (0, len(layers) - 1):
        for n, p in layers[i].named_parameters():
            saved[f"dit block {i} {n}"] = p.grad.float().cpu()
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, f"{label}.pt"))
    return rec


def compare(path_a: str, path_b: str, tol: float) -> dict:
    a, b = torch.load(path_a), torch.load(path_b)
    worst, errs = 0.0, {}
    for k, want in a.items():
        got = b[k].float()
        want = want.float()
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        if not torch.isfinite(got).all():
            err = float("inf")
        errs[k] = err
        worst = max(worst, err)
    return dict(tol=tol, within_tol=worst <= tol, worst=worst,
                worst_tensor=max(errs, key=errs.get), identical=all(
                    torch.equal(a[k], b[k]) for k in a), rel_errs=errs)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root")
    p.add_argument("--label")
    p.add_argument("--out")
    p.add_argument("--compare", nargs=2)
    p.add_argument("--tol", type=float, default=2e-2)
    args = p.parse_args()
    if args.compare:
        rec = compare(*args.compare, args.tol)
        print(json.dumps(dict(compare=args.compare, **rec)))
        return 0 if rec["within_tol"] else 1
    if not torch.cuda.is_available():
        print("ab_flash_bwd_torch: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.root, args.label, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
