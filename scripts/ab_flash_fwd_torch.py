"""Time the PyTorch port's flash-attention forward entries, its LayerNorm and
the paths they run on in one checkout of the repo, to compare two commits on
one CUDA card.

    python scripts/ab_flash_fwd_torch.py --root DIR --label NAME --out OUT
    python scripts/ab_flash_fwd_torch.py --compare OUT/A.pt OUT/B.pt

The first form imports `stable_audio_tools_tpu_torch` from DIR (a checkout,
for example a `git archive` of another commit unpacked there). On seeded bf16
inputs it times, with CUDA events after a warm-up:
- `flash_attention_nhd` (row 7) at [2, 6145, 24, 64] (SA-2.0 generation: q, k
  contiguous, v a view of the fused projection), `flash_attention_prefix`
  (row 1) at [2, 24, 1025, 64] (SA-Open), `flash_attention` (row 5) at
  [4, 16, 500, 64] causal (the LM's training), each beside
  `F.scaled_dot_product_attention` on the same inputs;
- `flash_attention_fused_qkv` (row 8) at [4, 6145, 24, 64] with rotary 32
  (SA-2.0 DiT training) beside SDPA on pre-rotated q, k, v and beside the
  rotary pass + `flash_attention_nhd`;
- `fused_layer_norm` (row 2) at [2, 1025, 1536] (SA-Open's DiT) beside
  `F.layer_norm`: ms a call in a loop of 200, and the host's microseconds a
  call (the loop enqueued without a sync);
and, on the synchronised host clock:
- one SA-2.0 sampler step: the DiT of `stable_audio_2_0.json` (24 blocks of
  1536, random weights from a seed) in inference mode on 2 x 6144 latents
  (the CFG batch; 6145 rows with the prefix token), 5 timed after 1 warm-up;
- one SA-2.0 DiT forward+backward at batch 4 x 6144 latents (block remat),
  3 timed after 1 warm-up;
- one SA-Open generation request (the shipped `stable_audio_open_1_0.json`,
  random weights and T5, batch 1, 100 steps, cfg 6, 2,097,152 samples),
  2 timed after a 2-step warm-up.
It prints one JSON line and saves to OUT/NAME.pt the entries' outputs, the
LayerNorm's, the sampler step's, the DiT's input gradient and its first and
last blocks' weight gradients, and the two-pass flash backward's gradients at
[4, 24, 1025, 64] from a plain forward's output (the same inputs in every
checkout). The second form holds two such files against each other: each
tensor's largest difference over the first file's peak, within `--tol`
(default 2e-2, chip_smoke.py's BWD_REL_TOL: the kernels round in other
places), and whether it is identical; exit 1 past the tolerance.

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
import torch.nn.functional as F

CONFIGS = ("stable_audio_tools_tpu", "configs", "model_configs", "txt2audio")
LATENTS, COND_TOKENS = 6144, 130
SA_OPEN_SAMPLES = 2097152
PROMPT = [{"prompt": "An upbeat electronic track with a driving bassline",
           "seconds_start": 0, "seconds_total": SA_OPEN_SAMPLES / 44100.0}]


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


def host_us(fn, iters: int = 200) -> float:
    """Microseconds of host time a call: the loop enqueued, not synced."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernels(dev, saved: dict) -> dict:
    from stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs, rotary_tables, rotate_nhd
    from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa
    from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    sdpa = F.scaled_dot_product_attention
    rec = {}
    with torch.no_grad():
        # row 7: SA-2.0 generation's self-attention
        fused = randn(2, 6145, 3 * 24 * 64)
        q, k, v = (t.view(2, 6145, 24, 64) for t in fused.chunk(3, dim=-1))
        q, k = q.contiguous(), k.contiguous()
        saved["row 7 out"] = fa.flash_attention_nhd(q, k, v, prefix_len=1).cpu()
        rec["row 7 [2,6145,24,64]"] = dict(
            ms=cuda_ms(lambda: fa.flash_attention_nhd(q, k, v, prefix_len=1), 20),
            sdpa_ms=cuda_ms(lambda: sdpa(*(t.transpose(1, 2) for t in (q, k, v))), 20))
        # row 1: SA-Open's
        q, k, v = (randn(2, 24, 1025, 64) for _ in range(3))
        saved["row 1 out"] = fa.flash_attention_prefix(q, k, v, 1)[0].cpu()
        rec["row 1 [2,24,1025,64]"] = dict(
            ms=cuda_ms(lambda: fa.flash_attention_prefix(q, k, v, 1), 100),
            sdpa_ms=cuda_ms(lambda: sdpa(q, k, v), 100))
        # row 5: the LM's causal training shape
        q, k, v = (randn(4, 16, 500, 64) for _ in range(3))
        saved["row 5 out"] = fa.flash_attention(q, k, v, True)[0].cpu()
        rec["row 5 [4,16,500,64] causal"] = dict(
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, True), 100),
            sdpa_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True), 100))
        # row 8: SA-2.0 DiT training's self-attention forward
        qkv = randn(4, 6145, 3 * 24 * 64)
        cos, sin = rotary_tables(rotary_freqs(6145, 32, device=dev))
        q, k, v = (t.view(4, 6145, 24, 64) for t in qkv.chunk(3, dim=-1))
        pair = lambda: fa.flash_attention_nhd(rotate_nhd(q, cos, sin), rotate_nhd(k, cos, sin), v,
                                              prefix_len=1)
        qr, kr = rotate_nhd(q, cos, sin), rotate_nhd(k, cos, sin)
        saved["row 8 out"] = fa.flash_attention_fused_qkv(qkv, cos, sin, 24).cpu()
        rec["row 8 [4,6145,24,64] rot 32"] = dict(
            ms=cuda_ms(lambda: fa.flash_attention_fused_qkv(qkv, cos, sin, 24), 10),
            rotary_plus_row7_ms=cuda_ms(pair, 10),
            sdpa_prerotated_ms=cuda_ms(lambda: sdpa(*(t.transpose(1, 2) for t in (qr, kr, v))), 10))
        del fused, qkv, q, k, v, qr, kr
        # row 2: the DiT's LayerNorm, gamma f32 (the library call takes it in bf16)
        x = randn(2, 1025, 1536) * 3
        gamma = torch.randn(1536, generator=g, device=dev)
        saved["row 2 out"] = ln.fused_layer_norm(x, gamma).cpu()
        run = lambda: ln.fused_layer_norm(x, gamma)
        lib = lambda gb=gamma.to(torch.bfloat16): F.layer_norm(x, (1536,), gb)
        rec["row 2 [2,1025,1536]"] = dict(ms=cuda_ms(run, 200), host_us=host_us(run),
                                           library_ms=cuda_ms(lib, 200), library_host_us=host_us(lib))
    # row 6's two-pass backward from a plain forward (the same inputs in every
    # checkout): the moved Hopper primitives must not change its bits
    q, k, v, dout = (randn(4, 24, 1025, 64) for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v)
    for n, t in zip("qkv", fa.flash_attention_prefix_bwd(q, k, v, out, lse, dout,
                                                         route="two_pass")):
        saved[f"row 6 two_pass d{n}"] = t.cpu()
    return rec


def sa2_dit(root: str, dev, saved: dict) -> dict:
    from stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
    from stable_audio_tools_tpu_torch.models.factory import init_random_

    with open(os.path.join(root, *CONFIGS, "stable_audio_2_0.json")) as f:
        cfg = json.load(f)["model"]["diffusion"]["config"]
    with dev:
        dit = DiffusionTransformer(**cfg)
    init_random_(dit, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(7)
    rand = lambda *s: torch.randn(*s, generator=g, device=dev)
    rec = {}
    # the sampler step: the CFG batch of 2 in inference mode
    x, t = rand(2, cfg["io_channels"], LATENTS), torch.rand(2, generator=g, device=dev)
    cond, glob = rand(2, COND_TOKENS, cfg["cond_token_dim"]), rand(2, cfg["global_cond_dim"])
    dit.eval()
    with torch.inference_mode():
        step = lambda: dit(x, t, cross_attn_cond=cond, global_embed=glob)
        saved["sa2 step out"] = step().float().cpu()
        rec["sa2_sampler_step_ms"] = [host_ms(step) for _ in range(5)]
    # the training forward+backward at batch 4
    dit.train()
    x = rand(4, cfg["io_channels"], LATENTS).requires_grad_()
    t = torch.rand(4, generator=g, device=dev)
    cond, glob = rand(4, COND_TOKENS, cfg["cond_token_dim"]), rand(4, cfg["global_cond_dim"])
    target = rand(4, cfg["io_channels"], LATENTS)

    def fwd_bwd():
        dit.zero_grad(set_to_none=True)
        x.grad = None
        out = dit(x, t, cross_attn_cond=cond, global_embed=glob)
        ((out.float() - target) ** 2).mean().backward()

    fwd_bwd()
    rec["sa2_dit_fwd_bwd_ms"] = [host_ms(fwd_bwd) for _ in range(3)]
    layers = dit.transformer.layers
    saved["sa2 dit dx"] = x.grad.cpu()
    for i in (0, len(layers) - 1):
        for n, p in layers[i].named_parameters():
            saved[f"sa2 dit block {i} {n}"] = p.grad.float().cpu()
    return rec


def sa_open(root: str, dev) -> dict:
    from stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_

    with open(os.path.join(root, *CONFIGS, "stable_audio_open_1_0.json")) as f:
        cfg = json.load(f)
    for c in cfg["model"]["conditioning"]["configs"]:
        if c["type"] == "t5":
            c["config"]["allow_random_init"] = True
    model = create_model_from_config(cfg, dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0)).eval()
    run = lambda steps, seed: generate_diffusion_cond(
        model, steps=steps, cfg_scale=6.0, conditioning=PROMPT, batch_size=1,
        sample_size=SA_OPEN_SAMPLES, seed=seed, sampler_type="dpmpp-3m-sde", sigma_min=0.3,
        sigma_max=500.0)
    run(2, 0)
    walls = []
    for seed in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = run(100, seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not torch.isfinite(audio).all():
            raise AssertionError("SA-Open generation: non-finite audio")
    return dict(sa_open_generation_s=walls)


def run(root: str, label: str, out_dir: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import stable_audio_tools_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    rec = dict(label=label, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    saved = {}
    rec["kernels"] = kernels(dev, saved)
    torch.cuda.empty_cache()
    rec.update(sa2_dit(root, dev, saved))
    torch.cuda.empty_cache()
    rec.update(sa_open(root, dev))
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, f"{label}.pt"))
    return rec


def compare(path_a: str, path_b: str, tol: float) -> dict:
    a, b = torch.load(path_a), torch.load(path_b)
    errs, same = {}, {}
    for k, want in a.items():
        got, want_f = b[k].float(), want.float()
        err = ((got - want_f).abs().max() / want_f.abs().max().clamp_min(1e-30)).item()
        errs[k] = err if torch.isfinite(got).all() else float("inf")
        same[k] = torch.equal(a[k], b[k])
    worst = max(errs.values())
    return dict(tol=tol, within_tol=worst <= tol, worst=worst, worst_tensor=max(errs, key=errs.get),
                identical=[k for k, s in same.items() if s],
                different=[k for k, s in same.items() if not s], rel_errs=errs)


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
        print("ab_flash_fwd_torch: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.root, args.label, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
