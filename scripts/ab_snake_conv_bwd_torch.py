"""Time the PyTorch port's snake-conv backward kernels (rows 10 and 11) and
one SA-2.0 VAE-GAN generator step in one checkout of the repo, to compare
two commits on one CUDA card.

    python scripts/ab_snake_conv_bwd_torch.py --root DIR --label NAME --out OUT
    python scripts/ab_snake_conv_bwd_torch.py --root DIR --label NAME --out OUT --plain
    python scripts/ab_snake_conv_bwd_torch.py --compare OUT/A.pt OUT/B.pt [OUT/REF.pt]

The first form imports `stable_audio_tools_tpu_torch` from DIR (a checkout,
for example a `git archive` of another commit unpacked there). On seeded bf16
inputs it times, with CUDA events after a warm-up:
- `snake_conv1d_dx` (row 10) and `snake_conv1d_wgrad` (row 11) at the 22
  snake-conv shapes of one generator step of the SA-2.0 VAE at batch 4 x
  65,536 (`autoencoders/stable_audio_2_0_vae.json`: five levels of k = 7 at
  d 1 / 3 / 9 and k = 1, the two conv_outs), and their sums weighted by the
  step's launches (2 each k = 7 case, 6 each k = 1, 1 each conv_out);
- `conv1d_wgrad` (row 11 without the snake) at the encoder's conv_in [4, 2,
  65536] -> 128 k = 7 and at [4, 64, 32] -> 2048, beside
  `torch.nn.grad.conv1d_weight` (a yardstick the port never calls);
and, on the synchronised host clock, the VAE-GAN trainer (`AutoencoderTrainer`
as `train.build` makes it: random weights from a seed, bf16, the EnCodec
discriminator) on one seeded batch: 2 warm-up pairs, then 5 timed pairs
(generator + discriminator step) with PyTorch's defaults and 5 with
deterministic algorithms (`torch.use_deterministic_algorithms(True,
warn_only=True)`: the step's reflection-pad backward has no deterministic
implementation and would raise); the generator step's pieces
(`gen_split`). Then the generator step's gradients from the same weights
and step number twice with the defaults, twice with only
`torch.backends.cudnn.deterministic`, twice with deterministic algorithms
(their run-to-run differences say which setting makes the step
reproducible), and once more in deterministic mode with the ops that have
no deterministic implementation recorded from their warnings. It prints one JSON
line and saves the kernels' outputs and the deterministic step's gradients
to OUT/NAME.pt. With --plain it times nothing: the same gradients with every
snake conv (forward and backward) replaced by its plain version in f32
(a reference for two commits' summation orders). The last form holds the
second file against the first: each kernel output's largest difference over
the first's peak beside its tolerance (2 bf16 ulps of the peak for dx, 1e-2
for dW, db, dalpha, dbeta, chip_smoke.py's phase 2), each gradient's
||B - A|| / ||A||, and with a third file both commits' distances from it.

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

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS under deterministic mode

import torch  # noqa: E402

SA2_VAE = ("stable_audio_tools_tpu", "configs", "model_configs", "autoencoders",
           "stable_audio_2_0_vae.json")
B = 4
LEVELS = ((128, 65536), (128, 32768), (256, 8192), (512, 2048), (1024, 256))
# (C, Co, L, k, d, launches in one generator step)
CASES = [(C, C, L, k, d, 6 if k == 1 else 2) for C, L in LEVELS
         for k, d in ((7, 1), (7, 3), (7, 9), (1, 1))]
CASES += [(2048, 128, 32, 3, 1, 1), (128, 2, 65536, 7, 1, 1)]
PLAIN_CASES = ((2, 128, 65536), (64, 2048, 32))
WARM_PAIRS, TIMED_PAIRS = 2, 5
DX_ULPS, GRAD_TOL = 2, 1e-2


def cuda_ms(fn, iters: int = 5) -> float:
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


def bound_ms(flops: float, *tensors) -> float:
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return max(flops / 989e12, nbytes / 3.35e12) * 1e3


def kernel_cases(cs, dev) -> tuple:
    """Rows 10 and 11 at the 22 cases and row 11 plain at its two: times,
    bounds and outputs."""
    rec, outs = {"cases": {}}, {}
    sums = dict(dx_ms=0.0, wgrad_ms=0.0, dx_bound_ms=0.0, wgrad_bound_ms=0.0)
    for i, (C, Co, L, k, d, n) in enumerate(CASES):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        rand = lambda *s, scale=1.0: (torch.randn(s, generator=g, device=dev) * scale)
        x = rand(B, C, L, scale=2.0).to(torch.bfloat16)
        w = rand(Co, C, k, scale=(C * k) ** -0.5).to(torch.bfloat16)
        a, b = rand(C).exp(), rand(C).exp()
        dy = rand(B, Co, L).to(torch.bfloat16)
        pad = d * (k - 1) // 2
        name = f"[{B},{C},{L}] -> {Co} k={k} d={d}"
        dx = cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d)
        dw = cs.snake_conv1d_wgrad(dy, x, k, a, b, pad, pad, d)
        outs[name] = dict(dx=dx[0].cpu(), dalpha=dx[1].cpu(), dbeta=dx[2].cpu(),
                          dW=dw[0].cpu(), db=dw[1].cpu())
        t_dx = cuda_ms(lambda: cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d))
        t_w = cuda_ms(lambda: cs.snake_conv1d_wgrad(dy, x, k, a, b, pad, pad, d))
        # row 10 reads dy, x, w, alpha, beta and writes dx; row 11 reads dy,
        # x, alpha, beta and writes dW
        case = dict(launches=n, dx_ms=t_dx, wgrad_ms=t_w,
                    dx_bound_ms=bound_ms(2.0 * B * L * C * Co * k, dy, x, w, a, b, x),
                    wgrad_bound_ms=bound_ms(2.0 * B * L * C * Co * k, dy, x, a, b, dw[0]))
        rec["cases"][name] = case
        for key in sums:
            sums[key] += n * case[key]
        del x, w, dy, dx, dw
    rec["step_sums"] = dict(sums, dx_share=sums["dx_bound_ms"] / sums["dx_ms"],
                            wgrad_share=sums["wgrad_bound_ms"] / sums["wgrad_ms"])
    rec["plain"] = {}
    for i, (C, Co, L) in enumerate(PLAIN_CASES):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        x = torch.randn(B, C, L, generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn(B, Co, L, generator=g, device=dev).to(torch.bfloat16)
        name = f"[{B},{C},{L}] -> {Co} k=7"
        dw = cs.conv1d_wgrad(dy, x, 7, 3, 3, 1)
        outs["plain " + name] = dict(dW=dw[0].cpu(), db=dw[1].cpu())
        rec["plain"][name] = dict(
            ms=cuda_ms(lambda: cs.conv1d_wgrad(dy, x, 7, 3, 3, 1), 10),
            conv1d_weight_ms=cuda_ms(
                lambda: torch.nn.grad.conv1d_weight(x, (Co, C, 7), dy, padding=3), 10))
    return rec, outs


def plain_f32(cs):
    """Every snake conv of the model, forward and backward, by its plain
    version in f32 (outputs rounded to the input's dtype)."""
    from stable_audio_tools_tpu_torch.ops import conv

    torch.backends.cudnn.allow_tf32 = False

    def launch(x, w, bias, alpha, beta, pad_lo, pad_hi, d, residual):
        res = None if residual is None else residual.float()
        return cs.snake_conv1d_plain(x.float(), w.float(), bias, alpha, beta, pad_lo, pad_hi, d,
                                     res).to(x.dtype)

    def dx(dy, x, w, alpha, beta, pad_lo, pad_hi, d):
        out = cs.snake_conv1d_dx_plain(dy.float(), x.float(), w.float(), alpha, beta, pad_lo,
                                       pad_hi, d)
        return (out[0].to(x.dtype),) + out[1:]

    cs._launch = launch
    cs.snake_conv1d_dx = dx
    cs.snake_conv1d_wgrad = lambda dy, x, k, a, b, lo, hi, d: cs.conv1d_wgrad_plain(
        dy.float(), x.float(), k, lo, hi, d, (a, b))
    conv.conv1d_wgrad = lambda dy, x, k, lo, hi, d: cs.conv1d_wgrad_plain(
        dy.float(), x.float(), k, lo, hi, d)


def trainer(root, dev):
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    with open(os.path.join(root, *SA2_VAE)) as f:
        cfg = json.load(f)
    cfg.setdefault("training", {}).setdefault("compute_dtype", "bfloat16")
    model = create_model_from_config(cfg, dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0))
    w = create_training_wrapper_from_config(cfg, model, seed=0)
    g = torch.Generator(device=dev).manual_seed(7)
    audio = torch.randn(B, 2, cfg["sample_size"], generator=g, device=dev) * 0.3
    return w, audio


def gen_grads(w, audio, start: dict) -> dict:
    """The generator step's gradients from the weights `start` (the
    autoencoder's and the discriminator's) at step 0."""
    with torch.no_grad():
        for n, p in list(w.params.items()) + list(w.disc_params.items()):
            p.copy_(start[n])
    w.step = 0
    w.train_step(audio)
    torch.cuda.synchronize()
    return {n: p.grad.detach().float().clone() for n, p in w.params.items()}


def max_rel(a: dict, b: dict) -> float:
    return max(((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)).item() for n in b)


def grad_names_overlap(w) -> None:
    if set(w.params) & set(w.disc_params):
        raise RuntimeError("the autoencoder's and the discriminator's parameter names overlap")


def step_runs(w, audio, timed: bool) -> tuple:
    rec = {}
    warnings.simplefilter("ignore")  # the deterministic mode's warnings, recorded below
    start = {n: p.detach().clone()
             for n, p in list(w.params.items()) + list(w.disc_params.items())}
    if timed:
        for _ in range(2 * WARM_PAIRS):
            w.train_step(audio)
        for mode in ("default", "deterministic"):
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            pairs = []
            for _ in range(TIMED_PAIRS):
                while w.uses_disc(w.step):
                    w.train_step(audio)
                pairs.append(host_ms(lambda: (w.train_step(audio), w.train_step(audio))))
            rec[f"pair_ms_{mode}"] = pairs
            rec[f"pair_ms_{mode}_median"] = statistics.median(pairs)
        torch.use_deterministic_algorithms(False)
        while w.uses_disc(w.step):
            w.train_step(audio)
        w.gen_split = {}
        rec["gen_step_ms"] = host_ms(lambda: w.train_step(audio))
        rec["gen_split"], w.gen_split = w.gen_split, None
        # which setting makes the generator step's gradients reproducible
        spread = {}
        for mode in ("default", "cudnn_deterministic", "deterministic"):
            torch.backends.cudnn.deterministic = mode == "cudnn_deterministic"
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            spread[mode] = max_rel(gen_grads(w, audio, start), gen_grads(w, audio, start))
        torch.backends.cudnn.deterministic = False
        rec["gen_grad_run_to_run"] = spread
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        grads = gen_grads(w, audio, start)
    torch.use_deterministic_algorithms(False)
    rec["no_deterministic_impl"] = sorted({str(c.message).split(" does not have")[0][:120]
                                           for c in caught if "deterministic" in str(c.message)})
    return rec, {n: g.cpu() for n, g in grads.items()}


def run(root: str, label: str, out_dir: str, plain: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import stable_audio_tools_tpu_torch as pkg
    from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    rec = dict(label=label, plain=plain, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    saved = {}
    if plain:
        plain_f32(cs)
    else:
        k, saved["kernels"] = kernel_cases(cs, dev)
        rec.update(k)
    w, audio = trainer(root, dev)
    grad_names_overlap(w)
    step, saved["grads"] = step_runs(w, audio, timed=not plain)
    rec.update(step)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, f"{label}.pt"))
    return rec


def compare(path_a: str, path_b: str, path_ref=None) -> dict:
    a, b = torch.load(path_a), torch.load(path_b)
    rec, ok = {"kernels": {}}, True
    for case, outs in a.get("kernels", {}).items():
        errs = {}
        for n, want in outs.items():
            got = b["kernels"][case][n].float()
            peak = want.float().abs().max().item()
            tol = DX_ULPS * 2.0 ** -7 * max(1.0, peak) if n == "dx" else GRAD_TOL * peak
            err = (got - want.float()).abs().max().item()
            errs[n] = [err, tol]
            ok &= err <= tol
        rec["kernels"][case] = errs
    ga, gb = a["grads"], b["grads"]
    per = {n: ((gb[n] - ga[n]).norm() / ga[n].norm().clamp_min(1e-30)).item() for n in ga}
    worst = max(per, key=per.get)
    rec["grads"] = dict(identical=all(torch.equal(ga[n], gb[n]) for n in ga),
                        worst=[worst, per[worst]], median=statistics.median(per.values()))
    if path_ref:
        ref = torch.load(path_ref)["grads"]
        for side, g in (("a", ga), ("b", gb)):
            d = {n: ((g[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item() for n in ref}
            w = max(d, key=d.get)
            rec[f"{side}_vs_ref"] = dict(worst=[w, d[w]], median=statistics.median(d.values()))
    rec["kernels_within_tol"] = ok
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root")
    p.add_argument("--label")
    p.add_argument("--out")
    p.add_argument("--plain", action="store_true",
                   help="the snake convs by their plain versions in f32; gradients only")
    p.add_argument("--compare", nargs="+")
    args = p.parse_args()
    if args.compare:
        rec = compare(*args.compare)
        print(json.dumps(dict(compare=args.compare, **rec)))
        return 0 if rec["kernels_within_tol"] else 1
    if not torch.cuda.is_available():
        print("ab_snake_conv_bwd_torch: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.root, args.label, args.out, args.plain)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
