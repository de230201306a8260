"""Build the port's snake-conv backward kernels on a CUDA card, check them and
time them at the SA-2.0 VAE's shapes: the quick loop for work on
`csrc/conv1d_wgrad.cu` (row 11) and `csrc/snake_conv1d_dx.cu` (row 10).

    python scripts/snake_conv_bwd_probe.py desc     # the MN-major descriptor
    python scripts/snake_conv_bwd_probe.py sincos   # the fast sines vs sincosf
    python scripts/snake_conv_bwd_probe.py check    # kernels vs plain versions
    python scripts/snake_conv_bwd_probe.py time     # the 22 VAE cases
    python scripts/snake_conv_bwd_probe.py variants # row 11's chunk T
    python scripts/snake_conv_bwd_probe.py narrow   # where the 2-channel convs' time goes
    python scripts/snake_conv_bwd_probe.py sass DIR # the forward's SASS vs DIR's

`desc` compiles a one-warpgroup kernel that multiplies a 64 x 16 tile by a 16
x 64 slice of a time-major window without swizzle (8-channel columns of
16-byte rows, as the producers of `csrc/snake_conv.cuh` lay it) read MN-major
by `wgmma` from a start at any row, and holds the product against numpy for
starts 0..57 and both readings of the descriptor's two offsets: row 11 reads
its windows so. `sincos` holds `sincos_fast` (row 10's epilogue) and
`sincos_lean` (row 9) against CUDA's `sincosf` and `sin_fast` (the snake)
against `sinf`, bit for bit, over every float with |v| < 105615. `check`
prints ptxas's registers and spills of the three snake-conv sources and holds
rows 10, 11 (with and without the snake) and the forward rows 12 and 3 against
their plain versions at edge cases (Ci or Co 2, 8, 64, 128, 256, 2048; k 1 / 3
/ 4 / 7 / 9; ragged L; one-sided padding; splits of one chunk and many): dx
within 2 bf16 ulps of the reference's peak, dW, db, dalpha, dbeta within 1e-2
of their peaks; row 12 equal to row 3 with a zero residual bit for bit. `time`
times rows 10 and 11 at the 22 snake-conv cases of one VAE generator step and
row 11 plain at its two, beside their bounds and `torch.nn.grad.conv1d_weight`
/ `conv1d_input` on the pre-snaked input. `sass DIR` counts the SASS
instructions by opcode in each warp role of `snake_conv1d_carry_kernel<128,0>`
(row 12 at 128 channels) built from this checkout and from the checkout at DIR
(another commit unpacked there), the producers' arithmetic beside their
bookkeeping, and holds every kernel of the three snake-conv sources (rows 12,
3, 10, 11) against DIR's instruction for instruction. `narrow` times rows 10
and 11 at the VAE's 2-channel convs (the encoder's conv_in [4,2,65536] -> 128
k = 7, row 11 without the snake; the decoder's conv_out [4,128,65536] -> 2 k =
7, rows 10 and 11), beside the k = 1 conv at 128 channels that reads the same
x, built as they are and from copies of the sources with the products switched
off (every `wgmma` dropped) and with row 10's epilogue sines switched off:
whether the products padded to 64 channels, the snake or the epilogue take the
time. Exit 1 if a check fails.
"""

import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from stable_audio_tools_tpu_torch.ops.kernels import _build, conv1d_snake as cs  # noqa: E402

PROBE = r"""
#include "snake_conv.cuh"

// D[64 x 64] = A[64 x 16] B[16 x 64]: A K-major without swizzle ([2][64][8]:
// k-half, row, column), B rows r0..r0+15 of a window [8 columns][rows][8]
extern "C" __global__ void probe_kernel(const __nv_bfloat16* A, const __nv_bfloat16* W, int rows,
                                        int r0, int lbo, int sbo, float* D) {
  __shared__ __align__(1024) unsigned char sm[2048 + 8 * 80 * 16];
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  for (int i = tid; i < 64 * 16; i += 128) {
    const int m = i / 16, k = i % 16;
    reinterpret_cast<__nv_bfloat16*>(sm)[(k / 8) * 512 + m * 8 + k % 8] = A[m * 16 + k];
  }
  const int chs = rows * 16;
  for (int i = tid; i < rows * 64; i += 128) {
    const int t = i / 64, n = i % 64;
    reinterpret_cast<__nv_bfloat16*>(sm + 2048)[(n / 8) * (chs / 2) + t * 8 + n % 8] = W[i];
  }
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float acc[32];
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const uint32_t a = smem_u32(sm), b = smem_u32(sm + 2048);
  wg_fence();
  wgmma_k<64, 1>(acc, desc_plain(a, 1024, 128), desc_plain(b + r0 * 16, lbo, sbo));
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);
  for (int r = 0; r < 32; ++r) {
    const int m = 16 * w + lane / 4 + 8 * ((r >> 1) & 1), n = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
    D[m * 64 + n] = acc[r];
  }
}

// mismatches of sincos_fast and sincos_lean against sincosf and sin_fast
// against sinf, bit for bit, over every float v with |v| < 105615 (each bit
// pattern once)
extern "C" __global__ void sincos_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float v = __uint_as_float((uint32_t)i);
    if (!(fabsf(v) < 105615.f)) continue;
    float s, c, s2, c2, s3, c3;
    sincos_fast(v, &s, &c);
    sincosf(v, &s2, &c2);
    sincos_lean(v, &s3, &c3);
    n += (__float_as_uint(s) != __float_as_uint(s2)) + (__float_as_uint(c) != __float_as_uint(c2)) +
         (__float_as_uint(sin_fast(v)) != __float_as_uint(sinf(v))) +
         (__float_as_uint(s3) != __float_as_uint(s2)) + (__float_as_uint(c3) != __float_as_uint(c2));
  }
  if (n) atomicAdd(bad, n);
}

extern "C" int sincos_check(void* bad) {
  sincos_kernel<<<132 * 16, 256>>>((unsigned long long*)bad);
  return (int)cudaDeviceSynchronize();
}

extern "C" int probe(const void* A, const void* W, int rows, int r0, int lbo, int sbo, void* D) {
  probe_kernel<<<1, 128>>>((const __nv_bfloat16*)A, (const __nv_bfloat16*)W, rows, r0, lbo, sbo,
                           (float*)D);
  return (int)cudaDeviceSynchronize();
}
"""

# (B, Ci, Co, L, k, d, pad_lo, pad_hi)
CASES = [(2, 128, 128, 1000, 7, 9, 27, 27), (2, 36, 70, 129, 7, 5, 15, 15),
         (2, 128, 2, 300, 7, 1, 3, 3), (2, 2, 128, 3000, 7, 1, 3, 3), (2, 96, 96, 65, 1, 1, 0, 0),
         (2, 200, 64, 32, 3, 1, 1, 1), (2, 64, 48, 77, 4, 2, 2, 2), (2, 64, 200, 32, 7, 1, 3, 3),
         (4, 2048, 128, 32, 3, 1, 1, 1), (2, 256, 256, 1000, 1, 1, 0, 0),
         (2, 512, 512, 300, 1, 1, 0, 0), (1, 8, 8, 517, 7, 3, 9, 9), (2, 64, 2048, 32, 7, 1, 3, 3),
         (1, 128, 128, 5000, 9, 2, 8, 8), (3, 128, 128, 64 * 128 + 3, 7, 3, 18, 0),
         (2, 1024, 1024, 256, 7, 9, 27, 27), (1, 256, 256, 2048, 2, 3, 3, 0)]
# the SA-2.0 VAE's snake convs at batch 4 (C, Co, L, k, d) and row 11 plain's two
AE_LEVELS = ((128, 65536), (128, 32768), (256, 8192), (512, 2048), (1024, 256))
AE_CASES = [(C, C, L, k, d) for C, L in AE_LEVELS for k, d in ((7, 1), (7, 3), (7, 9), (1, 1))]
AE_CASES += [(2048, 128, 32, 3, 1), (128, 2, 65536, 7, 1)]
PLAIN_CASES = [(2, 128, 65536), (64, 2048, 32)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_library():
    import ctypes

    out = _build.BUILD_DIR / "wgmma_mn_probe.so"
    src = _build.BUILD_DIR / "wgmma_mn_probe.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def sincos() -> bool:
    import ctypes

    fn = probe_library().sincos_check
    fn.argtypes = [ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    code = fn(bad.data_ptr())
    n = int(bad.item())
    print(f"sincos_fast and sincos_lean vs sincosf, sin_fast vs sinf over every |v| < 105615: "
          f"CUDA {code}, "
          f"{n} mismatches", flush=True)
    return code == 0 and n == 0


def desc() -> bool:
    import ctypes

    fn = probe_library().probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    rng = np.random.default_rng(0)
    rows = 80
    A = rng.standard_normal((64, 16)).astype(np.float32)
    W = rng.standard_normal((rows, 64)).astype(np.float32)
    At = torch.from_numpy(A).bfloat16().cuda()
    Wt = torch.from_numpy(W).bfloat16().cuda()
    A, W = At.float().cpu().numpy(), Wt.float().cpu().numpy()
    ok = {}
    for name, (lbo, sbo) in (("lbo 128, sbo chs", (128, rows * 16)),
                             ("lbo chs, sbo 128", (rows * 16, 128))):
        good = True
        for r0 in range(0, rows - 16 + 1):
            D = torch.zeros(64, 64, device="cuda")
            code = fn(At.data_ptr(), Wt.data_ptr(), rows, r0, lbo, sbo, D.data_ptr())
            if code:
                print(f"{name}: CUDA error {code} at r0 {r0}")
                good = False
                break
            err = np.abs(D.cpu().numpy() - A @ W[r0:r0 + 16]).max()
            good &= bool(err < 1e-3)
        ok[name] = good
        print(f"MN-major window descriptor, {name}: {'matches' if good else 'WRONG'} "
              f"(starts 0..{rows - 16})", flush=True)
    return ok["lbo 128, sbo chs"]


def randn(g, dev, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def rel(p, q):
    return ((p.float() - q.float()).abs().max() / q.float().abs().max().clamp_min(1e-30)).item()


def check() -> bool:
    from snake_conv_probe import local_memory_by_role

    for name in ("snake_conv1d", "snake_conv1d_dx", "conv1d_wgrad"):
        print("ptxas", name, _build.ptxas_report(name), flush=True)
        print("local-memory instructions by role", name,
              local_memory_by_role(_build._LIB_PATHS[name]), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for B, Ci, Co, L, k, d, pl, ph in CASES:
        x = randn(g, dev, B, Ci, L, scale=2.0)
        w = randn(g, dev, Co, Ci, k, scale=(Ci * k) ** -0.5)
        a = randn(g, dev, Ci, dtype=torch.float32).exp()
        b = randn(g, dev, Ci, dtype=torch.float32).exp()
        Lout = L + pl + ph - (k - 1) * d
        dy = randn(g, dev, B, Co, Lout)
        name = f"[{B},{Ci},{L}] -> {Co} k={k} d={d} pad {pl}/{ph}"
        errs = {}
        try:
            got = cs.snake_conv1d_dx(dy, x, w, a, b, pl, ph, d)
            want = cs.snake_conv1d_dx_plain(dy, x, w, a, b, pl, ph, d)
            tol = 2 * 2.0 ** -7 * max(1.0, want[0].float().abs().max().item())
            errs["dx"] = ((got[0].float() - want[0].float()).abs().max().item(), tol)
            errs["dalpha"] = (rel(got[1], want[1]), 1e-2)
            errs["dbeta"] = (rel(got[2], want[2]), 1e-2)
            for snake in (True, False):
                if snake:
                    got = cs.snake_conv1d_wgrad(dy, x, k, a, b, pl, ph, d)
                else:
                    got = cs.conv1d_wgrad(dy, x, k, pl, ph, d)
                want = cs.conv1d_wgrad_plain(dy, x, k, pl, ph, d, (a, b) if snake else None)
                tag = "snake " if snake else "plain "
                errs[tag + "dW"] = (rel(got[0], want[0]), 1e-2)
                errs[tag + "db"] = (rel(got[1], want[1]), 1e-2)
            bias = randn(g, dev, Co, dtype=torch.float32) * 0.1
            y = cs.snake_conv1d(x, w, bias, a, b, pl, ph, d)
            ref = cs.snake_conv1d_plain(x, w, bias, a, b, pl, ph, d)
            tol = 2 * 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
            errs["row 12"] = ((y.float() - ref.float()).abs().max().item(), tol)
            same = torch.equal(y, cs.snake_conv1d_res(x, w, bias, a, b, torch.zeros_like(y),
                                                      pl, ph, d))
            errs["row 12 == row 3"] = (0.0 if same else 1.0, 0.5)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"{name}: {e}", flush=True)
            return False
        good = all(e <= t and np.isfinite(e) for e, t in errs.values())
        ok &= good
        plan = wgrad_plan(B, Ci, Co, Lout, k)
        print(f"{name}: {'OK' if good else 'FAIL'} "
              + " ".join(f"{n} {e:.3g}/{t:.3g}" for n, (e, t) in errs.items())
              + f" plan {plan}", flush=True)
    return ok


def wgrad_plan(B, Ci, Co, Lout, k):
    """Row 11's tile (mt, split taps, T) and splits S as the wrapper plans them."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return cs.wgrad_tile(Co, k) + (cs.wgrad_splits(B, Ci, Co, Lout, k, sms),)


def bound_ms(flops, *tensors):
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return max(flops / 989e12, nbytes / 3.35e12) * 1e3


def time_cases() -> None:
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    B = 4
    for C, Co, L, k, d in AE_CASES:
        pad = d * (k - 1) // 2
        x = randn(g, dev, B, C, L, scale=2.0)
        w = randn(g, dev, Co, C, k, scale=(C * k) ** -0.5)
        a = randn(g, dev, C, dtype=torch.float32).exp()
        b = randn(g, dev, C, dtype=torch.float32).exp()
        dy = randn(g, dev, B, Co, L)
        flops = 2.0 * B * L * C * Co * k
        dx_ms = cuda_ms(lambda: cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d))
        dw_ms = cuda_ms(lambda: cs.snake_conv1d_wgrad(dy, x, k, a, b, pad, pad, d))
        sx = cs._snake_f32(x, a, b).to(x.dtype)
        lib_w = cuda_ms(lambda: torch.nn.grad.conv1d_weight(sx, w.shape, dy, padding=pad,
                                                            dilation=d))
        lib_x = cuda_ms(lambda: torch.nn.grad.conv1d_input(x.shape, w, dy, padding=pad,
                                                           dilation=d))
        dW = torch.empty(Co, C, k, device=dev)
        plain = cuda_ms(lambda: cs.conv1d_wgrad(dy, x, k, pad, pad, d))
        print(f"[{B},{C},{L}] -> {Co} k={k} d={d}: row 11 without the snake {plain:.4f}")
        print(f"[{B},{C},{L}] -> {Co} k={k} d={d}: dx {dx_ms:.4f} (bound "
              f"{bound_ms(flops, dy, x, w, a, b, x):.4f}, conv1d_input {lib_x:.4f}) wgrad "
              f"{dw_ms:.4f} (bound {bound_ms(flops, dy, x, a, b, dW):.4f}, conv1d_weight "
              f"{lib_w:.4f}) plan {wgrad_plan(B, C, Co, L, k)}", flush=True)
        del x, w, dy, sx
    for C, Co, L in PLAIN_CASES:
        x, dy = randn(g, dev, B, C, L), randn(g, dev, B, Co, L)
        ms = cuda_ms(lambda: cs.conv1d_wgrad(dy, x, 7, 3, 3, 1), 10)
        lib = cuda_ms(lambda: torch.nn.grad.conv1d_weight(x, (Co, C, 7), dy, padding=3), 10)
        print(f"plain [{B},{C},{L}] -> {Co} k=7: {ms:.4f} conv1d_weight {lib:.4f} bound "
              f"{bound_ms(2.0 * B * L * C * Co * 7, dy, x, torch.empty(Co, C, 7)):.4f}",
              flush=True)


def variants() -> None:
    """Row 11 at the VAE's cases with 128- and 256-sample chunks (T of
    `wgrad_tile`; a refusal where the stages and windows do not fit)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    B = 4
    wtile = cs.wgrad_tile
    for C, Co, L, k, d in AE_CASES:
        pad = d * (k - 1) // 2
        x = randn(g, dev, B, C, L, scale=2.0)
        a = randn(g, dev, C, dtype=torch.float32).exp()
        b = randn(g, dev, C, dtype=torch.float32).exp()
        dy = randn(g, dev, B, Co, L)
        out = []
        for T in (128, 256):
            cs.wgrad_tile = lambda co, kk, T=T: wtile(co, kk)[:2] + (T,)
            try:
                ms = cuda_ms(lambda: cs.snake_conv1d_wgrad(dy, x, k, a, b, pad, pad, d))
                out.append(f"T{T} {ms:.4f}")
            except RuntimeError as e:
                out.append(f"T{T} refused ({e})")
        cs.wgrad_tile = wtile
        print(f"row 11 [{B},{C},{L}] -> {Co} k={k} d={d}: " + ", ".join(out), flush=True)
        del x, dy


# source edits of the `narrow` variants: (file, text, replacement)
NARROW_VARIANTS = {
    "products off": [("conv1d_wgrad.cu", "wgmma_k<64, 1>(acc[m][j], da,",
                      "if (false) wgmma_k<64, 1>(acc[m][j], da,"),
                     ("snake_conv.cuh", "wgmma_k<NT>(acc[m], desc_plain(a0",
                      "if (false) wgmma_k<NT>(acc[m], desc_plain(a0")],
    "row 10 epilogue sines off": [("snake_conv1d_dx.cu", "sincos_fast(t[e], &sn[e], &cs[e]);",
                                   "sn[e] = t[e], cs[e] = 1.f;")],
}


def use_sources(csrc) -> None:
    """Build and bind rows 10 and 11 from the sources under `csrc` from now on."""
    from concurrent.futures import ThreadPoolExecutor

    _build.CSRC = csrc
    for cache in (_build._LIBS, _build._LIB_PATHS, _build._FNS):
        cache.clear()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.library, ("conv1d_wgrad", "snake_conv1d_dx")))


def narrow() -> None:
    import pathlib
    import shutil

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    B, L = 4, 65536
    x128, x2 = randn(g, dev, B, 128, L, scale=2.0), randn(g, dev, B, 2, L, scale=2.0)
    a = randn(g, dev, 128, dtype=torch.float32).exp()
    b = randn(g, dev, 128, dtype=torch.float32).exp()
    w_out, w_k1 = randn(g, dev, 2, 128, 7, scale=0.03), randn(g, dev, 128, 128, 1, scale=0.09)
    dy2, dy128 = randn(g, dev, B, 2, L), randn(g, dev, B, 128, L)
    runs = {
        "row 11 [4,128,65536] -> 2 k=7 (conv_out)":
            lambda: cs.snake_conv1d_wgrad(dy2, x128, 7, a, b, 3, 3, 1),
        "row 11 without the snake, the same shape": lambda: cs.conv1d_wgrad(dy2, x128, 7, 3, 3, 1),
        "row 11 [4,128,65536] -> 128 k=1": lambda: cs.snake_conv1d_wgrad(dy128, x128, 1, a, b,
                                                                         0, 0, 1),
        "row 11 plain [4,2,65536] -> 128 k=7 (conv_in)":
            lambda: cs.conv1d_wgrad(dy128, x2, 7, 3, 3, 1),
        "row 10 [4,128,65536] -> 2 k=7 (conv_out)":
            lambda: cs.snake_conv1d_dx(dy2, x128, w_out, a, b, 3, 3, 1),
        "row 10 [4,128,65536] -> 128 k=1": lambda: cs.snake_conv1d_dx(dy128, x128, w_k1, a, b,
                                                                      0, 0, 1),
    }
    base = _build.CSRC
    for name, edits in [("as built", [])] + list(NARROW_VARIANTS.items()):
        src = base
        if edits:
            src = _build.BUILD_DIR / ("csrc_" + name.replace(" ", "_"))
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(base, src)
            for f, old, new in edits:
                text = (src / f).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} is not once in {f}")
                (src / f).write_text(text.replace(old, new))
        use_sources(pathlib.Path(src))
        print(f"{name}: " + "; ".join(f"{n} {cuda_ms(fn, 10):.4f}" for n, fn in runs.items()),
              flush=True)
    use_sources(base)


SNAKE_CONV_SOURCES = ("snake_conv1d", "snake_conv1d_dx", "conv1d_wgrad")


def sass_functions(root: str) -> dict:
    """Each kernel of the snake-conv sources built from `root` (its name as
    `_build._kernel_name` gives it) -> its SASS listing by `cuobjdump`."""
    import importlib

    sys.path.insert(0, os.path.abspath(root))
    for m in [m for m in sys.modules if m.startswith("stable_audio_tools_tpu_torch")]:
        del sys.modules[m]
    build = importlib.import_module("stable_audio_tools_tpu_torch.ops.kernels._build")
    out = {}
    for name in SNAKE_CONV_SOURCES:
        build.library(name)
        text = subprocess.run([os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"),
                               "-sass", str(build._LIB_PATHS[name])],
                              capture_output=True, text=True).stdout
        for f in re.split(r"\n\s+Function : ", text)[1:]:
            lines = f.split("\n")
            out[f"{name}: {build._kernel_name(lines[0].strip())}"] = lines
    sys.path.pop(0)
    return out


def sass_roles(functions: dict) -> dict:
    """Opcode counts by warp role (before `setmaxnreg`, the consumers', the
    producers') of row 12's 128-channel kernel."""
    import collections

    role, hist = "pre", collections.defaultdict(collections.Counter)
    for line in functions["snake_conv1d: snake_conv1d_carry_kernel<128,0>"]:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if not m:
            continue
        if "USETMAXREG.TRY_ALLOC" in line:
            role = "consumers"
        elif "USETMAXREG.DEALLOC" in line:
            role = "producers"
        hist[role][m.group(2).split(".")[0]] += 1
    return hist


def sass_instructions(functions: dict) -> dict:
    """Each kernel's SASS instructions in order, addresses and encodings left
    out."""
    return {k: [m.group(1).strip() for m in
                (re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line) for line in lines) if m]
            for k, lines in functions.items()}


def sass(other: str) -> None:
    here, there = sass_functions(ROOT), sass_functions(other)
    mine, theirs = sass_roles(here), sass_roles(there)
    for role in ("pre", "consumers", "producers"):
        a, b = theirs[role], mine[role]
        diff = {op: b[op] - a[op] for op in sorted(set(a) | set(b)) if b[op] != a[op]}
        print(f"{role}: {sum(a.values())} instructions in {other}, {sum(b.values())} here; "
              f"by opcode (here - there) {diff}", flush=True)
    mine, theirs = sass_instructions(here), sass_instructions(there)
    differ = sorted(k for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k))
    print(f"every kernel of {', '.join(SNAKE_CONV_SOURCES)}: {len(mine)} here, {len(theirs)} in "
          f"{other}, {sum(map(len, mine.values()))} / {sum(map(len, theirs.values()))} "
          f"instructions; instruction for instruction the same: {not differ}"
          + (f"; differ: {differ}" if differ else ""), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("snake_conv_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(card(), flush=True)
    what = sys.argv[1] if len(sys.argv) > 1 else "check"
    if what == "desc":
        return 0 if desc() else 1
    if what == "sincos":
        return 0 if sincos() else 1
    print("nvcc seconds", _build.build_all(), flush=True)
    if what == "check":
        ok = check()
        print("ALL OK" if ok else "SOME FAILED")
        return 0 if ok else 1
    if what == "variants":
        variants()
        return 0
    if what == "narrow":
        narrow()
        return 0
    if what == "sass":
        sass(sys.argv[2])
        return 0
    time_cases()
    return 0


if __name__ == "__main__":
    sys.exit(main())
