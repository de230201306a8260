"""Build the port's snake-conv forward kernels on a CUDA card, check them and
time them at SA-2.0's decode levels: the quick loop for work on
`csrc/snake_conv1d.cu`.

    python scripts/snake_conv_probe.py

Prints ptxas's registers and spills of every instantiation, the local-memory
instructions in each warp role's part of the SASS (`cuobjdump`: before the
`setmaxnreg` split, the consumers', the producers'; sinf's slow path alone
accounts for some in the producers'), then holds each kernel against its
plain version (2 bf16 ulps at the reference's peak) on the edge cases below
and row 12 against row 3 with a zero residual (equal bit for bit), and times
row 12, row 3 and `F.conv1d` alone on the pre-snaked input at the fifteen
k = 7 decode levels, and row 3's k = 1 conv + residual at the five, beside
their bounds (989 TFLOP/s bf16, 3.35 TB/s). Exit 1 if a case disagrees.
"""

import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from stable_audio_tools_tpu_torch.ops.kernels import _build, conv1d_snake as cs  # noqa: E402

LEVELS = ((1024, 1024), (512, 8192), (256, 32768), (128, 131072), (128, 262144))
# (B, Ci, Co, L, k, d, residual, bias, pad_lo, pad_hi): k 1 / 3 / 7, Co = 2, 8,
# 70, 200, 1024, Ci = 33, 40, 2048, ragged L, one-sided padding, long strips
CASES = [(1, 64, 64, 256, 1, 1, False, True, 0, 0), (1, 64, 128, 256, 1, 1, True, True, 0, 0),
         (1, 128, 128, 1000, 7, 3, False, True, 9, 9), (2, 40, 70, 129, 7, 5, False, True, 15, 15),
         (2, 64, 2, 300, 7, 1, False, False, 3, 3), (2, 2048, 128, 32, 3, 1, False, True, 1, 1),
         (1, 256, 256, 5000, 7, 9, False, True, 27, 27),
         (1, 1024, 1024, 300, 7, 9, False, True, 27, 27),
         (2, 96, 64, 500, 7, 2, False, True, 12, 0),
         (1, 128, 128, 128 * 300 + 17, 7, 3, False, True, 9, 9),
         (8, 128, 128, 262144, 7, 9, False, True, 27, 27),
         (8, 128, 128, 262144, 1, 1, True, True, 0, 0),
         (1, 200, 200, 777, 7, 1, True, True, 3, 3), (1, 33, 8, 1000, 3, 9, False, True, 9, 9)]


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


def local_memory_by_role(so_path):
    sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
                           str(so_path)], capture_output=True, text=True).stdout
    out = {}
    for f in re.split(r"\n\s+Function : ", sass)[1:]:
        role, counts = "pre", {}
        for line in f.split("\n"):
            if "USETMAXREG.TRY_ALLOC" in line:
                role = "consumers"
            elif "USETMAXREG.DEALLOC" in line:
                role = "producers"
            if re.search(r"\b(STL|LDL)", line):
                counts[role] = counts.get(role, 0) + 1
        out[_build._kernel_name(f.split("\n")[0].strip())] = counts
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("snake_conv_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.library("snake_conv1d")
    print("ptxas", _build.ptxas_report("snake_conv1d"))
    print("local-memory instructions by role", local_memory_by_role(
        _build._LIB_PATHS["snake_conv1d"]))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    ok = True
    for B, Ci, Co, L, k, d, res, bias, pl, ph in CASES:
        x = randn(B, Ci, L, scale=2.0)
        w = randn(Co, Ci, k, scale=(Ci * k) ** -0.5)
        bt = randn(Co, dtype=torch.float32) * 0.1 if bias else None
        a, b = randn(Ci, dtype=torch.float32).exp(), randn(Ci, dtype=torch.float32).exp()
        Lout = L + pl + ph - (k - 1) * d
        r = randn(B, Co, Lout) if res else None
        if res:
            got = cs.snake_conv1d_res(x, w, bt, a, b, r, pl, ph, d)
        else:
            got = cs.snake_conv1d(x, w, bt, a, b, pl, ph, d)
        ref = cs.snake_conv1d_plain(x, w, bt, a, b, pl, ph, d, r)
        tol = 2 * 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
        err = (got.float() - ref.float()).abs().max().item()
        same = None
        if not res:
            same = torch.equal(got, cs.snake_conv1d_res(x, w, bt, a, b, torch.zeros_like(got),
                                                        pl, ph, d))
        good = err <= tol and same is not False
        ok &= good
        print(f"[{B},{Ci},{L}] -> {Co} k={k} d={d} res={res}: err {err:.4g} tol {tol:.4g} "
              f"row 12 == row 3 {same} {'OK' if good else 'FAIL'}", flush=True)
    for C, L in LEVELS:
        x = randn(8, C, L)
        bt = randn(C, dtype=torch.float32) * 0.1
        a, b = randn(C, dtype=torch.float32).exp(), randn(C, dtype=torch.float32).exp()
        sx = cs._snake_f32(x, a, b).to(x.dtype)
        for d in (1, 3, 9):
            w = randn(C, C, 7, scale=(C * 7) ** -0.5)
            row12 = cuda_ms(lambda: cs.snake_conv1d(x, w, bt, a, b, 3 * d, 3 * d, d))
            row3 = cuda_ms(lambda: cs.snake_conv1d_res(x, w, bt, a, b, x, 3 * d, 3 * d, d))
            conv = cuda_ms(lambda: torch.nn.functional.conv1d(sx, w, bt.to(x.dtype),
                                                              padding=3 * d, dilation=d))
            print(f"[8,{C},{L}] k=7 d={d}: row 12 {row12:.3f} row 3 {row3:.3f} F.conv1d alone "
                  f"{conv:.3f} bound {2.0 * 8 * C * C * 7 * L / 989e12 * 1e3:.3f} ms; plan "
                  f"{cs.carry_strip_tiles(8, C, C, L, 7, d)}", flush=True)
        w1 = randn(C, C, 1, scale=C ** -0.5)
        t = cuda_ms(lambda: cs.snake_conv1d_res(x, w1, bt, a, b, x, 0, 0, 1))
        print(f"[8,{C},{L}] k=1 + residual: row 3 {t:.3f} byte bound "
              f"{3 * x.numel() * 2 / 3.35e12 * 1e3:.3f} ms", flush=True)
    print("ALL OK" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
