"""Build and bind the package's CUDA C++ kernels (`csrc/*.cu`).

Each source compiles on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into `build/torch_kernels/<name>-<source hash>.so` at the repository root and
is loaded with `ctypes`; `-Xptxas -v`'s report (registers, spills, shared
memory per kernel) is kept beside it and parsed by `ptxas_report`. The sources include no PyTorch header and export a
plain C interface, so a build takes seconds. A changed source gets a new
hash and is rebuilt; an unchanged one is loaded from the build directory.

Every exported entry point returns `cudaGetLastError()` after its launch;
`check()` raises on a nonzero code, so a launch the GPU refused (too many
threads, too much shared memory) is reported where it happened.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIB_PATHS: Dict[str, Path] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}
# seconds spent in nvcc by this process, per source (0.0 when loaded from disk)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from `csrc/<name>.cu`."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    deps = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for p in [src, *deps]:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    else:
        BUILD_SECONDS[name] = 0.0
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    _LIB_PATHS[name] = out
    return lib


def ptxas_report(name: str) -> Dict[str, dict]:
    """Per kernel of `csrc/<name>.cu` (built or loaded first), what ptxas
    reported: registers, spill stores / loads (bytes), stack frame and shared
    memory (static bytes). Kernel templates are named by their arguments,
    e.g. `flash_bwd_dkv_kernel<64,2,0>`."""
    library(name)
    text = _LIB_PATHS[name].with_suffix(".ptxas.txt").read_text()
    out, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            out.setdefault(kernel, {})
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[kernel].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[kernel]["static_smem"] = int(m.group(1)) if m else 0
    return out


def _kernel_name(mangled: str) -> str:
    """`flash_bwd_dkv_kernel<64,0>` from an Itanium-mangled kernel name (its
    last length-prefixed part; int and bool template arguments only); other
    names unchanged."""
    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    name = None
    while pos and pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        pos += len(digits)
        name, pos = mangled[pos:pos + int(digits)], pos + int(digits)
    if name is None:
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>" if args else name


def bind(name: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """`fn` from `csrc/<name>.cu` with its argument types declared (at the
    first call; an entry point keeps one signature); every entry point
    returns the launch's cudaError_t as an int."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FNS[(name, fn)] = f
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        import torch

        raise RuntimeError(f"{what}: CUDA error {code} at launch "
                           f"({torch.cuda.get_device_name()})")


def build_all() -> Dict[str, float]:
    """Build (or load) every source under csrc/, one nvcc per source and all
    started together; returns nvcc seconds per source."""
    from concurrent.futures import ThreadPoolExecutor

    names = [src.stem for src in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(library, names))
    return dict(BUILD_SECONDS)

