"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object,
all sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library lands
in ``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed by
a hash of the sources and flags, so a fresh checkout builds at first use and
an edited source rebuilds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]
LIB_NAME = "librepro_torch_kernels.so"
PTXAS_LOG = "ptxas.txt"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types; each returns a cudaError_t
# (repro_ssd_bwd_partials a count).
SIGNATURES = {
    "repro_flash_attention": [
        _P, _P, _P, _P,                 # q, k, v, o
        _I, _I,                         # dtype code, head dim
        _I, _I, _I, _I,                 # B, H, KV, S
        _L, _L, _L,                     # q strides (b, h, s), elements
        _L, _L, _L,                     # k strides
        _L, _L, _L,                     # v strides
        _L, _L, _L,                     # o strides
        _I, _I,                         # causal, window
        _P,                             # stream
    ],
    "repro_rmsnorm": [
        _P, _L,                         # x, its row stride (elements)
        _P, _P,                         # scale, y
        _I,                             # dtype code
        _L, _I, _F,                     # rows, d, eps
        _I, _I, _I, _I,                 # plan: VPT, tpr, slots; blocks
        _P,                             # stream
    ],
    "repro_rmsnorm_bwd": [
        _P, _L,                         # x, its row stride (elements)
        _P,                             # scale
        _P, _L,                         # dy, its row stride
        _P,                             # dx
        _P, _P,                         # partial scratch, dscale
        _I,                             # dtype code
        _L, _I, _F,                     # rows, d, eps
        _I, _I, _I,                     # plan: VPT, tpr, slots
        _I,                             # blocks (rows of the scratch)
        _P,                             # stream
    ],
    "repro_rmsnorm_rowsum": [
        _P, _L,                         # x, its row stride (elements)
        _P, _L,                         # dy (or null), its row stride
        _P, _P,                         # scale, out: fp32 row sums
        _I,                             # dtype code
        _L, _I,                         # rows, d
        _I,                             # blocks
        _P,                             # stream
    ],
    "repro_rmsnorm_apply": [
        _P, _L,                         # x, its row stride (elements)
        _P, _P, _P,                     # scale, ss (reduced row sums), y
        _I,                             # dtype code
        _L, _I, _I, _F,                 # rows, d, the whole row's width, eps
        _I,                             # row blocks
        _P,                             # stream
    ],
    "repro_rmsnorm_apply_bwd": [
        _P, _L,                         # x, its row stride (elements)
        _P,                             # scale
        _P, _L,                         # dy, its row stride
        _P, _P,                         # ss, dot (reduced row sums)
        _P,                             # dx
        _P, _P,                         # partial scratch, dscale
        _I,                             # dtype code
        _L, _I, _I, _F,                 # rows, d, the whole row's width, eps
        _I,                             # row blocks (rows of the scratch)
        _P,                             # stream
    ],
    "repro_rmsnorm_blocks_per_sm": [
        _I, _I,                         # backward?, dtype code
        _I, _I, _I, _I,                 # plan: VPT, tpr, slots; d
        ctypes.POINTER(_I),             # out: blocks that fit on an SM
    ],
    "repro_ssd_scan": [
        _P, _P, _P, _P, _P,             # x, a, b, c, init state (or null)
        _P, _P,                         # y, final state
        _I,                             # dtype code
        _I, _I, _I, _I,                 # B, H, G, L
        _L, _L, _L,                     # x strides (b, h, l), elements
        _L, _L, _L,                     # a strides
        _L, _L, _L,                     # b strides (b, g, l)
        _L, _L, _L,                     # c strides
        _L, _L, _L,                     # y strides
        _P,                             # stream
    ],
    "repro_ssd_scan_bwd": [
        _P, _P, _P, _P, _P,             # x, a, b, c, dy
        _P, _P,                         # init state, dstate (or null)
        _P, _P, _P, _P, _P,             # dx, da, db, dc, d_init (or null)
        _P, _P, _P,                     # scratch: states, db / dc partials
        _I,                             # dtype code
        _I, _I, _I, _I,                 # B, H, G, L
        _I,                             # b/c groups as read
        _L, _L, _L,                     # x strides (b, h, l), elements
        _L, _L, _L,                     # a strides
        _L, _L, _L,                     # b strides (b, g, l)
        _L, _L, _L,                     # c strides
        _L, _L, _L,                     # dy strides
        _L, _L, _L,                     # dx strides
        _L, _L, _L,                     # db strides (b, g, l)
        _L, _L, _L,                     # dc strides
        _P,                             # stream
    ],
    "repro_ssd_bwd_partials": [_I, _I, _I],     # dtype code, H, G
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(ptxas_verbose: bool = False) -> Path:
    """Compile (if not cached) and return the shared library's path.

    ``ptxas_verbose`` rebuilds and prints each kernel's registers, shared
    memory and spills as ``ptxas`` reports them; the report is also kept
    beside the library as ``ptxas.txt``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists() and not ptxas_verbose:
        return lib
    # objects and the unlinked library are private to this process, so
    # concurrent first uses never see each other's half-written files
    work = out_dir / f".build-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    procs = []
    for src in sources():
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed, report = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        elif ptxas_verbose:
            print(out, end="")
            report.append(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = work / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    if ptxas_verbose:
        (out_dir / PTXAS_LOG).write_text("".join(report))
    shutil.rmtree(work, ignore_errors=True)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
