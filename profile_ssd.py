#!/usr/bin/env python3
"""Where the bf16 SSD kernel's time goes, phase by phase, on one GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 profile_ssd.py [--batch 8] [--heads 112]

It compiles a copy of ``src/repro_torch/kernels/csrc/ssd.cu`` with a
``clock64()`` stamp at each phase boundary of ``ssd_wgmma_kernel``'s chunk
loop (into the gitignored ``build/ssd_phases/``), runs it through the
port's wrapper at L = 910, one b/c group, with an initial state (zamba2's
prefill at the default sizes), and prints for each warpgroup of the first
block the SM cycles per chunk of each phase, then the kernel's time.  Run
it at the served shape and again with ``--batch 1 --heads 3`` (one block
alone on the card): equal cycles per chunk mean the block's own chain of
dependent steps, not contention for the SM, sets the time.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

import chip_smoke  # also puts the checkout's src/ on sys.path
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops, ssd

OUT = kbuild.BUILD_ROOT.parent / "ssd_phases"
LOOP = "  for (int k = 0; k < nchunks; ++k) {"
# (phase name, code the phase ends with, code to search from)
PHASES = [
    ("refill wait", "      issue(k + NS - 1);\n    }", LOOP),
    ("bar", "    bar_sync(1 + wg, 128);", LOOP),
    ("decay scan", "sts_f2(dec, __expf(fminf(tot, 0.f)), 0.f);\n    }", LOOP),
    ("S split", "        sts_u32(buf_lo + off, lo);\n      }", LOOP),
    ("fence", "    fence_proxy_async();", LOOP),
    ("chunk wait + bar", "    bar_sync(1 + wg, 128);",
     "    mbar_wait(bar_full + 8 * st, ph);"),
    ("G wgmma", "    wgmma_wait<0>();", "    // G = C B^T"),
    ("G_h split", "\n    }\n", "    // G_h = G o exp"),
    ("C S^T wgmma", "    wgmma_wait<0>();", "    // y = C S_hi^T"),
    ("scale", "\n    }\n", "      const float e0 ="),
    ("G_h x wgmma", "    wgmma_wait<0>();", "    // y += G_h x"),
    ("y store", "\n      }\n", "    uint16_t* yg"),
    ("x o w split", "      sts_v4(buf_lo + ch * 16, lo);\n    }", LOOP),
    ("fence", "    fence_proxy_async();", "sts_v4(buf_lo + ch * 16, lo);"),
    ("bar", "    bar_sync(1 + wg, 128);", "sts_v4(buf_lo + ch * 16, lo);"),
    ("state wgmma", "    if (lane == 0) mbar_arrive(bar_empty + 8 * st);",
     LOOP),
]
NP = len(PHASES)


def instrumented_source(src: str) -> str:
    """``src`` with MARK(i) after the code that ends phase i."""
    for i, (_, end, start) in enumerate(PHASES):
        pos = src.index(end, src.index(start)) + len(end)
        src = src[:pos] + f"\n    MARK({i});" + src[pos:]
    src = src.replace(LOOP, f"""\
  const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && tw == 0;
  unsigned long long ph_acc[{NP}] = {{}}, t_last = clock64();
#define MARK(i) if (prof) {{ const unsigned long long t_ = clock64(); \\
    ph_acc[i] += t_ - t_last; t_last = t_; }}
{LOOP}""", 1)
    src = src.replace("  float* sg =", f"""\
  if (prof)
    for (int i = 0; i < {NP}; ++i) g_phase[wg][i] = ph_acc[i];
  float* sg =""", 1)
    src = src.replace("namespace {\n", f"""\
namespace {{
__device__ unsigned long long g_phase[4][{NP}];
""", 1)
    return src + """
extern "C" int repro_ssd_phases(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));
}
"""


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "ssd_phases.cu"
    cu.write_text(instrumented_source((kbuild.CSRC / "ssd.cu").read_text()))
    lib = OUT / "libssd_phases.so"
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC),
                    "-shared", str(cu), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.repro_ssd_scan.argtypes = kbuild.SIGNATURES["repro_ssd_scan"]
    dll.repro_ssd_scan.restype = ctypes.c_int
    dll.repro_ssd_phases.argtypes = [ctypes.c_void_p]
    dll.repro_ssd_phases.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=112)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_ssd: CUDA is not available", file=sys.stderr)
        return 1
    dll = build()
    ssd.load_library = lambda: dll          # the wrapper launches this copy
    print(f"gpu: {chip_smoke.gpu_line()}")
    b, l, h = args.batch, 910, args.heads
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x = torch.randn((b, l, h, 64), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    a = -0.1 * torch.randn((b, l, h), generator=g, device="cuda").abs()
    bc = torch.randn((b, l, 128), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    bm, cm = bc[..., :64].view(b, l, 1, 64), bc[..., 64:].view(b, l, 1, 64)
    s0 = torch.randn((b, h, 64, 64), generator=g, device="cuda")
    ms = chip_smoke.time_ms(lambda: ops.ssd_chunked_kernel(x, a, bm, cm, s0))
    buf = (ctypes.c_ulonglong * (4 * NP))()
    kbuild.check(dll.repro_ssd_phases(ctypes.addressof(buf)), "phases")
    nchunks = -(-l // 64)
    for wg in range(min(3, h)):
        row = [v / nchunks for v in buf[wg * NP:(wg + 1) * NP]]
        print(f"warpgroup {wg}: {sum(row):.0f} cycles a chunk: " + ", ".join(
            f"{name} {v:.0f}" for (name, _, _), v in zip(PHASES, row)))
    print(f"shape (B={b}, L={l}, H={h}, one group): {ms:.4f} ms a call "
          f"(instrumented)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
