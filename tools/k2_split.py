#!/usr/bin/env python3
"""Where the time of K2's warp body goes, on one card, by clock64.

    python3 tools/k2_split.py

Run from the root of a checkout on a machine with an NVIDIA card. It
copies ``src/repro_torch/kernels/csrc/sa_inner.cu`` into
``build/k2_split/``, adds clock64 stamps to the copy (the kernel in the
package carries none), builds it with the package's nvcc flags and
launches its warp body at the Lasso paths' (s 16, mu 8), f32 and f64, on
random inputs made on the card (``chip_smoke.inner_inputs``, lam2 = 0 as
on the paths). Each stamp is taken in SM cycles from the kernel's first
instruction: warp 0's rows read, the staging warps done (the collisions
and G), the power-iteration warps done, the chain's end. Each
configuration runs whole and with the staging warps' or the
power-iteration warps' work left out (the results are then wrong; the
stamps show what each phase costs alone). Prints the median of 7
launches of each, and the card's name, power limit and top SM clock.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("rows", "staging", "power", "chain end")


def instrumented_source() -> str:
    """sa_inner.cu with stamps: g_st[0] the start, [1] warp 0's rows read,
    [2] the staging warps done (latest), [3] the power warps done
    (latest), [4] the chain's end; g_mode bit 1 skips the staging warps'
    work, bit 2 the power iterations."""
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                           "sa_inner.cu")) as f:
        src = f.read()

    def rep(a, b):
        nonlocal src
        if src.count(a) != 1:
            raise RuntimeError(f"k2_split: sa_inner.cu has changed; "
                               f"{a[:60]!r} is not found once")
        src = src.replace(a, b)
    rep('#include "common.cuh"\n', '#include "common.cuh"\n'
        '__device__ unsigned long long g_st[8];\n'
        '__device__ int g_mode;\n'
        '__device__ __forceinline__ unsigned long long clk() {\n'
        '  unsigned long long t;\n'
        '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");\n'
        '  return t;\n'
        '}\n')
    rep("  if (warp != 0) {\n    if (tid < stagers) {\n"
        "      warp_body_stage<T>(",
        "  const int gm = g_mode;\n"
        "  if (tid == 0) g_st[0] = clk();\n"
        "  if (warp != 0) {\n    if (tid < stagers) {\n"
        "      if (!(gm & 1)) warp_body_stage<T>(")
    rep("      const int pw = warp - stagers / 32;\n      switch",
        "      const int pw = warp - stagers / 32;\n      if (!(gm & 2)) switch")
    rep("    staged_barrier();\n    return;\n  }",
        "    if (lane == 0) atomicMax(&g_st[tid < stagers ? 2 : 3], clk());\n"
        "    staged_barrier();\n    return;\n  }")
    rep("\n  staged_barrier();\n",
        "\n  if (lane == 0) g_st[1] = clk();\n  staged_barrier();\n")
    rep("    rden = rden_n;\n  }\n}",
        "    rden = rden_n;\n  }\n  if (lane == 0) g_st[4] = clk();\n}")
    return src + """
extern "C" int k2_split_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_st, sizeof(g_st));
}
extern "C" int k2_split_reset(int mode) {
  unsigned long long z[8] = {};
  cudaError_t err = cudaMemcpyToSymbol(g_st, z, sizeof(z));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(g_mode, &mode, sizeof(int));
}
"""


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("k2_split.py: no card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.sa_inner.ops import _C_FN, _declare
    out_dir = os.path.join(ROOT, "build", "k2_split")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, n) for n in ("sa_inner_split.cu",
                                                 "libsa_inner_split.so"))
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    _declare(lib)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    s, mu = cs.S, cs.MU
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.float64):
        ins = cs.inner_inputs(s, mu, 2000, dtype, gen)
        out = torch.empty(s * mu + s, dtype=dtype, device="cuda")
        fn = getattr(lib, _C_FN[dtype][0])
        for mode, what in ((0, "whole"), (1, "no staging work"),
                           (2, "no power iterations"), (3, "chain alone")):
            runs = []
            for _ in range(7):
                if lib.k2_split_reset(mode):
                    raise RuntimeError("k2_split: reset failed")
                rc = fn(*(t.data_ptr() for t in ins), out.data_ptr(),
                        out.data_ptr() + s * mu * out.element_size(), s, mu,
                        250.0, 0.05, 0.0, 32, 2, 0, stream)
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"k2_split: launch error {rc}")
                st = (ctypes.c_ulonglong * 8)()
                lib.k2_split_read(st)
                runs.append([st[i] - st[0] if st[i] else 0
                             for i in range(1, 5)])
            med = [sorted(r[i] for r in runs)[3] for i in range(4)]
            ready = max(med[:3])
            print(f"{dtype} (s={s}, mu={mu}) {what}: cycles from the start: "
                  + ", ".join(f"{n} {c}" for n, c in zip(STAMPS, med))
                  + f"; chain {med[3] - ready} after the last of the three",
                  flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
