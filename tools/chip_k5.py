#!/usr/bin/env python3
"""K5 (``flash_attention``) alone on one card: phase 7 of ``chip_smoke.py``
and the kernel at two prefill shapes on random q/k/v.

    python3 tools/chip_k5.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds ``flash_attention`` alone, prints ptxas's report of each instance
(registers, spills; a spill in a ``wgmma`` instance, or a missing one,
fails), runs ``chip_smoke.phase_attention_kernel`` (every case against the
plain version, on the body ``dispatch`` names), then, at B 1, S 8192,
causal, on q/k/v drawn from seed 3 (0.3 N(0, 1) for q and k, N(0, 1) for
v): stablelm-12b's heads (32 over 8 of D = 160) and llama3-8b's (32 over 8
of D = 128). At each it holds the kernel to the plain version at the
prefill's bar (``chip_smoke.k5_held``) and prints ``chip_smoke.dense_k5_row``:
the wrapper, SDPA and the wgmma body without ping-pong in turns, the simt
body at bf16, the plain version, the device time and the bound. The last
JSON line holds the rows. Any failed check raises.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("stablelm-12b", 32, 8, 160), ("llama3-8b", 32, 8, 128))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_k5.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}",
          flush=True)
    t0 = time.perf_counter()
    _build.build(["flash_attention"])
    print(f"flash_attention built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    chip_smoke.log_ptxas("flash_attention")
    chip_smoke.phase_attention_kernel()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    for name, Hq, Hkv, D in SHAPES:
        q, k, v = chip_smoke.attn_inputs(1, Hq, Hkv, chip_smoke.PREFILL_S,
                                         chip_smoke.PREFILL_S, D,
                                         torch.bfloat16, gen)
        kw = {"causal": True}
        err = chip_smoke.k5_held(q, k, v, kw, f"random q/k/v at {name}'s")
        rows.append(chip_smoke.dense_k5_row(q, k, v, kw, name, 0, err))
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"rows": rows}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
