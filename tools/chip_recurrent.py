#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone, on one card: the recurrent blocks
(hymba's hybrid block with meta tokens, xLSTM's mLSTM and sLSTM).

    python3 tools/chip_recurrent.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together), prints ptxas's
report of K5 (``flash_attention``), runs phase 7's K5 sweep (which holds
hymba's 25 query heads over 5 at its window against the plain version)
and calls ``chip_smoke.phase_recurrent``, which prints what phase 18
prints: hymba-1.5b at full width and depth prefilled at B 1, S 8192 (32
K5 launches, median of three, tokens/s, peak memory, the split, the busy
share) and served (batch 8, prompt 128, generate 32); K5 at hymba's shape
against its plain version, SDPA with a band mask and the same call at
window 0; xlstm-350m at full width and depth prefilled at S 2048 (no
kernel) and served; f32 card against CPU at both archs' widths and the
smoke configs' serving; the serving CLI for both. The last JSON line is
what K5's row gains. Any failed check raises.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import KERNEL_PACKAGES, _build
    if not torch.cuda.is_available():
        print("chip_recurrent.py: torch.cuda.is_available() is False",
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
    _build.build(KERNEL_PACKAGES)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    chip_smoke.log_ptxas("flash_attention")
    chip_smoke.phase_attention_kernel()
    print(json.dumps(chip_smoke.phase_recurrent()), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
