#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone, on one card: LM training.

    python3 tools/chip_train.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together), prints ptxas's
report of K5 (``flash_attention``), runs phase 7 (K5 against its plain
version at every case, the smoke configs' D = 16 among them) and calls
``chip_smoke.phase_training``, which prints what phase 16 prints:
tinyllama-1.1b trained at full width and depth (losses, launches,
reductions, ms per step, tokens/s, peak memory, the step's split),
whisper-large-v3 (full depth) and pixtral-12b (8 layers) trained at full
width with their frames or patches, one f32 step on the card against the
CPU and the checkpointing policies, microbatches 1 against 4, a
checkpoint and an injected failure over four gloo ranks, and the
launchers (phases 14 (e) and 16-19's CLIs). Any failed check raises.
"""
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
        print("chip_train.py: torch.cuda.is_available() is False",
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
    print(chip_smoke.phase_training(), flush=True)
    chip_smoke.phase_launchers()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
