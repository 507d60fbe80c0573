#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone, on one card: tensor, expert and
sequence parallelism in the trainer.

    python3 tools/chip_tp.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together) and calls
``chip_smoke.phase_tp``: two gloo ranks sharing the card as one model
group first serve the four archs below split over the model axis (phase
21 (g): prefill and split-KV decode, each against one rank), then train
tinyllama-1.1b (with sequence parallelism),
granite-moe-1b-a400m (expert parallelism), hymba-1.5b (attention and SSM
heads split by flat columns, with sequence parallelism) and xlstm-350m
(mLSTM and sLSTM split by heads) at full width and depth, each against
the same steps in one process, then f32 at 2 layers against one rank,
each rank's argument bytes, peak, last step's FLOPs and collectives (by
axis and kind, count and result bytes) against the dry run's count of a
rank's own step at 1x2; then FSDP over the two ranks as data 2, held to
the 2x1 cell the same way. The cells are counted on the meta device in a
subprocess at nice 19 started before the build. Any failed check raises.
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
        print("chip_tp.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}",
          flush=True)
    chip_smoke.tp_dry_start()
    t0 = time.perf_counter()
    _build.build(KERNEL_PACKAGES)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    print(chip_smoke.phase_tp(smi), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
