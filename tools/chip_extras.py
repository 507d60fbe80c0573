#!/usr/bin/env python3
"""The parts of ``chip_smoke.py`` that run the archs with extras in
training and the two dense archs in serving, alone, on one card.

    python3 tools/chip_extras.py [--parts train,dense,tp]

Run from the root of a checkout on a machine with an NVIDIA H100. It
starts the dry run's subprocesses (``chip_smoke.tp_dry_start``), builds
the kernels (one ``nvcc`` per source, together), then runs each part
asked for (all three by default):

* ``train``: phase 16 (f) and (g) (``chip_smoke.phase_train_extras``):
  whisper-large-v3 at full width and depth and pixtral-12b at full width,
  8 layers, trained on one rank through ``make_train_step`` with their
  frames or patches in the batch;
* ``dense``: phase 22 (``chip_smoke.phase_dense``): qwen1.5-4b and
  stablelm-12b prefilled at B 1, S 8192 and served at batch 8;
* phase 20 on the paths those parts measured (argument bytes exact, the
  peak within ``PEAK_RATIO``), when either ran;
* ``tp``: phase 21 (h) and (i) (``chip_smoke.phase_tp(...,
  extras_only=True)``): both archs over two gloo ranks as data 1 x model
  2, each rank held to its own dry-run cell.

Any failed check raises.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("train", "dense", "tp")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}")
    parts = ap.parse_args().parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"--parts: {sorted(set(parts) - set(PARTS))} unknown")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import KERNEL_PACKAGES, _build
    if not torch.cuda.is_available():
        print("chip_extras.py: torch.cuda.is_available() is False",
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
    paths = []
    if "train" in parts:
        print(chip_smoke.phase_train_extras(), flush=True)
        paths += [f"{name} train" for name in chip_smoke.TRAIN_X]
        torch.cuda.empty_cache()
    if "dense" in parts:
        chip_smoke.phase_dense()
        paths += list(chip_smoke.DENSE_SERVED)
        torch.cuda.empty_cache()
    if paths:
        chip_smoke.phase_dryrun(smi, tuple(paths))
    if "tp" in parts:
        print(chip_smoke.phase_tp(smi, extras_only=True), flush=True)
    chip_smoke.log_timeline()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
