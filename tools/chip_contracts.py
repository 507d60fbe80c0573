#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, on one card: the static contracts
of ``repro_torch.analysis``.

    python3 tools/chip_contracts.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together), measures the
card's machine (``tune.measure_machine``) for the certified tuner of
(d), and calls ``chip_smoke.phase_contracts``, which prints what phase 14
prints: check_all on the card, the card's counts against the CPU's, the
full-width epsilon and news20.binary contracts with the recorder's
overhead, the certified selection and the CLI. Any failed check raises.
"""
import dataclasses
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
    from repro_torch import tune
    from repro_torch.kernels import KERNEL_PACKAGES, _build
    if not torch.cuda.is_available():
        print("chip_contracts.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}",
          flush=True)
    t0 = time.perf_counter()
    _build.build(KERNEL_PACKAGES)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    machine = tune.measure_machine()
    chip_smoke.phase_contracts(
        smi, {"epsilon": {"machine": dataclasses.asdict(machine)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
