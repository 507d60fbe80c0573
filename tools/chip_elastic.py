#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone, on one card: the elastic runtime.

    python3 tools/chip_elastic.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together), makes phase 2's
local solve of the epsilon Lasso (the undisturbed reference of (a)) and
calls ``chip_smoke.phase_elastic``, which prints what phase 15 prints:
the segmented solve at NCCL world size 1 with the checkpoints' bytes and
times, the recoveries of four gloo ranks on the epsilon and
news20.binary paths, the f64 chaos schedules against the CPU and the
torchrun CLI. Any failed check raises.

    python3 tools/chip_elastic.py --decode-around

also runs phase 9 (llama3-8b decode through ``BatchedServer``) twice
before phase 15 and once after each of its parts ((a); (b) and (c);
(d)) in the same process, and prints the process's OS threads, child
processes and Python objects at each point, to show whether what a part
leaves behind slows a later phase's host-bound decode step.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_state(label: str) -> None:
    """Print this process's OS threads (by name), child processes and
    live Python objects."""
    import collections
    import gc
    names = collections.Counter()
    children = []
    for tid in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{tid}/comm") as f:
            names[f.read().strip()] += 1
        with open(f"/proc/self/task/{tid}/children") as f:
            children += f.read().split()
    print(f"host state {label}: {sum(names.values())} threads "
          f"{dict(sorted(names.items()))}; children {children}; "
          f"{len(gc.get_objects())} Python objects", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode-around", action="store_true",
                    help="run phase 9's decode before and after phase 15")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke
    from repro_torch import api
    from repro_torch.kernels import KERNEL_PACKAGES, _build
    if not torch.cuda.is_available():
        print("chip_elastic.py: torch.cuda.is_available() is False",
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
    res = api.solve(chip_smoke.epsilon_problem(seed=0),
                    api.SolverConfig(block_size=chip_smoke.MU,
                                     s=chip_smoke.S, iterations=chip_smoke.H))
    chip_smoke.LOCAL["epsilon"] = (res.x.cpu(), res.objective.cpu())
    del res
    torch.cuda.empty_cache()
    if not args.decode_around:
        chip_smoke.phase_elastic()
        print(smi)
        return 0
    arch, model = chip_smoke.llama_model()
    host_state("before phase 9")
    for label, part in (("phase 9 again", None),
                        ("phase 15 (a)", chip_smoke.phase_elastic_nccl),
                        ("phase 15 (b), (c)", chip_smoke.phase_elastic_gloo),
                        ("phase 15 (d)", lambda: chip_smoke.elastic_cli_finish(
                            chip_smoke.elastic_cli_start()))):
        chip_smoke.phase_serve(arch, model)
        host_state(f"after phase 9, before {label}")
        if part is not None:
            part()
            torch.cuda.empty_cache()
    chip_smoke.phase_serve(arch, model)
    host_state("at the end")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
