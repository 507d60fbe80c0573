#!/usr/bin/env python3
"""Compare two checkouts' paths on one card, in turns.

    python3 tools/chip_ab.py PARENT_ROOT . . PARENT_ROOT

Each argument is the root of a checkout (with its own ``chip_smoke.py``
and ``src/repro_torch``). For each, in the order given, a fresh process
builds that tree's kernels and runs its ``chip_smoke.py`` phases 2, 4 and
5 (the dense Lasso at epsilon's shape, the sparse SVM at news20.binary's,
the sparse Lasso at url's: one counted solve, the classical check, five
steady solves and the traced phase split each) and three steady llama3-8b
prefills at B 1, S 8192. Giving the trees as parent, change, change,
parent puts both on the same card under the same drift. The last lines
sum up each run: the steady walls per outer iteration (median of five),
the prefill (median of three) and the traced kernel phases. Needs one
NVIDIA card; exits non-zero if any run fails.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time


def one(root: str) -> None:
    """The phases of one tree, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["gram", "sa_inner", "spmm", "svm_inner", "flash_attention"])
    print(f"== tree {root}", flush=True)
    cs.phase_main_path()
    torch.cuda.empty_cache()
    cs.phase_svm()
    torch.cuda.empty_cache()
    cs.phase_url()
    torch.cuda.empty_cache()
    arch, model = cs.llama_model()
    with torch.no_grad():
        toks = torch.randint(0, arch.vocab_size, (1, cs.PREFILL_S),
                             device="cuda")
        model.prefill(toks)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(toks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    print(f"  prefill steady {' '.join(f'{w:.4f}' for w in walls)} s "
          f"(median {sorted(walls)[1]:.4f})", flush=True)


def main(roots) -> int:
    keep = re.compile(r"^== tree|steady|(gram|spmm|svm_inner|sa_inner) "
                      r"kernel")
    summary = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"chip_ab: the run of {root} failed", file=sys.stderr)
            return 1
        summary += [ln for ln in out.stdout.splitlines() if keep.search(ln)]
    print("\n".join(["summary:"] + summary))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
