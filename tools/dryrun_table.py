#!/usr/bin/env python3
"""Markdown tables of the dry run's cached cells (``results/dryrun_torch/``,
written by ``python -m repro_torch.launch.dryrun`` for the production
mesh, ``--mesh 1x1`` or ``--mesh 4x1``), an arch a row and a shape a
column, each cell giving every mesh's bytes per device (argument +
temp), ``fits_hbm``, the bound and its dominant term, the collective
term, and the seconds the cell took to count, all predicted on
``HW_H100``'s data-sheet peaks.

    PYTHONPATH=src python tools/dryrun_table.py [--meshes pod16x16 pod1x1]
"""
import argparse
import glob
import json
import os

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results", "dryrun_torch")
TERM = {"compute": "C", "memory": "M", "collective": "N"}


def cell(r) -> str:
    if r is None:
        return "not run"
    if r["status"] != "ok":
        return r["status"]
    m, t = r["memory"], r["roofline"]
    fit = "" if r.get("count", "direct") == "direct" else " (S fit)"
    coll = "n/c" if t["collective_s"] is None \
        else f"{t['collective_s']:.4g} s"                  # an older cache
    return (f"{m['total_bytes'] / 1e9:.2f} GB "
            f"{'fits' if m['fits_hbm'] else 'no'} "
            f"{t['bound_s']:.4g} s {TERM[t['dominant']]}{fit}, "
            f"N {coll}, {r['wall_s']} s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", nargs="+", default=["pod16x16"])
    args = ap.parse_args()
    cells = {}
    for path in glob.glob(os.path.join(RESULTS, "*.json")):
        with open(path) as f:
            r = json.load(f)
        cells[r["arch"], r["shape"], r["mesh"]] = r
    archs = sorted({a for a, _, m in cells if m in args.meshes})
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    print(f"Each cell: {' / '.join(args.meshes)}; bytes per device "
          f"(argument + temp), fits HW_H100.hbm_bytes or not, the bound "
          f"and its term (C compute, M memory, N collective), N the "
          f"collective term (n/c: an older cell did not count it), the "
          f"cell's wall on the host that counted it.\n")
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for a in archs:
        print(f"| {a} | " + " | ".join(
            " / ".join(cell(cells.get((a, s, m))) for m in args.meshes)
            for s in shapes) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
