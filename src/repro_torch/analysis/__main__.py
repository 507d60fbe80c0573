"""CLI: ``python -m repro_torch.analysis [--checks ...] [--families ...]``.

Runs the static contracts and exits 1 if any pass reports an error.
``-v`` also prints the info diagnostics (payload bytes per outer
iteration, certified cost ratios, plans checked); ``--json`` emits the
machine-readable report instead of text; ``--variants`` restricts the
per-family solver passes to the named variants (``--family`` is an alias
of ``--families``). The solver passes run on ``--device`` (default the
card).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import CHECKS, check_all


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static contract analysis of the SA solvers.")
    parser.add_argument("--checks", nargs="+", choices=CHECKS,
                        default=None, metavar="CHECK",
                        help=f"subset of passes to run (default: all of "
                             f"{', '.join(CHECKS)})")
    parser.add_argument("--families", "--family", nargs="+", default=None,
                        metavar="FAMILY", dest="families",
                        help="subset of registered families (default: all)")
    parser.add_argument("--variants", "--variant", nargs="+", default=None,
                        metavar="VARIANT", dest="variants",
                        help="subset of registered variants for the "
                             "per-family passes (default: all)")
    parser.add_argument("--device", default="cuda",
                        help="where the solver passes solve: cuda (the "
                             "default; raises without a card) or cpu")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report (always "
                             "includes info diagnostics)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print info diagnostics (payload bytes, "
                             "cost ratios, plans checked)")
    args = parser.parse_args(argv)

    report = check_all(checks=args.checks, families=args.families,
                       variants=args.variants, device=args.device)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        print(report.format(verbose=args.verbose))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
