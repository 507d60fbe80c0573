"""Solver launcher for the port: a registered family (lasso, svm) on a
synthetic dataset.

    PYTHONPATH=src python -m repro_torch.launch.solve --problem lasso \
        --dataset epsilon-like --mu 8 --s 16 --iterations 512 --accelerated
    PYTHONPATH=src python -m repro_torch.launch.solve --problem svm \
        --dataset w1a-like --s 8 --iterations 128 --svm-loss l1 --sparse

Runs on the card unless ``--device cpu`` is given; ``--sparse`` passes A
as a SparseOperand. Prints the objective (svm: the dual) at the first
and last inner iteration.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import api
from repro_torch.api import FAMILIES, SolverConfig

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=sorted(FAMILIES), default="lasso")
    ap.add_argument("--dataset", default="news20-like")
    ap.add_argument("--mu", type=int, default=None,
                    help="block size (default: the family's)")
    ap.add_argument("--s", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=512)
    ap.add_argument("--accelerated", action="store_true")
    ap.add_argument("--lam-frac", type=float, default=0.1,
                    help="lasso: lambda as a fraction of ||A^T b||_inf")
    ap.add_argument("--svm-loss", choices=("l1", "l2"), default="l1",
                    help="svm: hinge (l1) or squared hinge (l2)")
    ap.add_argument("--sparse", action="store_true",
                    help="pass A as a SparseOperand (blocked ELL, the "
                         "spmm kernel) instead of a dense matrix")
    ap.add_argument("--symmetric-gram", action="store_true",
                    help="rebuild the Gram block from its lower triangle "
                         "(paper footnote 3)")
    ap.add_argument("--no-track-objective", dest="track_objective",
                    action="store_false",
                    help="skip the per-iteration objective trace")
    ap.add_argument("--power-iters", type=int, default=32,
                    help="power-method iterations for the block step size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    family = FAMILIES[args.problem]
    if args.mu is None:
        args.mu = family.default_mu
    cfg = SolverConfig(block_size=args.mu, s=args.s,
                       iterations=args.iterations,
                       accelerated=args.accelerated,
                       power_iters=args.power_iters,
                       track_objective=args.track_objective,
                       symmetric_gram=args.symmetric_gram,
                       seed=args.seed, device=args.device)
    t0 = time.perf_counter()
    problem = family.make_problem(args)
    res = api.solve(problem, cfg, family=family.name)
    print(family.describe(args, res, time.perf_counter() - t0))


if __name__ == "__main__":
    main()
