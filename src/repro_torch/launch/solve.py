"""Solver launcher for the port: any registered family (lasso, svm,
ksvm, logreg, sfista) on a synthetic dataset.

    PYTHONPATH=src python -m repro_torch.launch.solve --problem lasso \
        --dataset epsilon-like --mu 8 --s 16 --iterations 512 --accelerated
    PYTHONPATH=src python -m repro_torch.launch.solve --problem svm \
        --dataset w1a-like --s 8 --iterations 128 --svm-loss l1 --sparse
    PYTHONPATH=src python -m repro_torch.launch.solve --problem ksvm \
        --dataset w1a-like --s 8 --iterations 128 --kernel rbf \
        --kernel-gamma 0.1
    PYTHONPATH=src python -m repro_torch.launch.solve --problem logreg \
        --dataset w1a-like --s 8 --iterations 128 --logreg-l2 1e-3
    PYTHONPATH=src python -m repro_torch.launch.solve --problem sfista \
        --dataset epsilon-like --s 16 --iterations 512

``--problem`` takes every name of the family registry; each family builds
its problem (``make_problem``) and its one-line summary (``describe``);
``--list-families`` prints the registry (variants, partition axis, the
autotuner's grid) and exits. Runs on the card unless ``--device cpu`` is
given; ``--sparse`` passes A as a SparseOperand. ``--tune`` runs the
calibrated autotuner (``repro_torch.tune``) on the solve's device first,
with ``--s``/``--mu`` as the incumbent it must beat, and prints its
choice as ``tuned[family]: ...``. ``--kernel`` picks a registered SVM kernel (the
default is the family's: linear for svm, rbf for ksvm), and each kernel
hyperparameter is a ``--kernel-<name>`` flag. Prints the objective (svm,
ksvm: the dual) at the first and last inner iteration.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import api
from repro_torch.api import FAMILIES, KERNELS, SolverConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--list-families", action="store_true",
                    help="print every registered problem family (variants, "
                         "sharded partition axis, autotuner grid) and exit")
    ap.add_argument("--problem", choices=sorted(FAMILIES), default="lasso")
    ap.add_argument("--dataset", default="news20-like")
    ap.add_argument("--mu", type=int, default=None,
                    help="block size (default: the family's)")
    ap.add_argument("--s", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=512)
    ap.add_argument("--accelerated", action="store_true")
    ap.add_argument("--lam-frac", type=float, default=0.1,
                    help="lasso, sfista: lambda as a fraction of "
                         "||A^T b||_inf")
    ap.add_argument("--svm-loss", choices=("l1", "l2"), default="l1",
                    help="svm, ksvm: hinge (l1) or squared hinge (l2)")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default=None,
                    help="svm, ksvm: the SVM kernel (default: the "
                         "family's, linear for svm and rbf for ksvm)")
    # Every registered kernel hyperparameter is a --kernel-<name> flag, its
    # type and default from KernelSpec.cli_params.
    seen = set()
    for spec in KERNELS.values():
        for pname, default in spec.cli_params.items():
            if pname not in seen:
                seen.add(pname)
                ap.add_argument(f"--kernel-{pname}", type=type(default),
                                default=default,
                                help=f"{spec.name} kernel hyperparameter "
                                     f"(default {default})")
    ap.add_argument("--logreg-l2", type=float, default=1e-3,
                    help="logreg: l2 regularization weight")
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
    ap.add_argument("--tune", action="store_true",
                    help="autotune s/mu/symmetric_gram with the calibrated "
                         "cost model (repro_torch.tune) before solving; "
                         "--s/--mu become the incumbent the tuner must "
                         "beat")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def list_families() -> str:
    """One block per registered family, straight from the registry."""
    lines = []
    for name in sorted(FAMILIES):
        fam = FAMILIES[name]
        variants = ", ".join(f"{k} -> {v}"
                             for k, v in sorted(fam.variants.items()))
        grid = ", ".join(f"{k}={list(v)}"
                         for k, v in sorted(fam.tune_space.items()))
        lines += [f"{name}  ({fam.problem_cls.__name__}, "
                  f"partition={fam.partition}, default_mu={fam.default_mu})",
                  f"    variants:   {variants}",
                  f"    tune_space: {grid}"]
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_families:
        print(list_families())
        return
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
    if args.tune:
        from repro_torch import tune
        tr = tune.tune(problem, cfg, family=family.name)
        cfg = tr.config
        print(f"tuned[{family.name}]: s={cfg.s} mu={cfg.block_size} "
              f"symmetric_gram={cfg.symmetric_gram} "
              f"(model {tr.predicted_s:.3g}s vs incumbent "
              f"{tr.predicted_default_s:.3g}s"
              f"{', cached machine' if tr.from_cache else ''})")
        args.s, args.mu = cfg.s, cfg.block_size   # describe() reads these
    res = api.solve(problem, cfg, family=family.name)
    print(family.describe(args, res, time.perf_counter() - t0))


if __name__ == "__main__":
    main()
