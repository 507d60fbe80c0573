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

``--checkpoint-every N`` / ``--checkpoint-dir D`` run the solve through
the elastic driver (``repro_torch.runtime.solve_elastic``), checkpointing
every N outer iterations (1 when only ``--checkpoint-dir`` is given; a
fresh temporary directory when only ``--checkpoint-every`` is), and
``--inject-failure STEP:HOST`` (repeatable) kills a host at an inner
iteration. The hosts are the ranks of the default process group: under
``python -m torch.distributed.run --standalone --nproc-per-node P`` the
launcher joins it from the environment, otherwise it makes a group of
one rank. The
backend follows ``core.distributed.placement_backend`` (NCCL on the card
when each rank has a card, else gloo) and is printed, with the world
size, on the first line; the lowest surviving rank then prints each
event as ``elastic: <event>`` and the summary. (``--standalone`` puts
the rendezvous on a free port instead of torchrun's fixed default; the
``--`` below ends torchrun's options: the argparse of some Python 3.12
releases reads ``--s`` as an abbreviation of one of them.)

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m -- repro_torch.launch.solve --problem lasso --dataset w1a-like \
        --s 4 --iterations 24 --checkpoint-every 1 --inject-failure 10:2
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.api import FAMILIES, KERNELS, SolverConfig
from repro_torch.core import distributed


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
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory for the elastic sharded "
                         "driver (implies --checkpoint-every 1 if that "
                         "flag is unset)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="checkpoint every N OUTER iterations and run "
                         "through the elastic sharded driver (survives "
                         "injected host failures)")
    ap.add_argument("--inject-failure", action="append", default=[],
                    metavar="STEP:HOST",
                    help="kill HOST at inner iteration STEP (repeatable); "
                         "requires the elastic driver "
                         "(--checkpoint-every/--checkpoint-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def _elastic_requested(args) -> bool:
    """Whether an elastic flag was given: the elastic driver runs, else
    the plain local path (``repro``'s ``_elastic_kwargs`` is None)."""
    return (args.checkpoint_dir is not None
            or args.checkpoint_every is not None
            or bool(args.inject_failure))


def _elastic_kwargs(args):
    """Parse the elastic CLI flags into solve_elastic kwargs. A missing
    directory is made now, shared by every rank of the default group, so
    it is called once the group is joined."""
    from repro_torch.runtime import ElasticConfig, FailureInjector
    if args.checkpoint_dir is None:
        args.checkpoint_dir = distributed.shared_tempdir("repro_elastic_")
    failures = {}
    for spec in args.inject_failure:
        step_s, host_s = spec.split(":")
        failures.setdefault(int(step_s), []).append(int(host_s))
    return {
        "elastic": ElasticConfig(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every or 1),
        "injector": FailureInjector(failures=failures) if failures else None,
    }


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
    ekw = None
    with contextlib.ExitStack() as stack:
        if _elastic_requested(args):
            backend, world = stack.enter_context(
                distributed.join_hosts(args.device))
            ekw = _elastic_kwargs(args)
            if dist.get_rank() == 0:
                print(f"elastic: backend {backend}, world size {world}, "
                      f"device {args.device}, checkpoints in "
                      f"{args.checkpoint_dir}", flush=True)
        _solve(args, family, cfg, ekw)


def _solve(args, family, cfg, ekw):
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
    if ekw is None:
        res = api.solve(problem, cfg, family=family.name)
    else:
        from repro_torch.runtime import solve_elastic
        res = solve_elastic(problem, cfg, family=family.name, **ekw)
        report = res.aux["elastic"]
        if dist.get_rank() != report["live_hosts"][0]:
            return          # a lost host, or not the lowest survivor
        for ev in report["events"]:
            print(f"elastic: {ev}")
    print(family.describe(args, res, time.perf_counter() - t0))


if __name__ == "__main__":
    main()
