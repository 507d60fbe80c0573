"""Distributed entry points (the port of ``repro/core/distributed.py``):
thin shims over :func:`repro_torch.core.api.solve_sharded`, and
:func:`run_ranks`, which starts the processes of a ``torch.distributed``
job on one host.

Layout (the families' ``partition`` field): Lasso and SFISTA rows are
sharded and x is replicated; SVM, kernel SVM and logistic-regression
columns are sharded and everything in R^m (alpha, f, the margins) is
replicated. Zero padding of the partitioned axis is exact for all.

``repro``'s ``lower_lasso_step`` / ``lower_svm_step`` lower a JAX program
for a device mesh and have no counterpart here.
"""
from __future__ import annotations

import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import api
from repro_torch.core.types import (LassoProblem, SVMProblem, SolverConfig,
                                    SolverResult)


def solve_lasso_sharded(problem: LassoProblem, cfg: SolverConfig,
                        group=None) -> SolverResult:
    """Row-partitioned distributed Lasso solve (classical or SA)."""
    return api.solve_sharded(problem, cfg, group, family="lasso")


def solve_svm_sharded(problem: SVMProblem, cfg: SolverConfig,
                      group=None) -> SolverResult:
    """Column-partitioned distributed linear SVM solve (classical or
    SA)."""
    return api.solve_sharded(problem, cfg, group, family="svm")


def check_placement(backend: str, world_size: int, device: str,
                    device_count: int) -> None:
    """Refuse a job that cannot run: NCCL needs a card of its own for
    each rank (two ranks on one card fail inside NCCL, or hang), and a
    job on the card needs one."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device == "cuda" and device_count < 1:
        raise RuntimeError("device='cuda' requested but there is no card; "
                           "pass device='cpu' with backend='gloo'")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("backend='nccl' runs on the card: pass "
                             "device='cuda'")
        if world_size > device_count:
            raise ValueError(
                f"backend='nccl' with {world_size} ranks on {device_count} "
                f"card(s): NCCL cannot put two ranks on one card. Use "
                f"world_size <= {device_count}, or backend='gloo'")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, backend, device, port, out, args):
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(port)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world_size)
    try:
        result = fn(rank, world_size, *args)
        if rank == 0:
            torch.save(result, out)
        # No rank leaves while another may still be reading from it.
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str = "gloo",
              device: str = "cuda", args: tuple = ()):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes
    that form the default process group (``backend`` "gloo" or "nccl",
    over ``tcp://localhost`` at a free port), and return rank 0's
    result, with any tensors in it on the CPU.

    Processes start by the spawn method, so ``fn`` must be importable
    by name (a module-level function), and ``fn`` and ``args`` must
    pickle. On ``device="cuda"`` rank r runs on card r % device_count
    (``torch.cuda.set_device``); NCCL with more ranks than cards raises
    here at once. A rank that raises fails the call: the others are
    stopped and the error is raised here."""
    count = torch.cuda.device_count() if device == "cuda" else 0
    check_placement(backend, world_size, device, count)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.start_processes(
            _rank_main, args=(fn, world_size, backend, device, free_port(),
                              out, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
        return torch.load(out, map_location="cpu", weights_only=False)
