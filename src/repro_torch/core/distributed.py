"""Distributed entry points (the port of ``repro/core/distributed.py``):
thin shims over :func:`repro_torch.core.api.solve_sharded`, and
:func:`run_ranks`, which starts the processes of a ``torch.distributed``
job on one host.

Layout (the families' ``partition`` field): Lasso and SFISTA rows are
sharded and x is replicated; SVM, kernel SVM and logistic-regression
columns are sharded and everything in R^m (alpha, f, the margins) is
replicated. Zero padding of the partitioned axis is exact for all.

The launchers join (or make) their group through :func:`join_hosts`.
``repro``'s ``lower_lasso_step`` / ``lower_svm_step`` lower a JAX program
for a device mesh and have no counterpart here. :func:`survivor_group`
takes the place of ``repro.runtime.elastic.build_1d_mesh``: after a
failure the elastic driver re-groups the surviving ranks.
"""
from __future__ import annotations

import contextlib
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


def placement_backend(device: str, world_size: int,
                      device_count: int) -> str:
    """The backend :func:`check_placement` admits for a job: NCCL on the
    card when each rank has a card of its own, gloo otherwise (on the
    CPU, or host-staged on the card when ranks outnumber cards)."""
    if device == "cuda" and 1 <= world_size <= device_count:
        return "nccl"
    return "gloo"


def survivor_group(hosts, group=None):
    """A process group over the ranks ``hosts`` of ``group`` (the default
    group when None), renumbered in rank order: rank i of the new group
    is ``sorted(hosts)[i]``. Only those ranks call it
    (``use_local_synchronization=True``), so ranks that left the job take
    no part.

    It ends at the survivors' synchronisation point, a barrier over the
    new group: every survivor has joined it before any rank goes on.
    Then the group's rank 0 deletes the group's rendezvous keys from the
    default store. torch names a group by its ranks and the number of
    groups the process holds, so a later group over the same ranks, made
    once this one is destroyed, gets the same name and would read this
    one's stale addresses and hang.

    That naming, and the private ``_get_default_store``, are torch
    internals: this function is the only code that depends on them.
    tests/test_torch_elastic.py pins it (two groups in a row over the
    same ranks, and one beside a held group). Checked on torch 2.13.0
    (CPU, gloo, four ranks) and 2.11.0+cu128 (H100: gloo over four
    ranks on CUDA tensors, NCCL over one rank); an NCCL group of more
    than one rank is untried."""
    base = group if group is not None else dist.group.WORLD
    ranks = sorted(dist.get_global_rank(base, h) for h in hosts)
    new = dist.new_group(ranks, use_local_synchronization=True)
    dist.barrier(group=new)
    if dist.get_rank(new) == 0:
        store = dist.distributed_c10d._get_default_store()
        prefix = new.group_name + "/"
        for key in store.list_keys():
            if key.startswith(prefix):
                store.delete_key(key)
    return new


def shared_tempdir(prefix: str) -> str:
    """A new temporary directory that every rank of the default group
    names: rank 0 makes it and sends its path to the others (without a
    group, or at world size 1, simply a new temporary directory)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tempfile.mkdtemp(prefix=prefix)
    path = [tempfile.mkdtemp(prefix=prefix) if dist.get_rank() == 0
            else None]
    dist.broadcast_object_list(path, src=0)
    return path[0]


@contextlib.contextmanager
def join_hosts(device: str):
    """The default process group of a launcher, whose ranks are its
    hosts: joined from torchrun's environment (``WORLD_SIZE`` and the
    rest), or made here for one rank through a ``FileStore`` in a
    temporary directory. The backend is :func:`placement_backend`'s.
    Yields (backend, world size); a group made here is destroyed after
    the block."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    count = torch.cuda.device_count() if device == "cuda" else 0
    backend = placement_backend(device, world, count)
    check_placement(backend, world, device, count)
    with contextlib.ExitStack() as stack:
        if "WORLD_SIZE" in os.environ:
            if device == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                      % count)
            dist.init_process_group(backend)
        else:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="repro_torch_group_"))
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        stack.callback(dist.destroy_process_group)
        yield backend, world


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
