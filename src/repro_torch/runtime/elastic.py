"""Elastic fault-tolerant sharded solves (the port of
``repro/runtime/elastic.py``): checkpoint / failure / re-grouping
orchestration around :func:`repro_torch.core.api.solve_sharded`.

The SA solvers keep s iterations of recurrences in flight between fused
all-reduces, so the ONLY safe checkpoint points are outer-iteration
boundaries. This driver runs a solve as a sequence of SEGMENTS of
``checkpoint_every`` outer iterations, each one ``solve_sharded`` call;
at every boundary the full logical
:class:`~repro_torch.core.types.SolveState` (recurrence carries + the
global inner-iteration index; the block draws and the theta schedule are
rebuilt from ``cfg.seed`` and the index) is checkpointed with the specs
of the family's ``state_layout``, in ``repro``'s format.

Hosts: each host is one rank of a ``torch.distributed`` process group,
and :func:`solve_elastic` is SPMD — every rank of the group calls it with
the same problem, config, injector and monitor. The schedule and the
monitor's inputs are the same on every rank, so every rank makes the
same decision, and no decision needs a collective. When the
:class:`~repro_torch.runtime.failures.FailureInjector` schedules a
failure at an inner iteration inside the upcoming segment, that
segment's in-flight work is LOST. The dead ranks leave the job: they
take part in no later collective and return a result marked as lost.
The survivors build a new group over the live ranks, in host order
(:func:`repro_torch.core.distributed.survivor_group`, which takes the
place of ``repro``'s ``build_1d_mesh``), and restore the latest
checkpoint onto it — ``solve_sharded`` re-pads and re-shards the logical
state, so no resharding code exists here. A failure before the first
checkpoint restarts from the initial state. Replay is safe because
``FailureInjector.check`` pops: a fired failure never fires again.

Checkpoints: the lowest live rank writes them; every live rank restores
from disk, as ``repro`` does, and none uses the state it holds in
memory. No survivor reads the directory before the writer's save of the
latest boundary is complete on disk, and a writer that dies joins its
outstanding save before it leaves.

Straggler policy: after each segment the
:class:`~repro_torch.runtime.stragglers.StragglerMonitor` is fed per-host
times (measured, or simulated via the ``host_times`` hook). "rebalance"
is ADVISORY — the equal shards have no per-host share to shrink, so the
suggested ``microbatch_weights`` are surfaced in the report. "evict" is
ENFORCED: the host is dropped through the same re-grouping path as a
hard failure (restoring the checkpoint just written at the boundary, so
no work is lost).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
from repro_torch.core import api as core_api
from repro_torch.core import distributed
from repro_torch.core.types import SolveState, SolverConfig, SolverResult
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.stragglers import StragglerMonitor

__all__ = ["ElasticConfig", "solve_elastic"]

# How long a survivor waits for the writer's checkpoint to appear on disk.
CHECKPOINT_WAIT_SECONDS = 600.0


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_elastic_ckpt")


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs for :func:`solve_elastic`.

    checkpoint_dir:   where ``step_<inner_iteration>`` checkpoints land
                      (``repro_elastic_ckpt`` in the temporary directory
                      by default). Every rank reads it, so on several
                      hosts it is a shared filesystem.
    checkpoint_every: segment length in OUTER iterations (all-reduce
                      rounds) — the checkpoint cadence. Segment
                      boundaries fall at multiples of ``cfg.s`` inner
                      iterations, preserving s-group alignment, so an
                      undisturbed segmented solve is bit-identical to
                      the monolithic one on the same group.
    keep:             checkpoint retention (newest N kept).
    async_save:       overlap npz writes with the next segment (joined
                      before any restore and on exit).
    """

    checkpoint_dir: str = dataclasses.field(
        default_factory=_default_checkpoint_dir)
    checkpoint_every: int = 1
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1 outer iterations, "
                f"got {self.checkpoint_every}")
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")


def _state_specs(layout, axis: str) -> Dict[str, List[str]]:
    """The spec per state leaf: 'partition' leaves on the family's axis,
    'replicated' leaves on none (``repro``'s ``P(axis)`` and ``P()``)."""
    return {name: ([axis] if lay == "partition" else [])
            for name, lay in layout}


def _await_checkpoint(directory: str, step: int) -> None:
    """Block until a complete checkpoint of ``step`` (or a later one) is
    on disk: the writer's atomic rename makes it visible only whole."""
    deadline = time.monotonic() + CHECKPOINT_WAIT_SECONDS
    while (latest_step(directory) or -1) < step:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"the checkpoint of iteration {step} did not appear under "
                f"{directory} within {CHECKPOINT_WAIT_SECONDS:.0f} s")
        time.sleep(0.002)


def solve_elastic(problem, cfg: Optional[SolverConfig] = None, *,
                  elastic: Optional[ElasticConfig] = None,
                  family: Optional[object] = None,
                  group=None,
                  injector: Optional[FailureInjector] = None,
                  monitor: Optional[StragglerMonitor] = None,
                  host_times: Optional[Callable[[int, List[int]],
                                               Dict[int, float]]] = None,
                  x0=None) -> SolverResult:
    """Sharded solve that survives host failures mid-run. Every rank of
    ``group`` calls it with the same arguments.

    problem/cfg/family/x0: as :func:`repro_torch.core.api.solve`.
    elastic:   checkpoint cadence/retention (:class:`ElasticConfig`).
    group:     the process group whose ranks are the hosts (host h is
               rank h of it); the default group when None. It takes the
               place of ``repro``'s ``devices=``.
    injector:  scheduled failures keyed by GLOBAL inner iteration — a
               failure at iteration t kills its hosts mid-segment and
               loses that segment's in-flight work.
    monitor:   straggler monitor; fed after every segment.
    host_times: ``fn(segment_index, live_hosts) -> {host: seconds}`` —
               simulated (or externally measured) per-host step times.
               Without it each rank feeds the monitor its own segment
               wall for every live host (no skew — detection never
               triggers, and every rank decides alike).

    Returns the final :class:`SolverResult`; ``aux["elastic"]`` holds
    the event log, per-recovery records (kind, hosts, resumed_iteration,
    n_hosts, restore_seconds, and the port's group_seconds, the time to
    build the survivors' group), the advisory rebalance weights and the
    surviving host list. The objective trace covers all cfg.iterations
    inner iterations — replayed segments overwrite the work lost to each
    failure, exactly as the uninterrupted trace would read. On a rank
    that a failure or an eviction removed, x and the objective are None
    and ``aux["elastic"]["lost"]`` is True.
    """
    fam = core_api.resolve_family(problem, family)
    if cfg is None:
        cfg = SolverConfig()
    if elastic is None:
        elastic = ElasticConfig()
    if fam.state_layout is None:
        raise ValueError(
            f"family {fam.name!r} declares no state_layout — elastic "
            f"recovery needs checkpointable solver state")
    base = core_api._default_group(group)
    axis = fam.default_axes if isinstance(fam.default_axes, str) else "data"
    layout = fam.state_layout(cfg)
    specs = _state_specs(layout, axis)

    n_hosts = dist.get_world_size(base)
    me = dist.get_rank(base)                      # this rank's host id
    live = list(range(n_hosts))
    seg_len = elastic.checkpoint_every * cfg.s    # inner iters per segment

    events: List[str] = []
    recoveries: List[Dict[str, Any]] = []
    rebalances: List[Dict[str, Any]] = []
    traces: List[Dict[str, Any]] = []             # {"start": it, "objs": t}
    state: Optional[SolveState] = None
    saved: Optional[int] = None                   # the last boundary saved
    seg_index = 0
    current = base                                # the group solving now
    made = None                                   # the group this call made

    def report(lost: bool) -> Dict[str, Any]:
        return {"events": events, "recoveries": recoveries,
                "rebalances": rebalances, "live_hosts": list(live),
                "n_hosts_initial": n_hosts,
                "checkpoint_every": elastic.checkpoint_every, "lost": lost}

    def restore(mgr: CheckpointManager, reason: str):
        """Latest checkpoint -> (state, iteration); falls back to the
        initial state when nothing was checkpointed yet."""
        nonlocal state, traces
        t0 = time.perf_counter()
        mgr.wait()
        if saved is not None:
            _await_checkpoint(elastic.checkpoint_dir, saved)
        try:
            tree, extra = mgr.restore_latest(device=cfg.device)
        except FileNotFoundError:
            state, it = None, 0
            traces = []
            events.append(f"{reason}: no checkpoint yet — restarting "
                          f"from the initial state")
        else:
            it = int(extra["iteration"])
            state = SolveState(it, dict(tree))
            traces = [t for t in traces if t["start"] < it]
            events.append(f"{reason}: restored iteration {it} onto "
                          f"{len(live)} hosts")
        return it, time.perf_counter() - t0

    def regroup():
        """The survivors' group, replacing (and destroying) the one this
        call made before; returns the seconds it took."""
        nonlocal current, made
        t0 = time.perf_counter()
        new = distributed.survivor_group(live, base)
        if made is not None:
            dist.destroy_process_group(made)
        current = made = new
        return time.perf_counter() - t0

    def recover(mgr, kind: str, hosts: List[int], reason: str):
        it, dt = restore(mgr, reason)
        gt = regroup()
        recoveries.append({
            "kind": kind, "hosts": hosts, "resumed_iteration": it,
            "n_hosts": len(live), "restore_seconds": dt,
            "group_seconds": gt})
        return it

    # Leaving the with-block joins the outstanding save: on a rank that
    # leaves the job too, so a writer that dies finishes its write first.
    try:
        with CheckpointManager(elastic.checkpoint_dir, keep=elastic.keep,
                               async_save=elastic.async_save) as mgr:
            it = 0
            while it < cfg.iterations:
                if injector is not None:
                    dead = sorted({h for t in range(it + 1, it + seg_len + 1)
                                   for h in injector.check(t)
                                   if h in live})
                    if dead:
                        for h in dead:
                            live.remove(h)
                            if monitor is not None:
                                monitor.drop_host(h)
                        if not live:
                            raise RuntimeError("all hosts lost")
                        events.append(
                            f"hosts {dead} failed in segment after iteration "
                            f"{it} — segment work lost")
                        if me in dead:
                            return SolverResult(x=None, objective=None,
                                                aux={"elastic": report(True)})
                        it = recover(mgr, "failure", dead,
                                     f"failure of hosts {dead}")
                        continue

                H_seg = min(seg_len, cfg.iterations - it)
                cfg_seg = dataclasses.replace(cfg, iterations=H_seg)
                t0 = time.perf_counter()
                res = core_api.solve_sharded(
                    problem, cfg_seg, current, family=fam,
                    x0=x0 if (it == 0 and state is None) else None,
                    state=state)
                if res.x.is_cuda:
                    torch.cuda.synchronize(res.x.device)
                seg_seconds = time.perf_counter() - t0
                state = res.aux["state"]
                traces.append({"start": it, "objs": res.objective})
                it = int(state.iteration)
                if me == live[0]:
                    mgr.save(it, dict(state.carry), specs,
                             extra={"iteration": it, "family": fam.name,
                                    "seed": cfg.seed, "s": cfg.s,
                                    "accelerated": cfg.accelerated,
                                    "n_hosts": len(live)})
                saved = it
                seg_index += 1

                if monitor is not None:
                    times = (host_times(seg_index - 1, list(live))
                             if host_times is not None
                             else {h: seg_seconds for h in live})
                    actions = monitor.record(times)
                    evict = sorted(h for h, a in actions.items()
                                   if a == "evict" and h in live)
                    if evict and len(evict) < len(live):
                        for h in evict:
                            live.remove(h)
                            monitor.drop_host(h)
                        events.append(
                            f"hosts {evict} evicted as stragglers after "
                            f"iteration {it}")
                        if me in evict:
                            return SolverResult(x=None, objective=None,
                                                aux={"elastic": report(True)})
                        it = recover(mgr, "evict", evict,
                                     f"eviction of hosts {evict}")
                    elif any(a == "rebalance" for a in actions.values()):
                        rebalances.append({
                            "iteration": it,
                            "hosts": sorted(h for h, a in actions.items()
                                            if a == "rebalance"),
                            "microbatch_weights":
                                monitor.microbatch_weights()})
    finally:
        if made is not None:
            dist.destroy_process_group(made)

    objective = torch.cat([t["objs"] for t in traces])
    res.aux["state"] = state
    res.aux["elastic"] = report(False)
    return SolverResult(x=res.x, objective=objective, aux=res.aux)
