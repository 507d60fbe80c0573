"""The unified solver facade: ``repro_torch.api.solve(problem, cfg)``
(the port of ``repro/core/api.py``).

The family is inferred from the problem's type (plus its ``accepts``
hook) or forced with ``family="..."``; ``cfg.s`` and ``cfg.accelerated``
pick the variant inside the family, and ``cfg.device`` where it runs.
The backend says how: ``"local"`` on one process, ``"sharded"`` split
over the ranks of a ``torch.distributed`` process group by the family's
declared partition axis (:func:`solve_sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.core import linalg
from repro_torch.core.sparse_exec import pad_slice, shard_operand
from repro_torch.core.types import (FAMILIES, ProblemFamily, SolveState,
                                    SolverConfig, SolverResult)

# Importing a family module registers it in FAMILIES.
import repro_torch.core.lasso  # noqa: F401  (registers "lasso")
import repro_torch.core.svm  # noqa: F401  (registers "svm")
import repro_torch.core.kernel_svm  # noqa: F401  (registers "ksvm")
import repro_torch.core.logreg  # noqa: F401  (registers "logreg")
import repro_torch.core.sfista  # noqa: F401  (registers "sfista")

__all__ = ["solve", "solve_sharded", "resolve_family", "families",
           "BACKENDS"]


def families() -> Tuple[str, ...]:
    """Registered family names, sorted."""
    return tuple(sorted(FAMILIES))


def resolve_family(problem=None, family: Optional[object] = None
                   ) -> ProblemFamily:
    """Resolve a family from an explicit name or the problem's type."""
    if family is not None:
        if isinstance(family, ProblemFamily):
            return family
        if family not in FAMILIES:
            raise ValueError(
                f"unknown family {family!r}; registered: {sorted(FAMILIES)}")
        return FAMILIES[family]
    matched = [f for f in FAMILIES.values() if f.matches(problem)]
    if not matched:
        raise ValueError(
            f"no registered problem family handles "
            f"{type(problem).__name__}; registered: {sorted(FAMILIES)}")
    if len(matched) > 1:
        raise ValueError(
            f"problem matches several families "
            f"({sorted(f.name for f in matched)}); disambiguate with "
            f"family=...")
    return matched[0]


def _default_group(group=None):
    """``group``, or the default process group when it is None; raises
    ValueError when there is none."""
    if group is not None:
        return group
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "backend='sharded' needs a torch.distributed process group: "
            "call torch.distributed.init_process_group first (torchrun, or "
            "repro_torch.core.distributed.run_ranks), or pass group=")
    return dist.group.WORLD


# ---------------------------------------------------------------------------
# The sharded backend: ONE implementation of the pad/shard/gather plumbing,
# parameterized by the family's declared partition axis.
# ---------------------------------------------------------------------------

def solve_sharded(problem, cfg: SolverConfig, group=None,
                  family: Optional[object] = None, x0=None,
                  state: Optional[SolveState] = None) -> SolverResult:
    """Distributed solve of any registered family; every rank of
    ``group`` (the default process group when None) calls it with the
    same full problem and config.

    Pads the partitioned axis of A (rows for "row" families, columns for
    "col") to a multiple of the world size with zeros, which is exact:
    padded rows or columns add 0 to every Gram and projection block, and
    their state coordinates stay 0. This rank keeps its block of that
    axis: a view of a dense A where it needs no padding, or a
    ``SparseOperand`` of its own with shard-local indices, built on the
    operand's device. It runs the family's solver on it with
    ``group=``, so each outer iteration of an SA solve makes one
    ``linalg.preduce`` of its fused Gram/projection block (a tracked
    Lasso objective one more), and every rank draws the same blocks from
    the same seed. At the end the partition-layout outputs (the SVM's x,
    the Lasso's residual, the state's partition leaves) are gathered
    once and unpadded; the replicated ones are this rank's own.

    ``state``: a LOGICAL (unpadded) :class:`SolveState` of a previous
    solve on any world size, sharded as the problem is, so a state saved
    at one world size resumes on another; the returned
    ``aux["state"]`` is logical again.
    """
    fam = resolve_family(problem, family)
    group = _default_group(group)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    axis = 0 if fam.partition == "row" else 1
    orig = problem.A.shape[axis]
    size = -(-orig // world)
    lo = rank * size
    local = dataclasses.replace(
        problem, A=shard_operand(problem.A, axis, lo, size),
        b=pad_slice(problem.b, 0, lo, size) if axis == 0 else problem.b)
    if x0 is not None and fam.x0_layout == "partition":
        x0 = pad_slice(x0, 0, lo, size)
    layout = fam.state_layout(cfg) if fam.state_layout is not None else ()
    kw = {}
    if state is not None:
        if not layout:
            raise ValueError(f"family {fam.name!r} declares no state_layout"
                             f" — it cannot resume from a SolveState")
        kw["state"] = SolveState(int(state.iteration), {
            name: pad_slice(state.carry[name], 0, lo, size)
            if lay == "partition" else state.carry[name]
            for name, lay in layout})
    res = fam.solve(local, cfg, x0=x0, group=group, **kw)

    def gathered(v):
        return linalg.pgather(v, group)[:orig]

    partition = {k for k, lay in fam.aux_out if lay == "partition"}
    aux = {k: gathered(v) if k in partition else v
           for k, v in res.aux.items() if k != "state"}
    if layout:
        st = res.aux["state"]
        aux["state"] = SolveState(st.iteration, {
            name: gathered(st.carry[name]) if lay == "partition"
            else st.carry[name] for name, lay in layout})
    x = gathered(res.x) if fam.partition == "col" else res.x
    return SolverResult(x=x, objective=res.objective, aux=aux)


# ---------------------------------------------------------------------------
# The facade.
# ---------------------------------------------------------------------------

def _local_backend(fam: ProblemFamily, problem, cfg: SolverConfig, *,
                   group=None, x0=None, state=None) -> SolverResult:
    if group is not None:
        raise ValueError("group= is the sharded backend's; pass "
                         "backend='sharded'")
    kw = {} if state is None else {"state": state}
    return fam.solve(problem, cfg, x0=x0, **kw)


def _sharded_backend(fam: ProblemFamily, problem, cfg: SolverConfig, *,
                     group=None, x0=None, state=None) -> SolverResult:
    return solve_sharded(problem, cfg, group, family=fam, x0=x0,
                         state=state)


BACKENDS: Dict[str, Callable] = {
    "local": _local_backend,
    "sharded": _sharded_backend,
}


def solve(problem, cfg: Optional[SolverConfig] = None,
          backend: str = "local", *,
          family: Optional[object] = None, x0=None,
          state: Optional[SolveState] = None, group=None,
          mesh=None, axes=None,
          tune: Optional[str] = None,
          callbacks: Optional[Sequence[Callable]] = None) -> SolverResult:
    """Solve a registered problem family.

    problem:  a registered problem dataclass (LassoProblem, SVMProblem,
              LogRegProblem, SFISTAProblem); its type picks the family,
              and an SVMProblem's kernel picks "svm" (linear) or "ksvm"
              (any other). A, dense or a SparseOperand.
    cfg:      SolverConfig (defaults to ``SolverConfig()``, on the card).
    backend:  "local" (one process) or "sharded" (:func:`solve_sharded`
              over ``group``; every rank calls it with the same problem).
    family:   optional explicit family name, overriding type inference.
    x0:       optional warm start in the family's iterate space.
    state:    optional :class:`SolveState` from a previous solve's
              ``result.aux["state"]`` (or ``convert.state_from_numpy``)
              — resumes the full recurrence state; exclusive with x0. On
              the sharded backend it is logical (unpadded), so it may
              come from a solve on another world size.
    group:    the sharded backend's ``torch.distributed`` process group;
              None means the default group, which must be initialised.
    mesh, axes: ``repro``'s JAX mesh arguments, which have no counterpart
              here: passing either raises ValueError (a group spans all
              the ranks it reduces over).
    tune:     ``"auto"`` replaces cfg's tunables (s, block_size,
              symmetric_gram) with ``repro_torch.tune.autotune``'s
              calibrated-model selection before solving — iterations,
              dtype, device, seed etc. are preserved. The pilot solves
              run on ``cfg.device`` through the same kernels, and the
              calibrated machine is cached per host, device and regime
              under ``results/tuned/`` (``torch-`` keys), so only the
              first solve of a regime pays them. The config actually
              used lands in ``result.aux["tuned_config"]``. Local
              backend only (ValueError on the sharded one: the pilot
              solves run unsharded); None/"off" solves cfg as given.
    callbacks: callables invoked as ``cb(result)`` after the solve.
    """
    fam = resolve_family(problem, family)
    if cfg is None:
        cfg = SolverConfig()
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; registered: {sorted(BACKENDS)}")
    if mesh is not None or axes is not None:
        raise ValueError(
            "mesh=/axes= name a JAX mesh, which the port does not have: "
            "the sharded backend reduces over a torch.distributed process "
            "group (group=)")
    tuned = False
    if tune not in (None, False, "off"):
        if tune not in ("auto", True):
            raise ValueError(
                f"unknown tune mode {tune!r}; expected 'auto' (or "
                f"None/'off' to solve cfg as given)")
        if backend != "local":
            # the pilot solves run unsharded at P=1: applying that to a
            # sharded solve would tune for the wrong topology.
            raise ValueError(
                "tune='auto' only supports backend='local' (pilot "
                "solves run unsharded at P=1); for a sharded solve, "
                "call repro_torch.tune.select_config with a calibrated "
                "Machine and P = the world size")
        from repro_torch import tune as tune_mod
        cfg = tune_mod.autotune(problem, cfg, family=fam)
        tuned = True
    result = BACKENDS[backend](fam, problem, cfg, group=group, x0=x0,
                               state=state)
    if tuned:
        result.aux["tuned_config"] = cfg
    for cb in callbacks or ():
        cb(result)
    return result
