"""The unified solver facade: ``repro_torch.api.solve(problem, cfg)``
(the port of ``repro/core/api.py``, local backend).

The family is inferred from the problem's type (plus its ``accepts``
hook) or forced with ``family="..."``; ``cfg.s`` and ``cfg.accelerated``
pick the variant inside the family, and ``cfg.device`` where it runs.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.types import (FAMILIES, ProblemFamily, SolveState,
                                    SolverConfig, SolverResult)

# Importing a family module registers it in FAMILIES.
import repro_torch.core.lasso  # noqa: F401  (registers "lasso")
import repro_torch.core.svm  # noqa: F401  (registers "svm")

__all__ = ["solve", "resolve_family", "families", "BACKENDS"]


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


def _local_backend(fam: ProblemFamily, problem, cfg: SolverConfig, *,
                   x0=None, state=None) -> SolverResult:
    kw = {} if state is None else {"state": state}
    return fam.solve(problem, cfg, x0=x0, **kw)


def _sharded_backend(fam, problem, cfg, *, x0=None, state=None):
    raise NotImplementedError(
        "backend='sharded' is not ported yet: it is the next slice of the "
        "port (ROADMAP.md, Queue 1, 'Sharded backend' over NCCL)")


BACKENDS: Dict[str, Callable] = {
    "local": _local_backend,
    "sharded": _sharded_backend,
}


def solve(problem, cfg: Optional[SolverConfig] = None,
          backend: str = "local", *,
          family: Optional[object] = None, x0=None,
          state: Optional[SolveState] = None,
          tune: Optional[str] = None,
          callbacks: Optional[Sequence[Callable]] = None) -> SolverResult:
    """Solve a registered problem family.

    problem:  a registered problem dataclass (LassoProblem, SVMProblem);
              its type picks the family. A, dense or a SparseOperand.
              An SVMProblem with a kernel other than "linear" raises
              NotImplementedError (the kernel-SVM family is not ported).
    cfg:      SolverConfig (defaults to ``SolverConfig()``, on the card).
    backend:  "local" ("sharded" is a later slice and raises).
    family:   optional explicit family name, overriding type inference.
    x0:       optional warm start in the family's iterate space.
    state:    optional :class:`SolveState` from a previous solve's
              ``result.aux["state"]`` (or ``convert.state_from_numpy``)
              — resumes the full recurrence state; exclusive with x0.
    tune:     the autotuner is not ported yet; anything but None/"off"
              raises.
    callbacks: callables invoked as ``cb(result)`` after the solve.
    """
    fam = resolve_family(problem, family)
    if cfg is None:
        cfg = SolverConfig()
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; registered: {sorted(BACKENDS)}")
    if tune not in (None, False, "off"):
        raise NotImplementedError(
            "tune= is not ported yet (ROADMAP.md, Queue 1, 'Cost model, "
            "tuner, CLI and benchmarks')")
    result = BACKENDS[backend](fam, problem, cfg, x0=x0, state=state)
    for cb in callbacks or ():
        cb(result)
    return result
