"""Collective-budget verification (the port of
``repro/analysis/collectives.py``).

The paper's structural invariant: every outer iteration of an SA solver
issues exactly ONE fused all-reduce of the (s mu)^2 Gram / (m, s mu)
cross block and nothing else (Table I). ``repro`` reads it off the jaxpr
of the traced sharded solve; the port runs the sharded solve
(``api.solve_sharded``) over a one-rank group under a
:class:`~repro_torch.analysis.record.Recorder`, which sees every ``c10d``
operation at dispatch and sorts it by the outer iterations the solvers
mark (``seams.outer_loop``):

  * ``per_iteration``: the collectives of an outer iteration (the most of
    each kind any one iteration issued; ``outer`` keeps every
    iteration's), the budgeted hot path;
  * ``amortized``: those outside every outer iteration (setup);
  * ``end_gathers``: the sharded backend's ``linalg.pgather`` of the
    partition-layout outputs at the end of a solve, the port's explicit
    form of what ``repro``'s ``out_specs`` assemble without a jaxpr
    equation. They are amortized (once per solve) and the only
    collectives allowed outside the budget; they are kept apart from
    ``amortized`` so that it compares with ``repro``'s.

The contract is checked per outer iteration: each holds exactly one
all-reduce and no other collective. Payload bytes ride along.

``repro``'s ``compiled_collective_stats`` (post-SPMD HLO) has no
counterpart: there is no HLO.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.common import (Diagnostic, bench_shape,
                                         certification_problem,
                                         family_variants, one_rank_group,
                                         variant_config)
from repro_torch.analysis.record import COLLECTIVE_PRIMS, KINDS, Recorder
from repro_torch.core.types import ProblemFamily, SolverConfig

__all__ = ["COLLECTIVE_PRIMS", "CollectiveBudget", "BudgetRow",
           "BUDGET_SHAPES", "budget_rows", "check_collectives",
           "collective_budget", "solver_collective_budget",
           "recorded_solve"]


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Counts and all-reduce payload bytes of one recorded solve.

    per_iteration: the collectives of an outer iteration, by kind (the
        most any iteration issued). amortized: those outside every outer
        iteration. per_iteration_bytes / amortized_bytes: the all-reduce
        payload bytes of an outer iteration (the most any issued) / of
        the setup. outer: every outer iteration's counts, in order.
    end_gathers / end_gather_bytes: the end-of-solve all-gathers (see the
        module docstring).
    """

    per_iteration: Dict[str, int]
    amortized: Dict[str, int]
    per_iteration_bytes: float
    amortized_bytes: float
    outer: Tuple[Dict[str, int], ...] = ()
    end_gathers: int = 0
    end_gather_bytes: float = 0.0

    @property
    def total(self) -> Dict[str, int]:
        """Collectives per solve by kind, the end gathers included."""
        out = {k: sum(it[k] for it in self.outer) + self.amortized[k]
               for k in KINDS}
        out["all-gather"] += self.end_gathers
        return out


def collective_budget(rec: Recorder) -> CollectiveBudget:
    """The budget of a recorded solve."""
    outer = tuple(dict(t.collectives) for t in rec.outer)
    return CollectiveBudget(
        per_iteration={k: max((it[k] for it in outer), default=0)
                       for k in KINDS},
        amortized=dict(rec.setup.collectives),
        per_iteration_bytes=max((t.allreduce_bytes for t in rec.outer),
                                default=0.0),
        amortized_bytes=rec.setup.allreduce_bytes,
        outer=outer,
        end_gathers=sum(rec.end.collectives.values()),
        end_gather_bytes=rec.end.gather_bytes)


def recorded_solve(fam: ProblemFamily, cfg: SolverConfig, problem,
                   narrowing: bool = False) -> Recorder:
    """Run ``problem``'s sharded solve under ``cfg`` over a one-rank
    group (``common.one_rank_group`` on ``cfg.device``) inside a
    :class:`Recorder`; returns the recorder."""
    from repro_torch.core.api import solve_sharded
    with one_rank_group(cfg.device) as group:
        rec = Recorder(narrowing=narrowing)
        with rec:
            solve_sharded(problem, cfg, group, family=fam)
    return rec


def solver_collective_budget(fam: ProblemFamily, cfg: SolverConfig,
                             m: Optional[int] = None,
                             n: Optional[int] = None,
                             dtype=None, operand=None) -> CollectiveBudget:
    """The collective budget of one family x config sharded solve on
    ``cfg.device``, at (m, n) (default: ``bench_shape``) or on a sparse
    ``operand``."""
    bm, bn = bench_shape(fam)
    problem = certification_problem(
        fam, m or bm, n or bn, dtype or cfg.dtype, cfg.device, operand)
    return collective_budget(recorded_solve(fam, cfg, problem))


def budget_diags(where: str, cfg: SolverConfig,
                 budget: CollectiveBudget) -> List[Diagnostic]:
    """The per-outer-iteration contract on one budget: every outer
    iteration holds exactly ONE all-reduce and no other collective, and
    nothing outside them but the end gathers."""
    diags: List[Diagnostic] = []
    if len(budget.outer) != cfg.outer_iterations:
        diags.append(Diagnostic(
            "collectives", "error", where,
            f"{len(budget.outer)} outer iterations marked, expected "
            f"ceil(H/s) = {cfg.outer_iterations} — a solver loop runs "
            f"outside seams.outer_loop"))
    bad_ar = [(i, it["all-reduce"]) for i, it in enumerate(budget.outer)
              if it["all-reduce"] != 1]
    if bad_ar:
        shown = ", ".join(f"#{i}: {n}" for i, n in bad_ar[:4])
        diags.append(Diagnostic(
            "collectives", "error", where,
            f"expected exactly ONE all-reduce per outer iteration, found "
            f"another count in {len(bad_ar)} of {len(budget.outer)} "
            f"({shown}; s={cfg.s}, mu={cfg.block_size}) — the SA "
            f"contract (Table I) is one fused Gram/cross all-reduce and "
            f"nothing else"))
    for op in KINDS[1:]:
        hits = [i for i, it in enumerate(budget.outer) if it[op]]
        if hits:
            diags.append(Diagnostic(
                "collectives", "error", where,
                f"{sum(budget.outer[i][op] for i in hits)} {op} op(s) in "
                f"{len(hits)} outer iteration(s): the SA solvers must not "
                f"{op} — every exchanged value rides the one fused "
                f"all-reduce"))
    extra = {k: v for k, v in budget.amortized.items() if v}
    if extra:
        diags.append(Diagnostic(
            "collectives", "error", where,
            f"collectives {extra} outside every outer iteration (H="
            f"{cfg.iterations}, s={cfg.s}): setup must not communicate "
            f"for a zero-initialized solve; only the end-of-solve gathers "
            f"may"))
    return diags


def check_collectives(fam: ProblemFamily,
                      variants: Optional[Tuple[str, ...]] = None,
                      iterations: int = 16, device="cuda"
                      ) -> Tuple[List[Diagnostic], List[str]]:
    """The per-outer-iteration collective budget of every registered
    variant of ``fam``, solved on ``device``. Returns (diagnostics,
    checked subjects); payload bytes ride along as info."""
    diags: List[Diagnostic] = []
    checked: List[str] = []
    with one_rank_group(device):
        for variant in variants or family_variants(fam):
            where = f"{fam.name}:{variant}"
            checked.append(where)
            cfg = variant_config(fam, variant, iterations=iterations,
                                 device=device)
            budget = solver_collective_budget(fam, cfg)
            diags.extend(budget_diags(where, cfg, budget))
            diags.append(Diagnostic(
                "collectives", "info", where,
                f"all-reduce payload {budget.per_iteration_bytes:.0f} B "
                f"per outer iteration x {len(budget.outer)} outer "
                f"iterations; {budget.end_gathers} end gather(s) of "
                f"{budget.end_gather_bytes:.0f} B"))
    return diags, checked


@dataclasses.dataclass(frozen=True)
class BudgetRow:
    """One (family, s) row of the collective-budget report."""

    family: str
    s: int
    iterations: int
    budget: CollectiveBudget

    @property
    def allreduces_in_loop(self) -> int:
        return self.budget.per_iteration["all-reduce"]

    @property
    def other_collectives(self) -> int:
        return sum(v for k, v in self.budget.per_iteration.items()
                   if k != "all-reduce") \
            + sum(v for k, v in self.budget.amortized.items()
                  if k != "all-reduce")

    @property
    def trips(self) -> int:
        return -(-self.iterations // self.s)

    @property
    def runtime_messages(self) -> int:
        return sum(it["all-reduce"] for it in self.budget.outer) \
            + self.budget.amortized["all-reduce"]

    @property
    def bytes_per_outer(self) -> float:
        return self.budget.per_iteration_bytes


# repro's report shapes.
BUDGET_SHAPES = {"row": (512, 128), "col": (256, 512)}


def budget_rows(families: Optional[Tuple[str, ...]] = None,
                s_values: Tuple[int, ...] = (1, 4, 16),
                iterations: int = 64,
                shapes: Optional[Dict[str, Tuple[int, int]]] = None,
                device="cuda") -> Dict[Tuple[str, int], BudgetRow]:
    """The per-(family, s) collective-budget rows: each registered
    family's default (accelerated where it has it) solve at each s, at
    ``repro``'s report shapes, on ``device``."""
    from repro_torch.core.api import FAMILIES
    shapes = shapes or BUDGET_SHAPES
    rows: Dict[Tuple[str, int], BudgetRow] = {}
    with one_rank_group(device):
        for name in sorted(families or FAMILIES):
            fam = FAMILIES[name]
            m, n = shapes[fam.partition]
            for s in s_values:
                cfg = SolverConfig(block_size=fam.bench_block_size,
                                   iterations=iterations, s=s,
                                   track_objective=False, device=str(device))
                rows[(name, s)] = BudgetRow(
                    family=name, s=s, iterations=iterations,
                    budget=solver_collective_budget(fam, cfg, m=m, n=n))
    return rows
