"""repro_torch.analysis — the static contracts of the SA solvers, for
eager PyTorch (the port of ``repro.analysis``).

Seven passes; the solver passes enumerate the ``FAMILIES`` registry, so
a new family or variant is covered with no analyzer edit:

  * ``collectives`` — exactly ONE all-reduce in every outer iteration and
    no other collective, with payload bytes (``collectives.py``);
  * ``replication`` — every output the sharded solve declares replicated
    is bit-equal on two ranks (``replication.py``);
  * ``dtypes``      — no silent f64 -> f32 narrowing in an f64 solve,
    nor a kernel body that computes in f32 (``dtypes.py``);
  * ``costs``       — each family's Table I cost hook certified against
    the flops, words and messages counted on its solves, dense and
    SparseOperand, across an s-grid (``costs.py``);
  * ``kernels``     — the hand-written kernels' guard drift, plan
    injectivity and bounds (``kernels.py``);
  * ``lint``        — AST lint of ``src/repro_torch`` (raw collectives,
    ambient RNG, bare asserts) (``lint.py``);
  * ``registry``    — each engine program's carry against its family's
    state layout (``lint.py``).

Where ``repro`` walks a jaxpr, the solver passes run the solve on a
one-rank group under a recorder (``record.py``) that counts at dispatch
and at the seams of ``repro_torch.seams``: they run on the card unless
the caller passes ``device="cpu"``, and raise without one.

Entry points: :func:`check_all` in-process, ``python -m
repro_torch.analysis`` on the command line (``--json`` for the
machine-readable report), and ``tune.select_config(certified=True)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.collectives import (COLLECTIVE_PRIMS, BudgetRow,
                                              CollectiveBudget, budget_rows,
                                              check_collectives,
                                              collective_budget,
                                              solver_collective_budget)
from repro_torch.analysis.common import (AnalysisReport, Diagnostic,
                                         SEVERITIES, family_variants,
                                         one_rank_group, variant_config)
from repro_torch.analysis.costs import (CostCount, CostRow, CostTolerance,
                                        certification_operand, check_costs,
                                        cost_count, cost_ratio_rows,
                                        cost_tolerance, solver_cost_count)
from repro_torch.analysis.dtypes import check_dtypes, find_float_narrowing
from repro_torch.analysis.kernels import (check_kernels, guard_drift_diags,
                                          index_map_bounds_diags,
                                          output_injectivity_diags)
from repro_torch.analysis.lint import check_registry, lint_paths, lint_source
from repro_torch.analysis.record import Recorder
from repro_torch.analysis.replication import (check_replication,
                                              check_replication_families)

CHECKS = ("collectives", "replication", "dtypes", "costs", "kernels",
          "lint", "registry")

__all__ = [
    "AnalysisReport", "BudgetRow", "CHECKS", "COLLECTIVE_PRIMS",
    "CollectiveBudget", "CostCount", "CostRow", "CostTolerance",
    "Diagnostic", "Recorder", "SEVERITIES", "budget_rows",
    "certification_operand", "check_all", "check_collectives",
    "check_costs", "check_dtypes", "check_kernels", "check_registry",
    "check_replication", "check_replication_families",
    "collective_budget", "cost_count", "cost_ratio_rows",
    "cost_tolerance", "family_variants", "find_float_narrowing",
    "guard_drift_diags", "index_map_bounds_diags", "lint_paths",
    "lint_source", "one_rank_group",
    "output_injectivity_diags", "solver_collective_budget",
    "solver_cost_count", "variant_config",
]


def check_all(checks: Optional[Sequence[str]] = None,
              families: Optional[Sequence[str]] = None,
              variants: Optional[Sequence[str]] = None,
              device="cuda") -> AnalysisReport:
    """Run the selected passes (default: all) over the selected
    registered families (default: all) on ``device`` and merge the
    findings.

    ``variants`` filters the per-family solver passes to the named
    variants (each family keeps only the names it registers; a name no
    selected family registers is an error). The registry-wide passes
    (``lint``, ``registry``, ``kernels``) ignore the filter. The solver
    passes share one one-rank group; ``replication`` runs every selected
    family in one two-rank job.
    """
    from repro_torch.core.api import FAMILIES
    from repro_torch.core.types import resolve_device
    checks = tuple(checks or CHECKS)
    unknown = set(checks) - set(CHECKS)
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)}; "
                         f"available: {CHECKS}")
    fams = []
    for name in families or sorted(FAMILIES):
        if name not in FAMILIES:
            raise ValueError(f"unknown family {name!r}; registered: "
                             f"{sorted(FAMILIES)}")
        fams.append(FAMILIES[name])
    if variants is not None:
        registered = {v for fam in fams for v in fam.variants}
        missing = set(variants) - registered
        if missing:
            raise ValueError(
                f"variant(s) {sorted(missing)} registered by no "
                f"selected family; available: {sorted(registered)}")
    resolve_device(device)

    subjects = []
    for fam in fams:
        sel = None
        if variants is not None:
            sel = tuple(v for v in family_variants(fam) if v in variants)
            if not sel:
                continue
        subjects.append((fam, sel))

    report = AnalysisReport()

    def add(check, result):
        diags, checked = result
        report.extend(diags)
        report.checked.extend(f"{check}:{c}" for c in checked)

    per_family = {"collectives": check_collectives,
                  "dtypes": check_dtypes,
                  "costs": check_costs}
    with one_rank_group(device):
        for check in checks:
            if check in per_family:
                for fam, sel in subjects:
                    add(check, per_family[check](fam, variants=sel,
                                                 device=device))
    for check in checks:
        if check == "replication":
            add(check, check_replication_families(subjects, device=device))
        elif check == "kernels":
            add(check, check_kernels())
        elif check == "lint":
            add(check, lint_paths())
        elif check == "registry":
            add(check, check_registry())
    return report
