"""Table I cost certification (the port of ``repro/analysis/costs.py``).

The collectives pass proves the structural half of the paper's claim;
this pass proves the cost half: the F/W/L entries of Table I, which
``repro_torch.tune`` trusts through the per-family ``costs`` hooks, match
the work a solve actually does. For every registered family x variant
it:

  * runs the sharded solve over a one-rank group under a
    :class:`~repro_torch.analysis.record.Recorder` (``repro`` walks the
    traced jaxpr) and counts flops in ``repro``'s convention (2 x output
    x contraction for each product, the update elements of each
    scatter-add) and the all-reduce payload words and messages, split by
    outer iteration. A kernel call counts its seam's event, whether the
    plain version (the CPU) or the kernel (the card) runs, so both
    devices count the same;
  * evaluates the family's ``costs`` hook at the same (dims, s, mu, P=1)
    and certifies counted F and W inside a declared per-family band of
    the modeled terms;
  * sweeps SA variants over an s grid: the counted/modeled ratio must
    not drift across it (a wrong s exponent drifts by s_max/s_min = 16),
    and the all-reduce messages must equal ceil(H/s);
  * solves again on a :class:`SparseOperand` and certifies the products
    count O(nnz), not O(mn): sparse flops within ``sparse_factor`` x
    density of the dense count.

The certification constants, tolerances and bands are ``repro``'s,
verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.collectives import recorded_solve
from repro_torch.analysis.common import (Diagnostic, certification_problem,
                                         family_variants, one_rank_group,
                                         variant_config)
from repro_torch.analysis.record import Recorder
from repro_torch.core.types import ProblemFamily, SolverConfig, SparseOperand

__all__ = ["CERT_SHAPES", "CERT_ITERATIONS", "CERT_S_GRID", "CERT_DENSITY",
           "CostTolerance", "COST_TOLERANCES", "cost_tolerance",
           "CostCount", "cost_count", "solver_cost_count",
           "certification_operand", "CostRow", "cost_ratio_rows",
           "check_costs"]

# Certification shapes: large enough that the model's leading terms
# dominate its dropped lower-order ones (at the 64x32 bench shapes the
# +1/+2 appended projection columns alone drift the ratio), small
# enough that tracing all families x variants x s stays ~1 s total.
CERT_SHAPES = {"row": (384, 128), "col": (128, 384)}
CERT_ITERATIONS = 48            # divisible by every s in the grid
CERT_S_GRID = (1, 4, 16)
CERT_DENSITY = 0.08


@dataclasses.dataclass(frozen=True)
class CostTolerance:
    """Per-family certification tolerances (see module docstring).

    f_band / w_band: admissible counted/modeled ratio for the F and W
        terms at every s on the grid.
    drift: admissible (max ratio)/(min ratio) across the s grid — the
        s-scaling detector. A hook whose F carries one extra (or one
        missing) power of s drifts by (s_max/s_min) = 16 on the default
        grid; a wrong s^2 drifts by 256.
    mu: certification block size override (None = the family's
        bench_block_size). svm certifies at mu=4: at its bench mu=1 the
        O(s mu n) deferred GEMVs the model drops are the SAME order as
        the modeled mu^2 s n Gram term, which inflates the ratio ~3x
        at s=1 and fakes a drift.
    sparse_factor: admissible counted-sparse / (density x counted-dense)
        flop ratio — the O(nnz)-not-O(mn) certificate, with headroom
        for blocked-ELL width padding.
    """

    f_band: Tuple[float, float] = (0.4, 8.0)
    w_band: Tuple[float, float] = (0.4, 4.0)
    drift: float = 2.5
    mu: Optional[int] = None
    sparse_factor: float = 4.0


COST_TOLERANCES: Dict[str, CostTolerance] = {
    "svm": CostTolerance(mu=4),
}


def cost_tolerance(family_name: str) -> CostTolerance:
    """The declared tolerance for a family — defaults for any family
    not listed in :data:`COST_TOLERANCES` (zero per-family wiring)."""
    return COST_TOLERANCES.get(family_name, CostTolerance())


@dataclasses.dataclass(frozen=True)
class CostCount:
    """Counted costs of one recorded solve.

    flops: total flops (2 x output x contraction for each product, update
        elements for each scatter-add, each kernel seam's event).
    flops_in_loop: the subset issued inside the outer iterations.
    words: all-reduce payload ELEMENTS moved (the model's W is in words).
    messages: all-reduce executions — the model's L at log P = 1.
    allreduces_in_loop: the all-reduces of an outer iteration (the most
        any one issued).
    kernel_flops: the flops of the kernel seams, by "kernel.entry"
        ("spmm.ell_spmm", "gram.gram_fused", ...).
    """

    flops: float
    flops_in_loop: float
    words: float
    messages: float
    allreduces_in_loop: int
    kernel_flops: Mapping[str, float] = dataclasses.field(
        default_factory=dict)


def cost_count(rec: Recorder) -> CostCount:
    """The counted costs of a recorded solve."""
    spans = rec.spans()
    return CostCount(
        flops=sum(t.flops for t in spans),
        flops_in_loop=sum(t.flops for t in rec.outer),
        words=sum(t.allreduce_elements for t in spans),
        messages=float(sum(t.collectives["all-reduce"] for t in spans)),
        allreduces_in_loop=max(
            (t.collectives["all-reduce"] for t in rec.outer), default=0),
        kernel_flops=rec.kernel_flops())


def solver_cost_count(fam: ProblemFamily, cfg: SolverConfig,
                      m: Optional[int] = None, n: Optional[int] = None,
                      dtype=None,
                      operand: Optional[SparseOperand] = None
                      ) -> CostCount:
    """The counted costs of one family x config sharded solve on
    ``cfg.device`` (dense (m, n), default the certification shape, or
    the sparse path when ``operand`` is given)."""
    if operand is None and (m is None or n is None):
        m, n = CERT_SHAPES[fam.partition]
    problem = certification_problem(fam, m, n, dtype or cfg.dtype,
                                    cfg.device, operand)
    return cost_count(recorded_solve(fam, cfg, problem))


def certification_operand(fam: ProblemFamily,
                          density: float = CERT_DENSITY
                          ) -> SparseOperand:
    """A deterministic sparse operand at the family's certification
    shape, on the CPU: row i holds ~density x n nonzeros at evenly
    strided columns with values cycling over a small fixed set (the
    matrix of ``repro``'s ``certification_operand``)."""
    m, n = CERT_SHAPES[fam.partition]
    k = max(1, int(round(density * n)))
    step = max(n // k, 1)
    dense = np.zeros((m, n), np.float32)
    for i in range(m):
        for j in range(k):
            dense[i, (i + j * step) % n] = 1.0 + 0.25 * ((i * k + j) % 7)
    return SparseOperand.from_dense(dense)


@dataclasses.dataclass(frozen=True)
class CostRow:
    """One certification point: family x variant x s, counted vs
    modeled. ``sparse_flops``/``density`` are None when the sparse solve
    was not taken; ``sparse_spmm_flops`` is K4's share of
    ``sparse_flops`` (``repro``'s jaxpr walk counts none for its
    ``ell_spmm_ref``, a scan of elementwise multiply-adds)."""

    family: str
    variant: str
    s: int
    mu: int
    flops: float
    model_flops: float
    words: float
    model_words: float
    messages: float
    outer: int
    allreduces_in_loop: int
    sparse_flops: Optional[float] = None
    density: Optional[float] = None
    sparse_spmm_flops: Optional[float] = None

    @property
    def f_ratio(self) -> float:
        return self.flops / max(self.model_flops, 1.0)

    @property
    def w_ratio(self) -> float:
        return self.words / max(self.model_words, 1.0)

    @property
    def sparse_ratio(self) -> Optional[float]:
        """counted-sparse / (density x counted-dense) flops — <= 1 for
        ideal nnz scaling; a dense-shaped sparse path sits at 1/density
        (12.5 at the default density)."""
        if self.sparse_flops is None:
            return None
        return self.sparse_flops / max(self.density * self.flops, 1.0)


def cost_ratio_rows(fam: ProblemFamily,
                    variants: Optional[Sequence[str]] = None,
                    s_grid: Sequence[int] = CERT_S_GRID,
                    iterations: int = CERT_ITERATIONS,
                    sparse: bool = True,
                    tolerance: Optional[CostTolerance] = None,
                    device="cuda") -> List[CostRow]:
    """Solve and count every requested variant of ``fam`` across the s
    grid on ``device`` (classical variants certify at s=1 only) and pair
    each count with the family's modeled costs."""
    from repro_torch.core.cost_model import ProblemDims
    if fam.costs is None:
        raise ValueError(
            f"family {fam.name!r} declares no costs hook — nothing to "
            f"certify (register costs= to enable Table I certification)")
    tol = tolerance if tolerance is not None else cost_tolerance(fam.name)
    mu = tol.mu or fam.bench_block_size
    kern = dict(fam.bench_problem_kwargs).get("kernel", "linear")
    m, n = CERT_SHAPES[fam.partition]
    operand = certification_operand(fam) if sparse else None
    density = (operand.nnz / float(m * n)) if sparse else None
    rows: List[CostRow] = []
    with one_rank_group(device):
        for variant in variants or family_variants(fam):
            grid = tuple(s_grid) if variant.startswith(("sa", "ca")) \
                else (1,)
            for s in grid:
                if iterations % s:
                    raise ValueError(
                        f"iterations={iterations} not divisible by s={s}: "
                        f"the tail group would blur the per-outer split")
                cfg = variant_config(fam, variant, iterations=iterations,
                                     device=device, s=s, block_size=mu)
                count = solver_cost_count(fam, cfg, m=m, n=n)
                model = fam.costs(ProblemDims(m=m, n=n, f=1.0), iterations,
                                  mu, s, 1, kernel=kern)
                sp = None
                if sparse:
                    sp = solver_cost_count(fam, cfg, operand=operand)
                rows.append(CostRow(
                    family=fam.name, variant=variant, s=s, mu=mu,
                    flops=count.flops, model_flops=float(model["F"]),
                    words=count.words, model_words=float(model["W"]),
                    messages=count.messages, outer=cfg.outer_iterations,
                    allreduces_in_loop=count.allreduces_in_loop,
                    sparse_flops=None if sp is None else sp.flops,
                    density=density,
                    sparse_spmm_flops=None if sp is None else
                    sp.kernel_flops.get("spmm.ell_spmm", 0.0)))
    return rows


def _band_diag(where: str, term: str, band: Tuple[float, float],
               offenders: List[Tuple[int, float]]) -> Diagnostic:
    worst = max(offenders,
                key=lambda sr: max(sr[1] / band[1], band[0] / sr[1]))
    return Diagnostic(
        "costs", "error", where,
        f"term {term}: counted/modeled ratio "
        f"{worst[1]:.3g} at s={worst[0]} outside the declared band "
        f"[{band[0]:g}, {band[1]:g}] "
        f"({len(offenders)} of the grid points violate) — the "
        f"registered costs hook does not describe the computed work")


def check_costs(fam: ProblemFamily,
                variants: Optional[Sequence[str]] = None,
                s_grid: Sequence[int] = CERT_S_GRID,
                iterations: int = CERT_ITERATIONS,
                sparse: bool = True,
                tolerance: Optional[CostTolerance] = None,
                device="cuda", rows: Optional[Sequence[CostRow]] = None
                ) -> Tuple[List[Diagnostic], List[str]]:
    """Certify the family's Table I costs hook against its solves on
    ``device``, for every registered variant (or against ``rows``, the
    :func:`cost_ratio_rows` of an earlier call, without solving again).
    Per variant, at most one error per violated term:

      * ``F`` / ``W`` band — counted/modeled outside the declared band
        at some s;
      * ``F``/``W`` ``s-scaling`` — the ratio drifts across the s grid
        beyond the declared drift tolerance (wrong s exponent);
      * ``L`` — all-reduce messages differ from ceil(H/s);
      * ``O(nnz)`` — the sparse solve's flops exceed
        sparse_factor x density x the dense count.

    Returns (diagnostics, checked subjects); counted-vs-modeled ratios
    ride along as info diagnostics per variant either way.
    """
    tol = tolerance if tolerance is not None else cost_tolerance(fam.name)
    diags: List[Diagnostic] = []
    checked: List[str] = []
    if rows is None:
        rows = cost_ratio_rows(fam, variants=variants, s_grid=s_grid,
                               iterations=iterations, sparse=sparse,
                               tolerance=tol, device=device)
    by_variant: Dict[str, List[CostRow]] = {}
    for row in rows:
        by_variant.setdefault(row.variant, []).append(row)
    for variant, vrows in by_variant.items():
        where = f"{fam.name}:{variant}"
        checked.append(where)
        bad_f = [(r.s, r.f_ratio) for r in vrows
                 if not tol.f_band[0] <= r.f_ratio <= tol.f_band[1]]
        if bad_f:
            diags.append(_band_diag(where, "F", tol.f_band, bad_f))
        bad_w = [(r.s, r.w_ratio) for r in vrows
                 if not tol.w_band[0] <= r.w_ratio <= tol.w_band[1]]
        if bad_w:
            diags.append(_band_diag(where, "W", tol.w_band, bad_w))
        if len(vrows) > 1:
            for term, ratios in (
                    ("F", [r.f_ratio for r in vrows]),
                    ("W", [r.w_ratio for r in vrows])):
                drift = max(ratios) / max(min(ratios), 1e-12)
                if drift > tol.drift:
                    diags.append(Diagnostic(
                        "costs", "error", where,
                        f"term {term} s-scaling: counted/modeled ratio "
                        f"drifts {drift:.3g}x across s="
                        f"{[r.s for r in vrows]} (declared tolerance "
                        f"{tol.drift:g}x) — the costs hook carries a "
                        f"wrong s exponent (Table I scales F and W "
                        f"linearly in s for SA variants)"))
        bad_l = [r for r in vrows if r.messages != r.outer]
        if bad_l:
            r = bad_l[0]
            diags.append(Diagnostic(
                "costs", "error", where,
                f"term L: {r.messages:.0f} all-reduce messages at "
                f"s={r.s}, expected ceil(H/s) = {r.outer} — the modeled "
                f"latency must fall as 1/s"))
        bad_nnz = [(r.s, r.sparse_ratio) for r in vrows
                   if r.sparse_ratio is not None
                   and r.sparse_ratio > tol.sparse_factor]
        if bad_nnz:
            s_bad, ratio = max(bad_nnz, key=lambda sr: sr[1])
            diags.append(Diagnostic(
                "costs", "error", where,
                f"term O(nnz): the sparse-operand solve counts {ratio:.3g}x "
                f"(density x dense flops) at s={s_bad}, over the "
                f"declared {tol.sparse_factor:g}x — the hot products "
                f"must cost O(nnz), not O(mn) (Table I's density "
                f"factor f)"))
        summary = "; ".join(
            f"s={r.s}: F {r.f_ratio:.2f}x W {r.w_ratio:.2f}x"
            + (f" nnz {r.sparse_ratio:.2f}x"
               if r.sparse_ratio is not None else "")
            for r in vrows)
        diags.append(Diagnostic(
            "costs", "info", where,
            f"counted/modeled (mu={vrows[0].mu}): {summary}; "
            f"messages = ceil(H/s) at every point"
            if not bad_l else
            f"counted/modeled (mu={vrows[0].mu}): {summary}"))
    return diags, checked
