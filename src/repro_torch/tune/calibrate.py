"""Calibrate the alpha-beta-gamma-kappa machine model against measured
solves (the port of ``repro/tune/calibrate.py``).

The model is linear in the machine parameters:
``T(s, mu) = theta . c(s, mu)`` with ``theta = (gamma, beta, alpha,
kappa)`` and ``c = cost_model.cost_vector(fam.costs(...))``. So
calibration is a nonnegative least-squares fit of theta to a handful of
SHORT measured solves over a pilot (s, mu) grid — rows weighted by
1/measured so the fit minimizes RELATIVE error (an absolute-error fit
lets the largest pilot point dominate and leaves the cheap points off
by integer factors).

The microbench priors seed nothing here — the fit stands on its own.
(``tune(machine="micro")`` is the priors-only alternative for problems
too expensive to pilot-solve.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import Machine, ProblemDims
from repro_torch.core.sparse_exec import prep_operand
from repro_torch.core.types import SparseOperand, resolve_device
from repro_torch.tune.microbench import time_best

__all__ = ["CalibrationReport", "calibrate", "fit_machine", "nnls",
           "problem_dims", "measure_solve", "DEFAULT_PILOT_GRID",
           "sampled_axis"]


def problem_dims(problem) -> ProblemDims:
    """Table-I dims (m, n, density f) of a problem's data matrix, with
    f the EXECUTED density: a ``SparseOperand`` executes nnz-only work
    (f = stored density), while a dense array executes full dense
    products no matter how many stored zeros it carries (f = 1) — the
    calibration fits measured times, so its flop term must count the
    flops the solver actually runs, not the ones a sparse format
    would."""
    A = problem.A
    m, n = A.shape
    if isinstance(A, SparseOperand):
        return ProblemDims(m=m, n=n,
                           f=max(A.nnz / (m * n), 1e-12))
    return ProblemDims(m=m, n=n, f=1.0)


def nnls(C: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Tiny nonnegative least squares (4 unknowns): active-set by
    recursion — solve unconstrained, zero the most negative coordinate,
    repeat on the reduced system. No scipy dependency."""
    C = np.asarray(C, np.float64)
    t = np.asarray(t, np.float64)
    active = list(range(C.shape[1]))
    theta = np.zeros(C.shape[1])
    while active:
        sol, *_ = np.linalg.lstsq(C[:, active], t, rcond=None)
        if (sol >= 0).all():
            theta[active] = sol
            return theta
        drop = active[int(np.argmin(sol))]
        active = [a for a in active if a != drop]
    return theta


def fit_machine(cost_rows: Sequence, measured: Sequence[float],
                name: str = "calibrated") -> Machine:
    """Fit (gamma, beta, alpha, kappa) to measured times given the
    per-configuration cost dicts (or pre-extracted cost vectors).
    Rows are weighted by 1/measured -> relative-error fit."""
    C = np.array([cost_model.cost_vector(r) if isinstance(r, dict) else r
                  for r in cost_rows], np.float64)
    t = np.asarray(measured, np.float64)
    w = 1.0 / np.maximum(t, 1e-12)
    theta = nnls(C * w[:, None], t * w)
    return cost_model.machine_from_vector(theta, name=name)


def measure_solve(problem, fam, cfg, repeats: int = 3) -> float:
    """Steady-state seconds of one solve of ``problem`` under ``cfg``
    (objective tracking off — the timed work is the solver's data path,
    matching what the model counts), best of ``repeats`` after a warm-up,
    each ended by a device sync. The problem's A and b move to
    ``cfg.device`` in ``cfg.dtype`` once, before the timed calls: the
    solvers accept host arrays, and a host A would otherwise be copied
    to the card in every timed solve."""
    cfg = dataclasses.replace(cfg, track_objective=False)
    dev = resolve_device(cfg.device)
    on_dev = dataclasses.replace(
        problem, A=prep_operand(problem.A, cfg.dtype, dev),
        b=torch.as_tensor(problem.b).to(device=dev, dtype=cfg.dtype))
    return time_best(lambda: fam.solve(on_dev, cfg).x, repeats, dev)


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """The fitted machine plus the per-pilot-point evidence."""

    machine: Machine
    pilot_iters: int
    points: Tuple[dict, ...]       # {"s", "mu", "measured_s",
                                   #  "predicted_s", "ratio"} per point
    max_ratio: float               # worst max(pred/meas, meas/pred)

    def to_dict(self) -> dict:
        return {"machine": dataclasses.asdict(self.machine),
                "pilot_iters": self.pilot_iters,
                "points": list(self.points),
                "max_ratio": self.max_ratio}


DEFAULT_PILOT_GRID = ((1, 1), (1, 8), (4, 4), (8, 1), (16, 8), (32, 2))


def sampled_axis(fam, problem) -> int:
    """The axis the family's block sampler draws from: columns (n) for
    the row-partitioned Lasso layout, rows (m) for the column-partitioned
    SVM/logreg layout — mu candidates must not exceed it."""
    m, n = problem.A.shape
    return n if fam.partition == "row" else m


def _pilot_points(fam, problem, base_cfg, grid) -> List[Tuple[int, int]]:
    if grid is None:
        grid = DEFAULT_PILOT_GRID
    axis = sampled_axis(fam, problem)
    pts = []
    for s, mu in grid:
        if getattr(problem, "groups", None) is not None:
            # the group size is structural — never clamp it (a clamp
            # would hand the solver a block_size that violates the
            # validated contiguous-mu-blocks contract and raise).
            mu = base_cfg.block_size
        else:
            mu = min(mu, max(axis // 2, 1))
        if (s, mu) not in pts:
            pts.append((s, mu))
    return pts


def calibrate(problem, base_cfg, family=None, *,
              pilot_iters: int = 48, grid=None, P: int = 1,
              repeats: int = 3,
              measure_fn: Optional[Callable] = None) -> CalibrationReport:
    """Fit a ``Machine`` to short measured solves of ``problem`` over a
    pilot (s, mu) grid, on ``base_cfg.device``.

    measure_fn(cfg) -> seconds overrides the real measurement (tests).
    """
    from repro_torch.core.api import resolve_family

    fam = resolve_family(problem, family)
    dims = problem_dims(problem)
    kernel = getattr(problem, "kernel", "linear")
    pts = _pilot_points(fam, problem, base_cfg, grid)

    rows, times = [], []
    for s, mu in pts:
        cfg = dataclasses.replace(base_cfg, s=s, block_size=mu,
                                  iterations=pilot_iters)
        if measure_fn is not None:
            t = float(measure_fn(cfg))
        else:
            t = measure_solve(problem, fam, cfg, repeats=repeats)
        rows.append(fam.costs(dims, pilot_iters, mu, s, P, kernel=kernel))
        times.append(t)

    machine = fit_machine(rows, times)
    points, worst = [], 1.0
    for (s, mu), costs, t in zip(pts, rows, times):
        pred = cost_model.predicted_time(costs, machine)
        ratio = max(pred / t, t / max(pred, 1e-12)) if t > 0 else 1.0
        worst = max(worst, ratio)
        points.append({"s": s, "mu": mu, "measured_s": t,
                       "predicted_s": pred, "ratio": ratio})
    return CalibrationReport(machine=machine, pilot_iters=pilot_iters,
                             points=tuple(points), max_ratio=worst)
