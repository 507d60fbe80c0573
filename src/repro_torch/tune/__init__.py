"""``repro_torch.tune`` — the cost-model-calibrated autotuner (the port of
``repro.tune``).

Measure the alpha-beta-gamma-kappa machine parameters on the device a
solve runs on (``microbench``), refine them by least-squares against
short measured pilot solves (``calibrate``), then sweep the
registry-declared cost hook of any family (``select``) and hand back a
complete tuned ``SolverConfig``: the paper's question — which s, at
which mu? — asked of this machine.

    from repro_torch import tune
    cfg = tune.autotune(problem, base_cfg)      # tuned SolverConfig
    res = api.solve(problem, cfg)

or in one step::

    res = api.solve(problem, cfg, tune="auto")

The pilot solves run on ``base_cfg.device`` (the card unless the caller
asks for the CPU), through the same kernels the solve will run.
Calibrated machines persist per host, device, family, regime and dtype
under ``results/tuned/`` (override with ``cache_dir=`` or the
``REPRO_TUNE_CACHE`` env var) in files whose names start with
``torch-``, so the port never reads or overwrites a machine ``repro``
fitted; repeat solves of the same regime skip the measurement entirely.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import socket
from typing import Optional

import torch

from repro_torch.core.cost_model import Machine
from repro_torch.core.types import SolverConfig
from repro_torch.tune.calibrate import (CalibrationReport, calibrate,
                                        fit_machine, measure_solve, nnls,
                                        problem_dims)
from repro_torch.tune.microbench import device_label, measure_machine
from repro_torch.tune.select import (candidate_grid, predicted_solve_time,
                                     select_config)

__all__ = [
    "autotune", "tune", "TuneResult",
    "calibrate", "CalibrationReport", "fit_machine", "nnls",
    "measure_machine", "measure_solve", "problem_dims",
    "select_config", "candidate_grid",
    "predicted_solve_time", "cache_path", "load_cached_machine",
]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Everything one tuning run decided and why."""

    config: SolverConfig           # the tuned config (use this)
    machine: Machine               # calibrated machine parameters
    calibration: Optional[CalibrationReport]   # None on a cache hit
    predicted_s: float             # model time of the tuned config
    predicted_default_s: float     # model time of the incumbent config
    from_cache: bool
    # measured seconds from the incumbent-guard head-to-head (None when
    # the guard did not run) — callers timing the same configs at the
    # same budget can reuse these instead of re-measuring.
    guard_times: Optional[dict] = None


def _cache_dir(cache_dir: Optional[str]) -> str:
    if cache_dir is not None:
        return cache_dir
    return os.environ.get(
        "REPRO_TUNE_CACHE",
        os.path.join(os.getcwd(), "results", "tuned"))


def cache_path(problem, family_name: str,
               cache_dir: Optional[str] = None,
               dtype=torch.float32, device="cuda") -> str:
    """Per-(host, device, family, regime, dtype) cache file for the
    calibrated machine: the machine is a property of host x device x
    problem regime x solve dtype — not of one solve's H, and not of P:
    calibration always fits against P=1 pilot measurements (see
    :func:`tune`), so the fitted machine is topology-independent. The
    key starts with ``torch-`` (``repro``'s keys never do), names the
    device by the card's name or ``cpu``, and rounds density."""
    dims = problem_dims(problem)
    dt = str(dtype).rsplit(".", 1)[-1]
    dev = re.sub(r"[^A-Za-z0-9.]+", "-", device_label(device))
    key = (f"torch-{socket.gethostname()}-{dev}-"
           f"{family_name}-m{dims.m}-n{dims.n}-f{dims.f:.1e}-{dt}")
    return os.path.join(_cache_dir(cache_dir), f"{key}.json")


def load_cached_machine(path: str) -> Optional[Machine]:
    try:
        with open(path) as fh:
            payload = json.load(fh)
        return Machine(**payload["machine"])
    except (OSError, KeyError, TypeError, ValueError):
        return None


def _store_cache(path: str, machine: Machine,
                 report: Optional[CalibrationReport]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"machine": dataclasses.asdict(machine)}
    if report is not None:
        payload["calibration"] = report.to_dict()
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1)


def tune(problem, cfg: Optional[SolverConfig] = None, *,
         family=None, machine=None,
         pilot_iters: int = 48, grid=None, P: int = 1,
         cache: bool = True, cache_dir: Optional[str] = None,
         refresh: bool = False,
         guard_incumbent: Optional[bool] = None,
         guard_iters: Optional[int] = None,
         measure_fn=None) -> TuneResult:
    """Full tuning run: calibrate (or load the cached machine), select,
    and verify the selection against the incumbent ``cfg`` with one
    short measured head-to-head, keeping the incumbent on a loss so
    tuning can never recommend a regression it already measured.

    machine: a ``Machine`` to use as-is, ``"micro"`` to use the
    microbenchmark priors alone (no pilot solves — the cheap path when
    even short solves of the problem are expensive), or None (default)
    for the full pilot-solve calibration.

    P: the processor count used for SELECTION (the L/W terms' log P).
    Calibration always fits against P=1 — the pilot solves run
    unsharded on this device, so fitting P-scaled cost rows to them
    would corrupt the machine. The fitted machine is
    topology-independent; P only changes which config the model picks.

    guard_incumbent: None (default) runs the head-to-head only on a
    FRESH calibration — a cache hit skips all measurement, keeping
    repeat solves of a known regime measurement-free; True forces the
    guard every call, False disables it.

    measure_fn(cfg) -> seconds injects a fake measurement (tests).
    """
    from repro_torch.core.api import resolve_family

    fam = resolve_family(problem, family)
    base = cfg if cfg is not None else SolverConfig(
        block_size=fam.default_mu)

    report, from_cache = None, False
    if machine == "micro":
        machine = measure_machine(device=base.device)
    if machine is None:
        path = cache_path(problem, fam.name, cache_dir, dtype=base.dtype,
                          device=base.device)
        if cache and not refresh:
            machine = load_cached_machine(path)
            from_cache = machine is not None
        if machine is None:
            # always fit at P=1: the pilot solves run unsharded on
            # this device, whatever P the caller wants to SELECT for.
            report = calibrate(problem, base, fam,
                               pilot_iters=pilot_iters, P=1,
                               measure_fn=measure_fn)
            machine = report.machine
            if cache:
                _store_cache(path, machine, report)

    tuned = select_config(problem, machine, base, fam, P=P, grid=grid)
    dims = problem_dims(problem)
    kernel = getattr(problem, "kernel", "linear")
    pred_tuned = predicted_solve_time(fam, dims, tuned, machine, P=P,
                                      kernel=kernel)
    pred_base = predicted_solve_time(fam, dims, base, machine, P=P,
                                     kernel=kernel)

    differs = (tuned.s, tuned.block_size, tuned.symmetric_gram) != \
              (base.s, base.block_size, base.symmetric_gram)
    guard_times = None
    if guard_incumbent is None:
        guard_incumbent = not from_cache    # cache hits stay solve-free
    if guard_incumbent and differs:
        h = guard_iters if guard_iters is not None else pilot_iters
        tuned_h = dataclasses.replace(tuned, iterations=h)
        base_h = dataclasses.replace(base, iterations=h)
        if measure_fn is not None:          # injected measurements
            t_tuned = float(measure_fn(tuned_h))
            t_base = float(measure_fn(base_h))
        else:
            t_tuned = measure_solve(problem, fam, tuned_h)
            t_base = measure_solve(problem, fam, base_h)
        guard_times = {"iterations": h, "selected_s": t_tuned,
                       "incumbent_s": t_base}
        if t_base < t_tuned:
            tuned, pred_tuned = base, pred_base

    return TuneResult(config=tuned, machine=machine, calibration=report,
                      predicted_s=pred_tuned,
                      predicted_default_s=pred_base,
                      from_cache=from_cache,
                      guard_times=guard_times)


def autotune(problem, cfg: Optional[SolverConfig] = None,
             **kwargs) -> SolverConfig:
    """The public one-liner: a complete tuned ``SolverConfig`` for
    ``problem`` (see :func:`tune` for the knobs and the full record)."""
    return tune(problem, cfg, **kwargs).config
