"""Config selection: sweep the registry-declared ``costs`` hook over the
family's ``tune_space`` with a (calibrated) ``Machine`` and return the
complete tuned ``SolverConfig`` (the port of ``repro/tune/select.py``).

Selection is pure model evaluation — no solves — so it reruns cheaply
for any H once a machine is calibrated. It decides (s, mu,
symmetric_gram), under two constraints that make the result an
*executable* recommendation rather than a paper number:

* **Structural blocks**: group-lasso problems have mu fixed to the
  declared group size; the sweep only varies s.
* **symmetric_gram** is only proposed for families whose SA solvers
  honor it (registry flag), and only when the halved Gram message
  actually wins under the calibrated beta.

The port has no ``use_pallas`` and no fallback, so ``repro``'s VMEM
guards (``pallas_guards_ok``, ``_spmm_shapes``, ``allow_pallas``) have no
counterpart: on the card the hand-written kernels always run, on the
CPU their plain versions do. Every (s, mu) of the default grids has a
body in ``kernels/dispatch.py``; past the warp bodies' caps K2 and K3
take their ``block`` body, with G in global memory where it outgrows
shared memory — another route of the same kernel, not the plain
version.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

from repro_torch.core import cost_model
from repro_torch.core.cost_model import Machine
from repro_torch.core.types import SolverConfig
from repro_torch.tune.calibrate import problem_dims, sampled_axis

__all__ = ["select_config", "candidate_grid", "predicted_solve_time"]


def candidate_grid(fam, problem, base_cfg: SolverConfig
                   ) -> List[Tuple[int, int]]:
    """(s, mu) candidates: the family's declared tune_space, clamped to
    the sampled axis and to the structural group size when present."""
    space = dict(fam.tune_space)
    axis = sampled_axis(fam, problem)
    if getattr(problem, "groups", None) is not None:
        mus: Iterable[int] = (base_cfg.block_size,)
    else:
        mus = space.get("mu", (1, 2, 4, 8, 16))
    ss = space.get("s", (1, 2, 4, 8, 16, 32, 64))
    out = []
    for mu in mus:
        if mu > axis:
            continue
        for s in ss:
            if (s, mu) not in out:
                out.append((s, mu))
    return out


def predicted_solve_time(fam, dims, cfg: SolverConfig, machine: Machine,
                         P: int = 1, kernel: str = "linear") -> float:
    """Model time of a full solve under ``cfg``; symmetric_gram halves
    the Gram words W (paper footnote 3) when the family executes it —
    but pays the O(s^2 mu^2)-per-outer-iteration triangle pack/unpack
    as local element work (~2 passes), so on a machine whose beta is
    tiny relative to gamma (a single device) the packed message loses
    and the tuner keeps symmetric_gram off."""
    costs = fam.costs(dims, cfg.iterations, cfg.block_size, cfg.s, P,
                      kernel=kernel)
    t = cost_model.predicted_time(costs, machine)
    if cfg.symmetric_gram and fam.supports_symmetric_gram and cfg.s > 1:
        t -= 0.5 * machine.beta * costs["W"]
        t += 2.0 * machine.gamma * cfg.iterations * cfg.s \
            * cfg.block_size ** 2
    return t


def select_config(problem, machine: Machine, base_cfg: SolverConfig,
                  family=None, *, P: int = 1, grid=None,
                  certified: bool = False) -> SolverConfig:
    """The tuned SolverConfig: argmin of the calibrated model over the
    candidate grid, preserving everything the tuner does not own
    (iterations, dtype, device, seed, accelerated, track_objective, ...).

    certified=True first runs the static cost certifier
    (``repro_torch.analysis.check_costs``) on the family, solving its
    certification problems on ``base_cfg.device``, and refuses to fit the
    machine model against a cost hook the certifier rejects — a hook
    whose counted flops/words/messages disagree with the solves would
    make every "tuned" recommendation a fit to fiction.
    """
    from repro_torch.core.api import resolve_family

    fam = resolve_family(problem, family)
    if certified:
        from repro_torch.analysis.costs import check_costs
        diags, _ = check_costs(fam, device=base_cfg.device)
        errors = [d for d in diags if d.severity == "error"]
        if errors:
            detail = "; ".join(f"{d.where}: {d.message}" for d in errors)
            raise ValueError(
                f"refusing to tune against an uncertified cost model "
                f"for family {fam.name!r}: the static cost certifier "
                f"reports {len(errors)} error(s) — {detail}")
    dims = problem_dims(problem)
    kernel = getattr(problem, "kernel", "linear")
    if grid is not None:
        # an explicit grid still has to be executable: pin mu to the
        # structural group size when present, drop mu beyond the
        # sampled axis (the default candidate_grid does both).
        axis = sampled_axis(fam, problem)
        if getattr(problem, "groups", None) is not None:
            grid = [(s, base_cfg.block_size) for s, _ in grid]
        candidates = []
        for c in grid:
            if c[1] <= axis and c not in candidates:
                candidates.append(c)
        if not candidates:
            raise ValueError(
                f"no executable (s, mu) candidates in the provided "
                f"grid {list(grid)!r} (sampled axis size {axis})")
    else:
        candidates = candidate_grid(fam, problem, base_cfg)

    best_cfg, best_t = None, float("inf")
    for s, mu in candidates:
        for sym in ((False, True) if fam.supports_symmetric_gram
                    and s > 1 else (False,)):
            cfg = dataclasses.replace(base_cfg, s=s, block_size=mu,
                                      symmetric_gram=sym)
            t = predicted_solve_time(fam, dims, cfg, machine, P=P,
                                     kernel=kernel)
            if t < best_t:
                best_cfg, best_t = cfg, t
    if best_cfg is None:
        raise ValueError(
            f"no executable (s, mu) candidates for family "
            f"{fam.name!r} (sampled axis size "
            f"{sampled_axis(fam, problem)}, "
            f"block_size={base_cfg.block_size})")
    return best_cfg
