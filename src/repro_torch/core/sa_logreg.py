"""Synchronization-avoiding logistic regression — the s-step unroll of
``bcd_logreg`` (after Devarakonda & Demmel, arXiv:2011.08281), as a
:mod:`repro_torch.core.engine` FamilyProgram; the port of
``repro/core/sa_logreg.py``.

Every update direction lies in the span of the sampled rows: s damped
steps give w_{sk+s} = (prod_j d_j) w_sk + Y^T u, with d_j = 1 - eta_j lam
and u the per-step coefficients, each decayed by the d-factors of later
steps. The solver samples all s blocks up front, reduces the (m, s mu)
cross block A Y^T ONCE (for a sparse A through the ``spmm`` kernel on the
card), and runs the s dependent inner updates on replicated data:

  * the margins f update per step as f <- d f + (A Y^T)[:, B_j] u_j, a
    slice of the reduced block, so later gathers f[B_t] are current;
  * the coefficient buffer decays, U <- d U, then U[j] += u_j;
  * sq = ||w||^2 updates from the gathered margins and the diagonal
    block of the cross block.

The s step sizes depend only on the blocks Y_j Y_j^T, not on the chain, so
their power iterations run batched before it. Deferred per group: ONE
local product w <- rho w + Y^T vec(U), rho = prod_j d_j. The iterates are
those of ``bcd_logreg`` in exact arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import linalg, rng
from repro_torch.core.engine import Ctx, FamilyProgram, run_program
from repro_torch.core.logreg import _init_state, _tracked_objective
from repro_torch.core.sparse_exec import cross_block, row_block_ops
from repro_torch.core.types import (LogRegProblem, SolveState, SolverConfig,
                                    SolverResult)


def _logreg_setup(problem, cfg, group, x0, carry0):
    A, b, device, carry = _init_state(problem, cfg, group, x0, carry0)
    take, _, densify, apply_t = row_block_ops(A)
    ctx = Ctx(A=A, b=b, m=A.shape[0], mu=cfg.block_size,
              lam=float(problem.lam), take=take, densify=densify,
              apply_t=apply_t, cfg=cfg, device=device,
              sample_width=A.shape[0], bits=rng.bits_for(cfg.dtype),
              group=group)
    return ctx, carry


def _logreg_sample(ctx, keys):
    return linalg.sample_block(keys, ctx.m, ctx.mu, ctx.bits)


def _logreg_assemble(ctx, carry, idxs, s_grp):
    Y = ctx.take(idxs.reshape(s_grp * ctx.mu))        # (s*mu, n_loc) rows
    return Y, cross_block(ctx.A, ctx.densify(Y))


def _logreg_reduce(ctx, local, idxs, s_grp):
    return linalg.preduce(local, ctx.group)


def _logreg_inner(ctx, carry, Y, cross, idxs, win, s_grp):
    w, f, sq = carry
    cfg, mu, lam = ctx.cfg, ctx.mu, ctx.lam
    cross_r = cross.reshape(ctx.m, s_grp, mu)
    steps = torch.arange(s_grp, device=ctx.device)
    b_sel = ctx.b[idxs]                               # (s, mu)
    # Each step's Y_j Y_j^T, then all s step sizes at once.
    Gs = cross_r[idxs, steps[:, None], :]             # (s, mu, mu)
    vs = linalg.power_iteration_max_eig_batched(Gs, cfg.power_iters)
    etas = 1.0 / (0.25 * vs / mu + lam)
    rho = torch.ones((), dtype=cfg.dtype, device=ctx.device)
    U = torch.zeros((s_grp, mu), dtype=cfg.dtype, device=ctx.device)
    objs = []
    for j in range(s_grp):
        fB = f[idxs[j]]                               # current Y_j w
        c = -b_sel[j] * torch.sigmoid(-b_sel[j] * fB)
        eta = etas[j]
        d = 1.0 - eta * lam
        u = -(eta / mu) * c
        sq = d * d * sq + 2.0 * d * (fB @ u) + u @ (Gs[j] @ u)
        f = d * f + cross_r[:, j, :] @ u              # replicated, local
        rho = d * rho
        U = d * U
        U[j] += u                                     # decay, then record
        objs.append(_tracked_objective(f, sq, ctx.b, lam)
                    if cfg.track_objective
                    else torch.zeros((), dtype=cfg.dtype, device=ctx.device))
    return (w, f, sq), (rho, U, torch.stack(objs))


def _logreg_defer(ctx, carry, Y, inner_out, cross, idxs, win, s_grp):
    w, f, sq = carry
    rho, U, objs = inner_out
    w = rho * w + ctx.apply_t(Y, U.reshape(s_grp * ctx.mu))   # local GEMV
    return (w, f, sq), objs


_LOGREG_PROGRAM = FamilyProgram(
    name="sa_bcd_logreg", setup=_logreg_setup, sample=_logreg_sample,
    assemble=_logreg_assemble, reduce=_logreg_reduce, inner=_logreg_inner,
    defer=_logreg_defer,
    finalize=lambda ctx, carry, sched: (
        carry[0], {"margins": carry[1], "w_norm_sq": carry[2]}),
    carry_names=("w", "margins", "sq"), spmm_kind="cross")


def sa_bcd_logreg(problem: LogRegProblem, cfg: SolverConfig, x0=None,
                  state: Optional[SolveState] = None,
                  group=None) -> SolverResult:
    """s-step unrolled BCD logistic regression: the iterates of
    ``bcd_logreg`` in exact arithmetic, ONE reduction per s inner
    iterations."""
    return run_program(_LOGREG_PROGRAM, problem, cfg, x0, state, group)
