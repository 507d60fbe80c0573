"""Synchronization-Avoiding coordinate-descent solvers for proximal
least-squares — paper Algorithm 2 (SA-accBCD) and the non-accelerated
SA-BCD / SA-CD variants, as :mod:`repro_torch.core.engine`
FamilyPrograms (the port of ``repro/core/sa_lasso.py``, dense or sparse
operands).

Per outer iteration: sample s blocks, build ONE (s mu) x (s mu + k)
Gram/projection block Y^T [Y | vecs], run the s dependent inner updates
on it, then apply the deferred m-dimensional updates as one product.
The iterate sequence is Algorithm 1's in exact arithmetic. Sharded by
rows (``group`` given), the block is the one all-reduce of the outer
iteration; a tracked objective adds one more, of its s squared norms.

On a card the hot spots are hand-written kernels:
  * ``repro_torch.kernels.gram``     — the fused  Y^T [Y | ytil | ztil]
    for a dense A; ``repro_torch.kernels.spmm`` for a sparse one
    (``core.sparse_exec.col_block_ops``)
  * ``repro_torch.kernels.sa_inner`` — the accelerated s-step inner loop
    for the Lasso / elastic-net prox (group lasso's block prox runs as
    a plain PyTorch loop, which ``aux["inner_impl"]`` reports as "torch").
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import linalg
from repro_torch.core.engine import (Ctx, FamilyProgram, deferred_steps,
                                     gram_local, reduce_gram_proj,
                                     run_program)
from repro_torch.core.lasso import _objective, _prep, as_vector
from repro_torch.core.sparse_exec import col_block_ops
from repro_torch.core.types import (LassoProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    operand_matvec, require_unit_block)
# A module import: kernels.sa_inner's plain version imports core.linalg,
# so the names are read at call time.
from repro_torch.kernels import sa_inner


def _lasso_ctx(problem, cfg, group):
    A, b, n, mu, q, sampler, prox, device = _prep(problem, cfg)
    return Ctx(A=A, b=b, n=n, mu=mu, q=q, sampler=sampler, prox=prox,
               sparse=isinstance(A, SparseOperand),
               block_gram=col_block_ops(A)[0],
               m_loc=A.shape[0], problem=problem, cfg=cfg, device=device,
               sample_width=n, group=group,
               group_lasso=problem.groups is not None)


def _lasso_sample(ctx, keys):
    return ctx.sampler(keys)


def _lasso_assemble(ctx, vecs, idxs, s_grp):
    """LOCAL fused payload for the group's sampled columns:
    (handle, Y^T [Y | vecs^T]) for the k vectors ``vecs`` (k, m_loc);
    ``handle`` (the dense sampled columns Y, or the gathered ELL columns)
    feeds the deferred products."""
    flat = idxs.reshape(s_grp * ctx.mu)
    if ctx.sparse:
        return ctx.block_gram(flat, vecs.T)
    Y = ctx.A[:, flat]                                  # (m_loc, s*mu)
    return Y, gram_local(Y, vecs)


def _lasso_reduce(ctx, local, s_grp, vec_cols):
    return reduce_gram_proj(local, s_grp * ctx.mu, vec_cols, ctx.group,
                            ctx.cfg.symmetric_gram)


def _stepped(x, idxs, buf, s_grp, n):
    """The per-inner-iteration coordinate steps as dense rows (s_grp, n)."""
    rows = torch.arange(s_grp, device=x.device)[:, None].expand_as(idxs)
    return torch.zeros((s_grp, n), dtype=x.dtype, device=x.device) \
        .index_put_((rows, idxs), buf, accumulate=True)


# ---------------------------------------------------------------------------
# SA-BCD (non-accelerated): r_j = A_j^T r_sk + sum_{t<j} G[j,t] dx_t
# ---------------------------------------------------------------------------

def _bcd_setup(problem, cfg, group, x0, carry0):
    ctx = _lasso_ctx(problem, cfg, group)
    if carry0 is not None:
        x = as_vector(carry0["x"], cfg, ctx.device)
        r = as_vector(carry0["residual"], cfg, ctx.device)
    elif x0 is None:
        x = torch.zeros(ctx.n, dtype=cfg.dtype, device=ctx.device)
        r = -ctx.b
    else:
        x = as_vector(x0, cfg, ctx.device)
        r = operand_matvec(ctx.A, x) - ctx.b
    return ctx, (x, r)


def _bcd_assemble(ctx, carry, idxs, s_grp):
    return _lasso_assemble(ctx, carry[1][None], idxs, s_grp)


def _bcd_reduce(ctx, local, idxs, s_grp):
    return _lasso_reduce(ctx, local, s_grp, 1)


def _bcd_inner(ctx, carry, handle, payload, idxs, win, s):
    x, r = carry
    cfg, mu = ctx.cfg, ctx.mu
    G, P = payload
    G4 = G.reshape(s, mu, s, mu)
    r_proj = P[:, 0].reshape(s, mu)
    dx_buf = torch.zeros((s, mu), dtype=cfg.dtype, device=ctx.device)
    steps = torch.arange(s, device=ctx.device)
    for j in range(s):
        idx_j = idxs[j]
        Gj = G4[j]                                    # (mu, s, mu)
        cross = torch.einsum("ptq,tq->tp", Gj, dx_buf)
        mask = (steps < j).to(cfg.dtype)
        rj = r_proj[j] + torch.einsum("t,tp->p", mask, cross)
        v = linalg.power_iteration_max_eig(Gj[:, j, :], cfg.power_iters)
        eta = 1.0 / linalg.floor_eig(v)
        g = x[idx_j] - eta * rj
        dx = ctx.prox(g, eta) - x[idx_j]
        x.index_add_(0, idx_j, dx)
        dx_buf[j] = dx
    return (x, r), dx_buf


def _bcd_defer(ctx, carry, handle, dx_buf, payload, idxs, win, s):
    x, r = carry
    cfg = ctx.cfg
    steps = deferred_steps(ctx, handle, dx_buf, s)    # Eq. 7
    r_new = r + torch.sum(steps, dim=0)
    if cfg.track_objective:
        r_steps = r[None, :] + torch.cumsum(steps, dim=0)
        dfull = _stepped(x, idxs, dx_buf, s, ctx.n)
        x_steps = (x - torch.sum(dfull, 0))[None, :] \
            + torch.cumsum(dfull, dim=0)
        objs = _objective(r_steps, x_steps, ctx.problem, ctx.group)
    else:
        objs = torch.zeros(s, dtype=cfg.dtype, device=ctx.device)
    return (x, r_new), objs


def _bcd_finalize(ctx, carry, sched):
    x, r = carry
    return x, {"residual": r}


_BCD_PROGRAM = FamilyProgram(
    name="sa_bcd_lasso", setup=_bcd_setup, sample=_lasso_sample,
    assemble=_bcd_assemble, reduce=_bcd_reduce, inner=_bcd_inner,
    defer=_bcd_defer, finalize=_bcd_finalize,
    carry_names=("x", "residual"),
    inner_impl=lambda ctx, s_grp: "torch", spmm_kind="col_gram")


def sa_bcd_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
                 state: Optional[SolveState] = None,
                 group=None) -> SolverResult:
    return run_program(_BCD_PROGRAM, problem, cfg, x0, state, group)


# ---------------------------------------------------------------------------
# SA-accBCD — paper Algorithm 2.
# ---------------------------------------------------------------------------

def _acc_setup(problem, cfg, group, x0, carry0):
    ctx = _lasso_ctx(problem, cfg, group)
    if carry0 is not None:
        z = as_vector(carry0["z"], cfg, ctx.device)
        y = as_vector(carry0["y"], cfg, ctx.device)
        ztil = as_vector(carry0["ztil"], cfg, ctx.device)
        ytil = as_vector(carry0["ytil"], cfg, ctx.device)
    else:
        if x0 is None:
            z = torch.zeros(ctx.n, dtype=cfg.dtype, device=ctx.device)
            ztil = -ctx.b
        else:
            z = as_vector(x0, cfg, ctx.device)
            ztil = operand_matvec(ctx.A, z) - ctx.b
        y = torch.zeros(ctx.n, dtype=cfg.dtype, device=ctx.device)
        ytil = torch.zeros_like(ctx.b)
    return ctx, (z, y, ztil, ytil)


def _acc_schedule(ctx, cfg, total):
    return linalg.theta_schedule(ctx.mu / ctx.n, total, cfg.dtype,
                                 ctx.device)


def _acc_assemble(ctx, carry, idxs, s_grp):
    z, y, ztil, ytil = carry
    return _lasso_assemble(ctx, torch.stack([ytil, ztil]), idxs, s_grp)


def _acc_reduce(ctx, local, idxs, s_grp):
    return _lasso_reduce(ctx, local, s_grp, 2)


def _acc_coefU(ctx, th_prev):
    """Alg. 2 lines 21-22 coefficient (1 - q θ_{j-1}) / θ_{j-1}^2."""
    return (1.0 - ctx.q * th_prev) / (th_prev * th_prev)


def _acc_inner_torch(ctx, z, y, G, y_proj, z_proj, idxs, th_prev, coefU, s):
    """The s inner steps as a plain loop (group lasso's block prox),
    updating z and y in place; returns the (s, mu) dz history."""
    cfg, mu, q = ctx.cfg, ctx.mu, ctx.q
    G4 = G.reshape(s, mu, s, mu)
    dz_buf = torch.zeros((s, mu), dtype=cfg.dtype, device=ctx.device)
    steps = torch.arange(s, device=ctx.device)
    for j in range(s):
        idx_j = idxs[j]
        thp = th_prev[j]
        Gj = G4[j]                                    # (mu, s, mu)
        cross = torch.einsum("ptq,tq->tp", Gj, dz_buf)
        # Eq. (3): coefficient (theta_{j-1}^2 * coefU_t - 1) on G[j,t] dz_t
        coef_t = thp * thp * coefU - 1.0
        mask = (steps < j).to(cfg.dtype)
        rj = thp * thp * y_proj[j] + z_proj[j] \
            - torch.einsum("t,t,tp->p", mask, coef_t, cross)
        v = linalg.power_iteration_max_eig(Gj[:, j, :], cfg.power_iters)
        eta = 1.0 / linalg.floor_eig(q * thp * v)     # line 15
        g = z[idx_j] - eta * rj                       # Eq. (4)
        dz = ctx.prox(g, eta) - z[idx_j]              # Eq. (5)
        z.index_add_(0, idx_j, dz)                    # line 19
        y.index_add_(0, idx_j, -coefU[j] * dz)        # line 21
        dz_buf[j] = dz
    return dz_buf


def _acc_inner(ctx, carry, handle, payload, idxs, win, s):
    z, y, ztil, ytil = carry
    cfg, mu = ctx.cfg, ctx.mu
    G, P = payload
    y_proj = P[:, 0].reshape(s, mu)                   # A_j^T ytil_sk
    z_proj = P[:, 1].reshape(s, mu)                   # A_j^T ztil_sk
    th_prev, _ = win
    coefU = _acc_coefU(ctx, th_prev)
    if ctx.group_lasso:
        dz_buf = _acc_inner_torch(ctx, z, y, G, y_proj, z_proj, idxs,
                                  th_prev, coefU, s)
    else:
        flat = idxs.reshape(s * mu)
        dz_buf, _ = sa_inner.sa_inner_loop(
            G.contiguous(), y_proj.contiguous(), z_proj.contiguous(),
            z[flat].reshape(s, mu), idxs.contiguous(), th_prev.contiguous(),
            coefU, ctx.q, ctx.problem.lam, ctx.problem.l2, cfg.power_iters)
        z.index_add_(0, flat, dz_buf.reshape(s * mu))           # line 19
        y.index_add_(0, flat, (-coefU[:, None] * dz_buf).reshape(s * mu))
    return (z, y, ztil, ytil), dz_buf


def _acc_defer(ctx, carry, handle, dz_buf, payload, idxs, win, s):
    z, y, ztil, ytil = carry
    cfg = ctx.cfg
    th_prev, th_cur = win
    coefU = _acc_coefU(ctx, th_prev)
    # Deferred m-dimensional updates (paper Eqs. 7 & 9).
    steps = deferred_steps(ctx, handle, dz_buf, s)
    ztil_new = ztil + torch.sum(steps, dim=0)
    ytil_new = ytil - coefU @ steps
    if cfg.track_objective:
        ztil_steps = ztil[None, :] + torch.cumsum(steps, dim=0)
        ytil_steps = ytil[None, :] - torch.cumsum(
            coefU[:, None] * steps, dim=0)
        dz_full = _stepped(z, idxs, dz_buf, s, ctx.n)
        z_steps = (z - torch.sum(dz_full, 0))[None, :] \
            + torch.cumsum(dz_full, dim=0)
        y_steps = (y + torch.sum(coefU[:, None] * dz_full, 0))[None, :] \
            - torch.cumsum(coefU[:, None] * dz_full, dim=0)
        th2 = (th_cur * th_cur)[:, None]
        objs = _objective(th2 * ytil_steps + ztil_steps,
                          th2 * y_steps + z_steps, ctx.problem, ctx.group)
    else:
        objs = torch.zeros(s, dtype=cfg.dtype, device=ctx.device)
    return (z, y, ztil_new, ytil_new), objs


def _acc_finalize(ctx, carry, sched):
    z, y, ztil, ytil = carry
    thH = sched[-1]
    return thH * thH * y + z, {"residual": thH * thH * ytil + ztil}


_ACC_PROGRAM = FamilyProgram(
    name="sa_acc_bcd_lasso", setup=_acc_setup, sample=_lasso_sample,
    assemble=_acc_assemble, reduce=_acc_reduce, inner=_acc_inner,
    defer=_acc_defer, finalize=_acc_finalize,
    carry_names=("z", "y", "ztil", "ytil"), schedule=_acc_schedule,
    inner_impl=lambda ctx, s_grp: sa_inner.inner_impl(ctx.device,
                                                     ctx.group_lasso),
    spmm_kind="col_gram")


def sa_acc_bcd_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
                     state: Optional[SolveState] = None,
                     group=None) -> SolverResult:
    return run_program(_ACC_PROGRAM, problem, cfg, x0, state, group)


def sa_cd_lasso(problem, cfg, x0=None, state=None, group=None):
    require_unit_block(cfg, "sa_cd_lasso")
    return sa_bcd_lasso(problem, cfg, x0, state, group)


def sa_acc_cd_lasso(problem, cfg, x0=None, state=None, group=None):
    require_unit_block(cfg, "sa_acc_cd_lasso")
    return sa_acc_bcd_lasso(problem, cfg, x0, state, group)
