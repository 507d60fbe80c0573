"""Synchronization-Avoiding linear SVM — paper Algorithm 4 and its block
generalization SA-BDCD, as a :mod:`repro_torch.core.engine` FamilyProgram
(the port of ``repro/core/sa_svm.py``, dense or sparse operands).

Per outer iteration: sample s blocks of mu rows, build ONE fused
(s mu, s mu + 1) block  Y [Y^T | x_sk]  (Alg. 4 lines 9-10; through the
``gram`` kernel for a dense A, the ``spmm`` kernel for a sparse one),
add gamma I, run the s dependent block updates on it through the
``svm_inner`` kernel (lines 11-20), then apply the deferred primal update
x += Y^T (b * theta) in one product. The iterates are those of
``core.svm.bdcd_svm`` in exact arithmetic; row ids repeating across the s
blocks are corrected inside the inner loop. Sharded by columns (``group``
given), the fused block is the one all-reduce of the outer iteration;
alpha and the tracked dual are replicated and need no other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import linalg, rng
from repro_torch.core.engine import (Ctx, FamilyProgram, gram_local,
                                     reduce_gram_proj, run_program)
from repro_torch.core.sparse_exec import row_block_ops
from repro_torch.core.svm import svm_operands, svm_start
from repro_torch.core.types import (SVMProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    require_unit_block)
# A module import: kernels.svm_inner's plain version imports core.linalg,
# so the names are read at call time.
from repro_torch.kernels import svm_inner


def _svm_setup(problem, cfg, group, alpha0, carry0):
    A, b, device = svm_operands(problem, cfg)
    take, gram, _, apply_t = row_block_ops(A)
    ctx = Ctx(A=A, b=b, m=A.shape[0], mu=cfg.block_size,
              gamma=float(problem.gamma), nu=float(problem.nu),
              sparse=isinstance(A, SparseOperand), take=take, gram=gram,
              apply_t=apply_t, cfg=cfg, device=device,
              sample_width=A.shape[0], bits=rng.bits_for(cfg.dtype),
              group=group)
    return ctx, svm_start(A, b, cfg, problem, alpha0, carry0, device,
                          group)


def _svm_sample(ctx, keys):
    return linalg.sample_block(keys, ctx.m, ctx.mu, ctx.bits)


def _svm_assemble(ctx, carry, idxs, s_grp):
    _, x, _ = carry
    Y = ctx.take(idxs.reshape(s_grp * ctx.mu))       # (s*mu, n) rows
    # LOCAL fused  Y [Y^T | x]  (Alg. 4 lines 9-10)
    local = ctx.gram(Y, x[:, None]) if ctx.sparse \
        else gram_local(Y.T.contiguous(), x[None])
    return Y, local


def _svm_reduce(ctx, local, idxs, s_grp):
    smu = s_grp * ctx.mu
    Graw, P = reduce_gram_proj(local, smu, 1, ctx.group,
                               ctx.cfg.symmetric_gram)
    G = Graw + ctx.gamma * torch.eye(smu, dtype=ctx.cfg.dtype,
                                     device=ctx.device)   # line 9
    return G, P[:, 0].reshape(s_grp, ctx.mu)             # line 10: Y x_sk


def _svm_inner(ctx, carry, Y, payload, idxs, win, s_grp):
    alpha, x, dual = carry
    G, proj = payload
    flat = idxs.reshape(s_grp * ctx.mu)
    b_sel = ctx.b[flat].reshape(s_grp, ctx.mu)
    a_vals = alpha[flat].reshape(s_grp, ctx.mu)
    # --- the s_grp dependent inner updates (Alg. 4 lines 11-20) ---
    theta, deltas = svm_inner.svm_inner_loop(
        G.contiguous(), proj.contiguous(), b_sel, a_vals, idxs.contiguous(),
        gamma=ctx.gamma, nu=ctx.nu, power_iters=ctx.cfg.power_iters)
    return carry, (theta, deltas, b_sel, flat)


def _svm_defer(ctx, carry, Y, inner_out, payload, idxs, win, s_grp):
    alpha, x, dual = carry
    theta, deltas, b_sel, flat = inner_out
    smu = s_grp * ctx.mu
    alpha = alpha.index_add(0, flat, theta.reshape(smu))        # line 20
    x = x + ctx.apply_t(Y, (b_sel * theta).reshape(smu))        # line 21
    objs = dual + torch.cumsum(deltas, 0) if ctx.cfg.track_objective \
        else torch.zeros(s_grp, dtype=ctx.cfg.dtype, device=ctx.device)
    return (alpha, x, dual + torch.sum(deltas)), objs


_BDCD_PROGRAM = FamilyProgram(
    name="sa_bdcd_svm", setup=_svm_setup, sample=_svm_sample,
    assemble=_svm_assemble, reduce=_svm_reduce, inner=_svm_inner,
    defer=_svm_defer,
    finalize=lambda ctx, carry, sched: (
        carry[1], {"alpha": carry[0], "dual": carry[2]}),
    carry_names=("alpha", "x", "dual"),
    inner_impl=lambda ctx, s_grp: svm_inner.inner_impl(ctx.device),
    spmm_kind="row_gram")


def sa_bdcd_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
                state: Optional[SolveState] = None,
                group=None) -> SolverResult:
    """s-step unrolled BDCD: the iterates of ``bdcd_svm`` in exact
    arithmetic, one fused Gram/projection block per s inner iterations."""
    return run_program(_BDCD_PROGRAM, problem, cfg, alpha0, state, group)


def sa_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
           state: Optional[SolveState] = None,
           group=None) -> SolverResult:
    """Paper Algorithm 4: the block_size = 1 case of sa_bdcd_svm."""
    require_unit_block(cfg, "sa_svm")
    return sa_bdcd_svm(problem, cfg, alpha0, state, group)
