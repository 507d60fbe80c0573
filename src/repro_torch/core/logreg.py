"""Block coordinate-descent (mini-batch) logistic regression — the
communication structure of CA logistic regression (Devarakonda & Demmel,
arXiv:2011.08281); the port of ``repro/core/logreg.py``, dense or sparse
operands, on one process or sharded by columns.

Problem:  min_w  (1/m) sum_i log(1 + exp(-b_i a_i^T w)) + lam/2 ||w||^2

Layout (as the kernel SVM): A is partitioned by columns (m, n_loc) and w
alongside it; b, the margins f = A w in R^m and the scalars are
replicated.

Per iteration: sample a block B of mu data points, reduce the (m, mu)
cross block A Y^T (ONE reduction over ``group``; for a sparse A through
the ``spmm`` kernel on the card), and take the damped block-gradient step

    w <- (1 - eta lam) w - (eta/mu) Y^T c,   c_i = -b_i sigma(-b_i f[i]),

with eta = 1 / (lambda_max(Y Y^T)/(4 mu) + lam). The margins and
sq = ||w||^2 update from the same reduced block,

    f  <- d f + (A Y^T) u,
    sq <- d^2 sq + 2 d (f_B . u) + u^T (Y Y^T) u,   d = 1 - eta lam,
                                                    u = -(eta/mu) c,

so the exact objective is tracked after every iteration from replicated
data, with no further reduction.

``cfg.accelerated`` and ``cfg.symmetric_gram`` do not apply and are
ignored.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import seams
from repro_torch.core import cost_model, linalg, rng
from repro_torch.core.engine import block_draws
from repro_torch.core.sparse_exec import (cross_block, prep_operand,
                                          row_block_ops, spmm_aux)
from repro_torch.core.types import (LogRegProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    operand_matvec, register_family,
                                    resolve_device, resume_carry)


def logreg_objective(problem: LogRegProblem, w, group=None):
    """(1/m) sum_i log(1 + exp(-b_i a_i^T w)) + lam/2 ||w||^2, evaluated
    directly in A's dtype on A's device. Sharded by columns, w is this
    rank's slice and the margins and ||w||^2 are each summed over
    ``group``."""
    A = problem.A if isinstance(problem.A, SparseOperand) \
        else torch.as_tensor(problem.A)
    w = torch.as_tensor(w).to(device=A.device, dtype=A.dtype)
    b = torch.as_tensor(problem.b).to(device=A.device, dtype=A.dtype)
    margins = linalg.preduce(operand_matvec(A, w), group)
    sq = linalg.preduce(torch.sum(w * w), group)
    loss = torch.mean(torch.logaddexp(torch.zeros_like(margins),
                                      -b * margins))
    return loss + 0.5 * problem.lam * sq


def _tracked_objective(f, sq, b, lam):
    """The objective from the kept margins f = A w and sq = ||w||^2:
    replicated data only, no communication."""
    return torch.mean(torch.logaddexp(torch.zeros_like(f), -b * f)) \
        + 0.5 * lam * sq


def _init_state(problem: LogRegProblem, cfg: SolverConfig, group, x0,
                carry0=None):
    """(A, b, device, (w, margins, sq)): the operands on the solve's
    device and the starting carry — restored verbatim from a state, zero
    (no communication), or from the warm start x0 (this rank's slice of
    w), whose margins and ||w||^2 are one setup reduction over
    ``group``."""
    device = resolve_device(cfg.device)
    A = prep_operand(problem.A, cfg.dtype, device)
    b = torch.as_tensor(problem.b).to(device=device, dtype=cfg.dtype)

    def vec(v):
        return torch.as_tensor(v).to(device=device, dtype=cfg.dtype,
                                     copy=True)

    if carry0 is not None:
        return A, b, device, tuple(vec(carry0[k])
                                   for k in ("w", "margins", "sq"))
    if x0 is None:
        return A, b, device, (
            torch.zeros(A.shape[1], dtype=cfg.dtype, device=device),
            torch.zeros(A.shape[0], dtype=cfg.dtype, device=device),
            torch.zeros((), dtype=cfg.dtype, device=device))
    w = vec(x0)
    packed = linalg.preduce(
        torch.cat([operand_matvec(A, w), torch.sum(w * w)[None]]), group)
    return A, b, device, (w, packed[:-1], packed[-1])


def _step_size(G, mu: int, lam: float, power_iters: int):
    """eta = 1 / (lambda_max(Y Y^T)/(4 mu) + lam); at mu = 1 the (1, 1)
    block is the eigenvalue."""
    v = G[0, 0] if mu == 1 else linalg.power_iteration_max_eig(G, power_iters)
    return 1.0 / (0.25 * v / mu + lam)


def bcd_logreg(problem: LogRegProblem, cfg: SolverConfig, x0=None,
               state: Optional[SolveState] = None,
               group=None) -> SolverResult:
    """Classical (synchronous) block CD / mini-batch logistic regression:
    ONE reduction of the (m, mu) cross block per iteration."""
    mu = cfg.block_size
    lam = float(problem.lam)
    carry0 = resume_carry(state, x0, "bcd_logreg")
    start = 0 if state is None else int(state.iteration)
    A, b, device, (w, f, sq) = _init_state(problem, cfg, group, x0, carry0)
    take, _, densify, apply_t = row_block_ops(A)
    m = A.shape[0]
    bits = rng.bits_for(cfg.dtype)
    key = rng.key(cfg.seed, bits, device)
    objs = []
    for batch in block_draws(key,
                             lambda k: linalg.sample_block(k, m, mu, bits),
                             start, cfg.iterations, m):
        for idx in seams.outer_loop(batch):
            Y = take(idx)
            cross = linalg.preduce(cross_block(A, densify(Y)), group)
            G = cross[idx]                               # (mu, mu) = Y Y^T
            fB = f[idx]                                  # = Y w
            b_B = b[idx]
            c = -b_B * torch.sigmoid(-b_B * fB)
            eta = _step_size(G, mu, lam, cfg.power_iters)
            d = 1.0 - eta * lam
            u = -(eta / mu) * c
            w = d * w + apply_t(Y, u)
            sq = d * d * sq + 2.0 * d * (fB @ u) + u @ (G @ u)
            f = d * f + cross @ u
            objs.append(_tracked_objective(f, sq, b, lam)
                        if cfg.track_objective
                        else torch.zeros((), dtype=cfg.dtype, device=device))
    return SolverResult(
        x=w, objective=torch.stack(objs),
        aux={"margins": f, "w_norm_sq": sq,
             "state": SolveState(start + cfg.iterations,
                                 {"w": w, "margins": f, "sq": sq}),
             **spmm_aux(A, "cross")})


def _cli_problem(args):
    from repro_torch.data.sparse import make_svm_dataset
    A, b = make_svm_dataset(args.dataset, args.seed,
                            as_operand=args.sparse, device=args.device)
    return LogRegProblem(A=A, b=b, lam=args.logreg_l2)


def _cli_describe(args, res, elapsed: float) -> str:
    obj = res.objective.cpu().numpy()
    return (f"logreg {args.dataset} s={args.s} mu={args.mu} "
            f"device={args.device}{' sparse' if args.sparse else ''}: "
            f"obj {obj[0]:.5f} -> {obj[-1]:.5f}, {elapsed:.2f}s")


@register_family(
    "logreg",
    problem_cls=LogRegProblem,
    partition="col",
    default_axes="model",
    x0_layout="partition",           # a warm start is w, on the feature axis
    aux_out=(("margins", "replicated"),),
    variants={
        "classical": "repro_torch.core.logreg:bcd_logreg",
        "sa": "repro_torch.core.sa_logreg:sa_bcd_logreg",
    },
    objective=logreg_objective,
    costs=lambda dims, H, mu, s, P, kernel="linear": cost_model.logreg_costs(
        dims, H, mu, s, P),
    make_problem=_cli_problem,
    describe=_cli_describe,
    default_mu=4,
    bench_block_size=2,
    bench_problem_kwargs={"lam": 1e-3},
    # same (m, s*mu) cross-block message shape as the kernel SVM.
    tune_space={"s": (1, 2, 4, 8, 16, 32), "mu": (1, 2, 4, 8)},
    state_layout=lambda cfg: (("w", "partition"), ("margins", "replicated"),
                              ("sq", "replicated")),
)
def solve_logreg(problem: LogRegProblem, cfg: SolverConfig, x0=None,
                 state=None, group=None) -> SolverResult:
    """Dispatch on cfg.s: classical BCD vs the SA s-step unroll. x0 is a
    warm start of w (this rank's slice when sharded)."""
    if cfg.s > 1:
        from repro_torch.core.sa_logreg import sa_bcd_logreg
        return sa_bcd_logreg(problem, cfg, x0, state, group)
    return bcd_logreg(problem, cfg, x0, state, group)
