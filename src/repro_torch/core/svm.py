"""(Block) dual coordinate descent for linear SVM — paper Algorithm 3 and
its block generalization BDCD, for hinge (SVM-L1) and squared-hinge
(SVM-L2) losses. The port of ``repro/core/svm.py``, one process, dense or
sparse operands.

Per iteration: sample a block B of mu rows, form the fused (mu, mu + 1)
block  Y [Y^T | x]  (block Gram plus projection; for a sparse A through
the ``spmm`` kernel on a card), and take the projected block-gradient
step  alpha_B <- clip(alpha_B - g_B / lambda_max(G), 0, nu). The dual
objective is tracked exactly and incrementally: for alpha_B += theta,
    delta f_D = theta^T g_B + 1/2 (b_B theta)^T G (b_B theta).
These are the in-port oracle the SA solvers (``core.sa_svm``) are held
to: SA and classical draw the same blocks and agree in exact arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import linalg, rng
from repro_torch.core.engine import block_draws
from repro_torch.core.sparse_exec import (prep_operand, row_block_ops,
                                          spmm_aux)
from repro_torch.core.types import (SVMProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    operand_matvec,
                                    operand_rmatvec, register_family,
                                    require_unit_block, resolve_device,
                                    resume_carry)


def require_linear(problem: SVMProblem) -> None:
    """The linear (B)DCD solvers solve only kernel="linear" problems;
    anything else is the kernel-SVM family, which is not ported yet."""
    if problem.kernel != "linear":
        raise NotImplementedError(
            f"kernel={problem.kernel!r}: the kernel SVM family (K-BDCD / "
            f"SA-K-BDCD) is not ported yet (ROADMAP.md, Queue 1, 'The "
            f"other families': core/kernel_svm.py)")


def _on_operand(problem: SVMProblem, v):
    """(A, v, b): the problem's operand and v, b in A's dtype on A's
    device."""
    A = problem.A if isinstance(problem.A, SparseOperand) \
        else torch.as_tensor(problem.A)
    return (A, torch.as_tensor(v).to(device=A.device, dtype=A.dtype),
            torch.as_tensor(problem.b).to(device=A.device, dtype=A.dtype))


def primal_objective(problem: SVMProblem, x):
    """P(x) = 1/2 ||x||^2 + lam * sum_i loss(1 - b_i A_i x), in A's dtype
    on A's device."""
    A, x, b = _on_operand(problem, x)
    xi = torch.clamp(1.0 - b * operand_matvec(A, x), min=0.0)
    loss = torch.sum(xi) if problem.loss == "l1" else torch.sum(xi * xi)
    return 0.5 * torch.sum(x * x) + problem.lam * loss


def dual_objective(problem: SVMProblem, alpha):
    """f_D(alpha) = 1/2 alpha^T Qbar alpha - e^T alpha (direct)."""
    A, alpha, b = _on_operand(problem, alpha)
    w = operand_rmatvec(A, b * alpha)
    return 0.5 * torch.sum(w * w) \
        + 0.5 * problem.gamma * torch.sum(alpha * alpha) - torch.sum(alpha)


def duality_gap(problem: SVMProblem, x, alpha):
    """P(x) + f_D(alpha) >= 0, == 0 at the optimum."""
    return primal_objective(problem, x) + dual_objective(problem, alpha)


def svm_operands(problem: SVMProblem, cfg: SolverConfig):
    """(A, b, device): the data on the solve's device and dtype."""
    require_linear(problem)
    device = resolve_device(cfg.device)
    A = prep_operand(problem.A, cfg.dtype, device)
    b = torch.as_tensor(problem.b).to(device=device, dtype=cfg.dtype)
    return A, b, device


def svm_start(A, b, cfg, problem, alpha0, carry0, device):
    """The initial (alpha, x, dual): restored verbatim from a state, or
    alpha0 (zeros by default) with x = A^T (b alpha) and the dual tracked
    from f_D(alpha0) (zero at alpha0 = 0)."""
    if carry0 is not None:
        return tuple(torch.as_tensor(carry0[k]).to(
            device=device, dtype=cfg.dtype, copy=True)
            for k in ("alpha", "x", "dual"))
    m = A.shape[0]
    alpha = torch.zeros(m, dtype=cfg.dtype, device=device) \
        if alpha0 is None else torch.as_tensor(alpha0).to(
            device=device, dtype=cfg.dtype, copy=True)
    x = operand_rmatvec(A, b * alpha)                  # line 2
    dual = torch.zeros((), dtype=cfg.dtype, device=device) \
        if alpha0 is None else (
            0.5 * torch.sum(x * x) + 0.5 * problem.gamma
            * torch.sum(alpha * alpha) - torch.sum(alpha))
    return alpha, x, dual


def bdcd_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
             state: Optional[SolveState] = None) -> SolverResult:
    """Block dual coordinate descent (BDCD) for linear SVM; mu =
    cfg.block_size = 1 is paper Algorithm 3.

    alpha0: optional warm start of the dual; state: optional
    :class:`SolveState` carrying alpha, x and the running dual."""
    A, b, device = svm_operands(problem, cfg)
    take, gram, _, apply_t = row_block_ops(A)
    m, mu = A.shape[0], cfg.block_size
    gamma, nu = float(problem.gamma), float(problem.nu)
    carry0 = resume_carry(state, alpha0, "bdcd_svm")
    start = 0 if state is None else int(state.iteration)
    alpha, x, dual = svm_start(A, b, cfg, problem, alpha0, carry0, device)
    eye_mu = torch.eye(mu, dtype=cfg.dtype, device=device)
    bits = rng.bits_for(cfg.dtype)
    key = rng.key(cfg.seed, bits, device)
    objs = []
    for batch in block_draws(key,
                             lambda k: linalg.sample_block(k, m, mu, bits),
                             start, cfg.iterations, m):
        for idx in batch:
            Y = take(idx)
            b_B = b[idx]
            red = gram(Y, x[:, None])                   # Y [Y^T | x]
            G = red[:, :mu] + gamma * eye_mu            # line 7 (block)
            a_B = alpha[idx]
            g = b_B * red[:, mu] - 1.0 + gamma * a_B    # line 8 (block)
            # mu = 1: the (1, 1) Gram "block" IS the eigenvalue.
            v = G[0, 0] if mu == 1 \
                else linalg.power_iteration_max_eig(G, cfg.power_iters)
            gbar = torch.abs(torch.clamp(a_B - g, 0.0, nu) - a_B)  # line 9
            theta = torch.where(
                gbar != 0.0, torch.clamp(a_B - g / v, 0.0, nu) - a_B,
                torch.zeros_like(a_B))                  # line 11
            alpha = alpha.index_add(0, idx, theta)      # line 13
            bt = b_B * theta
            x = x + apply_t(Y, bt)                      # line 14
            dual = dual + torch.sum(theta * g) + 0.5 * bt @ (G @ bt)
            objs.append(dual if cfg.track_objective
                        else torch.zeros((), dtype=cfg.dtype, device=device))
    return SolverResult(
        x=x, objective=torch.stack(objs),
        aux={"alpha": alpha, "dual": dual,
             "state": SolveState(start + cfg.iterations,
                                 {"alpha": alpha, "x": x, "dual": dual}),
             **spmm_aux(A, "row_gram")})


def dcd_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
            state: Optional[SolveState] = None) -> SolverResult:
    """Paper Algorithm 3: the block_size = 1 special case of bdcd_svm."""
    require_unit_block(cfg, "dcd_svm")
    return bdcd_svm(problem, cfg, alpha0, state)


def _cli_problem(args):
    from repro_torch.data.sparse import make_svm_dataset
    A, b = make_svm_dataset(args.dataset, args.seed,
                            as_operand=args.sparse, device=args.device)
    return SVMProblem(A=A, b=b, lam=1.0, loss=args.svm_loss)


def _cli_describe(args, res, elapsed: float) -> str:
    obj = res.objective.cpu().numpy()
    return (f"svm-{args.svm_loss} {args.dataset} s={args.s} mu={args.mu} "
            f"device={args.device}{' sparse' if args.sparse else ''}: "
            f"dual {obj[0]:.5f} -> {obj[-1]:.5f}, {elapsed:.2f}s")


@register_family(
    "svm",
    problem_cls=SVMProblem,
    variants={
        "classical": "repro_torch.core.svm:bdcd_svm",
        "sa": "repro_torch.core.sa_svm:sa_bdcd_svm",
    },
    objective=dual_objective,
    make_problem=_cli_problem,
    describe=_cli_describe,
    default_mu=1,
    state_layout=lambda cfg: (("alpha", "replicated"), ("x", "partition"),
                              ("dual", "replicated")),
)
def solve_svm(problem: SVMProblem, cfg: SolverConfig, x0=None,
              state=None) -> SolverResult:
    """Dispatch on cfg.s: s == 1 -> bdcd_svm, s > 1 -> SA-BDCD. x0 is a
    warm start of the dual alpha. A kernel other than "linear" raises
    (the kernel-SVM family is a later slice)."""
    require_linear(problem)
    if cfg.s > 1:
        from repro_torch.core.sa_svm import sa_bdcd_svm
        return sa_bdcd_svm(problem, cfg, x0, state)
    return bdcd_svm(problem, cfg, x0, state)
