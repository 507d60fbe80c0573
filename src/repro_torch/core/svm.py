"""(Block) dual coordinate descent for linear SVM — paper Algorithm 3 and
its block generalization BDCD, for hinge (SVM-L1) and squared-hinge
(SVM-L2) losses. The port of ``repro/core/svm.py``, dense or sparse
operands, on one process or sharded by columns: with ``group`` given, A
holds this rank's features, x is its slice of the primal vector, alpha
and the dual are replicated, and each fused block is summed over
``group`` by ``linalg.preduce``.

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

from repro_torch import seams
from repro_torch.core import cost_model, linalg, rng
from repro_torch.core.engine import block_draws
from repro_torch.core.sparse_exec import (prep_operand, row_block_ops,
                                          spmm_aux)
from repro_torch.core.types import (SVMProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    build_kernel_params, operand_matvec,
                                    operand_rmatvec, register_family,
                                    require_unit_block, resolve_device,
                                    resume_carry)


def require_linear(problem: SVMProblem) -> None:
    """The linear (B)DCD solvers solve only kernel="linear" problems; any
    other kernel is the ``ksvm`` family (``core.kernel_svm``), which
    ``api.solve`` and ``solve_svm`` route it to. (``repro``'s linear
    solvers ignore the kernel and solve the linear problem.)"""
    if problem.kernel != "linear":
        raise ValueError(
            f"kernel={problem.kernel!r}: the linear (B)DCD solvers take "
            f"kernel='linear' only; solve a kernel SVM with the 'ksvm' "
            f"family (api.solve, solve_ksvm, kbdcd_svm or sa_kbdcd_svm)")


def _on_operand(problem: SVMProblem, v):
    """(A, v, b): the problem's operand and v, b in A's dtype on A's
    device."""
    A = problem.A if isinstance(problem.A, SparseOperand) \
        else torch.as_tensor(problem.A)
    return (A, torch.as_tensor(v).to(device=A.device, dtype=A.dtype),
            torch.as_tensor(problem.b).to(device=A.device, dtype=A.dtype))


def primal_objective(problem: SVMProblem, x, group=None):
    """P(x) = 1/2 ||x||^2 + lam * sum_i loss(1 - b_i A_i x), in A's dtype
    on A's device. Sharded by columns, the margins A x and ||x||^2 are
    each summed over ``group``."""
    A, x, b = _on_operand(problem, x)
    margins = linalg.preduce(operand_matvec(A, x), group)
    xi = torch.clamp(1.0 - b * margins, min=0.0)
    loss = torch.sum(xi) if problem.loss == "l1" else torch.sum(xi * xi)
    sq = linalg.preduce(torch.sum(x * x), group)
    return 0.5 * sq + problem.lam * loss


def dual_objective(problem: SVMProblem, alpha, group=None):
    """f_D(alpha) = 1/2 alpha^T Qbar alpha - e^T alpha (direct)."""
    A, alpha, b = _on_operand(problem, alpha)
    w = operand_rmatvec(A, b * alpha)
    quad = linalg.preduce(torch.sum(w * w), group)
    return 0.5 * quad \
        + 0.5 * problem.gamma * torch.sum(alpha * alpha) - torch.sum(alpha)


def duality_gap(problem: SVMProblem, x, alpha, group=None):
    """P(x) + f_D(alpha) >= 0, == 0 at the optimum."""
    return primal_objective(problem, x, group) \
        + dual_objective(problem, alpha, group)


def svm_operands(problem: SVMProblem, cfg: SolverConfig):
    """(A, b, device): the data on the solve's device and dtype."""
    require_linear(problem)
    device = resolve_device(cfg.device)
    A = prep_operand(problem.A, cfg.dtype, device)
    b = torch.as_tensor(problem.b).to(device=device, dtype=cfg.dtype)
    return A, b, device


def svm_start(A, b, cfg, problem, alpha0, carry0, device, group=None):
    """The initial (alpha, x, dual): restored verbatim from a state, or
    alpha0 (zeros by default) with x = A^T (b alpha) and the dual tracked
    from f_D(alpha0) (zero at alpha0 = 0; a warm start's ||x||^2 is one
    reduction over ``group``)."""
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
            0.5 * linalg.preduce(torch.sum(x * x), group)
            + 0.5 * problem.gamma
            * torch.sum(alpha * alpha) - torch.sum(alpha))
    return alpha, x, dual


def bdcd_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
             state: Optional[SolveState] = None,
             group=None) -> SolverResult:
    """Block dual coordinate descent (BDCD) for linear SVM; mu =
    cfg.block_size = 1 is paper Algorithm 3.

    alpha0: optional warm start of the dual; state: optional
    :class:`SolveState` carrying alpha, x and the running dual; group:
    the process group of a column-sharded solve (one reduction per
    iteration)."""
    A, b, device = svm_operands(problem, cfg)
    take, gram, _, apply_t = row_block_ops(A)
    m, mu = A.shape[0], cfg.block_size
    gamma, nu = float(problem.gamma), float(problem.nu)
    carry0 = resume_carry(state, alpha0, "bdcd_svm")
    start = 0 if state is None else int(state.iteration)
    alpha, x, dual = svm_start(A, b, cfg, problem, alpha0, carry0, device,
                               group)
    eye_mu = torch.eye(mu, dtype=cfg.dtype, device=device)
    bits = rng.bits_for(cfg.dtype)
    key = rng.key(cfg.seed, bits, device)
    objs = []
    for batch in block_draws(key,
                             lambda k: linalg.sample_block(k, m, mu, bits),
                             start, cfg.iterations, m):
        for idx in seams.outer_loop(batch):
            Y = take(idx)
            b_B = b[idx]
            red = linalg.preduce(gram(Y, x[:, None]), group)  # Y [Y^T|x]
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
            state: Optional[SolveState] = None,
            group=None) -> SolverResult:
    """Paper Algorithm 3: the block_size = 1 special case of bdcd_svm."""
    require_unit_block(cfg, "dcd_svm")
    return bdcd_svm(problem, cfg, alpha0, state, group)


def _cli_kernel(args) -> str:
    """--kernel is None when unset; this family defaults to linear."""
    return args.kernel or "linear"


def _cli_problem(args):
    from repro_torch.data.sparse import make_svm_dataset
    A, b = make_svm_dataset(args.dataset, args.seed,
                            as_operand=args.sparse, device=args.device)
    kernel = _cli_kernel(args)
    return SVMProblem(A=A, b=b, lam=1.0, loss=args.svm_loss, kernel=kernel,
                      kernel_params=build_kernel_params(kernel, args))


def _cli_describe(args, res, elapsed: float) -> str:
    obj = res.objective.cpu().numpy()
    return (f"svm-{args.svm_loss}[{_cli_kernel(args)}] {args.dataset} "
            f"s={args.s} mu={args.mu} "
            f"device={args.device}{' sparse' if args.sparse else ''}: "
            f"dual {obj[0]:.5f} -> {obj[-1]:.5f}, {elapsed:.2f}s")


@register_family(
    "svm",
    problem_cls=SVMProblem,
    partition="col",
    default_axes="model",
    x0_layout="replicated",
    aux_out=(("alpha", "replicated"),),
    accepts=lambda p: p.kernel == "linear",
    variants={
        "classical": "repro_torch.core.svm:bdcd_svm",
        "sa": "repro_torch.core.sa_svm:sa_bdcd_svm",
    },
    objective=dual_objective,
    # this family only accepts kernel="linear" problems; the hook still
    # takes the registry-wide kernel argument and ignores it.
    costs=lambda dims, H, mu, s, P, kernel="linear": cost_model.svm_costs(
        dims, H, s, P, mu=mu),
    make_problem=_cli_problem,
    describe=_cli_describe,
    default_mu=1,
    bench_block_size=1,
    bench_problem_kwargs={"lam": 1.0},
    supports_symmetric_gram=True,
    state_layout=lambda cfg: (("alpha", "replicated"), ("x", "partition"),
                              ("dual", "replicated")),
)
def solve_svm(problem: SVMProblem, cfg: SolverConfig, x0=None,
              state=None, group=None) -> SolverResult:
    """Dispatch on (problem.kernel, cfg.s): a kernel other than "linear"
    goes to the ``ksvm`` family's ``solve_ksvm``; otherwise s == 1 ->
    bdcd_svm, s > 1 -> SA-BDCD. x0 is a warm start of the dual alpha;
    ``group`` the process group of a column-sharded solve."""
    if problem.kernel != "linear":
        from repro_torch.core.kernel_svm import solve_ksvm
        return solve_ksvm(problem, cfg, x0, state, group)
    if cfg.s > 1:
        from repro_torch.core.sa_svm import sa_bdcd_svm
        return sa_bdcd_svm(problem, cfg, x0, state, group)
    return bdcd_svm(problem, cfg, x0, state, group)
