"""Kernel SVM — K-BDCD and its s-step synchronization-avoiding unroll
SA-K-BDCD (after Shao & Devarakonda, arXiv:2406.18001); the port of
``repro/core/kernel_svm.py``, dense or sparse operands, on one process or
sharded by columns.

The dual problem swaps the linear Gram block Y Y^T for a kernel block
K(Y, Y):

    min_a  1/2 a^T (diag(b) K(A, A) diag(b) + gamma I) a - e^T a,
    0 <= a_i <= nu

With a nonlinear kernel there is no n-dimensional primal to shadow, so the
solvers keep the replicated dual residual f = K(A, A) (b * alpha) in R^m:
the block gradient is the gather g_B = b_B * f[B] - 1 + gamma a_B, and f
is updated from the (m, mu) kernel column block K(A, Y) each iteration
already reduces.

Layout (as the linear SVM): A is partitioned by columns (m, n_loc);
alpha, b and f are replicated, and the primal shadow x = A^T (b alpha) is
this rank's slice. Each iteration makes ONE reduction, of the local cross
block [A Y^T | rownorms(A)] over ``group`` (the norms column rides along
only for a kernel that needs it, rbf); the kernel transform is applied to
the reduced copy. For a sparse A the cross block runs the ``spmm`` kernel
(K4) on the card; SA-K-BDCD runs its s inner updates through the
``svm_inner`` kernel (K3) with G = K(Y, Y) + gamma I and the gathered
residual f[B] as the projections.

``kernel="linear"`` reproduces ``bdcd_svm`` / ``sa_bdcd_svm`` (f = A x by
definition). ``cfg.symmetric_gram`` does not apply to the (m, s mu) cross
block and is ignored.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import seams
from repro_torch.core import cost_model, linalg, rng
from repro_torch.core.engine import (Ctx, FamilyProgram, block_draws,
                                     run_program)
from repro_torch.core.sparse_exec import (cross_block, prep_operand,
                                          row_block_ops, spmm_aux)
from repro_torch.core.types import (SVMProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    build_kernel_params, operand_rmatvec,
                                    register_family, resolve_device,
                                    resume_carry)
# Module imports: their plain versions import core.linalg, so the names
# are read at call time.
from repro_torch.kernels import spmm, svm_inner

# Elements of one densified chunk of the warm-start rebuild K(A, A).
FULL_CROSS_BUDGET = 1 << 26


def _local_norms(A, needs_norms: bool):
    """(m, 1) local partial squared row norms, computed once per solve and
    fused into every reduction; None when the kernel needs none. A sparse
    operand sums its stored row values (O(nnz))."""
    if not needs_norms:
        return None
    if isinstance(A, SparseOperand):
        return torch.sum(A.row_vals * A.row_vals, dim=1, keepdim=True)
    return torch.sum(A * A, dim=1, keepdim=True)


def _reduce_cross(local, group, norms_local):
    """ONE reduction of the LOCAL cross block ``[local | norms]`` over
    ``group`` -> (cross, norms or None)."""
    if norms_local is None:
        return linalg.preduce(local, group), None
    red = linalg.preduce(torch.cat([local, norms_local], dim=1), group)
    return red[:, :-1], red[:, -1]


def _full_cross_local(A):
    """LOCAL A A^T (m, m), for the warm-start rebuild and the direct
    objective. A sparse A densifies its rows a chunk at a time (each chunk
    at most ``FULL_CROSS_BUDGET`` elements, sized for the device's memory
    rather than ``repro``'s 16 MB) and contracts each chunk through the
    ELL arrays; every entry is one ELL row pass whatever the chunk, so
    the values do not depend on it."""
    if not isinstance(A, SparseOperand):
        return A @ A.T
    m, n_loc = A.shape
    chunk = int(max(1, min(m, FULL_CROSS_BUDGET // max(n_loc, 1))))
    pieces = []
    for start in range(0, m, chunk):
        idx = torch.arange(start, min(start + chunk, m), device=A.device)
        cols, vals, _ = A.gather_rows(idx)
        pieces.append(cross_block(A, spmm.scatter_dense(cols, vals, n_loc)))
    return torch.cat(pieces, dim=1)


def _kernelize(problem: SVMProblem, cross, anorms, flat_idx, dtype):
    """The registered kernel on the reduced cross block: K(A, Y)[i, j] =
    k(a_i, y_j), with y's norms gathered from a's."""
    ynorms = None if anorms is None else anorms[flat_idx]
    return problem.kernel_spec.fn(cross, anorms, ynorms,
                                  problem.kernel_params).to(dtype)


def kernel_dual_objective(problem: SVMProblem, alpha, group=None):
    """f_D(alpha) = 1/2 (b a)^T K (b a) + gamma/2 ||a||^2 - e^T a, from the
    full (m, m) kernel matrix (a diagnostic and test oracle: O(m^2)
    memory), in A's dtype on A's device; sharded by columns, the cross
    block and norms are one reduction over ``group``."""
    A = problem.A if isinstance(problem.A, SparseOperand) \
        else torch.as_tensor(problem.A)
    b = torch.as_tensor(problem.b).to(device=A.device, dtype=A.dtype)
    alpha = torch.as_tensor(alpha).to(device=A.device, dtype=A.dtype)
    spec = problem.kernel_spec
    cross, anorms = _reduce_cross(_full_cross_local(A), group,
                                  _local_norms(A, spec.needs_norms))
    K = spec.fn(cross, anorms, anorms, problem.kernel_params)
    ba = b * alpha
    return 0.5 * ba @ (K @ ba) \
        + 0.5 * problem.gamma * torch.sum(alpha * alpha) - torch.sum(alpha)


def _init_state(problem: SVMProblem, cfg: SolverConfig, group, alpha0,
                carry0=None):
    """(A, b, device, (alpha, x, f, dual)): the operands on the solve's
    device and the starting carry — restored verbatim from a state, zero
    (no communication), or rebuilt from the warm start alpha0 with the
    full K(A, A) (one reduction over ``group``), the dual f_D(alpha0)
    taken from that f."""
    device = resolve_device(cfg.device)
    A = prep_operand(problem.A, cfg.dtype, device)
    b = torch.as_tensor(problem.b).to(device=device, dtype=cfg.dtype)
    m = A.shape[0]

    def vec(v):
        return torch.as_tensor(v).to(device=device, dtype=cfg.dtype,
                                     copy=True)

    if carry0 is not None:
        return A, b, device, tuple(vec(carry0[k])
                                   for k in ("alpha", "x", "f", "dual"))
    if alpha0 is None:
        zero = torch.zeros((), dtype=cfg.dtype, device=device)
        return A, b, device, (
            torch.zeros(m, dtype=cfg.dtype, device=device),
            torch.zeros(A.shape[1], dtype=cfg.dtype, device=device),
            torch.zeros(m, dtype=cfg.dtype, device=device), zero)
    alpha = vec(alpha0)
    spec = problem.kernel_spec
    cross, anorms = _reduce_cross(_full_cross_local(A), group,
                                  _local_norms(A, spec.needs_norms))
    K = spec.fn(cross, anorms, anorms, problem.kernel_params).to(cfg.dtype)
    del cross
    ba = b * alpha
    f = K @ ba
    x = operand_rmatvec(A, ba)
    dual = 0.5 * ba @ f + 0.5 * problem.gamma * torch.sum(alpha * alpha) \
        - torch.sum(alpha)
    return A, b, device, (alpha, x, f, dual)


def kbdcd_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
              state: Optional[SolveState] = None,
              group=None) -> SolverResult:
    """Kernel block dual coordinate descent (K-BDCD).

    Per iteration: sample a block B of mu rows, reduce the fused
    [A Y^T | norms] cross block (ONE reduction over ``group``), kernelize
    it to K(A, Y), and take the projected block-gradient step

        alpha_B <- clip(alpha_B - g_B / lambda_max(K_BB + gamma I), 0, nu)

    with g_B = b_B * f[B] - 1 + gamma alpha_B, then f += K(A, Y)(b_B theta).
    At mu = 1 the (1, 1) block is the step size. The dual is tracked
    incrementally as in ``bdcd_svm`` with G -> K_BB + gamma I."""
    mu = cfg.block_size
    gamma, nu = float(problem.gamma), float(problem.nu)
    carry0 = resume_carry(state, alpha0, "kbdcd_svm")
    start = 0 if state is None else int(state.iteration)
    A, b, device, (alpha, x, f, dual) = _init_state(problem, cfg, group,
                                                    alpha0, carry0)
    take, _, densify, apply_t = row_block_ops(A)
    norms_local = _local_norms(A, problem.kernel_spec.needs_norms)
    m = A.shape[0]
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
            cross, anorms = _reduce_cross(cross_block(A, densify(Y)), group,
                                          norms_local)
            Kcol = _kernelize(problem, cross, anorms, idx, cfg.dtype)
            KBB = Kcol[idx] + gamma * eye_mu
            a_B = alpha[idx]
            g = b_B * f[idx] - 1.0 + gamma * a_B
            v = KBB[0, 0] if mu == 1 \
                else linalg.power_iteration_max_eig(KBB, cfg.power_iters)
            gbar = torch.abs(torch.clamp(a_B - g, 0.0, nu) - a_B)
            theta = torch.where(
                gbar != 0.0, torch.clamp(a_B - g / v, 0.0, nu) - a_B,
                torch.zeros_like(a_B))
            alpha = alpha.index_add(0, idx, theta)
            bt = b_B * theta
            f = f + Kcol @ bt
            x = x + apply_t(Y, bt)
            dual = dual + torch.sum(theta * g) + 0.5 * bt @ (KBB @ bt)
            objs.append(dual if cfg.track_objective
                        else torch.zeros((), dtype=cfg.dtype, device=device))
    return SolverResult(
        x=x, objective=torch.stack(objs),
        aux={"alpha": alpha, "dual": dual, "f": f,
             "state": SolveState(start + cfg.iterations,
                                 {"alpha": alpha, "x": x, "f": f,
                                  "dual": dual}),
             **spmm_aux(A, "cross")})


# ---------------------------------------------------------------------------
# SA-K-BDCD: the s-step unroll, as an engine FamilyProgram.
# ---------------------------------------------------------------------------

def _sak_setup(problem, cfg, group, alpha0, carry0):
    A, b, device, carry = _init_state(problem, cfg, group, alpha0, carry0)
    take, _, densify, apply_t = row_block_ops(A)
    ctx = Ctx(A=A, b=b, m=A.shape[0], mu=cfg.block_size,
              gamma=float(problem.gamma), nu=float(problem.nu),
              take=take, densify=densify, apply_t=apply_t,
              norms_local=_local_norms(A, problem.kernel_spec.needs_norms),
              problem=problem, cfg=cfg, device=device,
              sample_width=A.shape[0], bits=rng.bits_for(cfg.dtype),
              group=group)
    return ctx, carry


def _sak_sample(ctx, keys):
    return linalg.sample_block(keys, ctx.m, ctx.mu, ctx.bits)


def _sak_assemble(ctx, carry, idxs, s_grp):
    Y = ctx.take(idxs.reshape(s_grp * ctx.mu))        # (s*mu, n_loc) rows
    # LOCAL half of the fused [A Y^T | norms] block; the norms column
    # rides along only for a kernel that needs it (rbf).
    local = cross_block(ctx.A, ctx.densify(Y))
    if ctx.norms_local is not None:
        local = torch.cat([local, ctx.norms_local], dim=1)
    return Y, local


def _sak_reduce(ctx, local, idxs, s_grp):
    # The group's ONE reduction, then the kernel on the replicated copy:
    # K(A, Y_group) and the regularized (s mu, s mu) block K(Y, Y) + gamma I,
    # whose off-diagonal blocks carry the inner cross terms.
    flat = idxs.reshape(s_grp * ctx.mu)
    red = linalg.preduce(local, ctx.group)
    cross, anorms = (red, None) if ctx.norms_local is None \
        else (red[:, :-1], red[:, -1])
    Kfull = _kernelize(ctx.problem, cross, anorms, flat, ctx.cfg.dtype)
    G = Kfull[flat] + ctx.gamma * torch.eye(
        s_grp * ctx.mu, dtype=ctx.cfg.dtype, device=ctx.device)
    return G, Kfull


def _sak_inner(ctx, carry, Y, payload, idxs, win, s_grp):
    alpha, _, f, _ = carry
    G, _ = payload
    flat = idxs.reshape(s_grp * ctx.mu)
    b_sel = ctx.b[flat].reshape(s_grp, ctx.mu)
    # The s dependent updates on the svm_inner kernel; the projections
    # are the gathered residual f[B] (no projection is communicated).
    theta, deltas = svm_inner.svm_inner_loop(
        G, f[flat].reshape(s_grp, ctx.mu), b_sel,
        alpha[flat].reshape(s_grp, ctx.mu), idxs.contiguous(),
        gamma=ctx.gamma, nu=ctx.nu, power_iters=ctx.cfg.power_iters)
    return carry, (theta, deltas, b_sel, flat)


def _sak_defer(ctx, carry, Y, inner_out, payload, idxs, win, s_grp):
    alpha, x, f, dual = carry
    _, Kfull = payload
    theta, deltas, b_sel, flat = inner_out
    smu = s_grp * ctx.mu
    bt = (b_sel * theta).reshape(smu)
    alpha = alpha.index_add(0, flat, theta.reshape(smu))
    f = f + Kfull @ bt                                # deferred GEMV
    x = x + ctx.apply_t(Y, bt)                        # primal shadow
    objs = dual + torch.cumsum(deltas, 0) if ctx.cfg.track_objective \
        else torch.zeros(s_grp, dtype=ctx.cfg.dtype, device=ctx.device)
    return (alpha, x, f, dual + torch.sum(deltas)), objs


_SAK_PROGRAM = FamilyProgram(
    name="sa_kbdcd_svm", setup=_sak_setup, sample=_sak_sample,
    assemble=_sak_assemble, reduce=_sak_reduce, inner=_sak_inner,
    defer=_sak_defer,
    finalize=lambda ctx, carry, sched: (
        carry[1], {"alpha": carry[0], "dual": carry[3], "f": carry[2]}),
    carry_names=("alpha", "x", "f", "dual"),
    inner_impl=lambda ctx, s_grp: svm_inner.inner_impl(ctx.device),
    spmm_kind="cross")


def sa_kbdcd_svm(problem: SVMProblem, cfg: SolverConfig, alpha0=None,
                 state: Optional[SolveState] = None,
                 group=None) -> SolverResult:
    """s-step unrolled K-BDCD: the iterates of ``kbdcd_svm`` in exact
    arithmetic, ONE reduction of the (m, s mu [+ 1]) cross block per s
    inner iterations. The inner projections are the gathered f[B]; per
    group the deferred updates are f += K(A, Y) vec(b theta) and the
    primal shadow's x += Y^T vec(b theta)."""
    return run_program(_SAK_PROGRAM, problem, cfg, alpha0, state, group)


def _cli_kernel(args) -> str:
    """--kernel is None when unset; this family defaults to rbf, and an
    explicit --kernel linear is honoured (the kernelized linear path
    gives the BDCD iterates)."""
    return args.kernel or "rbf"


def _cli_problem(args):
    from repro_torch.data.sparse import make_svm_dataset
    A, b = make_svm_dataset(args.dataset, args.seed,
                            as_operand=args.sparse, device=args.device)
    kernel = _cli_kernel(args)
    return SVMProblem(A=A, b=b, lam=1.0, loss=args.svm_loss, kernel=kernel,
                      kernel_params=build_kernel_params(kernel, args))


def _cli_describe(args, res, elapsed: float) -> str:
    obj = res.objective.cpu().numpy()
    return (f"ksvm-{args.svm_loss}[{_cli_kernel(args)}] {args.dataset} "
            f"s={args.s} mu={args.mu} "
            f"device={args.device}{' sparse' if args.sparse else ''}: "
            f"dual {obj[0]:.5f} -> {obj[-1]:.5f}, {elapsed:.2f}s")


@register_family(
    "ksvm",
    problem_cls=SVMProblem,
    partition="col",
    default_axes="model",
    x0_layout="replicated",          # a warm start is the dual alpha
    aux_out=(("alpha", "replicated"), ("f", "replicated")),
    accepts=lambda p: p.kernel != "linear",
    variants={
        "classical": "repro_torch.core.kernel_svm:kbdcd_svm",
        "sa": "repro_torch.core.kernel_svm:sa_kbdcd_svm",
    },
    objective=kernel_dual_objective,
    # the caller passes problem.kernel; the default is this family's CLI
    # default, rbf.
    costs=lambda dims, H, mu, s, P, kernel="rbf": cost_model.svm_costs(
        dims, H, s, P, mu=mu, kernel=kernel),
    make_problem=_cli_problem,
    describe=_cli_describe,
    default_mu=1,
    bench_block_size=2,
    bench_problem_kwargs={"lam": 1.0, "kernel": "rbf",
                          "kernel_params": {"gamma": 0.1}},
    # the kernelized message is the (m, s*mu) cross block — replicated
    # memory grows with s*mu, so the candidate grid stays smaller.
    tune_space={"s": (1, 2, 4, 8, 16, 32), "mu": (1, 2, 4, 8)},
    state_layout=lambda cfg: (("alpha", "replicated"), ("x", "partition"),
                              ("f", "replicated"), ("dual", "replicated")),
)
def solve_ksvm(problem: SVMProblem, cfg: SolverConfig, x0=None,
               state=None, group=None) -> SolverResult:
    """Dispatch on cfg.s: s == 1 -> kbdcd_svm, s > 1 -> SA-K-BDCD. x0 is
    a warm start of the dual alpha (replicated (m,)); rebuilding f =
    K (b alpha) costs one setup reduction (a zero start and a ``state``
    resume cost none)."""
    if cfg.s > 1:
        return sa_kbdcd_svm(problem, cfg, x0, state, group)
    return kbdcd_svm(problem, cfg, x0, state, group)
