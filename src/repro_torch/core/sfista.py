"""Sampled FISTA (SFISTA) and its s-step synchronization-avoiding unroll
CA-SFISTA (after Soori et al., arXiv:1710.08883); the port of
``repro/core/sfista.py``, dense or sparse operands, on one process or
sharded by rows.

SFISTA takes a FISTA step restricted to a random block B of mu
coordinates of the momentum iterate y:

    x_h = y_{h-1} + e_B d,   d = prox(y_B - eta A_B^T ry, eta) - y_B
    y_h = x_h + beta_h e_B (x_B^h - x_B^{h-1}),
    beta_h = (t_{h-1} - 1) / t_h      (the FISTA t-sequence),

with eta = 1 / lambda_max(A_B^T A_B) and rx = A x - b, ry = A y - b the
two residuals (row-partitioned, like the Lasso's). The momentum acts in
the sampled subspace only, so y - x stays supported on the last block.
Per classical iteration: ONE reduction of the (mu, mu + 1) block
[G | A_B^T ry] over ``group``.

CA-SFISTA samples all s blocks up front, reduces the group's Y^T [Y | ry]
ONCE (for a dense A through the ``gram`` kernel on the card, for a sparse
one through ``spmm``), and runs the s dependent inner updates on
replicated data: with c_t = d_t + beta_t w_t,

    ry_j = ry_sk + sum_{t <= j} A_{B_t} c_t,   rx_j = ry_{j-1} + A_{B_j} d_j,

so step j's gradient is A_{B_j}^T ry_sk (the payload column) plus Gram
contractions with the recorded c_t. x and y in R^n are replicated and
updated in the inner loop; the s step sizes depend only on the diagonal
Gram blocks, so their power iterations run batched before the chain. The
deferred products then rebuild rx and ry (and each step's residual for
the objective trace, whose s squared norms are one reduction).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import seams
from repro_torch.core import cost_model, linalg, prox as prox_lib, rng
from repro_torch.core.engine import (Ctx, FamilyProgram, block_draws,
                                     deferred_steps, gram_local,
                                     reduce_gram_proj, run_program)
from repro_torch.core.sparse_exec import (col_block_ops, prep_operand,
                                          spmm_aux)
from repro_torch.core.types import (SolveState, SolverConfig, SolverResult,
                                    SparseOperand, operand_matvec,
                                    register_family, resolve_device,
                                    resume_carry)


@dataclasses.dataclass(frozen=True)
class SFISTAProblem:
    """Proximal least-squares problem data for the (CA-)SFISTA family.

    The data of :class:`~repro_torch.core.types.LassoProblem` — A (m, n)
    dense or a :class:`~repro_torch.core.types.SparseOperand` (sharded, a
    rank's rows), b (m,), the l1 weight lam, an optional l2 weight
    (elastic net) — in a class of its own, so the registry selects the
    momentum (FISTA) iteration instead of coordinate descent.
    """

    A: Any
    b: Any
    lam: float
    l2: float = 0.0

    @property
    def shape(self):
        return tuple(self.A.shape)


def _prep(problem: SFISTAProblem, cfg: SolverConfig):
    """(A, b, n, mu, prox, device): the operands on the solve's device
    and dtype, and the problem's prox."""
    device = resolve_device(cfg.device)
    A = prep_operand(problem.A, cfg.dtype, device)
    b = torch.as_tensor(problem.b).to(device=device, dtype=cfg.dtype)
    prox = prox_lib.make_prox(problem.lam, problem.l2, None)
    return A, b, A.shape[1], cfg.block_size, prox, device


def _objective(residual, x, problem, group=None):
    """1/2 ||residual||^2 + g(x) over the last axis; the squared norms of
    a row-sharded residual (one per leading index) are one reduction over
    ``group``."""
    quad = linalg.preduce(torch.sum(residual * residual, dim=-1), group)
    return 0.5 * quad + prox_lib.reg_value(x, problem.lam, problem.l2, None)


def _init_iterates(A, b, n, cfg, device, x0, carry0):
    """(x, y, rx, ry): restored verbatim from a state, rebuilt locally
    from a warm start (the momentum restarts: y = x, ry = rx), or the zero
    start, where rx = ry = -b; none communicates."""
    def vec(v):
        return torch.as_tensor(v).to(device=device, dtype=cfg.dtype,
                                     copy=True)

    if carry0 is not None:
        return tuple(vec(carry0[k]) for k in ("x", "y", "rx", "ry"))
    if x0 is None:
        x = torch.zeros(n, dtype=cfg.dtype, device=device)
        return x, x, -b, -b
    x = vec(x0)
    rx = operand_matvec(A, x) - b
    return x, x, rx, rx


# ---------------------------------------------------------------------------
# Classical SFISTA: one (mu, mu + 1) reduction per iteration.
# ---------------------------------------------------------------------------

def sfista(problem: SFISTAProblem, cfg: SolverConfig, x0=None,
           state: Optional[SolveState] = None,
           group=None) -> SolverResult:
    """Sampled FISTA (block proximal gradient with subspace momentum).

    x0: optional warm start (replicated (n,)); the momentum restarts and
    both residuals are rebuilt locally. state: optional
    :class:`SolveState` resuming x, y, rx, ry at its iteration; the
    t-schedule is recomputed over ``start + H`` steps, so its prefix is
    the uninterrupted one. group: the process group of a row-sharded
    solve."""
    A, b, n, mu, prox, device = _prep(problem, cfg)
    block_gram, block_apply = col_block_ops(A)
    H = cfg.iterations
    carry0 = resume_carry(state, x0, "sfista")
    start = 0 if state is None else int(state.iteration)
    ts = linalg.fista_t_schedule(start + H, cfg.dtype, device)
    x, y, rx, ry = _init_iterates(A, b, n, cfg, device, x0, carry0)
    bits = rng.bits_for(cfg.dtype)
    key = rng.key(cfg.seed, bits, device)
    objs = []
    h = start
    for batch in block_draws(key,
                             lambda k: linalg.sample_block(k, n, mu, bits),
                             start, H, n):
        for idx in seams.outer_loop(batch):
            h += 1
            Ah, local = block_gram(idx, ry[:, None])     # (mu, mu+1) local
            GR = linalg.preduce(local, group)
            G, g = GR[:, :mu], GR[:, mu]
            v = linalg.power_iteration_max_eig(G, cfg.power_iters)
            eta = 1.0 / linalg.floor_eig(v)   # floored: zero block, no-op
            yB = y[idx]
            d = prox(yB - eta * g, eta) - yB
            x_new = y.index_add(0, idx, d)               # prox step on y
            rx = ry + block_apply(Ah, d)                 # A x_new - b
            beta = (ts[h - 1] - 1.0) / ts[h]
            w = yB + d - x[idx]                          # x_B^h - x_B^{h-1}
            y = x_new.index_add(0, idx, beta * w)        # subspace momentum
            ry = ry + block_apply(Ah, d + beta * w)
            x = x_new
            objs.append(_objective(rx, x, problem, group)
                        if cfg.track_objective
                        else torch.zeros((), dtype=cfg.dtype, device=device))
    return SolverResult(
        x=x, objective=torch.stack(objs),
        aux={"residual": rx,
             "state": SolveState(start + H,
                                 {"x": x, "y": y, "rx": rx, "ry": ry}),
             **spmm_aux(A, "col_gram")})


# ---------------------------------------------------------------------------
# CA-SFISTA: the s-step unroll, as an engine FamilyProgram.
# ---------------------------------------------------------------------------

def _ca_setup(problem, cfg, group, x0, carry0):
    A, b, n, mu, prox, device = _prep(problem, cfg)
    ctx = Ctx(A=A, b=b, n=n, mu=mu, prox=prox,
              sparse=isinstance(A, SparseOperand),
              block_gram=col_block_ops(A)[0], m_loc=A.shape[0],
              problem=problem, cfg=cfg, device=device, sample_width=n,
              bits=rng.bits_for(cfg.dtype), group=group)
    return ctx, _init_iterates(A, b, n, cfg, device, x0, carry0)


def _ca_sample(ctx, keys):
    return linalg.sample_block(keys, ctx.n, ctx.mu, ctx.bits)


def _ca_schedule(ctx, cfg, total):
    return linalg.fista_t_schedule(total, cfg.dtype, ctx.device)


def _ca_assemble(ctx, carry, idxs, s_grp):
    x, y, rx, ry = carry
    flat = idxs.reshape(s_grp * ctx.mu)
    if ctx.sparse:
        return ctx.block_gram(flat, ry[:, None])
    Y = ctx.A[:, flat]                                # (m_loc, s*mu) local
    return Y, gram_local(Y, ry[None])                 # Y^T [Y | ry]


def _ca_reduce(ctx, local, idxs, s_grp):
    return reduce_gram_proj(local, s_grp * ctx.mu, 1, ctx.group,
                            ctx.cfg.symmetric_gram)


def _ca_inner(ctx, carry, handle, payload, idxs, win, s):
    x, y, rx, ry = carry
    cfg, mu = ctx.cfg, ctx.mu
    G, P = payload
    G4 = G.reshape(s, mu, s, mu)
    ry_proj = P[:, 0].reshape(s, mu)                  # A_j^T ry_sk
    th_prev, th_cur = win
    betas = (th_prev - 1.0) / th_cur
    steps = torch.arange(s, device=ctx.device)
    vs = linalg.power_iteration_max_eig_batched(G4[steps, :, steps, :],
                                                cfg.power_iters)
    etas = 1.0 / linalg.floor_eig(vs)                 # floored: zero block
    c_buf = torch.zeros((s, mu), dtype=cfg.dtype, device=ctx.device)
    d_buf = torch.zeros((s, mu), dtype=cfg.dtype, device=ctx.device)
    xs = []
    for j in range(s):
        idx_j = idxs[j]
        # ry_{j-1} = ry_sk + sum_t A_{B_t} c_t: the gradient is the payload
        # column plus Gram contractions with the recorded c_t (rows t >= j
        # are still zero).
        g = ry_proj[j] + torch.einsum("ptq,tq->p", G4[j], c_buf)
        eta = etas[j]
        yB = y[idx_j]
        d = ctx.prox(yB - eta * g, eta) - yB
        x_new = y.index_add(0, idx_j, d)              # prox step on y
        w = yB + d - x[idx_j]                         # x_B^j - x_B^{j-1}
        beta = betas[j]
        y = x_new.index_add(0, idx_j, beta * w)       # subspace momentum
        x = x_new
        c_buf[j] = d + beta * w
        d_buf[j] = d
        if cfg.track_objective:
            xs.append(x)
    return (x, y, rx, ry), (c_buf, d_buf, xs)


def _ca_defer(ctx, carry, handle, inner_out, payload, idxs, win, s):
    x, y, rx, ry = carry
    c_buf, d_buf, xs = inner_out
    # Deferred m-dimensional steps (dense: products of the sampled columns;
    # sparse: scatter-adds over their nonzeros): A_{B_t} c_t rebuilds the
    # momentum residual ry, A_{B_t} d_t the prox-point residual rx.
    steps_c = deferred_steps(ctx, handle, c_buf, s)   # (s, m_loc)
    steps_d = deferred_steps(ctx, handle, d_buf, s)
    cum = torch.cumsum(steps_c, dim=0)
    prefix = ry[None, :] + cum - steps_c              # ry_{j-1} per step
    ry_new = ry + cum[-1]
    rx_new = prefix[-1] + steps_d[-1]
    if ctx.cfg.track_objective:
        # rx_j per step; the s squared norms are ONE reduction.
        objs = _objective(prefix + steps_d, torch.stack(xs), ctx.problem,
                          ctx.group)
    else:
        objs = torch.zeros(s, dtype=ctx.cfg.dtype, device=ctx.device)
    return (x, y, rx_new, ry_new), objs


_CA_PROGRAM = FamilyProgram(
    name="ca_sfista", setup=_ca_setup, sample=_ca_sample,
    assemble=_ca_assemble, reduce=_ca_reduce, inner=_ca_inner,
    defer=_ca_defer,
    finalize=lambda ctx, carry, sched: (carry[0], {"residual": carry[2]}),
    carry_names=("x", "y", "rx", "ry"), schedule=_ca_schedule,
    spmm_kind="col_gram")


def ca_sfista(problem: SFISTAProblem, cfg: SolverConfig, x0=None,
              state: Optional[SolveState] = None,
              group=None) -> SolverResult:
    """s-step unrolled SFISTA: the iterates of ``sfista`` in exact
    arithmetic, ONE reduction per s inner iterations (a tracked objective
    adds one, of the group's s squared residual norms)."""
    return run_program(_CA_PROGRAM, problem, cfg, x0, state, group)


# ---------------------------------------------------------------------------
# Registration.
# ---------------------------------------------------------------------------

def sfista_objective(problem: SFISTAProblem, x, group=None):
    """1/2 ||A x - b||^2 + g(x), evaluated directly in A's dtype on A's
    device; sharded by rows, the squared norm is summed over ``group``."""
    A = problem.A if isinstance(problem.A, SparseOperand) \
        else torch.as_tensor(problem.A)
    x = torch.as_tensor(x).to(device=A.device, dtype=A.dtype)
    residual = operand_matvec(A, x) \
        - torch.as_tensor(problem.b).to(device=A.device, dtype=A.dtype)
    return _objective(residual, x, problem, group)


def _cli_problem(args):
    from repro_torch.data.sparse import make_lasso_dataset
    A, b, lam_max = make_lasso_dataset(args.dataset, args.seed,
                                       as_operand=args.sparse,
                                       device=args.device)
    return SFISTAProblem(A=A, b=b, lam=args.lam_frac * lam_max)


def _cli_describe(args, res, elapsed: float) -> str:
    obj = res.objective.cpu().numpy()
    nnz = int((res.x.abs() > 1e-8).sum())
    return (f"sfista {args.dataset} s={args.s} mu={args.mu} "
            f"device={args.device}{' sparse' if args.sparse else ''}: "
            f"obj {obj[0]:.4f} -> {obj[-1]:.4f}, nnz(x)={nnz}, "
            f"{elapsed:.2f}s")


@register_family(
    "sfista",
    problem_cls=SFISTAProblem,
    partition="row",
    default_axes="data",
    x0_layout="replicated",
    aux_out=(("residual", "partition"),),
    variants={
        "classical": "repro_torch.core.sfista:sfista",
        "sa": "repro_torch.core.sfista:ca_sfista",
    },
    objective=sfista_objective,
    # same operand layout and fused-payload shapes as Lasso, so
    # Table I's Lasso entries model it.
    costs=lambda dims, H, mu, s, P, kernel="linear": cost_model.lasso_costs(
        dims, H, mu, s, P),
    make_problem=_cli_problem,
    describe=_cli_describe,
    default_mu=8,
    bench_block_size=4,
    bench_problem_kwargs={"lam": 0.1},
    # the fused payload replicates (s mu)^2 + s mu entries — same growth
    # as Lasso, so the same candidate grid applies.
    tune_space={"s": (1, 2, 4, 8, 16, 32), "mu": (1, 2, 4, 8, 16)},
    supports_symmetric_gram=True,
    state_layout=lambda cfg: (("x", "replicated"), ("y", "replicated"),
                              ("rx", "partition"), ("ry", "partition")),
)
def solve_sfista(problem: SFISTAProblem, cfg: SolverConfig, x0=None,
                 state=None, group=None) -> SolverResult:
    """Dispatch on cfg.s: classical SFISTA vs the CA-SFISTA unroll."""
    if cfg.s > 1:
        return ca_sfista(problem, cfg, x0, state, group)
    return sfista(problem, cfg, x0, state, group)
