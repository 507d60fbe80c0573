"""Classical (synchronous) coordinate-descent solvers for proximal
least-squares — paper Algorithm 1 and its non-accelerated /
single-coordinate variants (accBCD, BCD, accCD, CD). The port of
``repro/core/lasso.py``, dense or sparse operands.

Two execution modes, as in ``repro``:

* one process: ``group=None``, A is the full (m, n) matrix;
* sharded (``repro_torch.core.api.solve_sharded``): A, b and the
  residuals are this rank's rows; x is replicated, and every (mu, mu + 1)
  Gram/projection block is summed over ``group`` by ``linalg.preduce``.

These are the in-port oracle the SA solvers are held to (SA and
classical draw the same blocks and agree in exact arithmetic). Each
iteration's (mu, mu + 1) Gram/projection block is a plain product for a
dense A (the hand-written ``gram`` kernel serves the SA solvers' (s mu)-
wide block), and the ``spmm`` kernel for a sparse one
(``core.sparse_exec.col_block_ops``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import seams
from repro_torch.core import cost_model, linalg, prox as prox_lib, rng
from repro_torch.core.engine import block_draws
from repro_torch.core.sparse_exec import (col_block_ops, prep_operand,
                                          spmm_aux)
from repro_torch.core.types import (LassoProblem, SolveState, SolverConfig,
                                    SolverResult, SparseOperand,
                                    operand_matvec, register_family,
                                    require_unit_block, resolve_device,
                                    resume_carry)


def _validate_groups(groups, n: int, mu: int) -> None:
    """Group lasso contract: groups are contiguous, equal-sized blocks of
    exactly mu coordinates, one distinct id per block."""
    if n % mu != 0:
        raise ValueError(
            f"group lasso requires block_size (the group size) to divide "
            f"n: got n={n}, block_size={mu} — the trailing {n % mu} "
            f"coordinates would never be sampled or updated")
    g = np.asarray(groups)
    if g.shape != (n,):
        raise ValueError(
            f"groups must be an (n,) array of group ids; got shape "
            f"{g.shape} for n={n}")
    blocks = g.reshape(n // mu, mu)
    uniform = (blocks == blocks[:, :1]).all()
    labels = blocks[:, 0]
    if not uniform or len(np.unique(labels)) != labels.size:
        raise ValueError(
            "groups must label contiguous, equal-sized blocks of "
            "block_size coordinates (one distinct group id per "
            "mu-sized block); the provided array does not — reorder "
            "the features or adjust cfg.block_size to the group size")


def as_vector(v, cfg: SolverConfig, device):
    """A fresh (n,) or (m,) tensor of the solve's dtype on ``device``: the
    solvers update carries in place, so they never alias a caller's
    tensor."""
    return torch.as_tensor(v).to(device=device, dtype=cfg.dtype, copy=True)


def _prep(problem: LassoProblem, cfg: SolverConfig):
    """(A, b, n, mu, q, sampler, prox, device): the operands on the
    solve's device and dtype, the block count q, and the batched block
    sampler keys (B, 2) -> (B, mu)."""
    device = resolve_device(cfg.device)
    A = prep_operand(problem.A, cfg.dtype, device)
    b = torch.as_tensor(problem.b).to(device=device, dtype=cfg.dtype)
    n = A.shape[1]
    mu = cfg.block_size
    bits = rng.bits_for(cfg.dtype)
    if problem.groups is not None:
        _validate_groups(problem.groups, n, mu)
        q = n // mu

        def sampler(keys):
            return linalg.sample_group(keys, q, mu, bits)
    else:
        q = -(-n // mu)  # ceil(n / mu)

        def sampler(keys):
            return linalg.sample_block(keys, n, mu, bits)
    prox = prox_lib.make_prox(problem.lam, problem.l2, problem.groups)
    return A, b, n, mu, q, sampler, prox, device


def _objective(residual, x, problem, group=None):
    """1/2 ||residual||^2 + g(x), over the last axis; the squared norms of
    a row-sharded residual (one per leading index) are summed over
    ``group`` in one reduction."""
    quad = linalg.preduce(torch.sum(residual * residual, dim=-1), group)
    return 0.5 * quad \
        + prox_lib.reg_value(x, problem.lam, problem.l2, problem.groups)


def _draws(cfg, sampler, device, start: int, n: int):
    """The blocks of global iterations start+1 .. start+H, one (mu,) block
    at a time, drawn in batches; each is one outer iteration to an open
    recorder."""
    key = rng.key(cfg.seed, rng.bits_for(cfg.dtype), device)
    for batch in block_draws(key, sampler, start, cfg.iterations, n):
        yield from seams.outer_loop(batch)


# ---------------------------------------------------------------------------
# Non-accelerated BCD (mu = 1 -> CD).
# ---------------------------------------------------------------------------

def bcd_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
              state: Optional[SolveState] = None,
              group=None) -> SolverResult:
    """Classical (non-accelerated) randomized block coordinate descent.

    x0: optional warm start; state: optional :class:`SolveState` carrying
    x and the residual plus the global iteration offset; group: the
    process group of a row-sharded solve (one reduction per iteration,
    two with the objective tracked)."""
    A, b, n, mu, q, sampler, prox, device = _prep(problem, cfg)
    block_gram, block_apply = col_block_ops(A)
    carry0 = resume_carry(state, x0, "bcd_lasso")
    start = 0 if state is None else int(state.iteration)
    if carry0 is not None:
        x = as_vector(carry0["x"], cfg, device)
        r = as_vector(carry0["residual"], cfg, device)
    elif x0 is None:
        x = torch.zeros(n, dtype=cfg.dtype, device=device)
        r = -b
    else:
        x = as_vector(x0, cfg, device)
        r = operand_matvec(A, x) - b
    objs = []
    for idx in _draws(cfg, sampler, device, start, n):
        Ah, local = block_gram(idx, r[:, None])
        GR = linalg.preduce(local, group)
        G, rh = GR[:, :mu], GR[:, mu]
        v = linalg.power_iteration_max_eig(G, cfg.power_iters)
        eta = 1.0 / linalg.floor_eig(v)
        g = x[idx] - eta * rh
        dx = prox(g, eta) - x[idx]
        x = x.index_add(0, idx, dx)
        r = r + block_apply(Ah, dx)
        objs.append(_objective(r, x, problem, group)
                    if cfg.track_objective
                    else torch.zeros((), dtype=cfg.dtype, device=device))
    return SolverResult(
        x=x, objective=torch.stack(objs),
        aux={"residual": r,
             "state": SolveState(start + cfg.iterations,
                                 {"x": x, "residual": r}),
             **spmm_aux(A, "col_gram")})


# ---------------------------------------------------------------------------
# Accelerated BCD — paper Algorithm 1 (APPROX / Fercoq–Richtarik).
# ---------------------------------------------------------------------------

def acc_bcd_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
                  state: Optional[SolveState] = None,
                  group=None) -> SolverResult:
    """Paper Algorithm 1: accelerated block coordinate descent for Lasso.

    State: z, y in R^n, ztil = Az - b, ytil = Ay in R^m; the iterate
    x_h = theta_h^2 y_h + z_h is implicit. x0 seeds z (y restarts at 0);
    state resumes z, y, ztil, ytil and the theta schedule; group as in
    :func:`bcd_lasso` (z, y replicated, ztil, ytil row-sharded)."""
    A, b, n, mu, q, sampler, prox, device = _prep(problem, cfg)
    block_gram, block_apply = col_block_ops(A)
    H = cfg.iterations
    carry0 = resume_carry(state, x0, "acc_bcd_lasso")
    start = 0 if state is None else int(state.iteration)
    thetas = linalg.theta_schedule(mu / n, start + H, cfg.dtype, device)

    if carry0 is not None:
        z = as_vector(carry0["z"], cfg, device)
        y = as_vector(carry0["y"], cfg, device)
        ztil = as_vector(carry0["ztil"], cfg, device)
        ytil = as_vector(carry0["ytil"], cfg, device)
    else:
        if x0 is None:
            z = torch.zeros(n, dtype=cfg.dtype, device=device)
            ztil = -b
        else:
            z = as_vector(x0, cfg, device)
            ztil = operand_matvec(A, z) - b
        y = torch.zeros(n, dtype=cfg.dtype, device=device)
        ytil = torch.zeros_like(b)

    objs = []
    for i, idx in enumerate(_draws(cfg, sampler, device, start, n)):
        th_prev, th_cur = thetas[start + i], thetas[start + i + 1]
        w = th_prev * th_prev * ytil + ztil
        Ah, local = block_gram(idx, w[:, None])             # lines 8-9
        GR = linalg.preduce(local, group)
        G, rh = GR[:, :mu], GR[:, mu]
        v = linalg.power_iteration_max_eig(G, cfg.power_iters)   # line 10
        eta = 1.0 / linalg.floor_eig(q * th_prev * v)     # line 11
        g = z[idx] - eta * rh                             # line 12
        dz = prox(g, eta) - z[idx]                        # line 13
        z = z.index_add(0, idx, dz)                       # line 14
        Adz = block_apply(Ah, dz)
        ztil = ztil + Adz                                 # line 15
        coef = (1.0 - q * th_prev) / (th_prev * th_prev)
        y = y.index_add(0, idx, -coef * dz)               # line 16
        ytil = ytil - coef * Adz                          # line 17
        if cfg.track_objective:
            objs.append(_objective(th_cur * th_cur * ytil + ztil,
                                   th_cur * th_cur * y + z, problem,
                                   group))
        else:
            objs.append(torch.zeros((), dtype=cfg.dtype, device=device))
    thH = thetas[-1]
    x = thH * thH * y + z                                 # line 19
    return SolverResult(
        x=x, objective=torch.stack(objs),
        aux={"residual": thH * thH * ytil + ztil,
             "state": SolveState(start + H, {"z": z, "y": y,
                                             "ztil": ztil, "ytil": ytil}),
             **spmm_aux(A, "col_gram")})


def cd_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
             state: Optional[SolveState] = None,
             group=None) -> SolverResult:
    """CD = BCD with mu = 1."""
    require_unit_block(cfg, "cd_lasso")
    return bcd_lasso(problem, cfg, x0, state, group)


def acc_cd_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
                 state: Optional[SolveState] = None,
                 group=None) -> SolverResult:
    """accCD = accBCD with mu = 1."""
    require_unit_block(cfg, "acc_cd_lasso")
    return acc_bcd_lasso(problem, cfg, x0, state, group)


def lasso_objective(problem: LassoProblem, x, group=None):
    """Direct objective evaluation 1/2 ||Ax - b||^2 + g(x), in A's dtype
    on A's device (A and b this rank's rows when ``group`` is given)."""
    A = problem.A if isinstance(problem.A, SparseOperand) \
        else torch.as_tensor(problem.A)
    x = torch.as_tensor(x).to(device=A.device, dtype=A.dtype)
    residual = operand_matvec(A, x) \
        - torch.as_tensor(problem.b).to(A.device, A.dtype)
    return _objective(residual, x, problem, group)


def _cli_problem(args):
    from repro_torch.data.sparse import make_lasso_dataset
    A, b, lam_max = make_lasso_dataset(args.dataset, args.seed,
                                       as_operand=args.sparse,
                                       device=args.device)
    return LassoProblem(A=A, b=b, lam=args.lam_frac * lam_max)


def _cli_describe(args, res, elapsed: float) -> str:
    obj = res.objective.cpu().numpy()
    nnz = int((res.x.abs() > 1e-8).sum())
    return (f"lasso {args.dataset} s={args.s} mu={args.mu} "
            f"device={args.device}{' sparse' if args.sparse else ''}: obj {obj[0]:.4f} -> {obj[-1]:.4f}, "
            f"nnz(x)={nnz}, {elapsed:.2f}s")


@register_family(
    "lasso",
    problem_cls=LassoProblem,
    partition="row",
    default_axes="data",
    x0_layout="replicated",
    aux_out=(("residual", "partition"),),
    variants={
        "classical": "repro_torch.core.lasso:bcd_lasso",
        "accelerated": "repro_torch.core.lasso:acc_bcd_lasso",
        "sa": "repro_torch.core.sa_lasso:sa_bcd_lasso",
        "sa_accelerated": "repro_torch.core.sa_lasso:sa_acc_bcd_lasso",
    },
    objective=lasso_objective,
    costs=lambda dims, H, mu, s, P, kernel="linear": cost_model.lasso_costs(
        dims, H, mu, s, P),
    make_problem=_cli_problem,
    describe=_cli_describe,
    default_mu=8,
    bench_block_size=4,
    bench_problem_kwargs={"lam": 0.1},
    supports_symmetric_gram=True,
    state_layout=lambda cfg: (
        (("z", "replicated"), ("y", "replicated"),
         ("ztil", "partition"), ("ytil", "partition"))
        if cfg.accelerated else
        (("x", "replicated"), ("residual", "partition"))),
)
def solve_lasso(problem: LassoProblem, cfg: SolverConfig, x0=None,
                state=None, group=None) -> SolverResult:
    """Dispatch on (accelerated, s): s == 1 -> this module; s > 1 -> SA.
    ``group``: the process group of a row-sharded solve."""
    if cfg.s > 1:
        from repro_torch.core import sa_lasso
        fn = (sa_lasso.sa_acc_bcd_lasso if cfg.accelerated
              else sa_lasso.sa_bcd_lasso)
    else:
        fn = acc_bcd_lasso if cfg.accelerated else bcd_lasso
    return fn(problem, cfg, x0, state, group)
