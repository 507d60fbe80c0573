"""The generic SA s-step engine (the port of ``repro/core/engine.py``):
ONE driver for every synchronization-avoiding solver family.

A family supplies its algorithm as a :class:`FamilyProgram` — sampled-
block assembly, the fused payload, the inner update rule, the deferred
application and objective recurrence, plus its carry schema — and
:func:`run_program` owns the rest: floor(H/s) full groups plus one
H mod s tail, the global ``fold_in`` iteration ids (so SA and classical
solvers draw the same blocks and a resumed solve continues the
uninterrupted schedule), batched block draws, ``SolveState`` resume, the
schedule windows and the objective stitching. The phase structure every
SA method shares:

    setup -> [per outer group: sample -> assemble -> reduce -> inner
              -> defer] -> finalize

Where JAX ran the groups in ``lax.scan``, this is a Python loop.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import linalg, rng
from repro_torch.core.sparse_exec import spmm_aux
from repro_torch.core.types import SolveState, SolverResult, resume_carry
from repro_torch.kernels import spmm
from repro_torch.kernels.gram import gram_fused

__all__ = [
    "FamilyProgram", "run_program", "run_grouped", "grouped_impl_label",
    "gram_local", "reduce_gram_proj", "gram_and_proj", "sample_all",
    "block_draws", "deferred_steps",
]


def run_grouped(group, carry, H: int, s: int, start: int = 0):
    """Run ``group(carry, start, s_grp) -> (carry, objs (s_grp,))`` over
    floor(H/s) full s-step groups, then ONE remainder tail group of
    H mod s iterations; returns (carry, objs (H,)). ``start`` offsets the
    global iteration ids of a resumed solve."""
    K, rem = divmod(H, s)
    objs = []
    for k in range(K):
        carry, o = group(carry, start + k * s, s)
        objs.append(o)
    if rem:
        carry, o = group(carry, start + K * s, rem)
        objs.append(o)
    return carry, torch.cat(objs)


def grouped_impl_label(impl_fn, H: int, s: int) -> str:
    """The inner-loop implementation(s) the grouped schedule runs:
    ``impl_fn(s_grp)`` for the full groups and the tail, joined as
    "main+tail" when they differ."""
    K, rem = divmod(H, s)
    labels = ([impl_fn(s)] if K else []) + ([impl_fn(rem)] if rem else [])
    if len(set(labels)) == 1:
        return labels[0]
    return "+".join(labels)


# ---------------------------------------------------------------------------
# Fused Gram/projection payload helpers.
# ---------------------------------------------------------------------------

def reduce_gram_proj(local, smu: int, vec_cols: int, axis_name=None,
                     symmetric: bool = False):
    """The fused reduction of the LOCAL (smu, smu + k) Gram/projection
    block -> (G, P), G (smu, smu) and P (smu, k).

    symmetric (``SolverConfig.symmetric_gram``, paper footnote 3): only
    G's lower triangle is packed and reduced, then mirrored — half the
    message, identical values."""
    if symmetric:
        il, jl = torch.tril_indices(smu, smu, device=local.device)
        packed = torch.cat([local[:, :smu][il, jl],
                            local[:, smu:].reshape(-1)])
        packed = linalg.preduce(packed, axis_name)
        ntri = il.shape[0]
        G = torch.zeros((smu, smu), dtype=local.dtype, device=local.device)
        G[il, jl] = packed[:ntri]
        G = G + torch.tril(G, -1).T
        return G, packed[ntri:].reshape(smu, vec_cols)
    out = linalg.preduce(local, axis_name)
    return out[:, :smu], out[:, smu:]


def gram_local(Y, vecs):
    """LOCAL fused Gram/projection block  Y^T @ [Y | vecs]  (the pre-reduce
    half of paper Alg. 2 lines 11-12), through the ``gram`` kernel on a
    card, which reads Y and the vectors where they lie. Y: (m_loc, s*mu)
    sampled columns; vecs: (k, m_loc), the k vectors as rows."""
    return gram_fused(Y, vecs)


def gram_and_proj(Y, vecs, axis_name=None, symmetric: bool = False):
    """:func:`gram_local` followed by :func:`reduce_gram_proj`: (G, P);
    vecs (k, m_loc) as there."""
    return reduce_gram_proj(gram_local(Y, vecs), Y.shape[1], vecs.shape[0],
                            axis_name, symmetric)


def sample_all(key, sampler, start: int, s_grp: int):
    """The s_grp blocks of the outer group starting after global iteration
    ``start``, at the classical solvers' fold_in ids h = start + 1 ..
    start + s_grp: (s_grp, mu)."""
    hs = torch.arange(start + 1, start + 1 + s_grp, device=key.device)
    return sampler(rng.fold_in(key, hs))


# Elements of one batch of draws: the sampler's (rows, width) temporaries.
DRAW_BUDGET = 1 << 24


def block_draws(key, sampler, start: int, H: int, width: int,
                group: int = 1):
    """The blocks of global iterations start+1 .. start+H, as (rows, mu)
    batches of whole groups whose (rows, width) sampler temporaries stay
    within ``DRAW_BUDGET`` elements. The draws do not depend on the solve,
    so batching them costs one set of small launches per batch instead of
    one per group; the bits are those of :func:`sample_all`."""
    rows = max(1, DRAW_BUDGET // (group * width)) * group
    for r0 in range(0, H, rows):
        yield sample_all(key, sampler, start + r0, min(rows, H - r0))


def deferred_steps(ctx, handle, buf, s_grp: int):
    """The deferred m-dimensional step vectors S_t = A_{B_t} @ buf_t,
    (s_grp, m_loc), for the column-sampling layout. Sparse (``ctx.sparse``,
    ``handle`` the gathered ELL columns): O(nnz of the sampled columns)
    scatter-adds. Dense: one product of the sampled columns Y (m_loc,
    s_grp*mu) with the block-diagonal (s_grp*mu, s_grp) matrix holding
    each step's buf_t."""
    if ctx.sparse:
        rows_g, vals_g, _ = handle
        return spmm.scatter_steps(rows_g.reshape(s_grp, ctx.mu, -1),
                                  vals_g.reshape(s_grp, ctx.mu, -1),
                                  buf, ctx.m_loc)
    smu = s_grp * ctx.mu
    D = torch.zeros((smu, s_grp), dtype=buf.dtype, device=buf.device)
    D[torch.arange(smu, device=buf.device),
      torch.arange(smu, device=buf.device) // ctx.mu] = buf.reshape(smu)
    return (handle @ D).T


# ---------------------------------------------------------------------------
# The program spec + the ONE generic driver.
# ---------------------------------------------------------------------------

Ctx = SimpleNamespace   # programs stash whatever their callbacks close over


@dataclasses.dataclass(frozen=True)
class FamilyProgram:
    """A solver family's s-step program: the callback seams plus the
    declarative fields the engine needs (``ctx`` is what ``setup``
    returns; ``carry`` the recurrence-leaf tuple in ``carry_names``
    order; ``s_grp`` the group size; ``win`` the schedule window
    ``(sched[start:start+s_grp], sched[start+1:start+s_grp+1])`` or
    None):

    setup(problem, cfg, x0, carry0) -> (ctx, carry)
        ``ctx.device`` is the solve's device (the RNG keys live there) and
        ``ctx.sample_width`` the size of the sampled axis.
    sample(ctx, keys (B, 2)) -> (B, mu) blocks
    assemble(ctx, carry, idxs, s_grp) -> (handle, local)
    reduce(ctx, local, idxs, s_grp) -> payload   (the ONE reduction)
    inner(ctx, carry, handle, payload, idxs, win, s_grp)
        -> (carry, inner_out)
    defer(ctx, carry, handle, inner_out, payload, idxs, win, s_grp)
        -> (carry, objs (s_grp,))
    finalize(ctx, carry, sched) -> (x, aux_extra dict)

    carry_names: the SolveState leaf names, in carry order.
    schedule(ctx, cfg, total) -> (total + 1,) tensor, optional.
    inner_impl(ctx, s_grp) -> str, optional: surfaced as
        ``aux["inner_impl"]`` with main+tail labels.
    spmm_kind: the sparse layout of the fused payload ("col_gram",
        "row_gram"); the engine surfaces ``aux["spmm_impl"]`` for a
        sparse ``ctx.A`` from it (nothing for a dense one).
    """

    name: str
    setup: Callable
    sample: Callable
    assemble: Callable
    reduce: Callable
    inner: Callable
    defer: Callable
    finalize: Callable
    carry_names: Tuple[str, ...]
    schedule: Optional[Callable] = None
    inner_impl: Optional[Callable] = None
    spmm_kind: Optional[str] = None


def run_program(prog: FamilyProgram, problem, cfg, x0=None,
                state=None) -> SolverResult:
    """Run a :class:`FamilyProgram` over the full grouped schedule."""
    carry0 = resume_carry(state, x0, prog.name)
    h0 = 0 if state is None else int(state.iteration)
    ctx, carry = prog.setup(problem, cfg, x0, carry0)
    key = rng.key(cfg.seed, rng.bits_for(cfg.dtype), ctx.device)
    s, H = cfg.s, cfg.iterations
    sched = None if prog.schedule is None \
        else prog.schedule(ctx, cfg, h0 + H)       # (h0 + H + 1,)

    def group_draws():
        for batch in block_draws(key, lambda k: prog.sample(ctx, k), h0, H,
                                 ctx.sample_width, s):
            yield from torch.split(batch, s)   # the last may be the tail

    draws = group_draws()

    def group(carry, start, s_grp):
        idxs = next(draws)                             # (s_grp, mu)
        win = None if sched is None else (
            sched[start:start + s_grp], sched[start + 1:start + s_grp + 1])
        handle, local = prog.assemble(ctx, carry, idxs, s_grp)
        payload = prog.reduce(ctx, local, idxs, s_grp)
        carry, inner_out = prog.inner(ctx, carry, handle, payload, idxs,
                                      win, s_grp)
        return prog.defer(ctx, carry, handle, inner_out, payload, idxs,
                          win, s_grp)

    carry, objs = run_grouped(group, carry, H, s, start=h0)
    x, extra = prog.finalize(ctx, carry, sched)
    aux = dict(extra)
    aux["state"] = SolveState(h0 + H, dict(zip(prog.carry_names, carry)))
    if prog.inner_impl is not None:
        aux["inner_impl"] = grouped_impl_label(
            lambda g: prog.inner_impl(ctx, g), H, s)
    if prog.spmm_kind is not None:
        aux.update(spmm_aux(ctx.A, prog.spmm_kind))
    return SolverResult(x=x, objective=objs, aux=aux)
