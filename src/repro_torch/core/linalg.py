"""Small linear-algebra and sampling utilities shared by the solvers
(the port of ``repro/core/linalg.py``)."""
from __future__ import annotations

import contextlib
import types
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import seams
from repro_torch.core import rng


def power_iteration_max_eig(G, iters: int = 32):
    """Largest eigenvalue of a small PSD matrix G (mu x mu): fixed
    iteration count from the normalised ones vector, then v^T G v."""
    mu = G.shape[0]
    if mu == 1:
        return G[0, 0]
    v = torch.ones(mu, dtype=G.dtype, device=G.device) \
        / torch.sqrt(torch.tensor(float(mu), dtype=G.dtype))
    for _ in range(iters):
        w = G @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return v @ (G @ v)


def floor_eig(v):
    """Floor a Gram-block eigenvalue (or the step-size denominator built
    from it) at the smallest positive normal of its dtype before it
    becomes a 1/v step size: a sampled all-zero block then makes a no-op
    step instead of ``inf * 0 = NaN``. Nonzero values pass bit for bit."""
    return torch.clamp(v, min=torch.finfo(v.dtype).tiny)


def theta_schedule(theta0: float, num: int, dtype, device="cpu"):
    """The APPROX acceleration scalars thetas[0..num], thetas[0] = theta0:

        theta_h = (sqrt(theta_{h-1}^4 + 4 theta_{h-1}^2) - theta_{h-1}^2) / 2

    A short scalar recurrence, so it runs on the host in ``dtype``
    (every operation rounds as the device's IEEE arithmetic does) and
    lands on ``device`` as one tensor."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    th = npdt(theta0)
    out = np.empty(num + 1, npdt)
    out[0] = th
    two, four = npdt(2.0), npdt(4.0)
    for h in range(1, num + 1):
        th2 = th * th
        th = (np.sqrt(th2 * th2 + four * th2) - th2) / two
        out[h] = th
    return torch.as_tensor(out, device=device)


def power_iteration_max_eig_batched(Gs, iters: int = 32):
    """:func:`power_iteration_max_eig` of each block of a (B, mu, mu)
    stack at once -> (B,): the same arithmetic per block, as the s blocks
    of an outer iteration do not depend on its step chain."""
    B, mu = Gs.shape[0], Gs.shape[1]
    if mu == 1:
        return Gs[:, 0, 0]
    v = torch.ones((B, mu, 1), dtype=Gs.dtype, device=Gs.device) \
        / torch.sqrt(torch.tensor(float(mu), dtype=Gs.dtype))
    for _ in range(iters):
        w = Gs @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                            min=1e-30)
    return (v * (Gs @ v)).sum(dim=(1, 2))


def fista_t_schedule(num: int, dtype, device="cpu"):
    """The FISTA momentum scalars ts[0..num] (Beck & Teboulle; used by
    CA-SFISTA, arXiv:1710.08883):

        t_0 = 1,    t_h = (1 + sqrt(1 + 4 t_{h-1}^2)) / 2,

    from which iteration h's momentum is beta_h = (t_{h-1} - 1) / t_h
    (beta_1 = 0). A short scalar recurrence, run on the host in ``dtype``
    as :func:`theta_schedule` is, landing on ``device`` as one tensor."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    one, two, four = npdt(1.0), npdt(2.0), npdt(4.0)
    t = one
    out = np.empty(num + 1, npdt)
    out[0] = t
    for h in range(1, num + 1):
        t = (one + np.sqrt(one + four * t * t)) / two
        out[h] = t
    return torch.as_tensor(out, device=device)


def sample_block(keys, n: int, mu: int, bits: int = 32):
    """Sample mu of n coordinates uniformly without replacement for each
    key: keys (B, 2) -> (B, mu) int64.

    The indices of the mu largest uniforms, as ``lax.top_k`` returns
    them: descending, ties toward the lower index (a stable sort;
    ``torch.topk``'s tie order is unspecified)."""
    if mu == n:
        return torch.arange(n, device=keys.device).expand(keys.shape[0], n)
    mant = rng._mantissas(keys, n, bits)
    return torch.sort(-mant, dim=1, stable=True).indices[:, :mu].contiguous()


def sample_group(keys, n_groups: int, group_size: int, bits: int = 32):
    """Sample one whole group per key (group-lasso mode): (B, group_size)
    coordinates."""
    g = rng.randint(keys, 0, n_groups, bits)
    return g[:, None] * group_size \
        + torch.arange(group_size, device=keys.device)


_OPEN_COUNTS = []     # the counters of the open count_reductions blocks


@contextlib.contextmanager
def count_reductions():
    """Count the all-reduces made inside the ``with`` block:

        with linalg.count_reductions() as c:
            api.solve(problem, cfg, backend="sharded")
        c.n   # ceil(H/s) for an SA solve with track_objective=False

    Only :func:`preduce` and :func:`preduce_scatter` add to ``c.n`` (once
    per collective they make); :func:`pmax` adds to ``c.max`` instead, and
    :func:`pgather` and :func:`pall_gather` to neither."""
    c = types.SimpleNamespace(n=0, max=0)
    _OPEN_COUNTS.append(c)
    try:
        yield c
    finally:
        _OPEN_COUNTS.remove(c)


def _all_reduce(x, op, group):
    """``x`` reduced by ``op`` over ``group``: in place when ``x`` is
    contiguous, else a contiguous copy (``all_reduce`` takes only dense
    tensors). The port's one ``all_reduce`` call site."""
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=group)
    return x


def preduce(x, group=None, counted: bool = True):
    """The all-reduce seam: the sum of ``x`` over the ranks of ``group``
    (a ``torch.distributed`` process group), or ``x`` itself when
    ``group`` is None: the seam every solver and the trainer reduce
    through.

    A contiguous ``x`` is reduced in place and returned; any other view
    (``all_reduce`` takes only dense tensors) is copied first.
    ``counted=False`` leaves the open :func:`count_reductions` blocks
    alone: the tuner's microbenchmark (``tune.microbench``) times
    reductions that belong to no solve, and the model axis's reductions
    (``parallel.tensor``) are not the step's one gradient reduction."""
    if group is None:
        return x
    x = _all_reduce(x, dist.ReduceOp.SUM, group)
    if counted:
        for c in _OPEN_COUNTS:
            c.n += 1
    return x


def pmax(x, group=None, counted: bool = True):
    """The max-reduction seam: the elementwise max of ``x`` over the ranks
    of ``group``, or ``x`` itself when ``group`` is None. Reduced in place
    when ``x`` is contiguous, as :func:`preduce` does. Counted in the open
    :func:`count_reductions` blocks' ``max``, apart from their sums:
    int8 gradient compression (``optim.compress``) takes the max of its
    scales before it sums the payload. ``counted=False``, as for
    :func:`preduce`."""
    if group is None:
        return x
    x = _all_reduce(x, dist.ReduceOp.MAX, group)
    if counted:
        for c in _OPEN_COUNTS:
            c.max += 1
    return x


def pall_gather(x, group):
    """Every rank's ``x`` (the same shape on each) concatenated along the
    first axis in rank order, in one ``all_gather_into_tensor``: the
    seam of the model axis's gathers (``parallel.tensor``) and of FSDP's
    gathers (``parallel.fsdp``: the weights in a training step, a
    checkpoint's trees). Not counted, and not an end gather: it belongs
    to the trainer, not to the end of a solve."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    with warnings.catch_warnings():     # deprecated by name in torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def preduce_scatter(x, group, counted: bool = True):
    """The sum of ``x`` over the ranks of ``group``, of which this rank
    keeps its block of the first axis (block r of ``size`` equal blocks
    for rank r), in one ``reduce_scatter_tensor``: the seam of the
    trainer's gradient reduction under FSDP (``parallel.fsdp``), counted
    in the open :func:`count_reductions` blocks as :func:`preduce` is,
    and of the model axis's scatters (``parallel.tensor``), which pass
    ``counted=False``."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)
    if counted:
        for c in _OPEN_COUNTS:
            c.n += 1
    return out


def pgather(x, group=None):
    """The partition-layout gather: every rank's ``x`` (the same shape on
    each) concatenated along the first axis in rank order, or ``x``
    itself when ``group`` is None. The sharded backend calls it once per
    output at the end of a solve; it is not a reduction and is not
    counted. An open recorder sees its all-gather as an end gather
    (``seams.gathering``), outside the outer iterations' budget."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with seams.gathering():
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
