"""Small linear-algebra and sampling utilities shared by the solvers
(the port of ``repro/core/linalg.py``)."""
from __future__ import annotations

import numpy as np
import torch

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


def preduce(x, axis_name=None):
    """The all-reduce seam: identity on one process (the sharded backend
    comes in a later slice)."""
    if axis_name is not None:
        raise NotImplementedError(
            "sharded reduction is not ported yet (ROADMAP Queue 1, "
            "sharded backend)")
    return x
