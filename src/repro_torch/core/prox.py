"""Proximal operators and objective functions (paper Sec. I, Eq. 2; the
port of ``repro/core/prox.py``).

Elementwise / blockwise tensor functions. ``reg_value`` and
``lasso_objective`` reduce over the LAST axis, so a (steps, n) stack of
iterates gives one value per step. The solvers call ``make_prox`` once
to bind a problem's regularizer into a ``prox(v, eta) -> v`` closure.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def soft_threshold(v, alpha):
    """S_alpha(v) = sign(v) * max(|v| - alpha, 0)   (paper Eq. 2)."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - alpha, min=0.0)


def elastic_net_prox(v, eta, l1, l2):
    """prox of eta * (l1 ||x||_1 + l2 ||x||_2^2): shrink then scale."""
    return soft_threshold(v, eta * l1) / (1.0 + 2.0 * eta * l2)


def group_soft_threshold(v, alpha):
    """Block soft-threshold for group lasso: v * max(0, 1 - alpha/||v||_2)
    (``v`` is one whole group)."""
    norm = torch.linalg.vector_norm(v)
    scale = torch.clamp(1.0 - alpha / torch.clamp(norm, min=1e-30), min=0.0)
    return v * scale


def make_prox(lam: float, l2: float = 0.0, groups: Optional[object] = None
              ) -> Callable:
    """Bind a regularizer into prox(v, eta): lasso lam ||x||_1,
    elastic-net lam ||x||_1 + l2 ||x||_2^2, or group lasso
    lam sum_g ||x_g||_2 (v = one group)."""
    if groups is not None:
        return lambda v, eta: group_soft_threshold(v, eta * lam)
    if l2 != 0.0:
        return lambda v, eta: elastic_net_prox(v, eta, lam, l2)
    return lambda v, eta: soft_threshold(v, eta * lam)


def reg_value(x, lam: float, l2: float = 0.0, groups=None):
    """g(x) over the last axis. ``groups`` is a host-side (n,) int array
    of group ids."""
    if groups is not None:
        groups = np.asarray(groups)
        n_groups = int(np.max(groups)) + 1
        ids = torch.as_tensor(groups, dtype=torch.int64, device=x.device)
        sq = torch.zeros(x.shape[:-1] + (n_groups,), dtype=x.dtype,
                         device=x.device).index_add_(-1, ids, x * x)
        return lam * torch.sum(torch.sqrt(sq), dim=-1)
    val = lam * torch.sum(torch.abs(x), dim=-1)
    if l2 != 0.0:
        val = val + l2 * torch.sum(x * x, dim=-1)
    return val


def lasso_objective(residual, x, lam: float, l2: float = 0.0, groups=None):
    """f(A,b,x) + g(x) with residual = Ax - b (paper Sec. IV-A)."""
    return 0.5 * torch.sum(residual * residual, dim=-1) \
        + reg_value(x, lam, l2, groups)
