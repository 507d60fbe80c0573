"""Plain PyTorch version of the SA accelerated inner loop (paper Alg. 2
lines 13-22, specialised to the Lasso / elastic-net prox).

Given the reduced Gram matrix G, the projections y_proj = A_j^T ytil_sk /
z_proj = A_j^T ztil_sk, the sampled-coordinate values z_vals = z_sk[idx]
and the theta schedule, run the s dependent inner steps and return
(dz, etas) — the same function as ``repro``'s ``sa_inner_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg import floor_eig, power_iteration_max_eig


def sa_inner_ref(G, y_proj, z_proj, z_vals, idx, th_prev, coefU,
                 q: float, lam1: float, lam2: float = 0.0,
                 power_iters: int = 32):
    """Reference s-step inner loop.

    G:      (s*mu, s*mu) Gram matrix Y^T Y
    y_proj: (s, mu)   A_j^T ytil_sk
    z_proj: (s, mu)   A_j^T ztil_sk
    z_vals: (s, mu)   z_sk gathered at each block's coordinates
    idx:    (s, mu)   sampled coordinate ids (for collision corrections)
    th_prev:(s,)      theta_{sk+j-1}
    coefU:  (s,)      (1 - q*theta_{sk+j-1}) / theta_{sk+j-1}^2
    Returns (dz (s, mu), etas (s,)).
    """
    s, mu = y_proj.shape
    G4 = G.reshape(s, mu, s, mu)
    idx_flat = idx.reshape(s * mu)
    dz_buf = torch.zeros((s, mu), dtype=G.dtype, device=G.device)
    etas = []
    for j in range(s):
        thp = th_prev[j]
        Gj = G4[j]                                     # (mu, s, mu)
        cross = torch.einsum("ptq,tq->tp", Gj, dz_buf)  # (s, mu)
        coef_t = thp * thp * coefU - 1.0
        mask = (torch.arange(s, device=G.device) < j).to(G.dtype)
        rj = thp * thp * y_proj[j] + z_proj[j] \
            - torch.einsum("t,t,tp->p", mask, coef_t, cross)
        v = power_iteration_max_eig(Gj[:, j, :], power_iters)
        eta = 1.0 / floor_eig(q * thp * v)
        # collision-corrected current z at this block's coordinates.
        eq = (idx[j][:, None] == idx_flat[None, :]).to(G.dtype)
        w = (mask[:, None] * dz_buf).reshape(s * mu)
        zj = z_vals[j] + eq @ w
        g = zj - eta * rj
        shrunk = torch.sign(g) * torch.clamp(torch.abs(g) - lam1 * eta,
                                             min=0.0)
        dz_buf[j] = shrunk / (1.0 + 2.0 * eta * lam2) - zj
        etas.append(eta)
    return dz_buf, torch.stack(etas)
