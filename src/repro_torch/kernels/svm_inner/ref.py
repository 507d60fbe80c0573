"""Plain PyTorch version of the SVM s-step inner loop (paper Alg. 4 lines
11-20, generalized to blocks) — the same function as ``repro``'s
``svm_inner_ref``.

Given the reduced block matrix G (Y Y^T + gamma I), the projections
proj = Y x_sk, the labels and dual values gathered at the start of the
group and the sampled row ids, run the s dependent block updates and
return the dual steps and each step's dual-objective increment. A row id
repeating across the s blocks is corrected with the eq-matrix gather;
the off-diagonal blocks of G carry the raw cross terms. Unlike the Lasso
inner loop there is no eigenvalue floor: a zero diagonal block divides
by zero here exactly as it does in ``repro``.
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg import power_iteration_max_eig


def svm_inner_ref(G, proj, b_sel, a_vals, idx, gamma: float, nu: float,
                  power_iters: int = 32):
    """Reference s-step SVM inner loop.

    G:      (s*mu, s*mu) block matrix, gamma already on the diagonal
    proj:   (s, mu)  Y_j x_sk
    b_sel:  (s, mu)  labels at the sampled rows
    a_vals: (s, mu)  alpha_sk gathered at each block's rows
    idx:    (s, mu)  sampled row ids (for collision corrections)
    Returns (theta (s, mu), dual_deltas (s,)), dual_deltas[j] =
    theta^T g + 1/2 (b theta)^T G_jj (b theta) of step j.
    """
    s, mu = proj.shape
    dt = G.dtype
    G4 = G.reshape(s, mu, s, mu)
    idx_flat = idx.reshape(s * mu)
    steps = torch.arange(s, device=G.device)
    th_buf = torch.zeros((s, mu), dtype=dt, device=G.device)
    deltas = []
    for j in range(s):
        b_j = b_sel[j]
        Gj = G4[j]                                      # (mu, s, mu)
        mask = (steps < j).to(dt)
        cross = torch.einsum("ptq,tq->tp", Gj, b_sel * th_buf)
        rj = proj[j] + torch.einsum("t,tp->p", mask, cross)
        # collision-corrected alpha at this block's rows.
        eq = (idx[j][:, None] == idx_flat[None, :]).to(dt)
        beta = a_vals[j] + eq @ (mask[:, None] * th_buf).reshape(s * mu)
        g = b_j * rj - 1.0 + gamma * beta
        Gjj = Gj[:, j, :]                               # (mu, mu)
        # mu = 1: the (1, 1) diagonal block IS the eigenvalue.
        v = Gjj[0, 0] if mu == 1 \
            else power_iteration_max_eig(Gjj, power_iters)
        gbar = torch.abs(torch.clamp(beta - g, 0.0, nu) - beta)
        theta = torch.where(gbar != 0.0,
                            torch.clamp(beta - g / v, 0.0, nu) - beta,
                            torch.zeros_like(beta))
        bt = b_j * theta
        deltas.append(torch.sum(theta * g) + 0.5 * bt @ (Gjj @ bt))
        th_buf[j] = theta
    return th_buf, torch.stack(deltas)
