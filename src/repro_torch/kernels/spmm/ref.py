"""Plain PyTorch version of the blocked-ELL SpMM.

The contraction runs over the padded ELL width K in storage order
(ascending index within each row), one (R, Q) sweep per ELL slot, so it
stays exact in the caller's dtype without materialising an (R, K, Q)
gather — the same function, and the same summation order, as
``repro``'s ``ell_spmm_ref``.
"""
from __future__ import annotations

import torch


def ell_spmm_ref(vals, idx, D):
    """out[r, q] = sum_k vals[r, k] * D[idx[r, k], q].

    vals: (R, K) ELL values (padded slots hold 0);
    idx:  (R, K) int32 or int64 row indices into D (padded slots hold 0);
    D:    (C, Q) dense right operand.
    Returns (R, Q) in the promoted input dtype.
    """
    dt = torch.promote_types(vals.dtype, D.dtype)
    out = torch.zeros((vals.shape[0], D.shape[1]), dtype=dt,
                      device=vals.device)
    for k in range(vals.shape[1]):
        out = out + vals[:, k, None] * D[idx[:, k]]
    return out
