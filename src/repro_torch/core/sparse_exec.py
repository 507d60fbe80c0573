"""Operand-polymorphic block operations (the port of
``repro/core/sparse_exec.py``): the one place the solver families branch
on a dense tensor vs a :class:`~repro_torch.core.types.SparseOperand`.

Each factory returns closures over the prepared operand, so the solver
bodies stay one code path. The dense closures are the expressions the
dense solvers use; the sparse closures do only nnz work through
``repro_torch.kernels.spmm``:

  * column layout (Lasso, COLUMNS sampled): ``col_block_ops`` — the
    fused (mu, mu + k) Gram/projection block A_B^T [A_B | vecs] and the
    deferred residual update A_B @ dx;
  * row layout (SVM, ROWS sampled): ``row_block_ops`` — the fused
    Y [Y^T | vecs] block, the densified sample Y^T and the deferred
    update Y^T @ coef;
  * ``cross_block`` — the (m, c) cross product A @ Y^T.

The sparse fused products run the ``spmm`` kernel against a dense right
operand [Y^T | vecs] of (size, r + k): one allocation whose column ranges
are written in place (the sampled rows scattered into the first r
columns, the vectors copied into the rest), never a concatenated copy.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import SparseOperand
from repro_torch.kernels import spmm

SPMM_KINDS = ("col_gram", "row_gram", "cross")


def prep_operand(A, dtype, device):
    """A problem's data matrix — dense or sparse — on ``device`` in the
    solve's ``dtype``."""
    if isinstance(A, SparseOperand):
        return A.to(device=device, dtype=dtype)
    A = torch.as_tensor(A).to(device=device, dtype=dtype)
    if A.dim() != 2:
        raise ValueError(f"A must be an (m, n) matrix; got shape "
                         f"{tuple(A.shape)}")
    return A


def _fused_rhs(idx, vals, size: int, vecs):
    """[densified gathered rows | vecs]: (size, r + k), written in place."""
    r = idx.shape[0]
    D = torch.zeros((size, r + vecs.shape[1]), dtype=vals.dtype,
                    device=vals.device)
    spmm.scatter_dense_into(D, idx, vals)
    D[:, r:] = vecs
    return D


def col_block_ops(A):
    """(block_gram, block_apply) for the column-sampling (Lasso) layout.

    block_gram(idx, vecs) -> (handle, local) with
        local = A_B^T [A_B | vecs]   (|idx|, |idx| + k);
    block_apply(handle, coef) -> A_B @ coef   (m,).
    """
    if isinstance(A, SparseOperand):
        m = A.shape[0]

        def block_gram(idx, vecs):
            handle = A.gather_cols(idx)
            rows, vals, nnb = handle
            local = spmm.ell_spmm(vals, rows, nnb,
                                  _fused_rhs(rows, vals, m, vecs),
                                  ell_block=A.ell_block)
            return handle, local

        def block_apply(handle, coef):
            rows, vals, _ = handle
            return spmm.scatter_add(
                torch.zeros(m, dtype=vals.dtype, device=vals.device),
                rows, vals, coef)

        return block_gram, block_apply

    def block_gram(idx, vecs):
        Ah = A[:, idx]
        return Ah, Ah.T @ torch.cat([Ah, vecs], dim=1)

    def block_apply(Ah, coef):
        return Ah @ coef

    return block_gram, block_apply


def row_block_ops(A):
    """(take, gram, densify, apply_t) for the row-sampling (SVM) layout.

    take(idx) -> handle for the sampled rows Y = A[idx];
    gram(handle, vecs) -> Y [Y^T | vecs]   (r, r + k);
    densify(handle) -> Y^T   (n, r) dense;
    apply_t(handle, coef) -> Y^T @ coef   (n,).
    """
    if isinstance(A, SparseOperand):
        n = A.shape[1]

        def take(idx):
            return A.gather_rows(idx)

        def gram(handle, vecs):
            cols, vals, nnb = handle
            return spmm.ell_spmm(vals, cols, nnb,
                                 _fused_rhs(cols, vals, n, vecs),
                                 ell_block=A.ell_block)

        def densify(handle):
            cols, vals, _ = handle
            return spmm.scatter_dense(cols, vals, n)

        def apply_t(handle, coef):
            cols, vals, _ = handle
            return spmm.scatter_add(
                torch.zeros(n, dtype=vals.dtype, device=vals.device),
                cols, vals, coef)

        return take, gram, densify, apply_t

    def take(idx):
        return A[idx]

    def gram(Y, vecs):
        return Y @ torch.cat([Y.T, vecs], dim=1)

    def densify(Y):
        return Y.T

    def apply_t(Y, coef):
        return Y.T @ coef

    return take, gram, densify, apply_t


def spmm_aux(A, kind: str) -> dict:
    """The ``aux["spmm_impl"]`` entry of a solve: "cuda" (the kernel) or
    "torch" (the plain version) for a sparse operand, nothing for a dense
    one. ``kind`` names the layout of the fused product ("col_gram",
    "row_gram" or "cross"); on the card every shape runs the same
    kernel, so the label does not depend on the group size."""
    if kind not in SPMM_KINDS:
        raise ValueError(f"unknown spmm layout kind {kind!r}")
    if not isinstance(A, SparseOperand):
        return {}
    return {"spmm_impl": spmm.spmm_impl(A.device)}


def cross_block(A, YT):
    """LOCAL cross product A @ Y^T: the (m, c) block of the kernel-SVM
    and logistic-regression families. ``YT`` is the (n, c) dense right
    operand; a sparse A contracts its row-major ELL arrays, O(nnz c)."""
    if isinstance(A, SparseOperand):
        return spmm.ell_spmm(A.row_vals, A.row_cols, A.row_blocks,
                             YT.contiguous(), ell_block=A.ell_block)
    return A @ YT
