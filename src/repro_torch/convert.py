"""State carried across from the JAX package to the port.

The solvers have no weights: what a solve carries is its problem and its
:class:`~repro_torch.core.types.SolveState` (the global iteration count
plus the named recurrence leaves: z/y/ztil/ytil or x/residual for Lasso,
alpha/x/dual for SVM). These helpers take and return numpy arrays, so a
state saved by ``repro`` (``np.asarray`` of each leaf of its
``aux["state"]``) resumes here. The RNG offset and the theta schedule are
recomputed from ``iteration``, so the resumed solve continues the
uninterrupted trajectory. A sparse operand crosses as its six ELL arrays
(``operand_from_numpy``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.types import (LassoProblem, SolveState, SparseOperand,
                                    SVMProblem, resolve_device)

_ELL_FIELDS = ("row_cols", "row_vals", "row_blocks",
               "col_rows", "col_vals", "col_blocks")


def operand_from_numpy(arrays, ell_block: int = 8, device="cuda",
                       dtype=torch.float32) -> SparseOperand:
    """A :class:`SparseOperand` from the six ELL arrays of a ``repro``
    operand (``np.asarray`` of each of ``row_cols, row_vals, row_blocks,
    col_rows, col_vals, col_blocks``), as a mapping or an object with
    those attributes; values become ``dtype``, indices stay int32."""
    dev = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, dict) \
        else lambda k: getattr(arrays, k)
    leaves = {}
    for k in _ELL_FIELDS:
        t = torch.as_tensor(np.array(get(k)), device=dev)
        leaves[k] = t.to(dtype) if k.endswith("vals") else t.to(torch.int32)
    return SparseOperand(ell_block=int(ell_block), **leaves)


def _matrix(A, dev, dtype):
    if isinstance(A, SparseOperand):
        return A.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(A)).to(device=dev, dtype=dtype)


def problem_from_numpy(A, b, lam: float, l2: float = 0.0, groups=None,
                       device="cuda", dtype=torch.float32) -> LassoProblem:
    """A :class:`LassoProblem` with A (a numpy matrix, or a SparseOperand
    from ``operand_from_numpy``) and b as ``dtype`` tensors on ``device``;
    ``groups`` stays a host array."""
    dev = resolve_device(device)
    return LassoProblem(
        A=_matrix(A, dev, dtype),
        b=torch.as_tensor(np.asarray(b)).to(device=dev, dtype=dtype),
        lam=float(lam), l2=float(l2),
        groups=None if groups is None else np.asarray(groups))


def svm_problem_from_numpy(A, b, lam: float = 1.0, loss: str = "l1",
                           device="cuda", dtype=torch.float32) -> SVMProblem:
    """A linear :class:`SVMProblem` with A (a numpy matrix, or a
    SparseOperand) and the {-1, +1} labels b as ``dtype`` tensors on
    ``device``."""
    dev = resolve_device(device)
    return SVMProblem(
        A=_matrix(A, dev, dtype),
        b=torch.as_tensor(np.asarray(b)).to(device=dev, dtype=dtype),
        lam=float(lam), loss=loss)


def state_from_numpy(iteration: int, carry: Dict[str, np.ndarray],
                     dtype=torch.float32, device="cuda") -> SolveState:
    """A :class:`SolveState` from numpy leaves (e.g. a JAX solve's
    ``aux["state"]`` after ``np.asarray``)."""
    dev = resolve_device(device)
    return SolveState(int(iteration), {
        name: torch.as_tensor(np.asarray(leaf)).to(device=dev, dtype=dtype)
        for name, leaf in carry.items()})


def state_to_numpy(state: SolveState) -> Tuple[int, Dict[str, np.ndarray]]:
    """(iteration, {leaf name: numpy array}) of a port state."""
    return int(state.iteration), {
        name: leaf.detach().cpu().numpy() for name, leaf in
        state.carry.items()}
