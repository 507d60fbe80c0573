"""Synthetic datasets mirroring the paper's LIBSVM shape regimes (the port
of ``repro/data/sparse.py``).

The draws are numpy ``default_rng`` draws, in the same order as
``repro``'s, so the arrays are bit for bit the same; they are then moved
to the requested device. ``as_operand=True`` returns A as a
:class:`~repro_torch.core.types.SparseOperand` built from the same dense
draw, whose ELL arrays equal ``repro``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import SparseOperand, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    m: int               # data points
    n: int               # features
    density: float       # fraction of nonzeros
    paper_analogue: str  # which LIBSVM dataset's regime this mirrors


# Scaled-down analogues of paper Tables II & IV (regime preserved).
SYNTHETIC_DATASETS = {
    # Lasso regimes (Table II)
    "url-like": SyntheticSpec("url-like", m=4096, n=6144, density=0.004,
                              paper_analogue="url (sparse, n > m)"),
    "news20-like": SyntheticSpec("news20-like", m=2048, n=8192, density=0.0013,
                                 paper_analogue="news20 (sparse, n >> m)"),
    "covtype-like": SyntheticSpec(
        "covtype-like", m=16384, n=54, density=0.22,
        paper_analogue="covtype (dense-ish, m >> n)"),
    "epsilon-like": SyntheticSpec("epsilon-like", m=8192, n=512, density=1.0,
                                  paper_analogue="epsilon (dense, m >> n)"),
    "leu-like": SyntheticSpec("leu-like", m=38, n=7129, density=1.0,
                              paper_analogue="leu (dense, tiny m)"),
    # SVM regimes (Table IV)
    "w1a-like": SyntheticSpec("w1a-like", m=300, n=2477, density=0.04,
                              paper_analogue="w1a"),
    "duke-like": SyntheticSpec("duke-like", m=44, n=7129, density=1.0,
                               paper_analogue="duke"),
    "rcv1-like": SyntheticSpec("rcv1-like", m=4096, n=8192, density=0.0016,
                               paper_analogue="rcv1.binary"),
    "gisette-like": SyntheticSpec("gisette-like", m=2048, n=4096, density=0.99,
                                  paper_analogue="gisette"),
}


def _sparse_matrix(rng: np.random.Generator, m: int, n: int,
                   density: float, dtype=np.float32) -> np.ndarray:
    A = rng.standard_normal((m, n)).astype(dtype)
    if density < 1.0:
        mask = rng.random((m, n)) < density
        A = A * mask
        # guarantee no empty column (keeps Gram blocks nonzero).
        empty = ~mask.any(axis=0)
        if empty.any():
            rows = rng.integers(0, m, size=int(empty.sum()))
            A[rows, np.flatnonzero(empty)] = \
                rng.standard_normal(int(empty.sum())).astype(dtype)
    return A


def make_lasso_dataset(name: str, seed: int = 0, k_sparse: int = 32,
                       noise: float = 0.1, as_operand: bool = False,
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor,
                                               float]:
    """Returns (A, b, lam_max) for a named synthetic regime, A and b as
    float32 tensors on ``device``.

    b = A x_true + noise with a k-sparse planted x_true; lam_max =
    ||A^T b||_inf is the smallest lambda for which x* = 0.
    ``as_operand=True`` returns A as a SparseOperand on ``device``."""
    spec = SYNTHETIC_DATASETS[name]
    rng = np.random.default_rng(seed)
    A = _sparse_matrix(rng, spec.m, spec.n, spec.density)
    x_true = np.zeros(spec.n, dtype=np.float32)
    support = rng.choice(spec.n, size=min(k_sparse, spec.n), replace=False)
    x_true[support] = rng.standard_normal(len(support)).astype(np.float32)
    b = A @ x_true + noise * rng.standard_normal(spec.m).astype(np.float32)
    lam_max = float(np.abs(A.T @ b).max())
    dev = resolve_device(device)
    return (_on_device(A, as_operand, dev),
            torch.as_tensor(b.astype(np.float32), device=dev), lam_max)


def make_svm_dataset(name: str, seed: int = 0, margin: float = 1.0,
                     as_operand: bool = False, device="cuda"
                     ) -> Tuple[object, torch.Tensor]:
    """Returns (A, b) — binary classification with labels in {-1, +1}
    mirroring the named regime, as float32 tensors on ``device``: b is
    the sign of planted scores A w (w a unit vector) plus noise scaled by
    0.1 / margin (larger margin, less label noise).
    ``as_operand=True`` returns A as a SparseOperand on ``device``."""
    if margin <= 0:
        raise ValueError(f"margin must be > 0, got {margin}")
    spec = SYNTHETIC_DATASETS[name]
    rng = np.random.default_rng(seed)
    A = _sparse_matrix(rng, spec.m, spec.n, spec.density)
    w = rng.standard_normal(spec.n).astype(np.float32)
    w /= np.linalg.norm(w)
    scores = A @ w
    b = np.sign(scores + (0.1 / margin) * rng.standard_normal(spec.m))
    b[b == 0] = 1.0
    dev = resolve_device(device)
    return (_on_device(A, as_operand, dev),
            torch.as_tensor(b.astype(np.float32), device=dev))


def _on_device(A: np.ndarray, as_operand: bool, device):
    A = torch.as_tensor(A, device=device)
    return SparseOperand.from_dense(A) if as_operand else A
