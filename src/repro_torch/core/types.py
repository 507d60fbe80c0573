"""Problem and solver configuration types (the port of
``repro/core/types.py``: the Lasso and linear SVM families, dense or
sparse operands).

The solvers take tensors (or anything ``torch.as_tensor`` accepts), or a
:class:`SparseOperand`, and put them on ``SolverConfig.device``. The
device decides the path: on a CUDA tensor the hand-written kernels run,
on a CPU tensor their plain PyTorch versions do. Asking for ``"cuda"`` on
a machine without a card raises; nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` a solve runs on; raises if it asks for a card
    this machine does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev


# ---------------------------------------------------------------------------
# Sparse operands.
#
# A SparseOperand holds one sparse matrix in a padded blocked-ELL layout,
# stored BOTH row-major and column-major: per row (resp. column), the
# nonzero indices (int32, ascending) and values padded to a common width K
# that is a multiple of ``ell_block``, plus the per-row/column count of
# *active* K-blocks. Padded slots hold index 0 / value 0, which makes every
# gather, scatter and SpMM exact with no masking. The Lasso family samples
# COLUMNS (rows of the column-major arrays), the SVM family ROWS; either
# way a blocked-ELL sub-operand falls out of a plain row gather and feeds
# ``repro_torch.kernels.spmm.ell_spmm`` directly. The arrays are those of
# ``repro``'s SparseOperand, bit for bit (``repro`` also keeps a BCOO form,
# which the port does not need).
# ---------------------------------------------------------------------------

def ell_width(max_nnz: int, ell_block: int) -> int:
    """The padded ELL width for a max per-row nnz: at least one block,
    rounded up to a multiple of ``ell_block``."""
    return -(-max(int(max_nnz), 1) // ell_block) * ell_block


def _ell_from_coo(rows, cols, vals, R: int, C: int, ell_block: int):
    """Row-major padded ELL arrays (idx int32, vals, blocks int32) from
    duplicate-free COO triplets (int64 rows/cols in [0, R) x [0, C)), on
    the triplets' device. Entries are ordered by the key row * C + col,
    which fits int64 at any LIBSVM shape, with one sort: the same order
    as ``repro``'s host ``np.lexsort``, so the same arrays."""
    dev = vals.device
    counts = torch.bincount(rows, minlength=R)
    K = ell_width(int(counts.max()) if R and rows.numel() else 0, ell_block)
    order = torch.argsort(rows * C + cols)
    r_s = rows[order]
    starts = torch.cumsum(counts, 0) - counts
    offsets = torch.arange(r_s.numel(), device=dev) - starts[r_s]
    del starts
    idx = torch.zeros((R, K), dtype=torch.int32, device=dev)
    idx[r_s, offsets] = cols[order].to(torch.int32)
    out = torch.zeros((R, K), dtype=vals.dtype, device=dev)
    out[r_s, offsets] = vals[order]
    blocks = ((counts + ell_block - 1) // ell_block).to(torch.int32)
    return idx, out, blocks


@dataclasses.dataclass(frozen=True)
class SparseOperand:
    """A sparse (m, n) data matrix in padded blocked-ELL form.

    row_cols/row_vals: (m, Kr) column indices (int32) / values per row;
    row_blocks: (m,) active Kr-block count per row (int32). col_rows/
    col_vals/col_blocks: the same, per column. ell_block: the K-padding
    quantum. Every problem dataclass accepts one in place of its dense
    ``A``; the solvers detect it with ``isinstance``.
    """

    row_cols: Any
    row_vals: Any
    row_blocks: Any
    col_rows: Any
    col_vals: Any
    col_blocks: Any
    ell_block: int = 8

    # -- construction -------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, shape: Tuple[int, int],
                 ell_block: int = 8) -> "SparseOperand":
        """Build both ELL orientations from duplicate-free COO triplets
        (tensors or arrays) on ``vals``' device — O(nnz) work and memory,
        never materialising the dense matrix."""
        vals = torch.as_tensor(vals)
        rows = torch.as_tensor(rows, device=vals.device).to(torch.int64)
        cols = torch.as_tensor(cols, device=vals.device).to(torch.int64)
        m, n = int(shape[0]), int(shape[1])
        rc, rv, rb = _ell_from_coo(rows, cols, vals, m, n, ell_block)
        cr, cv, cb = _ell_from_coo(cols, rows, vals, n, m, ell_block)
        return cls(rc, rv, rb, cr, cv, cb, ell_block)

    @classmethod
    def from_dense(cls, A, ell_block: int = 8) -> "SparseOperand":
        """Both ELL orientations of a dense matrix (tensor or array), on
        its device."""
        A = torch.as_tensor(A)
        if A.dim() != 2:
            raise ValueError(f"expected a matrix, got shape {tuple(A.shape)}")
        rows, cols = torch.nonzero(A, as_tuple=True)
        return cls.from_coo(rows, cols, A[rows, cols], tuple(A.shape),
                            ell_block=ell_block)

    # -- shape / dtype / device ---------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.row_cols.shape[0], self.col_rows.shape[0])

    @property
    def dtype(self):
        return self.row_vals.dtype

    @property
    def device(self):
        return self.row_vals.device

    @property
    def nnz(self) -> int:
        """Stored nonzeros (padding never stores nonzeros)."""
        return int((self.row_vals != 0).sum())

    def astype(self, dtype) -> "SparseOperand":
        return self.to(dtype=dtype)

    def to(self, device=None, dtype=None) -> "SparseOperand":
        """The operand on ``device`` with values of ``dtype`` (indices
        stay int32)."""
        def mv(t, cast):
            return t.to(device=device, dtype=dtype if cast else None)
        return dataclasses.replace(
            self, row_cols=mv(self.row_cols, False),
            row_vals=mv(self.row_vals, True),
            row_blocks=mv(self.row_blocks, False),
            col_rows=mv(self.col_rows, False),
            col_vals=mv(self.col_vals, True),
            col_blocks=mv(self.col_blocks, False))

    # -- conversions / products ---------------------------------------

    def todense(self):
        m, n = self.shape
        rows = torch.arange(m, device=self.device)[:, None]
        return torch.zeros((m, n), dtype=self.dtype, device=self.device) \
            .index_put_((rows.expand_as(self.row_cols), self.row_cols),
                        self.row_vals, accumulate=True)

    def matvec(self, x):
        """A @ x via the row-major ELL arrays: O(nnz)."""
        return torch.einsum("mk,mk->m", self.row_vals, x[self.row_cols])

    def rmatvec(self, y):
        """A^T @ y via the column-major ELL arrays: O(nnz)."""
        return torch.einsum("nk,nk->n", self.col_vals, y[self.col_rows])

    # -- sampled-block gathers (the solvers' hot path) ----------------

    def gather_cols(self, idx):
        """ELL form of the sampled columns A[:, idx]: (rows, vals,
        blocks), each gathered along the leading axis."""
        return (self.col_rows[idx], self.col_vals[idx],
                self.col_blocks[idx])

    def gather_rows(self, idx):
        """ELL form of the sampled rows A[idx]: (cols, vals, blocks)."""
        return (self.row_cols[idx], self.row_vals[idx],
                self.row_blocks[idx])

    def host_coo(self):
        """COO triplets as host numpy arrays, from the row-major ELL
        arrays; stored zeros are dropped (they contribute nothing)."""
        vals = self.row_vals.cpu().numpy()
        cols = self.row_cols.cpu().numpy()
        mask = vals != 0
        rows = np.broadcast_to(np.arange(vals.shape[0])[:, None],
                               vals.shape)
        return rows[mask], cols[mask], vals[mask]


def operand_matvec(A, x):
    """A @ x for a dense tensor or a SparseOperand."""
    if isinstance(A, SparseOperand):
        return A.matvec(x)
    return A @ x


def operand_rmatvec(A, y):
    """A^T @ y for a dense tensor or a SparseOperand."""
    if isinstance(A, SparseOperand):
        return A.rmatvec(y)
    return A.T @ y


@dataclasses.dataclass(frozen=True)
class LassoProblem:
    """Proximal least-squares problem data.

    A: (m, n) design matrix (m data points, n features), dense or a
       :class:`SparseOperand`.
    b: (m,) targets.
    lam: l1 regularization weight.
    l2: optional l2 weight -> elastic net (prox changes, loss unchanged).
    groups: optional (n,) host array of group ids -> group lasso. Groups
       must be contiguous, equal-sized blocks of ``block_size``
       coordinates; block sampling then samples whole groups.
    """

    A: Any
    b: Any
    lam: float
    l2: float = 0.0
    groups: Optional[Any] = None

    @property
    def shape(self):
        return tuple(self.A.shape)


# The SVM kernels ``repro`` registers. Only "linear" is ported; the others
# belong to the kernel-SVM family, a later slice.
SVM_KERNELS = ("linear", "poly", "rbf")


@dataclasses.dataclass(frozen=True)
class SVMProblem:
    """Dual linear SVM problem data.

    A: (m, n) data matrix, dense or a :class:`SparseOperand`.
    b: (m,) binary labels in {-1, +1}.
    lam: SVM penalty parameter (paper: lam = 1).
    loss: "l1" (hinge) or "l2" (squared hinge).
    kernel / kernel_params: as in ``repro``; anything but "linear" is the
       kernel-SVM family, which is not ported yet, and the solvers raise.
    """

    A: Any
    b: Any
    lam: float = 1.0
    loss: str = "l1"
    kernel: str = "linear"
    kernel_params: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.kernel not in SVM_KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; known: "
                             f"{list(SVM_KERNELS)}")
        if self.loss not in ("l1", "l2"):
            raise ValueError(f"loss must be 'l1' or 'l2', got {self.loss!r}")

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def gamma(self) -> float:
        return 0.0 if self.loss == "l1" else 0.5 / self.lam

    @property
    def nu(self) -> float:
        return self.lam if self.loss == "l1" else float("inf")


@dataclasses.dataclass(frozen=True)
class ProblemFamily:
    """A registered problem family.

    solve:      the family's variant-dispatching entry point
                ``fn(problem, cfg, x0=None, state=None) -> SolverResult``.
    variants:   variant name -> "module.path:function" (resolved lazily).
    accepts:    optional tie-break predicate when several families share a
                problem dataclass.
    objective:  direct objective evaluation ``fn(problem, x)``.
    make_problem / describe: CLI hooks (build a problem from parsed
                ``argparse`` args; format a one-line result summary).
    default_mu: CLI default block size.
    state_layout: ``fn(cfg) -> ((leaf_name, layout), ...)`` naming the
                recurrence leaves the variant selected by ``cfg`` carries
                across outer-iteration boundaries, in ``aux["state"]``
                order.
    """

    name: str
    problem_cls: type
    solve: Callable
    variants: Mapping[str, str]
    accepts: Optional[Callable] = None
    objective: Optional[Callable] = None
    make_problem: Optional[Callable] = None
    describe: Optional[Callable] = None
    default_mu: int = 1
    state_layout: Optional[Callable] = None

    def variant(self, name: str) -> Callable:
        """Resolve a registered variant name to its solver function."""
        if name not in self.variants:
            raise ValueError(
                f"unknown variant {name!r} for family {self.name!r}; "
                f"registered: {sorted(self.variants)}")
        module, _, attr = self.variants[name].partition(":")
        return getattr(importlib.import_module(module), attr)

    def matches(self, problem) -> bool:
        """Does this family handle ``problem``? (type + accepts hook)."""
        return isinstance(problem, self.problem_cls) and (
            self.accepts is None or bool(self.accepts(problem)))


FAMILIES: Dict[str, ProblemFamily] = {}


def register_family(name: str, **fields):
    """Decorator: register the decorated variant-dispatch function as the
    ``solve`` entry of a new :class:`ProblemFamily` (``FAMILIES[name]``)."""

    def deco(fn):
        if name in FAMILIES:
            raise ValueError(
                f"family {name!r} already registered "
                f"(registered: {sorted(FAMILIES)})")
        FAMILIES[name] = ProblemFamily(name=name, solve=fn, **fields)
        return fn

    return deco


@dataclasses.dataclass
class SolveState:
    """Full solver state at an outer-iteration boundary.

    iteration: global INNER iterations completed (a host int — it offsets
        the ``fold_in`` RNG iteration ids and the theta-schedule index, so
        a resumed solve draws the same blocks and acceleration scalars as
        the uninterrupted one).
    carry: the named recurrence leaves (tensors), in the family's
        ``state_layout(cfg)`` order.
    """

    iteration: int
    carry: Dict[str, Any] = dataclasses.field(default_factory=dict)


def resume_carry(state: Optional[SolveState], x0, solver_name: str):
    """``state`` and ``x0`` are mutually exclusive (a state IS the warm
    start). Returns ``state.carry`` or None."""
    if state is None:
        return None
    if x0 is not None:
        raise ValueError(
            f"{solver_name}: pass either x0= (fresh warm start) or "
            f"state= (resume a checkpointed solve), not both")
    return state.carry


def require_unit_block(cfg: "SolverConfig", solver_name: str) -> None:
    """Raise for the mu = 1 solver aliases when cfg asks for blocks."""
    if cfg.block_size != 1:
        raise ValueError(
            f"{solver_name} is the block_size == 1 special case "
            f"(got block_size={cfg.block_size}); call the blocked "
            f"variant instead")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Shared solver configuration.

    block_size: mu, the number of coordinates (columns) updated per
       iteration; mu = 1 recovers single-coordinate descent.
    s: recurrence-unrolling parameter. s=1 is the classical method; s>1
       samples s blocks at once and builds ONE fused Gram/projection block
       per outer iteration (paper Alg. 2).
    iterations: H, the total number of inner iterations (need not be a
       multiple of s: a remainder group of H mod s runs last).
    accelerated: use the Nesterov-accelerated variant (accBCD).
    power_iters: fixed power-method iteration count for the largest
       eigenvalue of each (mu, mu) Gram block.
    track_objective: record the objective after every inner iteration.
    symmetric_gram: rebuild the Gram block from its lower triangle (the
       packed layout the sharded backend reduces; identical values).
    seed: RNG seed; the port's threefry reproduces ``jax.random``'s bits.
    dtype: torch.float32 (working type) or torch.float64.
    device: where the solve runs ("cuda" by default; tests pass "cpu").
    """

    block_size: int = 1
    s: int = 1
    iterations: int = 100
    accelerated: bool = True
    power_iters: int = 32
    track_objective: bool = True
    symmetric_gram: bool = False
    seed: int = 0
    dtype: Any = torch.float32
    device: str = "cuda"

    def __post_init__(self):
        if self.s < 1 or self.block_size < 1:
            raise ValueError("s and block_size must be >= 1")
        if self.iterations < 1:
            raise ValueError("iterations must be >= 1")

    @property
    def outer_iterations(self) -> int:
        """Fused Gram rounds: full s-groups plus the remainder group."""
        return -(-self.iterations // self.s)


@dataclasses.dataclass
class SolverResult:
    """Solution + per-iteration diagnostics (tensors on the solve's
    device)."""

    x: Any                       # (n,) solution
    objective: Any               # (H,) objective after each inner iteration
    aux: dict = dataclasses.field(default_factory=dict)
