"""Problem and solver configuration types (the port of
``repro/core/types.py``, dense Lasso slice).

The solvers take tensors (or anything ``torch.as_tensor`` accepts) and
put them on ``SolverConfig.device``. The device decides the path: on a
CUDA tensor the ``gram`` and ``sa_inner`` kernels run, on a CPU tensor
their plain PyTorch versions do. Asking for ``"cuda"`` on a machine
without a card raises; nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Mapping, Optional

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


@dataclasses.dataclass(frozen=True)
class LassoProblem:
    """Proximal least-squares problem data.

    A: (m, n) dense design matrix (m data points, n features).
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
