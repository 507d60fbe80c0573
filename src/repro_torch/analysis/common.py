"""Shared vocabulary of the static contract analyzer (the port of
``repro/analysis/common.py``): diagnostics, the report container, the
family-variant enumeration every pass uses, and the problems and
one-rank process group the solver passes run on.

Each pass returns a flat list of :class:`Diagnostic`;
``repro_torch.analysis.check_all`` merges them into one
:class:`AnalysisReport`. A diagnostic names its pass, what it examined
(``family:variant`` for the solver passes, ``path:line`` for the repo
lint) and the violated contract.

Where ``repro`` traces a solve symbolically, the port runs it: every
solver pass builds a small deterministic problem
(:func:`certification_problem`) on the requested device and solves it on
the sharded backend over a one-rank group (:func:`one_rank_group`), so
each ``linalg.preduce`` issues its ``all_reduce``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Iterable, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.types import (ProblemFamily, SolverConfig,
                                    resolve_device)

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of one analysis pass.

    check:    the pass ("collectives", "replication", "dtypes", "costs",
              "kernels", "lint", "registry").
    severity: "error" fails the analysis; "warning" is reported but
              non-fatal; "info" carries measurements (payload bytes per
              outer iteration, cost ratios).
    where:    "family:variant" for solver passes, "path:line" for the
              repo lint.
    message:  the violated contract (or the measurement), human-first.
    """

    check: str
    severity: str
    where: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, "
                f"got {self.severity!r}")

    def format(self) -> str:
        return f"[{self.check}] {self.severity}: {self.where}: " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AnalysisReport:
    """All diagnostics of one analyzer run plus what it covered."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    checked: List[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def format(self, verbose: bool = False) -> str:
        lines = []
        for d in self.diagnostics:
            if verbose or d.severity != "info":
                lines.append(d.format())
        lines.append(
            f"{len(self.checked)} subjects checked, "
            f"{len(self.errors)} error(s), "
            f"{sum(d.severity == 'warning' for d in self.diagnostics)} "
            f"warning(s)")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """JSON-ready report: the ``--json`` CLI payload."""
        return {
            "ok": self.ok,
            "errors": len(self.errors),
            "warnings": sum(d.severity == "warning"
                            for d in self.diagnostics),
            "checked": list(self.checked),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }


def variant_config(fam: ProblemFamily, variant: str,
                   iterations: int = 16, device="cuda",
                   **overrides) -> SolverConfig:
    """The SolverConfig under which ``fam.solve`` dispatches to the
    named registered variant, on ``device``: SA variants ("sa*", "ca*")
    get s = 8, classical ones s = 1; "accelerated" in the name toggles
    ``cfg.accelerated``. ``iterations`` defaults to a multiple of s, so
    there is no remainder tail group; ``track_objective`` is off (a
    tracked objective adds reductions outside Table I's contract)."""
    if variant not in fam.variants:
        raise ValueError(
            f"unknown variant {variant!r} for family {fam.name!r}; "
            f"registered: {sorted(fam.variants)}")
    kw = dict(
        block_size=fam.bench_block_size,
        s=8 if variant.startswith(("sa", "ca")) else 1,
        accelerated="accelerated" in variant,
        iterations=iterations,
        track_objective=False,
        device=str(device),
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def family_variants(fam: ProblemFamily) -> Tuple[str, ...]:
    """The family's registered variant names, sorted: the enumeration
    axis of every solver pass."""
    return tuple(sorted(fam.variants))


def bench_shape(fam: ProblemFamily) -> Tuple[int, int]:
    """A small representative (m, n) per partition layout: row-
    partitioned families shard data points, column-partitioned ones
    shard features."""
    return (64, 32) if fam.partition == "row" else (32, 64)


def certification_problem(fam: ProblemFamily, m: int = None,
                          n: int = None, dtype=torch.float32,
                          device="cuda", operand=None):
    """A deterministic problem of ``fam``: A (m, n) standard normal (or
    the given ``SparseOperand``) and labels b in {-1, +1} (a valid
    target for every family), drawn on the host from a seeded generator
    and moved to ``device``, so the card and the CPU solve the same data;
    the rest from ``fam.bench_problem_kwargs``."""
    gen = torch.Generator().manual_seed(0)
    if operand is not None:
        m, n = operand.shape
        A = operand.to(device=device, dtype=dtype)
    else:
        A = torch.randn((m, n), generator=gen, dtype=torch.float64) \
            .to(device=device, dtype=dtype)
    b = torch.randn(m, generator=gen, dtype=torch.float64)
    b = torch.where(b >= 0, 1.0, -1.0).to(device=device, dtype=dtype)
    return fam.problem_cls(A=A, b=b, **dict(fam.bench_problem_kwargs))


@contextlib.contextmanager
def one_rank_group(device="cuda"):
    """The process group a solver pass solves over: the default group
    when the caller has one (every rank must then run the pass), else a
    group of world size 1 made for the block in this process (gloo on
    the CPU, NCCL on the card) through a ``FileStore`` in a temporary
    directory, and destroyed after it."""
    dev = resolve_device(device)
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_analysis_") as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()
