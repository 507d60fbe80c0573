"""Repo lint (the port of ``repro/analysis/lint.py``): AST rules for the
port's source plus the registry contract check.

Three AST rules over ``src/repro_torch``:

  * **raw-collective** — no direct ``torch.distributed`` collective
    (``all_reduce``, ``all_gather``, ``broadcast``, ``reduce_scatter``,
    ``all_to_all``, ``send``, ``recv``, ``barrier`` and their variants)
    outside ``core/linalg.py`` (``preduce`` / ``pgather``, the seams every
    solver communicates through) and ``core/distributed.py`` (the job
    launcher's barrier);
  * **ambient-rng** — no stdlib ``random``, no ``np.random.*`` global
    state, no ``torch.manual_seed`` / ``torch.seed``, and no
    ``torch.rand*`` / ``randn*`` / ``randint`` / ``randperm`` /
    ``normal`` / ``bernoulli`` / ``multinomial`` without ``generator=``:
    solver sampling flows through the keyed threefry of ``core.rng``.
    ``np.random.default_rng`` (an explicit generator) is allowed only in
    the data and launch layers and the microbench; a generator's own
    ``gen.manual_seed`` is allowed anywhere;
  * **bare-assert** — no ``assert`` in library code (``python -O``
    strips it; validation raises ``ValueError``).

Plus one runtime contract check:

  * **registry** — every module-level :class:`FamilyProgram` backing a
    registered family has ``carry_names`` covered by the family's
    ``state_layout(cfg)`` for some registered cfg shape, or a state the
    engine writes cannot be restored by name.
"""
from __future__ import annotations

import ast
import inspect
import pathlib
from typing import List, Optional, Tuple

from repro_torch.analysis.common import Diagnostic, variant_config

__all__ = ["COLLECTIVE_FNS", "RAW_COLLECTIVE_ALLOW", "lint_source",
           "lint_paths", "check_registry"]

COLLECTIVE_FNS = frozenset({
    "all_reduce", "all_reduce_coalesced", "all_gather",
    "all_gather_into_tensor", "all_gather_object", "all_gather_coalesced",
    "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "barrier",
    "monitored_barrier", "gather", "scatter", "gather_object",
    "scatter_object_list",
})
_DIST_NAMES = frozenset({"dist", "distributed"})

# paths (relative to src/repro_torch) allowed to call raw collectives.
RAW_COLLECTIVE_ALLOW = frozenset({"core/linalg.py", "core/distributed.py"})

DEFAULT_RNG_ALLOW_DIRS = ("data/", "launch/")
DEFAULT_RNG_ALLOW_FILES = frozenset({"tune/microbench.py"})

_NP_NAMES = frozenset({"np", "numpy"})
_RNG_GLOBAL_OK = frozenset({"default_rng", "Generator", "RandomState",
                            "SeedSequence", "BitGenerator", "Philox",
                            "PCG64"})
_TORCH_DRAWS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson"})
_TORCH_SEEDS = frozenset({"manual_seed", "seed", "initial_seed"})


def _attr_chain(node) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.diags: List[Diagnostic] = []
        self._dist_ok = rel in RAW_COLLECTIVE_ALLOW
        self._rng_ok = rel in DEFAULT_RNG_ALLOW_FILES or any(
            rel.startswith(d) for d in DEFAULT_RNG_ALLOW_DIRS)
        self._dist_imported = set()     # names bound by from-imports

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.diags.append(Diagnostic(
            "lint", "error", f"{self.rel}:{node.lineno}",
            f"[{rule}] {msg}"))

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain:
            leaf = chain[-1]
            raw = (len(chain) >= 2 and chain[-2] in _DIST_NAMES
                   and leaf in COLLECTIVE_FNS) \
                or (len(chain) == 1 and leaf in self._dist_imported)
            if raw and not self._dist_ok:
                self._emit(
                    "raw-collective", node,
                    f"direct torch.distributed.{leaf} call — solvers "
                    f"communicate through repro_torch.core.linalg.preduce "
                    f"so the collective budget stays in one place")
            if len(chain) >= 3 and chain[0] in _NP_NAMES \
                    and chain[1] == "random":
                fn = chain[2]
                if fn not in _RNG_GLOBAL_OK:
                    self._emit(
                        "ambient-rng", node,
                        f"np.random.{fn} uses numpy's ambient global RNG "
                        f"state — library code takes a keyed draw "
                        f"(core.rng) or an explicit Generator in the data "
                        f"layer")
                elif not self._rng_ok:
                    self._emit(
                        "ambient-rng", node,
                        f"np.random.{fn} outside the data/launch/"
                        f"microbench layers — solver-side randomness is "
                        f"the keyed threefry of core.rng")
            if chain[0] == "torch" and len(chain) >= 2:
                if leaf in _TORCH_SEEDS and chain[-2] in ("torch", "cuda",
                                                      "random"):
                    self._emit(
                        "ambient-rng", node,
                        f"torch.{'.'.join(chain[1:])} seeds torch's "
                        f"ambient generator — use a torch.Generator")
                elif len(chain) == 2 and leaf in _TORCH_DRAWS and not any(
                        k.arg == "generator" for k in node.keywords):
                    self._emit(
                        "ambient-rng", node,
                        f"torch.{leaf} without generator= draws from "
                        f"torch's ambient state — pass a seeded "
                        f"torch.Generator")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "random" or alias.name.startswith("random."):
                self._emit("ambient-rng", node,
                           "stdlib random is ambient global state — use "
                           "core.rng's keyed draws")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "random":
            self._emit("ambient-rng", node,
                       "stdlib random is ambient global state — use "
                       "core.rng's keyed draws")
        if node.module == "torch.distributed":
            for alias in node.names:
                if alias.name in COLLECTIVE_FNS:
                    self._dist_imported.add(alias.asname or alias.name)
                    if not self._dist_ok:
                        self._emit(
                            "raw-collective", node,
                            f"importing {alias.name} from "
                            f"torch.distributed — communicate through "
                            f"repro_torch.core.linalg.preduce")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._emit("bare-assert", node,
                   "bare assert is stripped under python -O — raise "
                   "ValueError for input validation")
        self.generic_visit(node)


def lint_source(source: str, rel: str) -> List[Diagnostic]:
    """Lint one module's source text; ``rel`` is its path relative to
    the package root (``src/repro_torch``)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Diagnostic("lint", "error", f"{rel}:{exc.lineno or 0}",
                           f"[syntax] {exc.msg}")]
    linter = _Linter(rel)
    linter.visit(tree)
    return linter.diags


def lint_paths(root: Optional[pathlib.Path] = None
               ) -> Tuple[List[Diagnostic], List[str]]:
    """Lint every ``.py`` file under ``root`` (default: the
    ``repro_torch`` package directory)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[1]
    root = pathlib.Path(root)
    diags: List[Diagnostic] = []
    checked: List[str] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        checked.append(rel)
        diags.extend(lint_source(path.read_text(), rel))
    return diags, checked


def check_registry(families=None) -> Tuple[List[Diagnostic], List[str]]:
    """Cross-check every family's engine programs against its declared
    state layout: ``FamilyProgram.carry_names`` must be covered by the
    names ``state_layout(cfg)`` declares for at least one registered cfg
    shape (classical / SA, plain / accelerated)."""
    from repro_torch.core.api import FAMILIES
    from repro_torch.core.engine import FamilyProgram
    diags: List[Diagnostic] = []
    checked: List[str] = []
    for fam in (FAMILIES.values() if families is None else families):
        if fam.state_layout is None:
            continue
        layouts = []
        for s in (1, 8):
            for accelerated in (False, True):
                cfg = variant_config(fam, sorted(fam.variants)[0], s=s,
                                     accelerated=accelerated, device="cpu")
                layouts.append(frozenset(
                    name for name, _ in fam.state_layout(cfg)))
        programs = {}
        for vname in fam.variants:
            module = inspect.getmodule(fam.variant(vname))
            for attr, val in vars(module).items():
                if isinstance(val, FamilyProgram):
                    programs[f"{module.__name__}.{attr}"] = val
        for pname, prog in programs.items():
            where = f"{fam.name}:{pname}"
            checked.append(where)
            carry = frozenset(prog.carry_names)
            if not any(carry <= layout for layout in layouts):
                missing = carry - frozenset().union(*layouts)
                diags.append(Diagnostic(
                    "registry", "error", where,
                    f"carry_names {sorted(carry)} not covered by any "
                    f"state_layout(cfg) ({[sorted(l) for l in layouts]}) "
                    f"— leaves {sorted(missing)} would be saved under "
                    f"names the restore path cannot map"))
    return diags, checked
