"""The recorder: one eager solve, counted at dispatch and at the seams.

``repro``'s passes walk a jaxpr; the port's run the solve under a
:class:`Recorder`, a ``TorchDispatchMode`` that is also an open recorder
of ``repro_torch.seams``. It sorts what it sees into the outer iterations
the solvers mark (``seams.outer_loop``), the setup around them, and the
end-of-solve gathers (``seams.gathering``):

  * collectives: the ``c10d`` operations ``torch.distributed`` dispatches
    (:data:`COLLECTIVE_PRIMS` maps them to ``repro``'s HLO names), with
    the all-reduces' payload elements and bytes, and by process group
    (``collectives_by_group``: a trainer's data group and model group),
    each with its result bytes (``collective_traffic``) in
    ``repro``'s convention (``collective_stats_from_hlo``'s): an
    all-gather's gathered output, a reduce-scatter's block of the rank,
    an all-reduce's reduced tensor, an all-to-all's or a permute's
    output: the tensors of the operation's first argument, which is its
    output in every ``c10d`` schema (a barrier's dummy counts none);
  * flops in ``repro.analysis``'s convention: 2 x output x contraction
    for each matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``addmv``, ``dot``, ``vdot``; a composite operation such as
    ``matmul`` or ``einsum``, which reaches the recorder whole under
    ``inference_mode``, is run as its decomposition, so a step counts
    the same under ``no_grad`` and ``inference_mode``), the update
    elements of each scatter-add (``index_put`` with ``accumulate``,
    ``index_add``, ``scatter_add``), and each kernel seam's event.
    Inside a seam the recorder counts nothing, so the plain version's
    products (the CPU) and the kernel (the card, which no dispatch mode
    sees) count the same: the event's;
  * with ``narrowing=True``, every operation that reads a float64 tensor
    and yields a narrower float one, and every seam event of a float64
    call that returns another type or takes a body that computes in
    f32, each with the Python source line that made it.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import seams

# c10d operation -> the HLO-side name repro's passes report (one shared
# vocabulary); broadcasts and barriers, which an SA solve has none of,
# under names of their own.
COLLECTIVE_PRIMS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "collective-broadcast",
    "barrier": "barrier",
}
# repro's five kinds first (its CollectiveBudget's keys), then the port's.
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "collective-broadcast", "barrier")

# Bodies that compute in f32 whatever they are given (K1's 3xTF32 wgmma
# body): a float64 call must never take one.
F32_ROUTES = frozenset({"wgmma"})

_PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv",
                       "dot", "vdot"})
_NARROW = (torch.float32, torch.float16, torch.bfloat16)
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.dirname(os.path.abspath(__file__)),
         os.path.join(_PKG, "seams.py"),
         os.path.dirname(os.path.abspath(torch.__file__)))


def _numel(shape) -> float:
    return float(math.prod(shape)) if len(shape) else 1.0


def product_flops(name: str, args) -> float:
    """2 x output x contraction of one matrix product at dispatch."""
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]
    a, b = args[0], args[1]
    if name == "mm":
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * a.shape[0] * a.shape[1]
    return 2.0 * a.shape[0]                              # dot, vdot


def _index_put_updates(self_t, indices) -> float:
    """Elements one ``index_put(..., accumulate=True)`` adds: the
    broadcast shape of the index tensors times the dimensions they do
    not index."""
    idx = [i for i in indices if i is not None]
    shape = torch.broadcast_shapes(*(tuple(i.shape) for i in idx))
    return _numel(shape) * _numel(tuple(self_t.shape[len(indices):]))


def scatter_add_updates(name: str, args, kwargs) -> Optional[float]:
    """Update elements of a scatter-add at dispatch, None for anything
    else (an ``index_put`` without ``accumulate`` is a scatter)."""
    if name in ("index_put_", "index_put", "_index_put_impl_"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return _index_put_updates(args[0], args[1]) if acc else None
    if name in ("index_add_", "index_add"):
        return float(args[3].numel())
    if name in ("scatter_add_", "scatter_add"):
        return float(args[2].numel())
    return None


def source_line() -> str:
    """file:line of the innermost frame outside torch, this package's
    ``analysis`` and ``seams`` modules: the solver line that made the
    operation."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not path.startswith(_SKIP):
            return f"{os.path.basename(path)}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


@dataclasses.dataclass
class Tally:
    """What one span of a solve did (an outer iteration, the setup
    around the iterations, or the end gathers)."""

    flops: float = 0.0
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    allreduce_elements: float = 0.0
    allreduce_bytes: float = 0.0
    gather_bytes: float = 0.0
    # (process group name, kind) -> count, and -> result bytes
    by_group: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=collections.Counter)
    bytes_by_group: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=collections.Counter)


_COMPOSITE: Dict[object, bool] = {}


def _composite(func) -> bool:
    """Whether ``func`` has a ``CompositeImplicitAutograd`` kernel."""
    if func not in _COMPOSITE:
        _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return _COMPOSITE[func]


def _group_name(args) -> str:
    """The name of the process group a ``c10d`` operation's arguments
    carry (``ProcessGroup.group_name``), or "?"."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return torch.distributed.ProcessGroup.unbox(a).group_name
            except (RuntimeError, AttributeError, TypeError):
                continue
    return "?"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def result_bytes(kind: str, args) -> float:
    """The result bytes of one ``c10d`` operation of ``kind`` at dispatch:
    the bytes of its first argument's tensors, the output in every
    schema (a barrier's dummy tensor: 0)."""
    if kind == "barrier":
        return 0.0
    return float(sum(t.numel() * t.element_size()
                     for t in _tensors(args[0])))


class Recorder(TorchDispatchMode):
    """Record one solve: ``with Recorder() as rec: api.solve_sharded(...)``.

    outer: one :class:`Tally` per outer iteration, in order; setup: the
    rest of the solve outside the outer iterations (and outside the end
    gathers); end: the end-of-solve gathers. events: the kernel seams'
    events with the outer iteration they ran in (None: setup).
    narrowing: (src dtype, dst dtype, what, source line) of each float64
    narrowing, when constructed with ``narrowing=True``.
    """

    def __init__(self, narrowing: bool = False):
        super().__init__()
        self.check_narrowing = narrowing
        self.outer: List[Tally] = []
        self.setup = Tally()
        self.end = Tally()
        self.events: List[Tuple[seams.KernelEvent, Optional[int]]] = []
        self.narrowing: List[Tuple[str, str, str, str]] = []
        self._seam = 0
        self._outer = 0
        self._gather = 0

    # -- the seams ------------------------------------------------------
    def __enter__(self):
        seams.OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        seams.OPEN.remove(self)
        return super().__exit__(*exc)

    def _tally(self) -> Tally:
        if self._gather:
            return self.end
        return self.outer[-1] if self._outer else self.setup

    def outer_begin(self) -> None:
        if self._outer == 0:
            self.outer.append(Tally())
        self._outer += 1

    def outer_end(self) -> None:
        self._outer -= 1

    def gather_begin(self) -> None:
        self._gather += 1

    def gather_end(self) -> None:
        self._gather -= 1

    def enter_seam(self, event: seams.KernelEvent) -> None:
        if self._seam == 0:
            self.events.append(
                (event, len(self.outer) - 1 if self._outer else None))
            self._tally().flops += event.flops
            if self.check_narrowing and event.dtype_in == torch.float64:
                if event.dtype_out != torch.float64:
                    self.narrowing.append((
                        "float64", str(event.dtype_out).split(".")[-1],
                        f"{event.kernel}.{event.entry} returns it",
                        source_line()))
                elif event.route in F32_ROUTES:
                    self.narrowing.append((
                        "float64", "float32",
                        f"{event.kernel}.{event.entry} takes its "
                        f"{event.route!r} body, which computes in f32",
                        source_line()))
        self._seam += 1

    def exit_seam(self, event: seams.KernelEvent) -> None:
        self._seam -= 1

    # -- dispatch -------------------------------------------------------
    def decomposed(self, func, args, kwargs):
        """A composite operation (one with a ``CompositeImplicitAutograd``
        kernel: ``matmul``, ``einsum``, ...) run as its decomposition,
        whose operations this recorder sees and counts; NotImplemented
        for any other. Under ``no_grad`` the autograd layer decomposes
        them before a dispatch mode sees them; under ``inference_mode``
        they arrive whole, and would hide their products."""
        if not _composite(func):
            return NotImplemented
        TorchDispatchMode.__enter__(self)
        try:
            return func.decompose(*args, **kwargs)
        finally:
            TorchDispatchMode.__exit__(self, None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self.decomposed(func, args, kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        ns, _, name = func._schema.name.partition("::")
        if ns == "c10d" and name in COLLECTIVE_PRIMS:
            self._collective(COLLECTIVE_PRIMS[name], args)
        elif ns == "aten" and self._seam == 0:
            if name in _PRODUCTS:
                self._tally().flops += product_flops(name, args)
            else:
                n = scatter_add_updates(name, args, kwargs)
                if n is not None:
                    self._tally().flops += n
        if self.check_narrowing:
            self._narrowing(name, args, kwargs, out)
        return out

    def _collective(self, kind: str, args) -> None:
        tally = self._tally()
        tally.collectives[kind] += 1
        key = (_group_name(args), kind)
        tally.by_group[key] += 1
        tally.bytes_by_group[key] += result_bytes(kind, args)
        if kind == "all-reduce":
            for t in _tensors(args[0]):
                tally.allreduce_elements += t.numel()
                tally.allreduce_bytes += t.numel() * t.element_size()
        elif kind == "all-gather":
            for t in _tensors(args[1]):
                tally.gather_bytes += t.numel() * t.element_size()

    def _narrowing(self, name, args, kwargs, out) -> None:
        ins = list(_tensors(list(args) + list(kwargs.values())))
        if not any(t.dtype == torch.float64 for t in ins):
            return
        for t in _tensors(out):
            if t.dtype in _NARROW:
                self.narrowing.append(("float64",
                                       str(t.dtype).split(".")[-1],
                                       f"aten.{name}", source_line()))
                return

    # -- summaries ------------------------------------------------------
    def spans(self):
        """Every tally: setup, each outer iteration, the end gathers."""
        return [self.setup, *self.outer, self.end]

    def collectives_by_group(self) -> Dict[str, Dict[str, int]]:
        """{process group name: {kind: count}} over every span."""
        out: Dict[str, Dict[str, int]] = {}
        for tally in self.spans():
            for (group, kind), n in tally.by_group.items():
                per = out.setdefault(group, {})
                per[kind] = per.get(kind, 0) + n
        return out

    def collective_traffic(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{process group name: {kind: {"count": n, "bytes": result
        bytes}}} over every span: :meth:`collectives_by_group`'s counts
        with each kind's result bytes beside them, kinds in name order."""
        sizes: Dict[Tuple[str, str], float] = collections.Counter()
        for tally in self.spans():
            sizes.update(tally.bytes_by_group)
        return {group: {kind: {"count": n, "bytes": sizes[(group, kind)]}
                        for kind, n in sorted(per.items())}
                for group, per in self.collectives_by_group().items()}

    def kernel_flops(self) -> Dict[str, float]:
        """Flops of the seam events by entry, "kernel.entry"."""
        out: Dict[str, float] = collections.defaultdict(float)
        for event, _ in self.events:
            out[f"{event.kernel}.{event.entry}"] += event.flops
        return dict(out)
