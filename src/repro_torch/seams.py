"""The recording seams: where a recorder of ``repro_torch.analysis`` sees
the structure of an eager solve.

``repro`` reads a solve's structure off its jaxpr: which collectives sit
inside the outer scan, which products the trace holds. Eager code has no
trace, so the port marks the same structure where it runs:

  * :func:`outer_loop` wraps the outer loop of every solver (the engine's
    grouped schedule and the classical solvers' loops): each item it
    yields is one outer iteration;
  * :func:`kernel_seam` wraps the public entry of each kernel wrapper
    (``gram``, ``spmm`` and its scatter companions, ``sa_inner``,
    ``svm_inner``, ``flash_attention``): it reports one
    :class:`KernelEvent` before the call routes to the plain version (a
    CPU tensor) or the kernel (a CUDA tensor), and the recorder ignores
    the operations inside, so the card, the CPU and the dry run's meta
    tensors count the same work;
  * :func:`gathering` marks the end-of-solve gathers of the sharded
    backend (``linalg.pgather``).

``OPEN`` lists the open recorders. With none open, each seam costs one
test of that list: per call for a kernel entry and ``gathering``, per
loop for ``outer_loop``. This module imports nothing of the port.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterable, NamedTuple, Tuple

# The open recorders (``repro_torch.analysis.record.Recorder``).
OPEN: list = []


class KernelEvent(NamedTuple):
    """One call of a kernel wrapper, as a recorder sees it.

    kernel: the wrapper's package ("gram", "spmm", "sa_inner",
        "svm_inner", "flash_attention"); entry: the function called ("gram_fused",
        "scatter_add", ...); shapes: its operands' shapes; dtype_in /
        dtype_out: the floating types it reads and returns; route: the
        body the call takes on a card (``dispatch``'s choice, "torch" for
        a companion that is plain PyTorch there too), or "plain" on the
        CPU; flops: the work in ``repro.analysis``'s convention (2 x
        output x contraction for a product, the update elements for a
        scatter-add, 4 B Hq D Sq Sk for an attention call).
    """

    kernel: str
    entry: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtype_in: Any
    dtype_out: Any
    route: str
    flops: float


def power_flops(mu: int, power_iters: int) -> float:
    """Flops of K0, ``linalg.power_iteration_max_eig`` on a (mu, mu) block,
    which both inner seams count: power_iters + 1 products G v and one
    v . (G v); none at mu = 1."""
    return 0.0 if mu == 1 else (power_iters + 1) * 2.0 * mu * mu + 2.0 * mu


def kernel_seam(describe: Callable[..., KernelEvent]):
    """Decorator for a kernel wrapper's public entry: with a recorder
    open, ``describe(*args, **kwargs)`` gives the call's event, which
    every open recorder sees on entry and exit."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not OPEN:
                return fn(*args, **kwargs)
            event = describe(*args, **kwargs)
            opened = tuple(OPEN)
            for rec in opened:
                rec.enter_seam(event)
            try:
                return fn(*args, **kwargs)
            finally:
                for rec in opened:
                    rec.exit_seam(event)
        return entry
    return deco


def outer_loop(items: Iterable):
    """``items``, each marked to the open recorders as one outer
    iteration of a solve (the recorder counts what happens between an
    item's yield and the next request as that iteration)."""
    if not OPEN:
        return iter(items)
    return _marked(items, tuple(OPEN))


def _marked(items, opened):
    for item in items:
        for rec in opened:
            rec.outer_begin()
        yield item
        for rec in opened:
            rec.outer_end()


@contextlib.contextmanager
def gathering():
    """Mark the block as the end-of-solve gathers of a sharded solve."""
    opened = tuple(OPEN)
    for rec in opened:
        rec.gather_begin()
    try:
        yield
    finally:
        for rec in opened:
            rec.gather_end()
