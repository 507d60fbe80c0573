"""Fully sharded data parallelism over the data axis: ``repro``'s ``fsdp``
rule in the port's trainer.

``repro``'s trainer places every parameter and its AdamW moments with
``param_partition_specs(..., fsdp="data")``: the dim of each matrix that
the model axis does not split goes over 'data' (``parallel.sharding``'s
rules), and ``sanitize_spec`` replicates a dim the axis does not divide.
The port does the same on a rank of a (data, model) grid
(``parallel.tensor.build_grid``): a leaf is cut first by the model axis
(``tensor.layout``), then by the data axis on its :func:`data_layout` dim
(``tensor.cut``), and the rank's ``nn.Parameter`` holds that shard
(:func:`shard_params`). These leaves stay whole over 'data':

  * the 1-D ``w_*`` leaves, whose 'data' entry ``repro`` puts on the group
    axis it stacks layers along, which the port does not have
    (``parallel.sharding``);
  * a leaf whose ``fsdp`` dim the data axis does not divide
    (``sanitize_spec``), and the leaves ``repro`` replicates (norm scales,
    biases, the router, the recurrent ``r_*``, ``meta``, ``pos_embed``).

A leaf split by flat columns on the model axis (hymba's attention and
SSM heads: ``parallel.tensor``) is cut over 'data' on its ``fsdp`` dim
all the same: the step gathers it whole, so head boundaries do not
matter.

The train step (``runtime.driver.make_train_step``) lays its leaves out
with a :class:`Plan`. With a data axis of D > 1:

  * per microbatch, the shards of each layer (and of the leaves outside
    the layers: the embedding, the unembedding, ...) are all-gathered over
    the data group in one ``linalg.pall_gather`` of their bytes
    (:meth:`Plan.gather`, :func:`gather_packed`), and :func:`bound` puts the gathered tensors in
    place of the parameters for the forward and the backward; they are
    what ``torch.autograd.grad`` differentiates;
  * the gradients add into one f32 buffer laid out rank-major: chunk r
    holds rank r's shards of every split leaf, then piece r of the tail
    (the whole leaves' gradients and the loss, flat, cut in D pieces).
    ONE counted ``linalg.preduce_scatter`` leaves each rank its summed
    chunk, the step's one gradient reduction (:meth:`Plan.reduce`); one
    ``pall_gather`` of the tail's pieces then gives every rank the whole
    leaves' sums and the loss. Each element is summed once, so the whole
    leaves stay equal on every rank bit for bit;
  * AdamW updates the shards; its clip's norm sums the shards' squares
    over the data group (``optim.adamw``).

With D = 1 the buffer is the tail alone and its reduction one counted
``linalg.preduce``, as before FSDP.

The trade: a rank keeps its shards of the parameters (2 bytes each at
bf16) and of the two f32 moments (8 bytes), (2 + 8)(1 - 1/D) bytes a
parameter less than replicated data parallelism. The f32 buffer (4 bytes
a parameter of the model rank's, plus its 4 / D reduced chunk) and one
microbatch's gathered weights are temporaries of the step; each
microbatch gathers (D - 1) / D of the weights into every rank.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Optional

import torch

from repro_torch.core import linalg

__all__ = ["data_layout", "grid_data_layout", "shard_params", "bound",
           "gather_packed", "Plan"]


def data_layout(arch, mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the dim the 'data' axis of ``mesh`` splits, or
    None}: ``repro``'s ``fsdp`` entry of each leaf
    (``sharding.param_partition_specs``, sanitized against ``mesh``)."""
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import param_partition_specs
    specs = param_partition_specs(lm.param_specs(arch), mesh)
    if mesh.shape.get("data", 1) == 1:
        return dict.fromkeys(specs)
    return {name: next((d for d, part in enumerate(spec) if part == "data"),
                       None)
            for name, spec in specs.items()}


def grid_data_layout(arch, data_size: int, model_size: int
                     ) -> Dict[str, Optional[int]]:
    """:func:`data_layout` on a (``data_size``, ``model_size``) mesh."""
    from repro_torch.launch.mesh import make_mesh
    return data_layout(arch, make_mesh((data_size, model_size),
                                       ("data", "model")))


def _modules(model, name):
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def shard_params(model, dims: Mapping[str, Optional[int]], axis) -> None:
    """Replace each parameter of ``model`` that ``dims`` splits by rank
    ``axis.index``'s block of it along that dim (a new ``nn.Parameter``,
    its own storage), in place."""
    from repro_torch.parallel.tensor import cut
    if axis is None or axis.size == 1:
        return
    for name, p in list(model.named_parameters()):
        if dims.get(name) is None:
            continue
        mod, leaf = _modules(model, name)
        with torch.no_grad():
            shard = cut(p.detach(), dims[name], axis).clone()
        setattr(mod, leaf, torch.nn.Parameter(shard,
                                              requires_grad=p.requires_grad))


@contextlib.contextmanager
def bound(model, tensors: Mapping[str, torch.Tensor]):
    """Inside the block, ``model``'s parameter ``name`` reads
    ``tensors[name]`` (a gathered weight) for every name given."""
    saved = []
    try:
        for name, t in tensors.items():
            mod, leaf = _modules(model, name)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield model
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def _align(n: int) -> int:
    return -(-n // 16) * 16


def gather_packed(tensors: Mapping[str, torch.Tensor],
                  dims: Mapping[str, Optional[int]], axis
                  ) -> Dict[str, torch.Tensor]:
    """{name: the whole leaf} of each of ``tensors`` (this rank's shards)
    that ``dims`` splits over ``axis``: one ``linalg.pall_gather`` of
    their bytes, packed at 16-byte offsets (any mix of dtypes), then each
    leaf concatenated from the ranks' blocks along its dim. Every rank of
    the axis calls it."""
    items = [(n, t) for n, t in tensors.items() if dims.get(n) is not None]
    if not items or axis is None or axis.size == 1:
        return {}
    offs, at = [], 0
    for n, t in items:
        nb = t.numel() * t.element_size()
        offs.append((at, nb))
        at = _align(at + nb)
    send = torch.empty(at, dtype=torch.uint8, device=items[0][1].device)
    for (n, t), (o, nb) in zip(items, offs):
        send[o:o + nb].view(t.dtype).copy_(t.detach().reshape(-1))
    got = linalg.pall_gather(send, axis.group).view(axis.size, at)
    return {n: torch.cat([got[r, o:o + nb].view(t.dtype).view(t.shape)
                          for r in range(axis.size)], dim=dims[n])
            for (n, t), (o, nb) in zip(items, offs)}


def _group_of(name: str) -> str:
    """The gather group of a leaf: its layer, or "" (the leaves outside
    the layers)."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part == "layers":
            return ".".join(parts[:i + 2])
    return ""


class Plan:
    """A rank's leaves in the step's buffer. ``shapes``: {name: the model
    rank's (unsplit by data) shape}, in the buffer's order; ``dims``: the
    data layout; ``data``: the data ``Axis``; ``dtypes``: {name: dtype}."""

    def __init__(self, shapes: Mapping[str, tuple], dtypes: Mapping,
                 dims: Mapping[str, Optional[int]], data):
        D = data.size if data is not None else 1
        self.data, self.D = data, D
        self.names = list(shapes)
        self.dims = {n: dims.get(n) if D > 1 else None for n in self.names}
        self.split = [n for n in self.names if self.dims[n] is not None]
        self.whole = [n for n in self.names if self.dims[n] is None]
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.shard = {}
        for n in self.split:
            s = list(self.shapes[n])
            s[self.dims[n]] //= D
            self.shard[n] = tuple(s)
        self.off, at = {}, 0
        for n in self.split:
            self.off[n] = at
            at += math.prod(self.shard[n])
        self.chunk_shards = at
        for n in self.whole:
            self.off[n] = at - self.chunk_shards
            at += math.prod(self.shapes[n])
        self.loss_at = at - self.chunk_shards
        tail = self.loss_at + 1
        self.piece = -(-tail // D)
        self.chunk = self.chunk_shards + self.piece
        # the gather groups: a layer's split leaves, and the rest's
        self.groups: Dict[str, List[str]] = {}
        for n in self.split:
            self.groups.setdefault(_group_of(n), []).append(n)

    def prefix(self, names) -> tuple:
        """(elements of the chunk's shards, elements of the tail) held by
        the leading leaves ``names`` of the order (the SP-partial ones)."""
        names = set(names)
        a = sum(math.prod(self.shard[n]) for n in self.split if n in names)
        b = sum(math.prod(self.shapes[n]) for n in self.whole if n in names)
        return a, b

    def gather(self, params: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """{name: the model rank's whole leaf, requiring grad} of the split
        leaves, gathered over the data group from ``params`` (the shards):
        one :func:`gather_packed` a group."""
        out = {}
        for leaves in self.groups.values():
            out.update(gather_packed({n: params[n] for n in leaves},
                                     self.dims, self.data))
        return {n: t.requires_grad_() for n, t in out.items()}

    def buffers(self, device):
        """(buf, tail, acc): the f32 buffer of D chunks, the tail (a view
        of ``buf`` for D = 1), and {name: the view(s) a gradient adds
        into}: D shard views for a split leaf, one for a whole leaf."""
        buf = torch.zeros(self.D * self.chunk, dtype=torch.float32,
                          device=device)
        tail = buf[self.chunk_shards:] if self.D == 1 else torch.zeros(
            self.D * self.piece, dtype=torch.float32, device=device)
        rows = buf.view(self.D, self.chunk)
        acc = {}
        for n in self.split:
            size = math.prod(self.shard[n])
            acc[n] = [rows[r, self.off[n]:self.off[n] + size].view(
                self.shard[n]) for r in range(self.D)]
        for n in self.whole:
            size = math.prod(self.shapes[n])
            acc[n] = tail[self.off[n]:self.off[n] + size].view(
                self.shapes[n])
        return buf, tail, acc

    def add(self, acc, name: str, g: torch.Tensor) -> None:
        """Add the whole (model rank's) gradient ``g`` of ``name``."""
        if self.dims[name] is None:
            acc[name].add_(g)
            return
        for view, part in zip(acc[name], g.chunk(self.D, self.dims[name])):
            view.add_(part)

    def reduce(self, buf, tail):
        """The step's one gradient reduction over the data group: (chunk,
        tail) summed over the ranks; ``chunk`` holds this rank's shards,
        ``tail`` every whole leaf and the loss (in the last used slot)."""
        if self.D == 1:
            linalg.preduce(buf, self.data.group if self.data else None)
            return buf, tail
        rows = buf.view(self.D, self.chunk)
        rows[:, self.chunk_shards:].copy_(tail.view(self.D, self.piece))
        chunk = linalg.preduce_scatter(buf, self.data.group, counted=True)
        tail = linalg.pall_gather(chunk[self.chunk_shards:], self.data.group)
        return chunk, tail

    def model_sum(self, chunk, tail, names, group) -> None:
        """Sum the reduced gradients of the leading leaves ``names`` (the
        SP-partial ones) over the model ``group``, in one uncounted
        all-reduce: a sum over the data group then the model group is the
        sum over both, on 1 / D of the bytes."""
        a, b = self.prefix(names)
        if a and b:
            both = linalg.preduce(torch.cat([chunk[:a], tail[:b]]), group,
                                  counted=False)
            chunk[:a].copy_(both[:a])
            tail[:b].copy_(both[a:])
        elif a or b:
            linalg.preduce(chunk[:a] if a else tail[:b], group,
                           counted=False)

    def scale(self, chunk, tail, n: int) -> None:
        """Divide the reduced gradients and loss by ``n``."""
        chunk.div_(n)
        if self.D > 1:                  # else ``tail`` is a view of it
            tail.div_(n)

    def grads(self, chunk, tail) -> Dict[str, torch.Tensor]:
        """{name: this rank's reduced gradient}: a view of ``chunk`` (a
        split leaf's shard) or of ``tail`` (a whole leaf)."""
        out = {}
        for n in self.names:
            if self.dims[n] is None:
                size = math.prod(self.shapes[n])
                out[n] = tail[self.off[n]:self.off[n] + size].view(
                    self.shapes[n])
            else:
                size = math.prod(self.shard[n])
                out[n] = chunk[self.off[n]:self.off[n] + size].view(
                    self.shard[n])
        return out
