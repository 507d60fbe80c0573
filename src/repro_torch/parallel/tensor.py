"""Tensor, expert and sequence parallelism over a (data, model) grid of
ranks: the grid, the model axis's collectives, and the layout that cuts
each parameter into its rank's shard and gathers it back.

The grid is ``repro``'s ``build_mesh``: n ranks in ``repro``'s order,
``reshape(n // model_axis, model_axis)``, so rank r sits at data index
r // m and model index r % m. :func:`build_grid` makes the model group
(the m ranks of one data index) and the data group (the ranks of one
model index) and returns them with the rank's two indices. A model is
built for a :class:`Axis` (the model group, its size and the rank's
index in it); the trainer (``runtime.driver``) reduces the gradients
once a step over the data group.

The collectives are Megatron's, as ``torch.autograd.Function``\\ s:

    copy_to      identity forward, all-reduce backward (enter a TP block)
    reduce_from  all-reduce forward, identity backward (leave one)
    gather_seq   all-gather over the sequence (dim 1) forward,
                 reduce-scatter backward (enter a block under SP)
    scatter_seq  reduce-scatter over the sequence forward, all-gather
                 backward (leave one under SP)
    gather_cols  all-gather over the last dim forward, reduce-scatter
                 backward (a flat column split's products to whole heads)

Each goes through a seam of ``core.linalg`` (``preduce``, ``pall_gather``,
``preduce_scatter``; ``all_reduce``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``), uncounted there: ``count_reductions`` counts
the step's one gradient reduction over the data group;
``analysis.record.Recorder`` counts every collective by group.

The layout. The modules decide, when built for a model axis of size m,
what they split (``models.layers``, ``models.recurrent``, ``models.lm``),
and they split every leaf as ``repro``'s sanitized ``param_partition_specs``
does on 'model': a projection's flat output columns (``wq``/``wk``/``wv``,
the ``w_*`` of the MLP and the recurrent mixers) and an out-projection's
rows (``wo``, ``w_down``) wherever m divides that dim, the QKV biases with
their columns, the MoE's experts where m divides their count (EP) and
else each expert's hidden width (expert-TP), the vocabulary (``embed`` by
rows, ``unembed`` by columns); ``repro``'s replicated leaves (the norms'
scales, the router, ``w_decay``/``b_decay``, ``b_f``, the sLSTM's
``r_*``, ``meta``, ``pos_embed``) and every dim that m does not divide
(granite's vocabulary of 49,155) stay whole. :func:`layout` reads the
split dim of each leaf off the shapes; it equals ``repro``'s rules for
every leaf of every arch. A mixer (attention or a recurrent one) runs in
one of two forms, each exact:

  * by heads, where every split falls on whole heads (m divides the
    heads: llama's attention, xlstm's mixers at m = 2 and 4): the rank
    runs its heads alone, with its heads' slice of the replicated leaves;
  * by flat columns, where a split cuts a head (hymba's 25 query and 5 kv
    heads, its SSM's keys of 16 at m = 2, xlstm at m = 8): the rank's
    column-parallel products are gathered to whole heads
    (:func:`gather_cols`: an all-gather forward, a reduce-scatter
    backward), the mixer runs whole on every rank (K5 at the whole
    heads), and the rank keeps its columns of the output
    (:func:`local_chunk` on the last dim) for its rows of ``wo``.

Either way the output is the rank's partial sum. A leaf that is whole in
a split mixer (a replicated leaf, or one m does not divide) then gets on
each rank only the part of its gradient from the rank's heads or
columns: :func:`tp_partial` names them, and the trainer sums their
gradients over the model group once a step, with or without SP. Over the
data axis each leaf is then cut on ``repro``'s ``fsdp`` dim
(``parallel.fsdp``: FSDP); :func:`partition_specs` gives both cuts.

Under SP (``train_loss(..., shard_acts=True)``) the residual stream
between blocks is (B, L / m, D) per rank, ``activation_spec``'s layout.
A leaf that is whole on the model axis and used on the decoder's stream
(the norms' scales, the router, a whole mixer, a whole vocabulary,
``meta``, the whole leaves of a split mixer) then gets on each rank the
gradient of its rank's positions or heads only: :func:`sp_partial` names
them, and the trainer sums their gradients over the model group once a
step. The encoder runs without SP.

Decode (``LM.decode_step`` on a split model) keeps ``repro``'s decode
layout, ``batch_partition_specs`` sanitized on the rank's (data, model)
grid (``models.lm.shard_cache``): a KV or cross-attention cache holds the
rank's contiguous block of S / m sequence slots where m divides S
(:func:`cache_slots`; else the whole sequence), its batch rows split over
the data axis where D divides the batch, and the recurrent states whole
on every rank of the model group. Each attention layer gathers the new
token's q, k and v to every head (:func:`gather_last`, one all-gather),
attends over the rank's slots, and merges the ranks' partial softmaxes
(:func:`merge_softmax`: the max over the group, then one all-reduce of
the rescaled sums); a recurrent mixer split by heads updates its heads'
slice of the whole state and gathers the slices (:func:`gather_heads`,
one all-gather for all its state tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.core import linalg

__all__ = ["Axis", "Grid", "build_grid", "copy_to", "reduce_from",
           "gather_seq", "scatter_seq", "gather_cols", "local_chunk",
           "gather_rows", "max_over", "scale_grad", "seq_split", "layout",
           "partition_specs", "sp_partial", "tp_partial", "full_shape",
           "cut", "shard_model", "gather_last", "gather_heads",
           "cache_slots", "merge_softmax"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the grid: its process ``group`` (None for a
    description with no group, as on the meta device, or for one
    process), its ``size`` and this rank's ``index`` along it. A model is
    built for its model axis."""
    group: Optional[object] = None
    size: int = 1
    index: int = 0


def _split(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


@dataclasses.dataclass
class Grid:
    """A rank's place in a (data, model) grid: its ``data`` axis (group
    None: one process, nothing reduced) and its ``model`` axis.
    ``made``: the groups :func:`build_grid` made (the caller destroys
    them)."""
    data: Axis
    model: Axis
    made: List = dataclasses.field(default_factory=list)


def build_grid(group, model_axis: int, ranks: Optional[List[int]] = None
               ) -> Grid:
    """The grid of ``ranks`` (ranks of ``group``, in rank order; default
    all of them) with ``model_axis`` ranks a model group, ``repro``'s
    ``build_mesh`` order. Only those ranks call it (the groups are made
    with ``core.distributed.survivor_group``). With ``group=None`` it is
    one process: ``model_axis`` must be 1 and nothing is reduced."""
    from repro_torch.core.distributed import survivor_group
    if group is None:
        if model_axis != 1:
            raise ValueError(f"one process cannot hold a model axis of "
                             f"{model_axis}")
        return Grid(Axis(), Axis())
    world = dist.get_world_size(group)
    ranks = list(range(world)) if ranks is None else list(ranks)
    n, m = len(ranks), model_axis
    if n % m:
        raise ValueError(f"{n} devices do not divide into "
                         f"model_axis={m}")
    pos = ranks.index(dist.get_rank(group))
    d, i = divmod(pos, m)
    if m == 1:
        data = group if n == world else survivor_group(ranks, group)
        return Grid(Axis(data, n, d), Axis(),
                    [] if data is group else [data])
    model = survivor_group(ranks[d * m:(d + 1) * m], group)
    data = survivor_group(ranks[i::m], group)
    return Grid(Axis(data, n // m, d), Axis(model, m, i), [model, data])


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def _gather1(x, group):
    """x (B, s, ...) gathered over the group along dim 1."""
    return linalg.pall_gather(x.transpose(0, 1), group).transpose(0, 1)


def _scatter1(x, group):
    """x (B, S, ...) summed over the group, this rank's block of dim 1."""
    return linalg.preduce_scatter(x.transpose(0, 1), group,
                                  counted=False).transpose(0, 1)


def _gather_last(x, group):
    """x (..., n) gathered over the group along its last dim."""
    return linalg.pall_gather(x.movedim(-1, 0), group).movedim(0, -1)


def _scatter_last(x, group):
    """x (..., N) summed over the group, this rank's block of the last
    dim."""
    return linalg.preduce_scatter(x.movedim(-1, 0), group,
                                  counted=False).movedim(0, -1)


def _fresh(x):
    """A contiguous copy of x, which ``preduce`` may reduce in place."""
    return x.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return linalg.preduce(_fresh(g), ctx.group, counted=False), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return linalg.preduce(_fresh(x), group, counted=False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather1(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter1(g, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter1(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather1(g, ctx.group), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_last(g, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to(x, axis: Optional[Axis]):
    """Enter a tensor-parallel block: x itself; its gradient summed over
    the model group."""
    return _CopyTo.apply(x, axis.group) if _split(axis) else x


def reduce_from(x, axis: Optional[Axis]):
    """Leave one: the sum of the ranks' partial x; the gradient passes."""
    return _ReduceFrom.apply(x, axis.group) if _split(axis) else x


def gather_seq(x, axis: Optional[Axis]):
    """x (B, L / m, ...) gathered to (B, L, ...) in rank order; its
    gradient reduce-scattered."""
    return _GatherSeq.apply(x, axis.group) if _split(axis) else x


def scatter_seq(x, axis: Optional[Axis]):
    """The ranks' partial x (B, L, ...) summed, this rank's (B, L / m,
    ...); the gradient all-gathered."""
    return _ScatterSeq.apply(x, axis.group) if _split(axis) else x


def gather_cols(x, axis: Optional[Axis]):
    """x (..., n), the rank's block of a flat column split, gathered to
    (..., m n) in rank order; the ranks' partial gradients of the whole
    summed and scattered back to the rank's block."""
    return _GatherCols.apply(x, axis.group) if _split(axis) else x


def gather_rows(x, axis: Optional[Axis]):
    """The ranks' x (the same shape on each) concatenated along dim 0 in
    rank order (no gradient)."""
    if not _split(axis):
        return x
    return linalg.pall_gather(x.detach(), axis.group)


def max_over(x, axis: Optional[Axis]):
    """The elementwise max of x over the model group (no gradient)."""
    if not _split(axis):
        return x
    return linalg.pmax(_fresh(x), axis.group, counted=False)


def local_chunk(x, axis: Optional[Axis], dim: int = 1):
    """This rank's block of x along ``dim``: by default its positions of
    x (B, L, ...) under SP, (B, L / m, ...); on the last dim its columns
    of a whole product, or of a replicated leaf its heads (a view; its
    gradient is zero elsewhere)."""
    if not _split(axis):
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


def scale_grad(x, scale: float):
    """x, whose gradient is multiplied by ``scale``: the share of a
    replicated term that one rank back-propagates when the ranks' partial
    gradients are summed (the MoE's aux loss under SP)."""
    return _ScaleGrad.apply(x, scale) if scale != 1 else x


def seq_split(length: int, axis: Optional[Axis]) -> None:
    """Raise unless a sequence of ``length`` positions splits evenly over
    the model axis (SP)."""
    if _split(axis) and length % axis.size:
        raise ValueError(
            f"shard_acts splits the sequence over the model axis: its "
            f"{length} positions (prefix rows included) do not divide by "
            f"{axis.size}")


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

def _shapes(model) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def layout(arch, model_size: int) -> Dict[str, Optional[int]]:
    """{parameter name: the dim the model axis splits, or None} of
    ``arch``'s LM built for a model axis of ``model_size`` (read off the
    shapes of the two builds on the meta device)."""
    from repro_torch.models import lm
    full = _shapes(lm.param_specs(arch))
    if model_size == 1:
        return dict.fromkeys(full)
    local = _shapes(lm.param_specs(arch, Axis(None, model_size, 0)))
    out = {}
    for name, shape in full.items():
        dims = [d for d, (a, b) in enumerate(zip(shape, local[name]))
                if a != b]
        out[name] = dims[0] if dims else None
    return out


def partition_specs(arch, mesh, tp: str = "model"):
    """{parameter name: ``PartitionSpec``} of the port's own layout on
    ``mesh``, what a rank of the trainer holds: ``tp`` on the dim the
    model axis splits (:func:`layout`), 'data' on the dim the data axis
    splits (``parallel.fsdp.data_layout``), every other dim replicated."""
    from repro_torch.models import lm
    from repro_torch.parallel.fsdp import data_layout
    from repro_torch.parallel.sharding import P
    shapes = _shapes(lm.param_specs(arch))
    data = data_layout(arch, mesh)
    out = {}
    for name, dim in layout(arch, mesh.shape.get(tp, 1)).items():
        if dim is not None and dim == data[name]:
            raise ValueError(f"{name}: the model and the data axis split "
                             f"the same dim {dim}")
        out[name] = P(*(tp if d == dim else "data" if d == data[name]
                        else None for d in range(len(shapes[name]))))
    return out


def sp_partial(lay: Mapping[str, Optional[int]]) -> List[str]:
    """The leaves whose gradient, under SP, holds only this rank's
    positions (or heads or columns): those whole on the model axis, but
    the encoder's (among them :func:`tp_partial`'s outside the encoder)."""
    return [n for n, d in lay.items()
            if d is None and not n.startswith("encoder.")]


def tp_partial(arch, model_size: int) -> List[str]:
    """The leaves whole on the model axis whose gradient holds, on each
    rank, only the part from its heads or columns: the whole leaves of a
    split mixer (each module's ``partial``), read off ``arch``'s LM built
    for a model axis of ``model_size`` on the meta device."""
    if model_size == 1:
        return []
    from repro_torch.models import lm
    model = lm.param_specs(arch, Axis(None, model_size, 0))
    return [f"{path}.{leaf}" for path, mod in model.named_modules()
            if getattr(mod, "tp", None) is not None
            for leaf in getattr(mod, "partial", ())]


def full_shape(shape, dim: Optional[int], size: int) -> tuple:
    """The full leaf's shape of a shard of ``shape`` split on ``dim``."""
    shape = tuple(shape)
    if dim is None:
        return shape
    return shape[:dim] + (shape[dim] * size,) + shape[dim + 1:]


def cut(full, dim: Optional[int], axis: Optional[Axis]):
    """Rank ``axis.index``'s block of ``full`` (a tensor or a numpy array)
    along ``dim`` (None: ``full`` itself)."""
    if dim is None or not _split(axis):
        return full
    n = full.shape[dim] // axis.size
    index = [slice(None)] * full.ndim
    index[dim] = slice(axis.index * n, (axis.index + 1) * n)
    return full[tuple(index)]


def shard_model(model, axis: Axis):
    """A new LM of ``model``'s arch on its device, built for ``axis``,
    holding the rank's shards of the one-rank ``model``'s weights."""
    from repro_torch.models import lm
    out = lm.LM(model.arch, model.embed.device, axis)
    lay = layout(model.arch, axis.size)
    whole = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(cut(whole[name], lay[name], axis))
    return out


# ---------------------------------------------------------------------------
# Decode over the model axis
# ---------------------------------------------------------------------------

def gather_last(xs, axis: Optional[Axis]) -> list:
    """The ranks' blocks of the last dim of each tensor of ``xs`` (the
    same leading dims and dtype), gathered to the whole (..., m n_i) in
    rank order in ONE all-gather of their concatenation (no gradient)."""
    xs = list(xs)
    if not _split(axis) or not xs:
        return xs
    widths = [x.shape[-1] for x in xs]
    lead = xs[0].shape[:-1]
    got = linalg.pall_gather(torch.cat(xs, -1).movedim(-1, 0), axis.group)
    got = got.reshape((axis.size, sum(widths)) + tuple(lead))
    return [g.reshape((-1,) + tuple(lead)).movedim(0, -1)
            for g in got.split(widths, dim=1)]


def gather_heads(xs, axis: Optional[Axis]) -> list:
    """The ranks' slices of dim 1 (heads) of each tensor of ``xs`` (B, h,
    ...) (one dtype; the same h on each), gathered to (B, m h, ...) in
    rank order in ONE all-gather (no gradient): the slices of a recurrent
    state that the ranks' heads updated."""
    xs = list(xs)
    if not _split(axis) or not xs:
        return xs
    h = xs[0].shape[1]
    flat = [x.transpose(0, 1).reshape(h, -1) for x in xs]
    widths = [f.shape[1] for f in flat]
    got = linalg.pall_gather(torch.cat(flat, 1), axis.group)
    got = got.reshape(axis.size * h, sum(widths))
    return [g.reshape((axis.size * h, x.shape[0]) + tuple(x.shape[2:]))
            .transpose(0, 1) for g, x in zip(got.split(widths, dim=1), xs)]


def cache_slots(length: int, axis: Optional[Axis]) -> tuple:
    """(first, count): the slots of a decode cache's sequence of
    ``length`` that this rank holds under ``repro``'s split-KV rule,
    sanitized: its contiguous block [i length / m, (i + 1) length / m)
    where m divides ``length``, else all of them."""
    if not _split(axis) or length % axis.size:
        return 0, length
    n = length // axis.size
    return axis.index * n, n


def merge_softmax(mx, total, o, axis: Optional[Axis]):
    """The softmax-weighted output of attention split over the model
    axis's sequence slots, from each rank's partial over its slots, in
    f32: ``mx`` (...) the row max of its scores, ``total`` (...) the sum
    of exp(s - mx), ``o`` (..., Dh) the sum of exp(s - mx) v.
    The group's max M (:func:`max_over`), then one all-reduce of total
    exp(mx - M) and o exp(mx - M) packed, then O / L. A rank whose slots
    are all masked (scores -1e30) adds exp(-1e30 - M) = 0 of its sums."""
    if not _split(axis):
        return o / total[..., None]
    scale = torch.exp(mx - max_over(mx, axis))[..., None]
    sums = linalg.preduce(torch.cat([total[..., None] * scale, o * scale],
                                    -1), axis.group, counted=False)
    return sums[..., 1:] / sums[..., :1]
