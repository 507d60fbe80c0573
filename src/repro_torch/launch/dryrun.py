"""Dry run of the port (the port of ``repro/launch/dryrun.py``): every
(architecture x input shape x mesh) cell's step, run on the meta device at
full width and depth (nothing is allocated), with the roofline inputs
counted as it runs. On one card the step is the whole step. On a mesh of
n > 1 cards it is rank 0's own step (data 0, model 0; ``rank=`` another
rank's), as ``repro``'s SPMD compile gives one device's program
(``flops_split: "rank"``). The ranks of a model group run the same
shapes but in one case: under ``shard_acts`` with a prefix (hymba's meta
rows, a vision stub's patches) and a vocabulary the model axis does not
split, only the ranks past the prefix compute logits on all their
positions, so rank 0 computes fewer. The
step runs inside a process group of torch's ``fake`` backend of world
size n (:func:`rank_grid`), whose model group and data group are made
with ``dist.new_group`` in ``repro``'s ``build_mesh`` order, as
``parallel.tensor.build_grid`` makes them on a real job. The fake
backend's collectives move nothing, which on meta tensors is all a count
needs. The rank holds what a rank of the port's trainer or server holds:

  * train: the model built for the model axis (``lm.param_specs(arch,
    axis)``), cut over the data axis (``fsdp.shard_params`` on
    ``fsdp.grid_data_layout``), AdamW's state on those shards, the rank's
    rows of the batch; the step ``driver.make_train_step(..., grid=)``,
    with ``shard_acts`` (``DryrunOptions.shard_acts``) where the model
    axis divides the sequence (its prefix rows included);
  * prefill: ``LM.prefill`` of the split model on the rank's rows;
  * decode: ``LM.decode_step(..., data=)`` on ``lm.init_cache(...,
    axis=, data=)``, the rank's shares of the cache.

The multi-pod mesh's data axis is pod x data (32 ranks), as ``repro``'s
``dp_axes`` join them for the batch: the port's trainer has one data
group, so a rank holds 1/32 of each leaf that ``repro``'s ``fsdp`` rule
splits (``repro`` splits it over 'data' alone, 1/16, replicated over the
pods). Before it counts, the cell checks that the leaves the rank holds
on meta sum to the argument bytes of the specs (:func:`argument_bytes`),
and raises if they do not.

What a cell counts, for the device it describes:

  * FLOPs: ``analysis.record.Recorder``'s count, ``repro.analysis``'s
    convention: 2 x output x contraction of each matrix product, plus each
    kernel seam's event (K5: 4 B Hq D Sq Sk, ``repro``'s cost-exact
    count), the same count a ``Recorder`` makes of the step on a real
    rank, on the CPU or the card;
  * argument bytes, exact: what each leaf's sanitized partition spec
    (``repro_torch.parallel``) leaves on a device, over the parameters,
    the AdamW state (train) and the batch or decode cache. The
    parameters' specs are the port's own layout
    (``parallel.tensor.partition_specs``: ``repro``'s sanitized rules on
    the 'model' axis, its ``fsdp`` rule on 'data'); a prefill or decode
    cell's are the 'model' axis's alone: the port's server holds the
    model rank's leaves whole over the data axis, where ``repro``'s
    program holds them split by its ``fsdp`` rule;
  * temp bytes: the peak of the meta storage that the step made and that
    was alive at once, tracked by storage identity with weak references,
    so the step's own frees (autograd's saved tensors included) count as
    they do on the card. ``fits_hbm``: argument + temp below
    ``HW_H100.hbm_bytes``;
  * HBM bytes: each operation's tensor inputs and outputs summed, views
    excluded (a kernel seam: its operands and output). This is eager's
    unfused traffic, what the card runs, not XLA's fused "bytes
    accessed". A collective counts its operand read and its result
    written once each, as the collective library's kernels read and write
    the card's memory;
  * collectives (n > 1): each ``c10d`` operation of the rank's step by
    axis ('model', 'data') and kind, its count and its result bytes
    (``Recorder.collective_traffic``: ``repro``'s convention),
    as ``collectives_by_axis``. ``collectives_static`` (bytes by kind and
    ``total``), ``collective_counts`` and ``per_device.collective_bytes``
    sum the axes of more than one rank: a one-rank group's collective
    (the gradient all-reduce of a data axis of 1) moves nothing between
    cards. ``roofline.collective_s`` is that total over one card's
    NVLink rate, and may be the ``dominant`` term.

With ``cost_fit`` the cell is also counted at 1 and 2 layer groups
(``_reduced``) and the FLOPs, HBM bytes and collective bytes fit to full
depth (``two_point_fit``), as ``repro`` does; for an arch without
attention (xlstm), whose sLSTM scan is S host-launched steps, a train or
prefill cell is counted at three short lengths and fit over S instead
(``fit_over_seq``). ``unroll_layers`` is not ported (a layer is a
module, counted as it runs). Results cache as JSON under
``results/dryrun_torch/``. The numbers are predictions on ``HW_H100``'s
data-sheet peaks.

The steps are the port's own: train is ``runtime.driver.make_train_step``
(microbatches into one f32 buffer, AdamW), prefill is ``LM.prefill``
(only the last position is unembedded, where ``repro``'s prefill step
makes every position's logits), decode is ``LM.decode_step`` at the last
position of a full cache, its arguments the tokens, the cache and ``pos``
(not the frames, which ``repro``'s decode batch carries and does not
read: their cross k and v are in the cache).

The count makes a process group of its own and destroys it after: a
process that already runs one (a rank of a job) cannot count a mesh cell
and is told so; count it in a subprocess.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 1x1  # all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from fractions import Fraction
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.record import (COLLECTIVE_PRIMS, Recorder,
                                         result_bytes)
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, \
    input_specs
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh, \
    set_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor as par
from repro_torch.parallel.sharding import (batch_partition_specs,
                                           shard_shape)
from repro_torch.parallel.tensor import partition_specs
from repro_torch.roofline.analysis import (HW_H100, collective_stats,
                                           model_flops, roofline_terms,
                                           two_point_fit)
from repro_torch.runtime import driver

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "..", "..", "..", "results", "dryrun_torch")
META = torch.device("meta")


@dataclasses.dataclass
class DryrunOptions:
    remat: str = "full"
    shard_acts: bool = True      # SP in a mesh cell's train step, where
    #                              the model axis divides the sequence
    include_optimizer: bool = True
    microbatches: int = 1        # grad-accumulation splits (memory knob;
    #                              ONE gradient reduction per step)
    cost_fit: bool = True        # also count at 1 and 2 layer groups


# per-(arch, shape) microbatch defaults (``repro``'s; a run of 1 takes
# them, the FLOPs are invariant to the split).
MICROBATCH_DEFAULTS = {
    ("mixtral-8x7b", "train_4k"): 8,
    ("llama3-8b", "train_4k"): 4,
    ("stablelm-12b", "train_4k"): 4,
    ("pixtral-12b", "train_4k"): 4,
    ("qwen1.5-4b", "train_4k"): 4,
    ("whisper-large-v3", "train_4k"): 8,
    ("granite-moe-1b-a400m", "train_4k"): 4,
    ("hymba-1.5b", "train_4k"): 8,
    ("tinyllama-1.1b", "train_4k"): 2,
    ("xlstm-350m", "train_4k"): 2,
}
# The lengths of the fit over S: multiples of ``chunked_gla``'s chunk of 128
# from two chunks on, where a count is linear in S (FLOPs, temp bytes,
# collectives) or, the HBM bytes of a training step, quadratic (each of
# the sLSTM's S steps reads a (B, S, D) slice, whose backward writes a
# full-length gradient), so a quadratic through three lengths is exact.
SEQ_FIT = (256, 512, 768)
# the collective kinds with an operand apart from their output (its
# second argument); the others reduce or move their first in place
_SEPARATE_INPUT = ("all-gather", "reduce-scatter", "all-to-all")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class Meter(Recorder):
    """A :class:`Recorder` (FLOPs, collectives) that also keeps the HBM
    bytes of each operation and the peak of the live storage the step
    made. ``hold(tensors)`` marks the arguments' storage, which is not the
    step's own."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._known = WeakIdKeyDictionary()

    def hold(self, tensors) -> None:
        for t in _tensors(tensors):
            self._known[t.untyped_storage()] = True

    def _free(self, n: int) -> None:
        self.live -= n

    def _made(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._known:
                continue
            self._known[st] = True
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def enter_seam(self, event) -> None:
        if self._seam == 0:
            # the operands read and an output of the first operand's shape
            # written: K5's, the one seam an LM step reaches.
            self.hbm_bytes += sum(math.prod(s) for s in event.shapes) \
                * event.dtype_in.itemsize \
                + math.prod(event.shapes[0]) * event.dtype_out.itemsize
        super().enter_seam(event)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self.decomposed(func, args, kwargs)
        if out is not NotImplemented:
            return out                  # its operations counted each
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self._made(out)
        if self._seam:
            return out
        ns, _, name = func._schema.name.partition("::")
        if ns == "c10d" and name in COLLECTIVE_PRIMS:
            # its operand read, its result written
            kind = COLLECTIVE_PRIMS[name]
            operand = args[1] if kind in _SEPARATE_INPUT else args[0]
            self.hbm_bytes += result_bytes(kind, args) \
                + (0 if kind == "barrier"
                   else sum(_nbytes(t) for t in _tensors(operand)))
        elif not func.is_view \
                and not name.startswith(("empty", "new_empty")):
            for t in list(_tensors(args)) + list(_tensors(kwargs)) \
                    + list(_tensors(out)):
                self.hbm_bytes += min(_nbytes(t), t.untyped_storage().nbytes())
        return out

    def flops(self) -> float:
        return sum(t.flops for t in self.spans())


class _Frozen:
    """An optimizer whose update changes nothing (``include_optimizer``
    off: the state is still an argument, as in ``repro``)."""

    @staticmethod
    def update(grads, state, params, **_):
        return params, state


def rank_mesh(mesh: Mesh) -> Mesh:
    """The (data, model) mesh of the port's grid on ``mesh``: the
    multi-pod mesh's pod and data axes joined into one data axis."""
    if tuple(mesh.axis_names) == ("data", "model"):
        return mesh
    m = mesh.shape.get("model", 1)
    return make_mesh((mesh.size // m, m), ("data", "model"))


@contextlib.contextmanager
def rank_grid(mesh: Mesh, rank: int = 0):
    """Rank ``rank``'s ``parallel.tensor.Grid`` (data rank // m, model
    rank % m) on ``mesh``, inside a process group of torch's ``fake``
    backend of world size ``mesh.size``, destroyed on the way out. Its
    groups are made with ``dist.new_group`` in ``build_grid``'s order:
    the model group is the m ranks of its data index, the data group the
    ranks of its model index, i, i + m, i + 2 m, ... (a one-rank group at
    D = 1; the world at m = 1). ``build_grid`` itself cannot run here:
    its ``survivor_group`` lists the store's keys, which the fake
    backend's store does not hold."""
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run counts a mesh cell's rank inside a process group "
            "of the 'fake' backend of its own, and this process already "
            "runs a process group: call run_cell from a process without "
            "one (a subprocess)")
    # importing it registers the 'fake' backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = mesh.size
    m = mesh.shape.get("model", 1)
    d, i = divmod(rank, m)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        if m == 1:
            yield par.Grid(par.Axis(dist.group.WORLD, n, d), par.Axis())
        else:
            model = dist.new_group(list(range(d * m, (d + 1) * m)))
            data = dist.new_group(list(range(i, n, m)))
            yield par.Grid(par.Axis(data, n // m, d), par.Axis(model, m, i))
    finally:
        dist.destroy_process_group()


def _batch(arch: ArchConfig, shape: ShapeConfig):
    batch = input_specs(arch, shape, META)
    if shape.kind == "decode":
        # decode reads the tokens, the cache and pos: an encoder-decoder
        # arch's frames are in the cache's cross k and v, which a rank
        # holds instead (``repro``'s decode batch carries them unread)
        batch.pop("frames", None)
    return batch


def build_step(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
               opts: DryrunOptions):
    """(fn, args, specs): ``fn(*args)`` runs one whole step eagerly on the
    meta device; ``specs`` are the partition specs of ``args`` on
    ``mesh``, leaf for leaf."""
    batch = _batch(arch, shape)
    model = lm.param_specs(arch)
    # the port's own layout, what a rank of its trainer holds: repro's
    # sanitized rules on the model axis, its fsdp rule on the data axis;
    # its server holds the model rank's leaves whole over the data axis
    ppart = partition_specs(arch, mesh if shape.kind == "train" else
                            make_mesh((1, mesh.shape.get("model", 1)),
                                      ("data", "model")))
    bpart = batch_partition_specs(batch, mesh, kind=shape.kind)

    if shape.kind == "train":
        model.requires_grad_(True)
        opt = AdamW(learning_rate=1e-4)
        ostate = opt.init(dict(model.named_parameters()))
        opart = opt.state_specs(ppart)
        step = driver.make_train_step(
            arch, opt if opts.include_optimizer else _Frozen(),
            driver.TrainerConfig(microbatches=opts.microbatches,
                                 remat=opts.remat))
        return step, (model, ostate, batch), (ppart, opart, bpart)
    return _serve_step(shape), (model, batch), (ppart, bpart)


def _serve_step(shape: ShapeConfig, data=None):
    if shape.kind == "prefill":
        def prefill_step(model, batch):
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            with torch.no_grad():
                return model.prefill(batch["tokens"], extras)
        return prefill_step

    def serve_step(model, batch):
        # ``pos`` stands in for the position, which a meta tensor cannot
        # hold: the last slot of the cache.
        with torch.no_grad():
            return model.decode_step(batch["tokens"], batch["cache"],
                                     shape.seq_len - 1, data=data)[0]
    return serve_step


def _positions(arch: ArchConfig, shape: ShapeConfig) -> int:
    """The positions of a train step's sequence, its prefix rows (hymba's
    meta tokens; a vision stub's patches, which ``input_specs`` takes out
    of S) included."""
    return shape.seq_len + arch.meta_tokens


def build_rank_step(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                    grid: par.Grid, opts: DryrunOptions):
    """(fn, args): ``fn(*args)`` runs rank ``grid``'s own step eagerly on
    the meta device, on what the rank holds (see the module docstring);
    ``grid`` from :func:`rank_grid`."""
    rmesh = rank_mesh(mesh)
    D, m = grid.data.size, grid.model.size
    axis = grid.model if m > 1 else None
    whole = _batch(arch, shape)
    bpart = batch_partition_specs(whole, rmesh, kind=shape.kind)
    batch = {}
    for name, t in whole.items():
        if name == "cache":
            batch[name] = lm.init_cache(arch, shape.global_batch,
                                        shape.seq_len, META, axis, grid.data)
        else:
            batch[name] = torch.zeros(shard_shape(tuple(t.shape),
                                                  bpart[name], rmesh),
                                      dtype=t.dtype, device=META)
    model = lm.param_specs(arch, axis)
    if shape.kind == "train":
        fsdp.shard_params(model, fsdp.grid_data_layout(arch, D, m),
                          grid.data)
        model.requires_grad_(True)
        opt = AdamW(learning_rate=1e-4)
        ostate = opt.init(dict(model.named_parameters()))
        sp = opts.shard_acts and m > 1 \
            and _positions(arch, shape) % m == 0
        step = driver.make_train_step(
            arch, opt if opts.include_optimizer else _Frozen(),
            driver.TrainerConfig(
                microbatches=opts.microbatches, remat=opts.remat,
                shard_acts=sp, model_axis=m), grid=grid)
        return step, (model, ostate, batch)
    # the data axis routes an MoE's tokens as one where it splits the
    # batch (``decode_step``'s ``data``)
    data = grid.data if shape.global_batch % D == 0 else None
    return _serve_step(shape, data), (model, batch)


def _leaves(arg):
    """An argument (or its specs) as nested dicts and lists: an LM as its
    named parameters, an AdamW state as its step, mu and nu, a batch as
    it is."""
    if isinstance(arg, torch.nn.Module):
        return dict(arg.named_parameters())
    if hasattr(arg, "_fields"):                          # AdamWState
        return {"step": arg.step, "mu": arg.mu, "nu": arg.nu}
    return arg


def argument_bytes(args, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``args`` laid out by ``specs``."""
    total = 0

    def walk(x, s):
        nonlocal total
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            total += math.prod(shard_shape(tuple(x.shape), s, mesh)) \
                * x.element_size()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, s[k])
        elif isinstance(x, (list, tuple)):
            for v, sv in zip(x, s):
                walk(v, sv)
    for a, s in zip(args, specs):
        walk(_leaves(a), _leaves(s))
    return total


def held_bytes(args) -> int:
    """Bytes of the tensors of ``args`` (what a rank holds)."""
    return sum(_nbytes(t) for a in args for t in _tensors(_leaves(a)))


def axes_traffic(recorder: Recorder, grid: par.Grid) -> Dict:
    """{axis: {kind: {"count": n, "bytes": result bytes}}} of the
    collectives ``recorder`` saw on ``grid``'s groups ('model', 'data';
    an axis without a group is left out): a cell's
    ``collectives_by_axis``, and what a real rank's ``Recorder`` is held
    to."""
    traffic = recorder.collective_traffic()
    return {name: traffic.get(ax.group.group_name, {})
            for name, ax in (("model", grid.model), ("data", grid.data))
            if ax.group is not None}


def count_step(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
               opts: DryrunOptions, grid: Optional[par.Grid] = None) -> Dict:
    """One step of the cell on the meta device: its FLOPs, HBM bytes,
    argument, temp and output bytes, all for one device: the whole step
    on one card; on a mesh of n > 1, rank ``grid``'s own step (default:
    rank 0's, in a :func:`rank_grid` of its own), with its collectives
    by axis (``"collectives"``)."""
    if mesh.size > 1 and grid is None:
        with rank_grid(mesh) as grid:
            return count_step(arch, shape, mesh, opts, grid)
    if mesh.size == 1:
        fn, args, specs = build_step(arch, shape, mesh, opts)
        arg_bytes = argument_bytes(args, specs, mesh)
    else:
        _, whole, specs = build_step(arch, shape, rank_mesh(mesh), opts)
        arg_bytes = argument_bytes(whole, specs, rank_mesh(mesh))
        fn, args = build_rank_step(arch, shape, mesh, grid, opts)
        held = held_bytes(args)
        if held != arg_bytes:
            raise AssertionError(
                f"{arch.name} {shape.name} on {mesh_label(mesh)}: the rank "
                f"holds {held} B, its specs {arg_bytes} B")
    meter = Meter()
    meter.hold(list(_leaves(a) for a in args))
    with set_mesh(mesh), meter:
        out = fn(*args)
    output = sum(min(_nbytes(t), t.untyped_storage().nbytes())
                 for t in _tensors(out))
    c = {"flops": meter.flops(), "hbm_bytes": meter.hbm_bytes,
         "argument_bytes": arg_bytes, "temp_bytes": meter.peak,
         "output_bytes": output}
    if mesh.size > 1:
        c["collectives"] = axes_traffic(meter, grid)
    return c


def _attention_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic attention FLOPs per step: 4*B*Hq*Dh*sum_attended per layer
    forward (QK^T + PV), x3 for train (bwd). Causal full attention sums
    ~S^2/2 pairs; sliding window ~S*window."""
    B, S = shape.global_batch, shape.seq_len
    Hq, Dh = arch.n_heads, arch.head_dim_
    n_attn_layers = sum(
        1 for i in range(arch.n_layers)
        if arch.block_at(i) in ("attn_mlp", "swa_mlp", "moe", "hybrid"))
    if shape.kind == "decode":
        attended = min(S, arch.window) if arch.window else S
        per_layer = 4.0 * B * Hq * Dh * attended
        return per_layer * n_attn_layers
    if arch.window:
        pairs = S * min(arch.window, S)
    else:
        pairs = S * S / 2.0
    per_layer = 4.0 * B * Hq * Dh * pairs
    mult = 3.0 if shape.kind == "train" else 1.0
    total = per_layer * n_attn_layers * mult
    if arch.is_encdec:
        enc_pairs = arch.encoder_seq ** 2
        total += 4.0 * B * Hq * Dh * enc_pairs * arch.encoder_layers * mult
        total += 4.0 * B * Hq * Dh * S * arch.encoder_seq \
            * arch.n_layers * mult        # cross-attention
    return total


def _reduced(arch: ArchConfig, groups: int) -> ArchConfig:
    period = len(arch.block_pattern)
    kw = {"n_layers": period * groups}
    if arch.encoder_layers:
        kw["encoder_layers"] = max(1, groups)
    return dataclasses.replace(arch, **kw)


def seq_fitted(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """Whether the cell is counted by the fit over S: a train or prefill
    step of an arch without attention layers, longer than the fit's
    lengths."""
    return shape.kind != "decode" and not lm.has_attention(arch) \
        and shape.seq_len > SEQ_FIT[-1]


def quadratic_fit(xs, ys, x: float) -> float:
    """The quadratic through the three points (xs[i], ys[i]) at x
    (Lagrange's form in exact rational arithmetic, so integer counts on a
    line or a parabola come back exactly)."""
    out = Fraction(0)
    for i in range(3):
        term = Fraction(ys[i])
        for j in range(3):
            if j != i:
                term *= Fraction(x - xs[j], xs[i] - xs[j])
        out += term
    return float(out)


def _fit_leaves(pts, fit):
    """``pts`` (counts of the same nested structure) folded leaf by leaf
    with ``fit`` (a list of the points' numbers -> one)."""
    if isinstance(pts[0], dict):
        return {k: _fit_leaves([p[k] for p in pts], fit) for k in pts[0]}
    return fit(pts)


def fit_over_seq(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                 opts: DryrunOptions, lengths=None,
                 grid: Optional[par.Grid] = None) -> Dict:
    """``count_step`` at the three ``lengths`` and each count but the
    argument bytes (the collectives' counts and bytes too) fit to
    ``shape.seq_len`` by ``quadratic_fit`` (exact for an arch without
    attention, at multiples of its chunk from two chunks on); the
    argument bytes are counted at the full length."""
    lengths = lengths or SEQ_FIT
    pts = [count_step(arch, dataclasses.replace(shape, seq_len=s), mesh,
                      opts, grid) for s in lengths]
    out = _fit_leaves(pts, lambda ys: quadratic_fit(lengths, ys,
                                                    shape.seq_len))
    at = rank_mesh(mesh)
    _, args, specs = build_step(arch, shape, at, opts)
    out["argument_bytes"] = argument_bytes(args, specs, at)
    for k in ("temp_bytes", "output_bytes"):
        out[k] = int(round(out[k]))
    for kinds in out.get("collectives", {}).values():
        for v in kinds.values():
            v["count"] = int(round(v["count"]))
    return out


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def mesh_label(mesh: Mesh) -> str:
    return "pod" + "x".join(str(d) for d in mesh.dims)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
             opts: Optional[DryrunOptions] = None, mesh: Optional[Mesh] = None,
             verbose: bool = True, *, arch: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None, rank: int = 0) -> Dict:
    """One cell's result (``repro``'s keys). ``arch`` / ``shape`` replace
    the named configs (a cut depth, a path's own batch and length). On a
    mesh of n > 1 it is rank ``rank``'s own step (see the module
    docstring)."""
    opts = opts or DryrunOptions()
    if opts.microbatches == 1:
        mb = MICROBATCH_DEFAULTS.get((arch_name, shape_name), 1)
        if mb != 1:
            opts = dataclasses.replace(opts, microbatches=mb)
    arch = arch or get_config(arch_name)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    result: Dict = {"arch": arch_name, "shape": shape_name,
                    "mesh": mesh_label(mesh), "status": "ok",
                    "opts": dataclasses.asdict(opts)}
    if shape_name in arch.skip_shapes:
        result["status"] = "skip"
        result["reason"] = ("pure full-attention arch: long_500k needs "
                            "sub-quadratic attention (DESIGN.md)")
        return result
    n_chips = mesh.size
    m = mesh.shape.get("model", 1)
    # the axes whose collectives move bytes between cards
    moved = [a for a, size in (("model", m), ("data", n_chips // m))
             if size > 1]
    t0 = time.time()
    try:
        with rank_grid(mesh, rank) if n_chips > 1 \
                else contextlib.nullcontext() as grid:
            fitted = seq_fitted(arch, shape)

            def count(a):
                return fit_over_seq(a, shape, mesh, opts, grid=grid) \
                    if fitted else count_step(a, shape, mesh, opts, grid)
            c = count(arch)
            pts = {}
            if opts.cost_fit:
                for g in (1, 2):
                    cg = count(_reduced(arch, g))
                    pts[g] = {"flops": cg["flops"],
                              "bytes": cg["hbm_bytes"],
                              "coll": collective_stats(cg.get(
                                  "collectives", {}), moved).total_bytes}
        result["count"] = "fit over S at %d, %d, %d" % SEQ_FIT if fitted \
            else "direct"
        temp = c["temp_bytes"]
        result["memory"] = {
            "argument_bytes": int(c["argument_bytes"]),
            "output_bytes": int(c["output_bytes"]),
            "temp_bytes": int(temp),
            "total_bytes": int(c["argument_bytes"] + temp),
            "fits_hbm": bool(c["argument_bytes"] + temp
                             < HW_H100.hbm_bytes),
        }
        stats = collective_stats(c.get("collectives", {}), moved)
        result["collectives_static"] = dict(stats.bytes,
                                            total=stats.total_bytes)
        result["collective_counts"] = dict(stats.counts)
        if n_chips > 1:
            result["rank"] = rank
            result["collectives_by_axis"] = c["collectives"]
        flops_dev = c["flops"]
        bytes_dev = c["hbm_bytes"]
        coll_dev = stats.total_bytes
        result["flops_split"] = "exact" if n_chips == 1 else "rank"
        if opts.cost_fit:
            n_groups = arch.n_layers // len(arch.block_pattern)
            result["cost_fit_points"] = pts
            result["cost_fit"] = {
                key: two_point_fit(pts[1][key], pts[2][key], 1, 2, n_groups)
                for key in ("flops", "bytes", "coll")}
        result["per_device"] = {"flops_macs": flops_dev,
                                "hbm_bytes": bytes_dev,
                                "collective_bytes": coll_dev}

        # ---- roofline terms on the H100 --------------------------------
        result["roofline"] = roofline_terms(flops_dev, bytes_dev, coll_dev)
        n_active = lm.param_count(arch)
        if arch.n_experts:
            # the analytic active count rescaled by the leaves / analytic
            # ratio (repro's).
            n_active = int(arch.active_param_count() * n_active
                           / max(arch.param_count(), 1))
        tokens = shape.global_batch * shape.seq_len
        mf = model_flops(n_active, shape.kind, tokens, shape.global_batch)
        flops_global = flops_dev * n_chips
        result["model_flops"] = mf
        result["useful_ratio"] = mf / flops_global if flops_global else 0.0
        af = _attention_flops(arch, shape)
        result["attention_flops"] = af
        result["useful_ratio_attn"] = (mf + af) / flops_global \
            if flops_global else 0.0
        result["n_chips"] = n_chips
        result["wall_s"] = round(time.time() - t0, 1)
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-3000:]
    if verbose:
        _print_cell(result)
    return result


def _print_cell(r: Dict):
    if r["status"] == "skip":
        print(f"[SKIP] {r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
              f"({r['reason'][:60]})")
        return
    if r["status"] == "error":
        print(f"[FAIL] {r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
              f"{r['error'][:120]}")
        return
    m, t = r["memory"], r["roofline"]
    coll = "   n/c  " if t["collective_s"] is None \
        else f"{t['collective_s'] * 1e3:8.2f}"          # an older cache
    print(f"[ OK ] {r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
          f"mem/dev={m['total_bytes'] / 1e9:7.2f}GB "
          f"fits={m['fits_hbm']} "
          f"C={t['compute_s'] * 1e3:9.2f}ms M={t['memory_s'] * 1e3:9.2f}ms "
          f"N={coll}ms -> {t['dominant']:8s} bound "
          f"{t['bound_s'] * 1e3:.2f}ms on {HW_H100.name} "
          f"useful={r['useful_ratio']:.2f}/{r['useful_ratio_attn']:.2f} "
          f"({r['wall_s']}s)")


def cell_path(arch: str, shape: str, mesh: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="data x model, e.g. 1x1 (one card) or 4x1; "
                         "default: the production mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-optimizer", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.mesh:
        meshes = [make_mesh([int(d) for d in args.mesh.split("x")],
                            ("data", "model"))]
    else:
        meshes = [make_production_mesh(multi_pod=mp) for mp in
                  ([False, True] if args.both_meshes else [args.multi_pod])]
    base_opts = DryrunOptions(remat=args.remat,
                              include_optimizer=not args.no_optimizer)

    n_fail = 0
    for mesh in meshes:
        # the fit points on the production mesh only, as repro's
        # single-pod roofline pass.
        opts = dataclasses.replace(base_opts,
                                   cost_fit="pod" not in mesh.axis_names)
        for a in archs:
            for s in shapes:
                path = cell_path(a, s, mesh_label(mesh))
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        r = json.load(f)
                    _print_cell(r)
                    n_fail += r["status"] == "error"
                    continue
                r = run_cell(a, s, opts=opts, mesh=mesh)
                if r["status"] == "ok":
                    r.pop("traceback", None)
                with open(path, "w") as f:
                    json.dump(r, f, indent=1)
                n_fail += r["status"] == "error"
    print(f"\ndone; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
