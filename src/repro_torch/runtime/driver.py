"""Fault-tolerant LM training driver (the port of
``repro/runtime/driver.py``).

  * the train step: the gradients of every microbatch (``autograd.grad``)
    accumulate in ONE f32 buffer that also holds the rank's loss, and that
    buffer is reduced ONCE per step over the data-parallel group,
    whatever ``cfg.microbatches`` is — the trainer's counterpart of the
    paper's one all-reduce per outer iteration, and what ``repro``'s
    docstring claims for its jitted step. With one data rank that is a
    ``linalg.preduce``; with D > 1 it is FSDP's one reduce-scatter
    (below). That is the step's one gradient reduction, the one
    ``linalg.count_reductions`` counts; an MoE layer's routing adds two
    small collectives over the data group for each MoE layer, microbatch
    and chunk (the mean router probabilities summed and the experts' pick
    counts gathered, ``layers.moe_route``), since ``repro``'s step routes
    its global batch as one. Rank d's microbatch j is its share of
    ``repro``'s microbatch j (:func:`microbatch_rows`), so the experts see
    ``repro``'s groups;
  * fully sharded data parallelism over the data axis
    (``parallel.fsdp``), as ``repro``'s trainer places every weight with
    its ``fsdp`` rule: with D > 1 data ranks each holds its shards of the
    parameters and the AdamW moments, gathers them whole per layer and
    microbatch, and the one reduction is a reduce-scatter of a rank-major
    buffer, which leaves each rank its shards' gradients (and every rank
    the whole leaves' and the loss, gathered after it). The clip's norm
    sums the shards' squares over the data group. A rank's resident state
    is its shards: (2 + 8)(1 - 1/D) bytes a bf16 parameter less than
    replicated; the f32 buffer and one microbatch's gathered weights are
    temporaries;
  * tensor, expert and sequence parallelism over a (data, model) grid
    (``parallel.tensor``): with ``cfg.model_axis`` m > 1 the ranks form
    ``repro``'s ``build_mesh`` grid, each holds its model rank's shards
    (then cut over the data axis), and the buffer holds the shards'
    gradients. The whole leaves of a split mixer, whose gradient holds
    only the rank's heads' or columns' part (``parallel.tensor.
    tp_partial``), and under ``cfg.shard_acts`` every leaf whose gradient
    holds only the rank's positions (``sp_partial``) come first in the
    buffer, and their reduced gradients are summed over the model group
    once a step;
  * periodic async checkpoints (params, optimizer state, the pipeline's
    state) in ``repro``'s tree and on-disk format, so a checkpoint written
    by either package's trainer restores in the other's;
  * failure handling: on an injected host failure the surviving ranks
    form a new group (``core.distributed.survivor_group``), restore the
    latest checkpoint, rewind the data pipeline and go on;
  * straggler policy: eviction goes through the same path.

Hosts are ranks of a ``torch.distributed`` group (rank r is host
``host_of_rank(r)``), and the trainer is SPMD: every rank of the group
runs it with the same arguments. Each trains on its data index's rows of
the step's global batch (``pipeline.batch_at(step)``, the rows of
:func:`microbatch_rows`); the injector's schedule is the same on every
rank, so every rank decides alike without a collective. With
``group=None`` one process trains on the whole batch and nothing is
reduced. Checkpoints gather the shards over the data group, then the
model group, into ``repro``'s full tree; only the lowest rank in use
writes, and every rank reads the one directory (a shared filesystem
across machines) and cuts the tree for the grid it is on, over both axes.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import linalg
from repro_torch.core.types import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor as par
from repro_torch.runtime.elastic import _await_checkpoint
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.stragglers import StragglerMonitor

__all__ = ["TrainerConfig", "Trainer", "make_train_step", "check_config",
           "microbatch_rows"]

def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 20
    ckpt_keep: int = 3
    microbatches: int = 1
    remat: str = "none"
    shard_acts: bool = False
    model_axis: int = 1            # TP degree
    seed: int = 0
    log_every: int = 10


def check_config(cfg: TrainerConfig) -> None:
    """Raise for a configuration the port cannot train."""
    if cfg.remat not in lm.REMAT:
        raise ValueError(f"remat must be one of {lm.REMAT}, not "
                         f"{cfg.remat!r}")
    if min(cfg.model_axis, cfg.microbatches, cfg.ckpt_every) < 1:
        raise ValueError(f"model_axis ({cfg.model_axis}), microbatches "
                         f"({cfg.microbatches}) and ckpt_every "
                         f"({cfg.ckpt_every}) must be >= 1")


def _model_shapes(arch, axis: par.Axis):
    """({name: shape}, {name: dtype}) of the model rank's leaves (before
    any data cut), on the meta device."""
    model = lm.param_specs(arch, axis if axis.size > 1 else None)
    return ({n: tuple(p.shape) for n, p in model.named_parameters()},
            {n: p.dtype for n, p in model.named_parameters()})


def microbatch_rows(global_batch: int, k: int, size: int, index: int):
    """The global batch's rows that data rank ``index`` of ``size`` trains
    on in a step of ``k`` microbatches, in its order: block j of them, the
    rank's microbatch j, is rows j B / k + index B / (k size) + [0, B /
    (k size)), its share of ``repro``'s microbatch j (global rows [j B /
    k, (j + 1) B / k)). With k = 1 or size = 1, ``shard_at``'s rows."""
    per = global_batch // (k * size)
    return np.concatenate([np.arange(per) + j * (global_batch // k)
                           + index * per for j in range(k)])


def make_train_step(arch: ArchConfig, optimizer: AdamW, cfg: TrainerConfig,
                    group=None, grid: Optional[par.Grid] = None):
    """``step(model, opt_state, batch) -> loss``: one optimizer step of
    ``model`` (its parameters must require grad) IN PLACE on this rank's
    ``batch`` ({"tokens", "targets"}: (B, S), and an encoder-decoder or
    vision-stub arch's "frames" or "patches": (B, ., D); every entry split
    into ``cfg.microbatches`` microbatches of B / k consecutive rows, as
    ``repro``'s step splits every leaf), returning the mean loss over the
    group's global batch (an f32 0-dim tensor).

    Each microbatch's gradients (in the parameters' dtype) are added into
    one f32 buffer, as ``repro``'s microbatch scan adds them into f32
    zeros; the buffer also holds the sum of the microbatch losses. One
    reduction sums the buffer over ``group``, then it is divided by k
    times the group's size and AdamW runs on it.

    ``grid`` (``parallel.tensor.build_grid``) replaces ``group``: its data
    group takes the one reduction, and ``model`` must be built for its
    model axis. With a data axis of D > 1 the step is FSDP's
    (``parallel.fsdp``): ``model``'s parameters are the rank's shards
    (``fsdp.shard_params`` on ``fsdp.grid_data_layout``), each
    microbatch gathers them whole, and the reduction is one counted
    reduce-scatter of the rank-major buffer; with D = 1 it is one
    ``linalg.preduce``. On a model axis the buffer holds the model rank's
    shards; the reduced gradients of the leaves of ``tp_partial`` and,
    under ``cfg.shard_acts``, of ``sp_partial`` (first in the buffer) are
    then summed over the model group (an uncounted reduction:
    ``linalg.count_reductions`` counts the data group's). The clip's norm
    is the whole model's."""
    check_config(cfg)
    if grid is None:
        grid = par.Grid(par.Axis(group, 1 if group is None
                                 else dist.get_world_size(group)),
                        par.Axis())
    k, ax, data = cfg.microbatches, grid.model, grid.data
    lay = par.layout(arch, ax.size) if ax.size > 1 else {}
    split = frozenset(n for n, d in lay.items() if d is not None)
    first = par.sp_partial(lay) if cfg.shard_acts else []
    first += [n for n in par.tp_partial(arch, ax.size) if n not in first]
    shapes, dtypes = _model_shapes(arch, ax)
    order = first + [n for n in shapes if n not in frozenset(first)]
    plan = fsdp.Plan({n: shapes[n] for n in order}, dtypes,
                     fsdp.grid_data_layout(arch, data.size, ax.size), data)
    kw = dict(axis=ax, split=split) if ax.size > 1 else {}
    if plan.D > 1:
        kw.update(data=data, data_split=frozenset(plan.split))

    def step(model, opt_state, batch):
        named = dict(model.named_parameters())
        for n in plan.split:
            if tuple(named[n].shape) != plan.shard[n]:
                raise ValueError(
                    f"{n}: a data axis of {data.size} trains the rank's "
                    f"shards {plan.shard[n]}, not {tuple(named[n].shape)} "
                    f"(fsdp.shard_params cuts them)")
        dev = named[order[0]].device
        batch = {name: torch.as_tensor(v, device=dev)
                 for name, v in batch.items()}
        rows_in = batch["tokens"].shape[0]
        if rows_in % k:
            raise ValueError(f"a batch of {rows_in} rows does not "
                             f"split into {k} microbatches")
        mb = rows_in // k
        buf, tail, acc = plan.buffers(dev)
        for j in range(k):
            rows = slice(j * mb, (j + 1) * mb)
            whole = plan.gather(named)
            inputs = [whole.get(n, named[n]) for n in order]
            with fsdp.bound(model, whole):
                loss = lm.train_loss(model, {name: v[rows]
                                             for name, v in batch.items()},
                                     remat=cfg.remat,
                                     shard_acts=cfg.shard_acts, data=data)
                # a rank of a split model may leave a leaf unused (meta
                # rows that only the model group's first rank adds)
                grads = torch.autograd.grad(loss, inputs,
                                            allow_unused=ax.size > 1)
            del whole, inputs
            for n, g in zip(order, grads):
                if g is not None:
                    plan.add(acc, n, g)
            del grads
            tail[plan.loss_at:plan.loss_at + 1].add_(loss.detach())
        chunk, tail = plan.reduce(buf, tail)
        del buf, acc
        if first:
            plan.model_sum(chunk, tail, first, ax.group)
        if k * data.size > 1:
            plan.scale(chunk, tail, k * data.size)
        optimizer.update(plan.grads(chunk, tail), opt_state, named, **kw)
        return tail[plan.loss_at]

    return step


class Trainer:
    """Trains ``arch`` on ``pipeline`` with ``optimizer`` for
    ``cfg.steps`` steps on every rank of ``group`` (see the module
    docstring).

    model:  the LM to train (its parameters are set to require grad);
            None draws ``lm.init_params(arch, cfg.seed, device, axis)``
            for the rank's model axis. A one-rank model given on a grid
            of ``cfg.model_axis`` > 1 is cut to the rank's shards, and on
            a data axis of D > 1 to its data rank's (FSDP, in place: the
            trainer's ``model`` then holds shards, and runs through its
            step).
    failure_injector: host failures keyed by step; the failed ranks leave
            the run, the survivors re-group and resume from the latest
            checkpoint.
    straggler_monitor: fed every step's time for every live host after
            the step (and its checkpoint, if one is due); an "evict" goes
            through the failure path.
    host_of_rank: rank -> host id (identity by default).
    """

    def __init__(self, arch: ArchConfig, optimizer: AdamW,
                 pipeline: TokenPipeline, cfg: TrainerConfig, *,
                 group=None, device="cuda", model: Optional[lm.LM] = None,
                 failure_injector: Optional[FailureInjector] = None,
                 straggler_monitor: Optional[StragglerMonitor] = None,
                 host_of_rank: Optional[Callable[[int], int]] = None):
        check_config(cfg)
        self.arch = arch
        self.optimizer = optimizer
        self.pipeline = pipeline
        self.cfg = cfg
        self.device = resolve_device(device)
        self.base = group
        self.me = 0 if group is None else dist.get_rank(group)
        self.live = list(range(1 if group is None
                               else dist.get_world_size(group)))
        self.injector = failure_injector
        self.stragglers = straggler_monitor
        self.host_of_rank = host_of_rank or (lambda r: r)
        self.layout = par.layout(arch, cfg.model_axis) \
            if cfg.model_axis > 1 else {}
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.losses: List[float] = []
        self.events: List[str] = []
        self.step = 0
        self.saved: Optional[int] = None       # the last step checkpointed
        self.lost = False                      # this rank left the run
        self._made: List = []                  # the groups this trainer made
        self.grid: Optional[par.Grid] = None
        self._setup()
        axis = self.grid.model if self.grid is not None else None
        if model is None:
            model = lm.init_params(arch, cfg.seed, self.device, axis)
        elif axis is not None and axis.size > 1 and model.axis is None:
            model = par.shard_model(model, axis)
        self._place(model)

    def _place(self, model: lm.LM):
        """Train ``model`` (the model rank's leaves): cut over the data
        axis to the rank's shards (FSDP), with fresh AdamW state."""
        if self.grid is not None:
            fsdp.shard_params(model, self.dlayout, self.grid.data)
        self.model = model
        self.model.requires_grad_(True)
        self.opt_state = self.optimizer.init(
            dict(self.model.named_parameters()))

    # -- topology -------------------------------------------------------

    def _usable(self) -> List[int]:
        """``repro``'s ``_usable_devices``: the largest prefix of the live
        ranks whose count ``cfg.model_axis`` divides, and whose data size
        divides the global batch and its microbatch split."""
        gb, k = self.pipeline.global_batch, self.cfg.microbatches
        m = self.cfg.model_axis
        for n in range(len(self.live), 0, -1):
            if n % m == 0 and gb % (n // m) == 0 \
                    and gb % ((n // m) * k) == 0:
                return self.live[:n]
        raise RuntimeError("no usable device configuration")

    def _setup(self):
        """The grid of the usable ranks (``parallel.tensor.build_grid``)
        and its train step. A survivor beyond the usable prefix leaves the
        run; it takes no part in the groups (``survivor_group``
        synchronises only their members)."""
        used = self._usable()
        self.live = used
        if self.me not in used:
            self.lost = True
            return
        for g in self._made:
            dist.destroy_process_group(g)
        self.grid = par.build_grid(self.base, self.cfg.model_axis, used)
        self._made = self.grid.made
        self.dlayout = fsdp.grid_data_layout(self.arch, self.grid.data.size,
                                             self.grid.model.size)
        self.step_fn = make_train_step(self.arch, self.optimizer, self.cfg,
                                       grid=self.grid)

    # -- checkpoint / restore -------------------------------------------

    def _save(self):
        """Each leaf gathered over the data group (every rank takes part),
        then over the model group of data index 0; the lowest rank writes
        ``repro``'s tree."""
        self.saved = self.step
        writer = self.me == self.live[0]

        def whole(flat):
            flat = {n: t.detach() for n, t in flat.items()}
            flat.update(fsdp.gather_packed(flat, self.dlayout,
                                           self.grid.data))
            if self.grid.data.index != 0:
                return None
            flat.update(fsdp.gather_packed(flat, self.layout,
                                           self.grid.model))
            return {n: t.cpu() if writer else None for n, t in flat.items()}
        st = self.opt_state
        flats = [whole(f) for f in (dict(self.model.named_parameters()),
                                    st.mu, st.nu)]
        if not writer:
            return
        host = lambda ts: torch.stack(list(ts))
        tree = {"params": convert.lm_tree(self.arch, flats[0], host),
                "opt": {"step": st.step,
                        "mu": convert.lm_tree(self.arch, flats[1], host),
                        "nu": convert.lm_tree(self.arch, flats[2], host)}}
        self.ckpt.save(self.step, tree,
                       extra={"pipeline": self.pipeline.checkpoint(),
                              "step": self.step})

    def _restore(self):
        """Overwrite the model and optimizer state from the latest
        checkpoint in ``cfg.ckpt_dir`` (written by either package's
        trainer, on any grid), each leaf cut for this rank's, and rewind
        the pipeline to it."""
        self.ckpt.wait()
        if self.saved is not None:
            _await_checkpoint(self.cfg.ckpt_dir, self.saved)
        flat, extra = self.ckpt.restore_latest(device=self.device)
        tree = convert._nest(flat, "/")
        st = self.opt_state
        with torch.no_grad():
            for dst, src in ((dict(self.model.named_parameters()),
                              tree["params"]), (st.mu, tree["opt"]["mu"]),
                             (st.nu, tree["opt"]["nu"])):
                for name, leaf in convert.lm_flat(self.arch, src).items():
                    leaf = par.cut(leaf, self.layout.get(name),
                                   self.grid.model)
                    dst[name].copy_(par.cut(leaf, self.dlayout.get(name),
                                            self.grid.data))
            st.step.copy_(tree["opt"]["step"])
        self.step = int(extra["step"])
        self.pipeline.state.step = int(extra["pipeline"]["step"])

    # -- failure path ---------------------------------------------------

    def _handle_failure(self, dead_hosts: List[int]):
        self.events.append(f"step {self.step}: hosts {dead_hosts} failed")
        self.ckpt.wait()
        self.live = [r for r in self.live
                     if self.host_of_rank(r) not in dead_hosts]
        if not self.live:
            raise RuntimeError("all devices lost")
        if self.me not in self.live:
            self.lost = True
            return
        survivors = len(self.live)
        self._setup()
        if self.lost:
            return
        # the shards of the new grid's rank, filled by the restore
        self._place(lm.LM(self.arch, self.device, self.grid.model))
        self._restore()
        self.events.append(
            f"re-meshed to {survivors} devices ({{'data': "
            f"{self.grid.data.size}, 'model': {self.grid.model.size}}}), "
            f"resumed at step {self.step}")

    # -- main loop --------------------------------------------------------

    def run(self) -> Dict:
        """Train to ``cfg.steps``. Returns {"losses", "events",
        "final_step"} as ``repro``'s does, and "lost": whether this rank
        left the run (failed, evicted, or beyond the usable ranks)."""
        try:
            while self.step < self.cfg.steps and not self.lost:
                if self.injector:
                    dead = self.injector.check(self.step)
                    if dead:
                        self._handle_failure(dead)
                        continue
                rows = microbatch_rows(
                    self.pipeline.global_batch, self.cfg.microbatches,
                    self.grid.data.size, self.grid.data.index)
                tokens, targets = (t[rows] for t in
                                   self.pipeline.batch_at(self.step))
                t0 = time.perf_counter()
                loss = float(self.step_fn(self.model, self.opt_state,
                                          {"tokens": tokens,
                                           "targets": targets}))
                dt = time.perf_counter() - t0
                self.losses.append(loss)
                self.step += 1
                if self.step % self.cfg.ckpt_every == 0 \
                        or self.step == self.cfg.steps:
                    self._save()
                if self.stragglers:
                    hosts = sorted({self.host_of_rank(r) for r in self.live})
                    actions = self.stragglers.record({h: dt for h in hosts})
                    evict = [h for h, a in actions.items() if a == "evict"]
                    if evict:
                        self._handle_failure(evict[:1])
        finally:
            # the outstanding save joined, the groups this trainer made gone
            self.ckpt.wait()
            for g in self._made:
                dist.destroy_process_group(g)
            self._made = []
        return {"losses": self.losses, "events": self.events,
                "final_step": self.step, "lost": self.lost}
