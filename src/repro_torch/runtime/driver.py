"""Fault-tolerant LM training driver (the port of
``repro/runtime/driver.py``).

  * the train step: the gradients of every microbatch (``autograd.grad``)
    accumulate in ONE f32 buffer that also holds the rank's loss, and that
    buffer is reduced ONCE per step over the data-parallel group
    (``linalg.preduce``), whatever ``cfg.microbatches`` is — the
    trainer's counterpart of the paper's one all-reduce per outer
    iteration, and what ``repro``'s docstring claims for its jitted step.
    Clipping and AdamW run after the reduction, on replicated gradients;
  * periodic async checkpoints (params, optimizer state, the pipeline's
    state) in ``repro``'s tree and on-disk format, so a checkpoint written
    by either package's trainer restores in the other's;
  * failure handling: on an injected host failure the surviving ranks
    form a new group (``core.distributed.survivor_group``), restore the
    latest checkpoint, rewind the data pipeline and go on;
  * straggler policy: eviction goes through the same path.

Hosts are ranks of a ``torch.distributed`` group (rank r is host
``host_of_rank(r)``), and the trainer is SPMD: every rank of the group
runs it with the same arguments. Each trains on its slice of the step's
global batch (``pipeline.shard_at(step, rank, world)``); the injector's
schedule is the same on every rank, so every rank decides alike without a
collective. With ``group=None`` one process trains on the whole batch and
nothing is reduced. Only the lowest rank in use writes checkpoints; every
rank reads the one directory (a shared filesystem across machines).

Not ported (ROADMAP Queue 1, item 7): tensor parallelism (``model_axis >
1``), expert parallelism and ``shard_acts``. ``repro_torch.parallel``
gives their partition specs, but no model code runs them; ``model_axis >
1`` and ``shard_acts`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed, linalg
from repro_torch.core.types import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.elastic import _await_checkpoint
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.stragglers import StragglerMonitor

__all__ = ["TrainerConfig", "Trainer", "make_train_step", "check_config"]

MODEL_AXIS_UNPORTED = (
    "model_axis > 1 (tensor parallelism) is not ported: the partition specs "
    "exist (repro_torch.parallel), the model code does not run them "
    "(ROADMAP Queue 1, item 7)")


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
    model_axis: int = 1            # TP degree: 1 only
    seed: int = 0
    log_every: int = 10


def check_config(cfg: TrainerConfig) -> None:
    """Raise for a configuration the port cannot train."""
    if cfg.model_axis > 1:
        raise NotImplementedError(MODEL_AXIS_UNPORTED)
    if cfg.shard_acts:
        raise NotImplementedError(
            "shard_acts (sequence-parallel activations over a mesh's 'model' "
            "axis) is not ported (ROADMAP Queue 1, item 7)")
    if cfg.remat not in lm.REMAT:
        raise ValueError(f"remat must be one of {lm.REMAT}, not "
                         f"{cfg.remat!r}")
    if min(cfg.model_axis, cfg.microbatches, cfg.ckpt_every) < 1:
        raise ValueError(f"model_axis ({cfg.model_axis}), microbatches "
                         f"({cfg.microbatches}) and ckpt_every "
                         f"({cfg.ckpt_every}) must be >= 1")


def make_train_step(arch: ArchConfig, optimizer: AdamW, cfg: TrainerConfig,
                    group=None):
    """``step(model, opt_state, batch) -> loss``: one optimizer step of
    ``model`` (its parameters must require grad) IN PLACE on this rank's
    ``batch`` ({"tokens", "targets"}: (B, S), and an encoder-decoder or
    vision-stub arch's "frames" or "patches": (B, ., D); every entry split
    into ``cfg.microbatches`` microbatches of B / k rows, as ``repro``'s
    step splits every leaf), returning the mean loss over the group's
    global batch (an f32 0-dim tensor).

    Each microbatch's gradients (in the parameters' dtype) are added into
    one f32 buffer, as ``repro``'s microbatch scan adds them into f32
    zeros; the buffer's last entry holds the sum of the microbatch losses.
    One ``linalg.preduce`` sums the buffer over ``group``, then it is
    divided by k times the group's size and AdamW runs on it."""
    check_config(cfg)
    k = cfg.microbatches
    world = 1 if group is None else dist.get_world_size(group)

    def step(model, opt_state, batch):
        named = list(model.named_parameters())
        params = [p for _, p in named]
        dev = params[0].device
        batch = {name: torch.as_tensor(v, device=dev)
                 for name, v in batch.items()}
        rows_in = batch["tokens"].shape[0]
        if rows_in % k:
            raise ValueError(f"a batch of {rows_in} rows does not "
                             f"split into {k} microbatches")
        mb = rows_in // k
        sizes = [p.numel() for p in params]
        buf = torch.zeros(sum(sizes) + 1, dtype=torch.float32, device=dev)
        grads = [v.view(p.shape) for v, p in zip(buf[:-1].split(sizes),
                                                  params)]
        for j in range(k):
            rows = slice(j * mb, (j + 1) * mb)
            loss = lm.train_loss(model, {name: v[rows]
                                         for name, v in batch.items()},
                                 remat=cfg.remat)
            for acc, g in zip(grads, torch.autograd.grad(loss, params)):
                acc.add_(g)
            buf[-1:].add_(loss.detach())
        linalg.preduce(buf, group)
        if k * world > 1:
            buf.div_(k * world)
        optimizer.update(dict(zip((n for n, _ in named), grads)), opt_state,
                         dict(named))
        return buf[-1]

    return step


class Trainer:
    """Trains ``arch`` on ``pipeline`` with ``optimizer`` for
    ``cfg.steps`` steps on every rank of ``group`` (see the module
    docstring).

    model:  the LM to train (its parameters are set to require grad);
            None draws ``lm.init_params(arch, cfg.seed, device)``.
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
        self.model = model if model is not None else lm.init_params(
            arch, cfg.seed, self.device)
        self.model.requires_grad_(True)
        self.opt_state = optimizer.init(dict(self.model.named_parameters()))
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.losses: List[float] = []
        self.events: List[str] = []
        self.step = 0
        self.saved: Optional[int] = None       # the last step checkpointed
        self.lost = False                      # this rank left the run
        self._made = None                      # the group this trainer made
        self._setup()

    # -- topology -------------------------------------------------------

    def _usable(self) -> List[int]:
        """``repro``'s ``_usable_devices``: the largest prefix of the live
        ranks whose count divides the global batch and its microbatch
        split."""
        gb, k = self.pipeline.global_batch, self.cfg.microbatches
        for n in range(len(self.live), 0, -1):
            if gb % n == 0 and gb % (n * k) == 0:
                return self.live[:n]
        raise RuntimeError("no usable device configuration")

    def _setup(self):
        """The group of the usable ranks and its train step. A survivor
        beyond the usable prefix leaves the run; it takes no part in the
        group (``survivor_group`` synchronises only its members)."""
        used = self._usable()
        self.live = used
        if self.me not in used:
            self.lost = True
            return
        if self.base is None or len(used) == dist.get_world_size(self.base):
            group = self.base
        else:
            group = distributed.survivor_group(used, self.base)
        if self._made is not None:
            dist.destroy_process_group(self._made)
        self._made = None if group is self.base else group
        self.step_fn = make_train_step(self.arch, self.optimizer, self.cfg,
                                       group)

    # -- checkpoint / restore -------------------------------------------

    def _save(self):
        self.saved = self.step
        if self.me != self.live[0]:
            return
        host = lambda ts: torch.stack([t.detach().cpu() for t in ts])
        st = self.opt_state
        tree = {"params": convert.lm_tree(
                    self.arch, dict(self.model.named_parameters()), host),
                "opt": {"step": st.step,
                        "mu": convert.lm_tree(self.arch, st.mu, host),
                        "nu": convert.lm_tree(self.arch, st.nu, host)}}
        self.ckpt.save(self.step, tree,
                       extra={"pipeline": self.pipeline.checkpoint(),
                              "step": self.step})

    def _restore(self):
        """Overwrite the model and optimizer state from the latest
        checkpoint in ``cfg.ckpt_dir`` (written by either package's
        trainer) and rewind the pipeline to it."""
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
                    dst[name].copy_(leaf)
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
        self._restore()
        self.events.append(
            f"re-meshed to {survivors} devices ({{'data': "
            f"{len(self.live)}, 'model': 1}}), resumed at step {self.step}")

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
                n = len(self.live)
                tokens, targets = self.pipeline.shard_at(
                    self.step, self.live.index(self.me), n)
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
            # the outstanding save joined, the group this trainer made gone
            self.ckpt.wait()
            if self._made is not None:
                dist.destroy_process_group(self._made)
                self._made = None
        return {"losses": self.losses, "events": self.events,
                "final_step": self.step, "lost": self.lost}
