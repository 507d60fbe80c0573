"""AdamW with f32 state, global-norm clipping and a cosine schedule (the
port of ``repro/optim/adamw.py``).

``repro``'s update, not ``torch.optim.AdamW``'s: no f32 master copy of
the parameters; f32 moments, also for bf16 parameters; a global-norm clip
over every leaf in f32; bias corrections ``1 - b ** step`` on an f32 step;
``mh / (sqrt(vh) + eps) + wd * p`` with p read in f32, and ``p - lr *
delta`` rounded back to the parameter's dtype. The scalars are f32
tensors and each product rounds where ``repro``'s does. The update runs
in place, one leaf at a time, so its f32 temporaries are one leaf's size.

A tree is a dict or a list of tensors (the trainer passes the model's
``named_parameters`` as a dict). On a model axis, a data axis (FSDP) or
both the trees hold the rank's shards, and the clip's norm is the whole
model's. ``state_specs`` gives the state's
partition specs (``repro_torch.parallel.sharding``) from the parameters'.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core import linalg

F32 = torch.float32


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable:
    """lr(step): linear warm-up to ``base_lr`` over ``warmup_steps``, then
    a cosine decay to ``min_ratio * base_lr`` at ``total_steps``; an f32
    tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, base_lr * cos)
    return lr


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-dim
    mu: object                  # f32, shaped like the parameters
    nu: object


def _keys(tree):
    return list(tree) if isinstance(tree, dict) else range(len(tree))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return [fn(v) for v in tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        first = next(iter(params.values() if isinstance(params, dict)
                          else params))
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=_map(zeros, params), nu=_map(zeros, params))

    def state_specs(self, param_specs_tree) -> AdamWState:
        """PartitionSpecs for the state, mirroring the param specs."""
        from repro_torch.parallel.sharding import P
        return AdamWState(step=P(), mu=param_specs_tree,
                          nu=_map(lambda s: s, param_specs_tree))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, axis=None,
               split=frozenset(), data=None, data_split=frozenset()
               ) -> Tuple[object, AdamWState]:
        """Apply one step to ``params`` IN PLACE from ``grads`` (the same
        keys; any float dtype). The state's step and moments update in
        place too. Returns (params, state), the same objects.

        ``axis``: the model axis (``parallel.tensor.Axis``) the
        parameters are split over, ``split`` the keys of the leaves it
        splits; ``data``: the data axis, ``data_split`` the keys of the
        leaves it splits (FSDP, ``parallel.fsdp``). The clip's global norm
        counts each element once: it sums the squares of a model-split
        leaf over the model group, of a data-split leaf over the data
        group, of a leaf split on both over both, and takes a whole leaf,
        equal on every rank, once. The update itself is elementwise on the
        shards."""
        keys = _keys(params)
        dev = state.step.device
        scalar = lambda x: torch.tensor(x, dtype=F32, device=dev)
        step = state.step.add_(1)
        scale = None
        if self.clip_norm > 0:
            sq = lambda k: torch.sum(torch.square(grads[k].to(F32)))
            on_m = axis is not None and axis.size > 1
            on_d = data is not None and data.size > 1
            if not on_m and not on_d:
                gnorm = torch.sqrt(sum(sq(k) for k in keys))
            else:
                ms = lambda k: on_m and k in split
                ds = lambda k: on_d and k in data_split
                part = lambda m, d: sum((sq(k) for k in keys
                                         if ms(k) == m and ds(k) == d),
                                        scalar(0.0))
                total = part(False, False)
                both = part(True, True)
                if on_m:                # [model-split only, split on both]
                    summed = linalg.preduce(torch.stack(
                        [part(True, False), both]), axis.group,
                        counted=False)
                    total, both = total + summed[0], summed[1]
                if on_d:
                    total = total + linalg.preduce(part(False, True) + both,
                                                   data.group, counted=False)
                gnorm = torch.sqrt(total)
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        b1, b2 = scalar(self.b1), scalar(self.b2)
        c1, c2 = scalar(1 - self.b1), scalar(1 - self.b2)
        bc1 = 1 - b1 ** step.to(F32)
        bc2 = 1 - b2 ** step.to(F32)
        lr = self.learning_rate(step) if callable(self.learning_rate) \
            else scalar(self.learning_rate)
        eps, wd = scalar(self.eps), scalar(self.weight_decay)
        for k in keys:
            p, m, v = params[k], state.mu[k], state.nu[k]
            g = grads[k].to(F32)
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(c1 * g)
            v.mul_(b2).add_(c2 * g * g)
            pf = p.to(F32)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
            p.copy_(pf - lr * delta)
        return params, state
