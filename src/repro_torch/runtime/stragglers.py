"""Straggler detection and mitigation bookkeeping (the port of
``repro/runtime/stragglers.py``, the same behaviour).

The per-host step times are fed in by the driver (measured or
simulated). Detection: a host is a straggler when its EMA step time
exceeds ``threshold`` x the median EMA across hosts for ``patience``
consecutive steps. Mitigation policy (returned as an action for the
driver):

  * "rebalance" — shrink the straggler's microbatch share (gradual skew)
  * "evict"     — persistent straggler: treat as failed, trigger the
                  elastic re-grouping path (same as a hard failure)

In a ``torch.distributed`` job every rank feeds its own monitor the same
times, so every rank returns the same actions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    ema_decay: float = 0.8
    threshold: float = 1.5
    patience: int = 3
    evict_after: int = 8

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in (0, 1), got {self.ema_decay}")
        if self.threshold < 1.0:
            raise ValueError(
                f"threshold must be >= 1 (a host slower than the median "
                f"by less than 1x is not a straggler), got {self.threshold}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.evict_after < self.patience:
            raise ValueError(
                f"evict_after ({self.evict_after}) must be >= patience "
                f"({self.patience}): rebalance escalates INTO evict, "
                f"never the other way")
        self._ema: List[Optional[float]] = [None] * self.n_hosts
        self._strikes: List[int] = [0] * self.n_hosts
        self._dropped: Set[int] = set()

    def record(self, host_times: Dict[int, float]) -> Dict[int, str]:
        """Feed one step's per-host times; returns {host: action}.
        Times reported for a dropped host (a late heartbeat racing its
        eviction) are ignored — a dropped host never reappears in the
        EMA table or the returned actions."""
        for h, t in host_times.items():
            if h in self._dropped:
                continue
            prev = self._ema[h]
            self._ema[h] = t if prev is None \
                else self.ema_decay * prev + (1 - self.ema_decay) * t
        live = sorted(e for e in self._ema if e is not None)
        if not live:
            return {}
        median = live[len(live) // 2]
        actions: Dict[int, str] = {}
        for h, e in enumerate(self._ema):
            if e is None:
                continue
            if e > self.threshold * median:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.evict_after:
                actions[h] = "evict"
            elif self._strikes[h] >= self.patience:
                actions[h] = "rebalance"
        return actions

    def drop_host(self, host: int):
        self._dropped.add(host)
        self._ema[host] = None
        self._strikes[host] = 0

    @property
    def live_hosts(self) -> List[int]:
        """Hosts never dropped (tracked or not yet heard from)."""
        return [h for h in range(self.n_hosts) if h not in self._dropped]

    def microbatch_weights(self) -> List[float]:
        """Per-host work shares inversely proportional to EMA step time
        (the 'rebalance' mitigation). Sums to n_live."""
        live = [(h, e) for h, e in enumerate(self._ema) if e is not None]
        if not live:
            return []
        inv = [1.0 / e for _, e in live]
        s = sum(inv)
        n = len(live)
        return [n * x / s for x in inv]
