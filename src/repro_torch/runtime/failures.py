"""Deterministic failure injection (the port of
``repro/runtime/failures.py``, the same behaviour).

Schedules host failures at given steps; the elastic driver consults the
injector before every segment and runs its recovery path when a failure
fires. In a ``torch.distributed`` job every rank holds its own copy of
the same schedule and pops the same steps, so every rank reaches the
same decision without a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class FailureInjector:
    """failures: {step: [host_ids]} — hosts that die at that step."""
    failures: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    fired: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def check(self, step: int) -> List[int]:
        # pop: a failure fires exactly once — after the driver restores to
        # an earlier step and replays past the failure point, the hosts
        # are already gone and must not "die" again.
        hosts = self.failures.pop(step, [])
        for h in hosts:
            self.fired.append((step, h))
        return hosts
