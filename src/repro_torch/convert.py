"""State carried across from the JAX package to the port.

The solvers have no weights: what a solve carries is its problem and its
:class:`~repro_torch.core.types.SolveState` (the global iteration count
plus the named recurrence leaves). These helpers take and return numpy
arrays, so a state saved by ``repro`` (``np.asarray`` of each leaf of its
``aux["state"]``) resumes here. The RNG offset and the theta schedule are
recomputed from ``iteration``, so the resumed solve continues the
uninterrupted trajectory.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.types import LassoProblem, SolveState, resolve_device


def problem_from_numpy(A, b, lam: float, l2: float = 0.0, groups=None,
                       device="cuda", dtype=torch.float32) -> LassoProblem:
    """A :class:`LassoProblem` with A and b as ``dtype`` tensors on
    ``device``; ``groups`` stays a host array."""
    dev = resolve_device(device)
    return LassoProblem(
        A=torch.as_tensor(np.asarray(A)).to(device=dev, dtype=dtype),
        b=torch.as_tensor(np.asarray(b)).to(device=dev, dtype=dtype),
        lam=float(lam), l2=float(l2),
        groups=None if groups is None else np.asarray(groups))


def state_from_numpy(iteration: int, carry: Dict[str, np.ndarray],
                     dtype=torch.float32, device="cuda") -> SolveState:
    """A :class:`SolveState` from numpy leaves (e.g. a JAX solve's
    ``aux["state"]`` after ``np.asarray``)."""
    dev = resolve_device(device)
    return SolveState(int(iteration), {
        name: torch.as_tensor(np.asarray(leaf)).to(device=dev, dtype=dtype)
        for name, leaf in carry.items()})


def state_to_numpy(state: SolveState) -> Tuple[int, Dict[str, np.ndarray]]:
    """(iteration, {leaf name: numpy array}) of a port state."""
    return int(state.iteration), {
        name: leaf.detach().cpu().numpy() for name, leaf in
        state.carry.items()}
