"""Measure the alpha-beta-gamma-kappa ``Machine`` parameters on the
device a solve runs on (the port of ``repro/tune/microbench.py``).

The cost model (``repro_torch.core.cost_model``) assigns a configuration
the time ``T = gamma F + beta W + alpha L + kappa I``. Its one built-in
machine (``Machine.cray_xc30``) is the paper's; this module produces a
``Machine`` for the device we actually run on:

* **gamma** (s/flop) — timed square GEMMs (``torch.matmul``) at a couple
  of sizes: the flop rate of the dense products that dominate F. A
  library GEMM, as ``repro`` times XLA's outside any kernel of its own;
  the caller's TF32 setting stands.
* **beta** (s/word, 8 B words) — timed all-reduce of a large vector
  (``linalg.preduce``, uncounted) when ``torch.distributed`` is
  initialised with more than one rank, otherwise a memory-bound
  elementwise pass on the device (the one-device proxy for moving one
  word through the reduction).
* **alpha** (s/message) — the time of the SAME reduction on a
  1-element vector: pure launch/collective latency, the term SA trades
  against.
* **kappa** (s/inner-iteration) — the slope in H of the port's
  ``bcd_lasso`` on a tiny (32 x 64, mu = 1) problem on the device:
  per-iteration serial overhead that unrolling does NOT remove.

Every timed call ends in ``torch.cuda.synchronize()`` on the card: the
solvers and kernels return before the device is done, and without the
sync the tuner would time launches, not work.

These are *priors*: ``repro_torch.tune.calibrate`` refines all four by
fitting predicted to measured times over a pilot (s, mu) grid.
"""
from __future__ import annotations

import socket
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import linalg
from repro_torch.core.cost_model import Machine
from repro_torch.core.types import resolve_device

__all__ = ["measure_machine", "measure_gamma", "measure_alpha_beta",
           "measure_kappa", "time_best", "device_label"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_best(fn: Callable, repeats: int = 5, device="cuda") -> float:
    """Best-of-``repeats`` wall-clock seconds of ``fn()`` after one
    warm-up call, each call ended by a device sync on the card. The
    warm-up absorbs the first ``nvcc`` build and CUDA's lazy loading;
    best-of suppresses scheduler noise on a shared host."""
    dev = resolve_device(device)
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_gamma(sizes=(512, 2048), repeats: int = 5,
                  dtype=torch.float32, device="cuda") -> float:
    """s/flop from timed n x n ``torch.matmul`` GEMMs (2 n^3 flops each);
    the larger size usually wins (amortized launch) — take the best
    rate."""
    dev = resolve_device(device)
    best = float("inf")
    for n in sizes:
        a = torch.ones((n, n), dtype=dtype, device=dev)
        t = time_best(lambda: torch.matmul(a, a), repeats, dev)
        best = min(best, t / (2.0 * n ** 3))
    return best


def _reduce_fn(x: torch.Tensor) -> Callable:
    """The timed reduction of ``x``: a real all-reduce over the default
    process group when it spans several ranks (every rank must then
    call), an elementwise memory pass (the one-device bandwidth proxy)
    otherwise."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        group = dist.group.WORLD
        return lambda: linalg.preduce(x, group, counted=False)
    return lambda: x * 1.0 + 1.0


def measure_alpha_beta(big: Optional[int] = None, repeats: int = 5,
                       device="cuda"):
    """(alpha, beta): latency from a 1-element reduction, inverse
    bandwidth per 8 B word from the marginal cost of a ``big``-element
    one (latency subtracted). ``big`` defaults to repro's 2^22 elements
    on the CPU and 2^26 on the card: at 2^22 (16 MB) the card's pass
    takes less time than the launches and sync around it, and the
    marginal cost vanishes into their noise."""
    dev = resolve_device(device)
    if big is None:
        big = 1 << 26 if dev.type == "cuda" else 1 << 22
    alpha = time_best(_reduce_fn(torch.ones(1, device=dev)), repeats, dev)
    t_big = time_best(_reduce_fn(torch.ones(big, device=dev)), repeats, dev)
    words = big * 4 / 8.0                     # f32 elements -> 8 B words
    beta = max(t_big - alpha, 1e-12) / words
    return alpha, beta


def measure_kappa(h_small: int = 16, h_big: int = 96,
                  repeats: int = 3, device="cuda") -> float:
    """s/inner-iteration from the slope in H of a tiny (32 x 64, mu=1)
    Lasso solve — at that size the per-iteration flops are sub-us, so
    the slope IS the serial bookkeeping overhead kappa models."""
    from repro_torch.core.lasso import bcd_lasso
    from repro_torch.core.types import LassoProblem, SolverConfig

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    problem = LassoProblem(
        A=torch.as_tensor(rng.standard_normal((32, 64)).astype(np.float32),
                          device=dev),
        b=torch.as_tensor(rng.standard_normal(32).astype(np.float32),
                          device=dev),
        lam=0.1)

    def solve_time(H: int) -> float:
        cfg = SolverConfig(block_size=1, iterations=H, accelerated=False,
                           track_objective=False, device=str(dev))
        return time_best(lambda: bcd_lasso(problem, cfg).x, repeats, dev)

    slope = (solve_time(h_big) - solve_time(h_small)) / (h_big - h_small)
    return max(slope, 1e-9)


def device_label(device) -> str:
    """The name a machine or cache key gives ``device``: the card's name
    (``torch.cuda.get_device_name``), or ``cpu``."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type


def measure_machine(name: Optional[str] = None, repeats: int = 5,
                    device="cuda") -> Machine:
    """Measure all four parameters on ``device`` (a few seconds); the
    machine is named ``{host}-{device name}``."""
    alpha, beta = measure_alpha_beta(repeats=repeats, device=device)
    gamma = measure_gamma(repeats=repeats, device=device)
    kappa = measure_kappa(repeats=max(repeats - 2, 1), device=device)
    if name is None:
        name = f"{socket.gethostname()}-{device_label(device)}"
    return Machine(name=name, alpha=alpha, beta=beta, gamma=gamma,
                   kappa=kappa)
