"""Analytical cost model — paper Table I — plus an alpha-beta-gamma machine
model that predicts running times, speedups, and the optimal unrolling
parameter s (the port of ``repro/core/cost_model.py``, which imports no
JAX; the port keeps its own copy, function for function the same).

Paper Table I (critical-path costs; A sparse with density f, H iterations,
block size mu, P processors, s = unrolling parameter):

  accBCD:     F = O(H mu^2 f m / P + H mu^3)    L = O(H log P)
              W = O(H mu^2 log P)               M = O(fmn/P + m/P + mu^2 + n)
  SA-accBCD:  F = O(H mu^2 s f m / P + H mu^3)  L = O(H/s log P)
              W = O(H s mu^2 log P)             M = O(fmn/P + m/P + mu^2 s^2 + n)

The machine model assigns time
  T = gamma * F  +  beta * W  +  alpha * L  +  kappa * I
with per-flop time gamma, per-word time beta, per-message latency alpha
and per-inner-iteration overhead kappa.

The one built-in machine is the paper's own (``Machine.cray_xc30``). The
card's machine is measured, never written down: ``repro_torch.tune``'s
``measure_machine`` times it (the priors) and ``calibrate`` fits it to
pilot solves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Machine:
    """alpha-beta-gamma-kappa machine parameters (seconds, words = 8 B).

    kappa is the per-inner-iteration serial overhead (BLAS dispatch,
    subproblem solve bookkeeping) that communication-avoiding does NOT
    remove — both classical and SA execute H inner iterations. Without it
    the model predicts speedup -> alpha*logP/0 as s grows; with it the
    speedup saturates at ~(alpha*logP + kappa)/kappa, which is what the
    paper measures (1.2x-5.1x)."""
    name: str
    alpha: float     # latency per message (s)
    beta: float      # inverse bandwidth, per 8-byte word (s/word)
    gamma: float     # time per flop (s/flop)
    kappa: float = 0.0   # per-inner-iteration overhead (s)

    @classmethod
    def cray_xc30(cls) -> "Machine":
        # Aries interconnect: ~1.3 us latency, ~8 GB/s per-core effective BW,
        # ~10 GFLOP/s per-core DGEMM, ~3 us per-iteration serial overhead.
        return cls("cray-xc30", alpha=1.3e-6, beta=8.0 / 8e9,
                   gamma=1.0 / 10e9, kappa=3.0e-6)


@dataclasses.dataclass(frozen=True)
class ProblemDims:
    m: int           # data points
    n: int           # features
    f: float         # density (nnz / (m*n))


def lasso_costs(dims: ProblemDims, H: int, mu: int, s: int, P: int
                ) -> Dict[str, float]:
    """Table I entries for (SA-)accBCD. s=1 gives the classical column."""
    logP = max(math.log2(max(P, 2)), 1.0)
    F = H * mu * mu * s * dims.f * dims.m / P + H * mu ** 3
    L = (H / s) * logP
    W = H * s * mu * mu * logP
    M = (dims.f * dims.m * dims.n + dims.m) / P + mu * mu * s * s + dims.n
    return {"F": F, "L": L, "W": W, "M": M, "I": float(H)}


# Approximate flop cost of one kernel-function evaluation, given the
# already-computed linear cross product (transform applied on the
# replicated post-all-reduce block): exp/pow and the norm combine.
KERNEL_EVAL_FLOPS = {"linear": 0.0, "poly": 3.0, "rbf": 5.0}


def svm_costs(dims: ProblemDims, H: int, s: int, P: int,
              mu: int = 1, kernel: str = "linear") -> Dict[str, float]:
    """(SA-)BDCD SVM analogue of Table I: mu dual coordinates per
    iteration, Gram is (s*mu) x (s*mu). mu = 1, s = 1 is classical DCD.

    Linear (kernel="linear", the paper's Alg. 3-4 / BDCD): per inner
    iteration the Gram/projection GEMM costs mu^2 s f n / P flops
    (amortized over the outer group), the redundant inner updates cost
    s mu^2 (cross terms), the mu x mu subproblem mu^3 (power iteration).
    The all-reduce moves s mu^2 words every s iterations ->
    W = H s mu^2 log P at L = (H/s) log P messages.

    Kernelized ((SA-)K-BDCD, arXiv:2406.18001): the per-group message is
    the (m, s*mu) cross block A Y^T (the m-dimensional dual residual f
    replaces the n/P-partitioned primal), so W grows to H mu m log P and
    F gains the cross-product GEMM m mu s f n / P plus the
    kernel-evaluation transform c_k m mu per inner iteration
    (c_k = KERNEL_EVAL_FLOPS[kernel], applied on the replicated reduced
    block — kernelizing adds NO messages and NO latency). L is unchanged:
    still one all-reduce per outer iteration.
    """
    logP = max(math.log2(max(P, 2)), 1.0)
    F = H * mu * mu * s * dims.f * dims.n / P + H * s * mu * mu \
        + H * mu ** 3
    L = (H / s) * logP
    W = H * s * mu * mu * logP
    M = (dims.f * dims.m * dims.n) / P + dims.m + s * s * mu * mu \
        + dims.n / P
    if kernel != "linear":
        if kernel not in KERNEL_EVAL_FLOPS:
            raise ValueError(
                f"unknown kernel {kernel!r}; known: "
                f"{sorted(KERNEL_EVAL_FLOPS)}")
        ck = KERNEL_EVAL_FLOPS[kernel]
        # cross-product GEMM + kernel transform + the f/alpha GEMV work,
        # all per inner iteration (amortized over the outer group).
        F = H * mu * dims.m * dims.f * dims.n / P \
            + ck * H * mu * dims.m + H * s * mu * mu + H * mu ** 3 \
            + H * mu * dims.m
        W = H * mu * dims.m * logP
        M = (dims.f * dims.m * dims.n) / P + 3.0 * dims.m \
            + s * mu * dims.m + s * s * mu * mu
    return {"F": F, "L": L, "W": W, "M": M, "I": float(H)}


def logreg_costs(dims: ProblemDims, H: int, mu: int, s: int, P: int
                 ) -> Dict[str, float]:
    """(SA-)BCD logistic regression (arXiv:2011.08281 regime): the
    per-group message is the (m, s*mu) cross block A Y^T (the replicated
    margin vector f plays the role the kernel SVM's dual residual does),
    so W = H mu m log P at L = (H/s) log P messages — kernel-SVM message
    shape with linear-SVM flops: the cross GEMM mu s f n / P plus the
    O(m mu) margin update and the mu^3 subproblem per inner iteration.
    """
    logP = max(math.log2(max(P, 2)), 1.0)
    F = H * mu * dims.m * dims.f * dims.n / P + H * mu * dims.m \
        + H * s * mu * mu + H * mu ** 3
    L = (H / s) * logP
    W = H * mu * dims.m * logP
    M = (dims.f * dims.m * dims.n) / P + 3.0 * dims.m + s * mu * dims.m \
        + dims.n / P
    return {"F": F, "L": L, "W": W, "M": M, "I": float(H)}


def logreg_speedup(dims: ProblemDims, H: int, s: int, P: int,
                   machine: Machine, mu: int = 1) -> float:
    t1 = predicted_time(logreg_costs(dims, H, mu, 1, P), machine)
    ts = predicted_time(logreg_costs(dims, H, mu, s, P), machine)
    return t1 / ts


# The machine model is LINEAR in the machine parameters: T = theta . c
# with theta = (gamma, beta, alpha, kappa) and c = (F, W, L, I). The
# autotuner (repro_torch.tune) exploits this — calibration is a (weighted)
# least-squares fit of theta to measured pilot solves, so the per-term
# cost vectors are public alongside the summed predicted_time.
COST_TERMS = ("F", "W", "L", "I")


def cost_vector(costs: Dict[str, float]):
    """The (F, W, L, I) per-term cost vector of a Table-I cost dict —
    the calibration feature row for one (s, mu) configuration. F/W/L
    are required (a malformed costs hook must fail loudly, not predict
    a near-zero time the tuner would then 'prefer'); I defaults to 0
    for cost dicts that predate the kappa term."""
    return (float(costs["F"]), float(costs["W"]), float(costs["L"]),
            float(costs.get("I", 0.0)))


def machine_vector(machine: Machine):
    """(gamma, beta, alpha, kappa) — the parameter vector paired with
    :func:`cost_vector` (same term order)."""
    return (machine.gamma, machine.beta, machine.alpha, machine.kappa)


def machine_from_vector(vec, name: str = "calibrated") -> Machine:
    """Inverse of :func:`machine_vector`."""
    gamma, beta, alpha, kappa = (float(v) for v in vec)
    return Machine(name=name, alpha=alpha, beta=beta, gamma=gamma,
                   kappa=kappa)


def time_breakdown(costs: Dict[str, float], machine: Machine
                   ) -> Dict[str, float]:
    """Per-term seconds — which of flops / bandwidth / latency /
    per-iteration overhead dominates a configuration's predicted time."""
    return {term: p * c for term, p, c in
            zip(COST_TERMS, machine_vector(machine), cost_vector(costs))}


def predicted_time(costs: Dict[str, float], machine: Machine) -> float:
    return sum(p * c for p, c in
               zip(machine_vector(machine), cost_vector(costs)))


def lasso_speedup(dims: ProblemDims, H: int, mu: int, s: int, P: int,
                  machine: Machine) -> float:
    """T(classical) / T(SA with unrolling s)."""
    t1 = predicted_time(lasso_costs(dims, H, mu, 1, P), machine)
    ts = predicted_time(lasso_costs(dims, H, mu, s, P), machine)
    return t1 / ts


def svm_speedup(dims: ProblemDims, H: int, s: int, P: int,
                machine: Machine, mu: int = 1,
                kernel: str = "linear") -> float:
    t1 = predicted_time(svm_costs(dims, H, 1, P, mu, kernel), machine)
    ts = predicted_time(svm_costs(dims, H, s, P, mu, kernel), machine)
    return t1 / ts


def best_s(dims: ProblemDims, H: int, mu: int, P: int, machine: Machine,
           candidates=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
           kind: str = "lasso", kernel: str = "linear"):
    """Sweep s and return (s*, speedup(s*)) — the paper's tuning knob.

    The existence of an interior optimum (speedup rises with s while
    latency dominates, then falls once the s*mu^2 bandwidth/flop terms take
    over) reproduces the qualitative shape of paper Fig. 4e-h.

    kind selects the cost formula: "lasso" (Table I), "svm" (the
    (SA-)(K-)BDCD analogue; ``kernel`` selects the message/flop regime),
    or "logreg" (the CA-logistic-regression regime). Unknown kinds raise.
    """
    if kind == "lasso":
        def fn(s):
            return lasso_speedup(dims, H, mu, s, P, machine)
    elif kind == "svm":
        def fn(s):
            return svm_speedup(dims, H, s, P, machine, mu, kernel)
    elif kind == "logreg":
        def fn(s):
            return logreg_speedup(dims, H, s, P, machine, mu)
    else:
        raise ValueError(
            f"unknown kind {kind!r}; known: 'lasso', 'svm', 'logreg'")
    best = max(candidates, key=fn)
    return best, fn(best)


# Paper Table II / IV dataset shape regimes (the synthetic analogues the
# data makers scale down are in repro_torch.data.sparse).
PAPER_DATASETS = {
    "url": ProblemDims(m=2_396_130, n=3_231_961, f=3.6e-5),
    "news20": ProblemDims(m=15_935, n=62_061, f=1.3e-3),
    "covtype": ProblemDims(m=581_012, n=54, f=0.22),
    "epsilon": ProblemDims(m=400_000, n=2_000, f=1.0),
    "leu": ProblemDims(m=38, n=7_129, f=1.0),
    "w1a": ProblemDims(m=300, n=2_477, f=0.04),
    "duke": ProblemDims(m=44, n=7_129, f=1.0),
    "news20.binary": ProblemDims(m=1_355_191, n=19_996, f=3.0e-4),
    "rcv1.binary": ProblemDims(m=47_236, n=20_242, f=1.6e-3),
    "gisette": ProblemDims(m=5_000, n=6_000, f=0.99),
}
