#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` and

1. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at edge shapes, and times ``gram`` and
   ``sa_inner`` with their plain versions and (``gram``) ``torch.matmul``
   with CUDA events;
2. drives the dense Lasso path — ``repro_torch.api.solve`` on a dense
   Lasso at the shape of LIBSVM ``epsilon`` (400,000 x 2,000, f32),
   SA-accBCD with mu = 8, s = 16, H = 512 — checks that ``gram`` and
   ``sa_inner`` each launched ceil(H/s) = 32 times, that the objective is
   finite and falls, and that the classical accBCD (s = 1) gives the same
   trace within rel 1e-3; then times where each outer iteration's time
   goes;
3. runs an f64 solve on the card (epsilon-like, 8192 x 512) through the
   same kernels and holds it to the CPU solve within 1e-8;
4. drives the sparse SVM path — ``api.solve`` on a linear SVM-L1 at the
   shape of LIBSVM ``news20.binary`` (19,996 x 1,355,191, ~9.1 M nonzeros,
   a SparseOperand made on the card), SA-BDCD mu = 1, s = 64, H = 4096 —
   checks 64 launches each of ``spmm`` and ``svm_inner`` and none of
   ``gram``, a finite falling dual trace and the classical BDCD (s = 1)
   within rel 1e-3, times the phases, and times ``spmm`` and
   ``svm_inner`` on the inputs the solve gave them against their plain
   versions and (``spmm``) ``torch.sparse.mm``;
5. drives the sparse Lasso path — SA-accBCD mu = 8, s = 16, H = 512 on a
   sparse Lasso at the shape of LIBSVM ``url`` (2,396,130 x 3,231,961,
   ~279 M nonzeros) — with the same checks (32 launches each of ``spmm``
   and ``sa_inner``, none of ``gram``) and phase split;
6. runs f64 sparse solves on the card (SVM rcv1-like, Lasso news20-like)
   through ``spmm``, ``svm_inner`` and ``sa_inner`` and holds them to the
   CPU solves within 1e-8.

Any failed check raises, so the exit code is non-zero. The last lines
are the kernels' JSON line, the card's name and power limit as
``nvidia-smi`` reports them, and the device JSON line. Without a card,
or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

M_EPS, N_EPS = 400_000, 2_000           # LIBSVM epsilon
MU, S, H = 8, 16, 512
# LIBSVM news20.binary (SVM path) and url (sparse Lasso path; density f
# as src/repro/core/cost_model.py:246 gives it).
M_NEWS, N_NEWS, F_NEWS = 19_996, 1_355_191, 3.36e-4
S_SVM, H_SVM = 64, 4096
M_URL, N_URL, F_URL = 2_396_130, 3_231_961, 3.6e-5
# The url Lasso plants a 1%-dense x: with the recipe's default 32 nonzeros
# among 3.2 M features, only ~4% of the solve's 512 blocks of 8 would
# meet one, and lam = 0.1 lam_max zeroes every other step, so the
# objective could not visibly fall.
K_URL = N_URL // 100


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sa_inner_flops(s: int, mu: int, iters: int) -> float:
    """Floating-point operations of one sa_inner call on its inputs: the
    power iterations (skipped at mu = 1), the masked cross-term and
    collision sums over the j*mu earlier entries of each step, the prox."""
    power = 0 if mu == 1 else s * (iters * (2 * mu * mu + 3 * mu)
                                   + 2 * mu * mu + 4 * mu)
    chain = sum(mu * j * mu * 5 for j in range(s))
    return power + chain + s * (4 + mu * 12)


def svm_inner_flops(s: int, mu: int, iters: int) -> float:
    """Floating-point operations of one svm_inner call on its inputs: the
    power iterations (skipped at mu = 1), the cross-term and collision
    sums over the j*mu earlier entries of each step, the clipped update,
    and the dual increments."""
    power = 0 if mu == 1 else s * (iters * (2 * mu * mu + 3 * mu)
                                   + 2 * mu * mu + 4 * mu)
    chain = sum(mu * j * mu * 4 for j in range(s))
    return power + chain + s * mu * 12 + s * (2 * mu * mu + 4 * mu)


def check_close(name, got, want, rtol, atol):
    import torch
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    log(f"  {name}: max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:.3g})"
        f" {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version.
# ---------------------------------------------------------------------------

def inner_inputs(s, mu, n_ids, dtype, gen):
    import torch
    dev = "cuda"
    G0 = torch.randn(256, s * mu, generator=gen, device=dev, dtype=dtype)
    G = (G0.T @ G0).contiguous()
    yp, zp = (torch.randn(s, mu, generator=gen, device=dev, dtype=dtype)
              for _ in range(2))
    zv = 0.1 * torch.randn(s, mu, generator=gen, device=dev, dtype=dtype)
    idx = torch.randint(0, n_ids, (s, mu), generator=gen, device=dev)
    th = torch.linspace(0.5, 0.01, s, device=dev, dtype=dtype)
    coefU = (1.0 - 250.0 * th) / (th * th)
    return G, yp, zp, zv, idx, th, coefU


def random_ell(R, C, per_row, gen, dtype, empty_rows=0):
    """(vals, idx, blocks) of an (R, C) blocked-ELL operand with about
    ``per_row`` distinct ascending column ids per row (rows < empty_rows
    have none), made on the card."""
    import torch
    from repro_torch.core.types import SparseOperand
    nnz = max(1, int(R * per_row))
    keys = torch.unique(torch.randint(0, R * C, (nnz,), generator=gen,
                                      device="cuda"))
    keys = keys[keys // C >= empty_rows]
    op = SparseOperand.from_coo(
        keys // C, keys % C,
        torch.randn(keys.numel(), generator=gen, device="cuda",
                    dtype=dtype), (R, C))
    return op.row_vals, op.row_cols, op.row_blocks


def phase_kernels():
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.gram import gram_t
    from repro_torch.kernels.gram.ref import gram_t_ref
    from repro_torch.kernels.sa_inner import sa_inner_loop
    from repro_torch.kernels.sa_inner.ops import _declare as inner_declare
    from repro_torch.kernels.sa_inner.ref import sa_inner_ref
    from repro_torch.kernels.spmm import ell_spmm
    from repro_torch.kernels.spmm.ops import _declare as spmm_declare
    from repro_torch.kernels.spmm.ref import ell_spmm_ref
    from repro_torch.kernels.svm_inner import svm_inner_loop
    from repro_torch.kernels.svm_inner.ops import _declare as svm_declare
    from repro_torch.kernels.svm_inner.ref import svm_inner_ref

    log("phase 1: kernels against their plain versions")
    t0 = time.perf_counter()
    names = ["gram", "sa_inner", "spmm", "svm_inner"]
    _build.build(names)                     # one nvcc per source, together
    log(f"  built {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # gram at the main path's shape: Y (m, s mu) against [Y | ytil | ztil].
    m, p, q = M_EPS, S * MU, S * MU + 2
    x = torch.randn(m, p, generator=gen, device="cuda")
    y = torch.randn(m, q, generator=gen, device="cuda")
    err = check_close(f"gram f32 ({m}, {p}) x ({m}, {q})", gram_t(x, y),
                      gram_t_ref(x, y), 2e-4, 2e-4 * math.sqrt(m))
    b, why = bound_ms((m * p + m * q + p * q) * 4, 2.0 * m * p * q)
    rows["gram"] = {
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:48",
        "max_abs_err": err,
        "ms": time_ms(lambda: gram_t(x, y), 20),
        "plain_ms": time_ms(lambda: gram_t_ref(x, y), 20),
        "bound_ms": b, "bound_by": why,
        "library_ms": time_ms(lambda: torch.matmul(x.T, y), 20)}
    del x, y
    for dtype, rtol, atol in ((torch.float32, 2e-4, 2e-4 * math.sqrt(513)),
                              (torch.float64, 1e-12, 1e-12)):
        x = torch.randn(513, 257, generator=gen, device="cuda", dtype=dtype)
        y = torch.randn(513, 3, generator=gen, device="cuda", dtype=dtype)
        check_close(f"gram {dtype} (513, 257) x (513, 3)", gram_t(x, y),
                    gram_t_ref(x, y), rtol, atol)

    # sa_inner: G in shared memory (16, 8), in global memory (64, 8), and
    # forced collisions (ids from 0..3) at mu = 1, f32 and f64.
    lib = _build.load("sa_inner", inner_declare)
    for s, mu, isz in ((16, 8, 4), (64, 8, 4), (16, 8, 8), (238, 1, 4)):
        for g in (True, False):
            want = dispatch.sa_inner_smem_bytes(s, mu, isz, g)
            got = lib.sa_inner_smem_bytes(s, mu, isz, int(g))
            if got != want:
                raise AssertionError(f"sa_inner smem layout differs: C {got}"
                                     f" vs dispatch {want} at {(s, mu, isz)}")
    cases = ((16, 8, torch.float32, 2000, True),
             (64, 8, torch.float32, 2000, False),
             (4, 1, torch.float32, 4, True),
             (4, 1, torch.float64, 4, True),
             (16, 8, torch.float64, 2000, True))
    for s, mu, dtype, n_ids, smem in cases:
        ins = inner_inputs(s, mu, n_ids, dtype, gen)
        if dispatch.sa_inner_g_in_smem(s, mu, ins[0].element_size()) != smem:
            raise AssertionError(f"sa_inner ({s}, {mu}) G placement")
        kw = dict(q=250.0, lam1=0.05, lam2=0.01, power_iters=32)
        dz, eta = sa_inner_loop(*ins, **kw)
        dz_r, eta_r = sa_inner_ref(*ins, **kw)
        tol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-12, 1e-12)
        where = "smem" if smem else "global"
        e = check_close(f"sa_inner {dtype} (s={s}, mu={mu}, G {where}) dz",
                        dz, dz_r, *tol)
        check_close(f"sa_inner {dtype} (s={s}, mu={mu}) eta", eta, eta_r,
                    tol[0], 0.0)
        if (s, mu, dtype) == (S, MU, torch.float32):
            smu = s * mu
            nbytes = smu * smu * 4 + 3 * smu * 4 + smu * 8 + 2 * s * 4 \
                + smu * 4 + s * 4
            b, why = bound_ms(nbytes, sa_inner_flops(s, mu, 32))
            rows["sa_inner"] = {
                "name": "sa_inner", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/sa_inner.cu",
                "replaces": "src/repro/kernels/sa_inner/kernel.py:91",
                "max_abs_err": e,
                "ms": time_ms(lambda: sa_inner_loop(*ins, **kw), 200, 5),
                "plain_ms": time_ms(lambda: sa_inner_ref(*ins, **kw), 5, 1),
                "bound_ms": b, "bound_by": why, "library_ms": None}

    # spmm: the SVM path's (64 rows of ~455 slots, D 1,355,191 x 65) and
    # the Lasso path's (128 of ~86, D 2,396,130 x 130) shapes, the
    # test_spmm_kernel_sweep shapes, R = 1 with Q = 2 (classical SVM at
    # mu = 1), two q tiles (Q = 300), rows with no slots, and f64.
    lib = _build.load("spmm", spmm_declare)
    if lib.spmm_q_tile() != dispatch.SPMM_Q_TILE:
        raise AssertionError(f"spmm q tile: C {lib.spmm_q_tile()} vs "
                             f"dispatch {dispatch.SPMM_Q_TILE}")
    for R, C, Q, per_row, dtype, empty in (
            (64, N_NEWS, S_SVM + 1, F_NEWS * N_NEWS, torch.float32, 0),
            (S * MU, M_URL, S * MU + 2, F_URL * M_URL, torch.float32, 0),
            (12, 40, 5, 12, torch.float32, 0),
            (33, 128, 17, 6.4, torch.float32, 0),
            (64, 200, 1, 100, torch.float32, 0),
            (7, 16, 130, 6.4, torch.float32, 0),
            (1, 50, 2, 10, torch.float32, 0),
            (40, 3000, 300, 12, torch.float32, 5),
            (7, 16, 130, 6.4, torch.float64, 2),
            (S * MU, M_URL, S * MU + 2, F_URL * M_URL, torch.float64, 0)):
        vals, idx, blocks = random_ell(R, C, per_row, gen, dtype, empty)
        D = torch.randn(C, Q, generator=gen, device="cuda", dtype=dtype)
        tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-12, 1e-12)
        check_close(f"spmm {dtype} R={R} K={idx.shape[1]} C={C} Q={Q}"
                    f"{f' ({empty} empty rows)' if empty else ''}",
                    ell_spmm(vals, idx, blocks, D), ell_spmm_ref(vals, idx, D),
                    *tol)
        del D

    # svm_inner: G in shared memory ((64, 1), (16, 8), (3, 5)) and in
    # global memory ((64, 8)), ids from 0..11 so blocks collide, hinge
    # (nu = 1) and squared hinge (nu = inf), f32 and f64.
    lib = _build.load("svm_inner", svm_declare)
    for s, mu, isz in ((64, 1, 4), (16, 8, 4), (64, 8, 4), (16, 8, 8),
                       (238, 1, 4), (167, 1, 8)):
        for g in (True, False):
            want = dispatch.svm_inner_smem_bytes(s, mu, isz, g)
            got = lib.svm_inner_smem_bytes(s, mu, isz, int(g))
            if got != want:
                raise AssertionError(f"svm_inner smem layout differs: C "
                                     f"{got} vs dispatch {want} at "
                                     f"{(s, mu, isz)}")
    for s, mu, dtype, smem in ((64, 1, torch.float32, True),
                               (16, 8, torch.float32, True),
                               (3, 5, torch.float32, True),
                               (64, 8, torch.float32, False),
                               (64, 1, torch.float64, True),
                               (16, 8, torch.float64, True),
                               (64, 8, torch.float64, False)):
        for nu in (1.0, float("inf")):
            ins = svm_inputs(s, mu, 12, dtype, gen)
            if dispatch.svm_inner_g_in_smem(s, mu, ins[0].element_size()) \
                    != smem:
                raise AssertionError(f"svm_inner ({s}, {mu}) G placement")
            th, dl = svm_inner_loop(*ins, gamma=0.3, nu=nu)
            th_r, dl_r = svm_inner_ref(*ins, 0.3, nu)
            f32 = dtype == torch.float32
            where = "smem" if smem else "global"
            check_close(f"svm_inner {dtype} (s={s}, mu={mu}, nu={nu}, G "
                        f"{where}) theta", th, th_r,
                        *((1e-4, 1e-5) if f32 else (1e-12, 1e-12)))
            check_close(f"svm_inner {dtype} (s={s}, mu={mu}, nu={nu}) "
                        f"dual increments", dl, dl_r,
                        *((1e-4, 1e-4) if f32 else (1e-12, 1e-12)))
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms,"
            f" bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    torch.cuda.synchronize()
    return rows


def svm_inputs(s, mu, n_ids, dtype, gen):
    import torch
    dev = "cuda"
    G0 = torch.randn(64, s * mu, generator=gen, device=dev, dtype=dtype)
    G = (G0.T @ G0 + 0.5 * torch.eye(s * mu, device=dev,
                                     dtype=dtype)).contiguous()
    proj = torch.randn(s, mu, generator=gen, device=dev, dtype=dtype)
    b = torch.where(torch.randn(s, mu, generator=gen, device=dev) < 0,
                    -1.0, 1.0).to(dtype)
    a_vals = 0.2 * torch.rand(s, mu, generator=gen, device=dev, dtype=dtype)
    idx = torch.randint(0, n_ids, (s, mu), generator=gen, device=dev)
    return G, proj, b, a_vals, idx


# ---------------------------------------------------------------------------
# Phase 2: the main path at full data size.
# ---------------------------------------------------------------------------

def epsilon_problem(seed: int):
    """A dense Lasso at the shape of LIBSVM epsilon, made on the card by the
    make_lasso_dataset recipe: planted 32-sparse x, noise 0.1,
    lam = 0.1 ||A^T b||_inf."""
    import torch
    from repro_torch.api import LassoProblem
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    A = torch.randn(M_EPS, N_EPS, generator=gen, device="cuda")
    support = torch.randperm(N_EPS, generator=gen, device="cuda")[:32]
    x_true = torch.zeros(N_EPS, device="cuda")
    x_true[support] = torch.randn(32, generator=gen, device="cuda")
    b = A @ x_true + 0.1 * torch.randn(M_EPS, generator=gen, device="cuda")
    lam = 0.1 * float((A.T @ b).abs().max())
    return LassoProblem(A=A, b=b, lam=lam)


class PhaseTimer:
    """CUDA event pairs around named callables: device time per phase.
    The first call's arguments of each are kept in ``first``."""

    def __init__(self):
        self.events = {}
        self.first = {}

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
            self.first.setdefault(name, (args, kw))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.events.setdefault(name, []).append((e0, e1))
            return out
        return timed

    def totals_ms(self):
        import torch
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


def phase_main_path():
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core import engine, sa_lasso
    from repro_torch.kernels import sa_inner

    log(f"phase 2: main path, dense Lasso {M_EPS} x {N_EPS} f32, "
        f"SA-accBCD mu={MU} s={S} H={H}")
    problem = epsilon_problem(seed=0)
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(problem, cfg)
    obj = res.objective.cpu()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = {"gram": counts["gram"], "sa_inner": counts["sa_inner"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the solve: {counts} (expected {outer} each of "
        f"gram and sa_inner)")
    log(f"  objective {float(obj[0]):.6g} -> {float(obj[-1]):.6g}; "
        f"inner_impl {res.aux['inner_impl']}")
    log(f"  wall {wall:.4f} s, {wall / outer * 1e3:.4f} ms per outer "
        f"iteration; peak device memory {peak / 2**30:.3f} GiB")
    if counts != {"gram": outer, "sa_inner": outer, "spmm": 0,
                  "svm_inner": 0}:
        raise AssertionError(f"main path launches {counts}, expected "
                             f"{outer} of gram and sa_inner")
    # Accelerated BCD is not a descent method: allow rises of 1e-2 of the
    # start within a trace that falls overall.
    rise = float((obj[1:] - obj[:-1]).max() / obj[0])
    log(f"  largest one-step rise {rise:.3e} of the starting objective")
    if not (torch.isfinite(obj).all() and obj[-1] < obj[0] and rise < 1e-2):
        raise AssertionError("objective trace not finite and falling")
    if res.aux["inner_impl"] != "cuda":
        raise AssertionError(f"inner loop ran as {res.aux['inner_impl']}")

    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    obj_c = classical.objective.cpu()
    dev = float(((obj - obj_c).abs() / obj_c.abs()).max())
    log(f"  SA vs classical accBCD (s=1): max rel objective deviation "
        f"{dev:.3e} (bar 1e-3)")
    if not dev <= 1e-3:
        raise AssertionError(f"SA and classical traces differ: {dev:.3e}")

    # Steady state: five more solves, untraced, host clock around each.
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.solve(problem, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / outer * 1e3)
    log(f"  steady solves: ms per outer iteration "
        f"{' '.join(f'{w:.4f}' for w in walls)} (median "
        f"{sorted(walls)[2]:.4f})")

    # Where each outer iteration's time goes: CUDA events around the
    # engine's phases and the kernels inside them, on one more solve.
    timer = PhaseTimer()
    prog = sa_lasso._ACC_PROGRAM
    wrapped = dataclasses.replace(
        prog, **{k: timer.wrap(k, getattr(prog, k)) for k in
                 ("assemble", "reduce", "inner", "defer", "finalize")})
    saved = (engine.sample_all, sa_lasso.gram_local,
             sa_inner.sa_inner_loop, sa_lasso.deferred_steps)
    engine.sample_all = timer.wrap("sample", saved[0])
    sa_lasso.gram_local = timer.wrap("gram (cat + kernel)", saved[1])
    sa_inner.sa_inner_loop = timer.wrap("sa_inner kernel", saved[2])
    sa_lasso.deferred_steps = timer.wrap("deferred GEMVs", saved[3])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_program(wrapped, problem, cfg)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        (engine.sample_all, sa_lasso.gram_local, sa_inner.sa_inner_loop,
         sa_lasso.deferred_steps) = saved
    tot = timer.totals_ms()
    split = {
        "sample (threefry + sort)": tot["sample"],
        "gather Y = A[:, blocks]": tot["assemble"]
        - tot["gram (cat + kernel)"],
        "gram (cat + kernel)": tot["gram (cat + kernel)"],
        "reduce (G, P views)": tot["reduce"],
        "sa_inner kernel": tot["sa_inner kernel"],
        "inner rest (gather z, index_add)": tot["inner"]
        - tot["sa_inner kernel"],
        "deferred GEMVs": tot["deferred GEMVs"],
        "objective stitching": tot["defer"] - tot["deferred GEMVs"],
        "finalize": tot["finalize"],
    }
    log(f"  where the time goes (device time per outer iteration, traced "
        f"solve wall {wall2 / outer * 1e3:.4f} ms/outer):")
    for k, v in split.items():
        log(f"    {k:36s} {v / outer:.4f} ms")
    return launches


# ---------------------------------------------------------------------------
# Phase 3: f64 on the card against the CPU.
# ---------------------------------------------------------------------------

def phase_f64():
    import torch
    from repro_torch import api
    from repro_torch.data.sparse import make_lasso_dataset
    from repro_torch.kernels import sa_inner
    from repro_torch.kernels.gram import gram_t

    log("phase 3: f64 epsilon-like (8192 x 512) on the card vs the CPU")
    out = {}
    for device in ("cuda", "cpu"):
        A, b, lam_max = make_lasso_dataset("epsilon-like", seed=0,
                                           device=device)
        cfg = api.SolverConfig(block_size=MU, s=S, iterations=128,
                               dtype=torch.float64, device=device)
        gram_t.launches = sa_inner.sa_inner_loop.launches = 0
        out[device] = api.solve(api.LassoProblem(A=A, b=b,
                                                 lam=0.1 * lam_max), cfg)
        if device == "cuda":
            n = (gram_t.launches, sa_inner.sa_inner_loop.launches)
            if n != (8, 8):
                raise AssertionError(f"f64 solve launches {n}, expected 8")
    o_gpu = out["cuda"].objective.cpu()
    o_cpu = out["cpu"].objective
    dev = float(((o_gpu - o_cpu).abs() / o_cpu.abs()).max())
    dx = float((out["cuda"].x.cpu() - out["cpu"].x).abs().max())
    log(f"  max rel objective deviation {dev:.3e}, max |dx| {dx:.3e} "
        f"(bar 1e-8)")
    if not (dev <= 1e-8 and dx <= 1e-8):
        raise AssertionError("f64 card solve differs from the CPU solve")


# ---------------------------------------------------------------------------
# Phases 4-6: the sparse paths.
# ---------------------------------------------------------------------------

def sparse_coo_on_card(m, n, f, gen):
    """Duplicate-free COO triplets of an (m, n) matrix of density about f
    with standard normal values, made on the card by the data makers'
    recipe: uniform nonzero positions, at least one nonzero per column."""
    import torch
    keys = torch.unique(torch.randint(0, m * n, (round(m * n * f),),
                                      generator=gen, device="cuda"))
    rows, cols = keys // n, keys % n
    del keys
    empty = torch.nonzero(torch.bincount(cols, minlength=n) == 0).flatten()
    rows = torch.cat([rows, torch.randint(0, m, (empty.numel(),),
                                          generator=gen, device="cuda")])
    cols = torch.cat([cols, empty])
    return rows, cols, torch.randn(rows.numel(), generator=gen,
                                   device="cuda")


def news20_problem(seed: int):
    """A sparse linear SVM-L1 at the shape of LIBSVM news20.binary, made
    on the card by the make_svm_dataset recipe: a planted unit w and
    b = sign(A w + 0.1 noise)."""
    import torch
    from repro_torch.api import SparseOperand, SVMProblem
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    A = SparseOperand.from_coo(*sparse_coo_on_card(M_NEWS, N_NEWS, F_NEWS,
                                                   gen), (M_NEWS, N_NEWS))
    w = torch.randn(N_NEWS, generator=gen, device="cuda")
    w /= torch.linalg.vector_norm(w)
    b = torch.sign(A.matvec(w) + 0.1 * torch.randn(M_NEWS, generator=gen,
                                                   device="cuda"))
    b[b == 0] = 1.0
    return SVMProblem(A=A, b=b, lam=1.0, loss="l1")


def url_problem(seed: int):
    """A sparse Lasso at the shape of LIBSVM url, made on the card by the
    make_lasso_dataset recipe with k_sparse = K_URL: planted K_URL-sparse
    x, noise 0.1, lam = 0.1 ||A^T b||_inf."""
    import torch
    from repro_torch.api import LassoProblem, SparseOperand
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    A = SparseOperand.from_coo(*sparse_coo_on_card(M_URL, N_URL, F_URL,
                                                   gen), (M_URL, N_URL))
    x_true = torch.zeros(N_URL, device="cuda")
    x_true[torch.randperm(N_URL, generator=gen, device="cuda")[:K_URL]] = \
        torch.randn(K_URL, generator=gen, device="cuda")
    b = A.matvec(x_true) + 0.1 * torch.randn(M_URL, generator=gen,
                                             device="cuda")
    return LassoProblem(A=A, b=b, lam=0.1 * float(A.rmatvec(b).abs().max()))


def counters():
    from repro_torch.kernels import sa_inner, spmm, svm_inner
    from repro_torch.kernels.gram import gram_t
    return {"gram": gram_t, "sa_inner": sa_inner.sa_inner_loop,
            "spmm": spmm.ell_spmm, "svm_inner": svm_inner.svm_inner_loop}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_trace(obj, obj_c, what, descent: bool):
    """A finite trace that falls (by at most 1e-2 of its start at a step
    for an accelerated method; not at all beyond roundoff for dual
    descent) and matches the classical trace within rel 1e-3."""
    import torch
    steps = obj[1:] - obj[:-1]
    scale = float(obj.abs().max())
    rise = float(steps.max()) / scale
    log(f"  {what}: objective {float(obj[0]):.6g} -> {float(obj[-1]):.6g}; "
        f"largest one-step rise {rise:.3e} of max |objective|")
    bar = 1e-5 if descent else 1e-2
    if not (torch.isfinite(obj).all() and obj[-1] < obj[0] and rise < bar):
        raise AssertionError(f"{what}: trace not finite and falling")
    dev = float(((obj - obj_c).abs()
                 / torch.clamp(obj_c.abs(), min=1e-3 * scale)).max())
    log(f"  {what}: SA vs classical (s=1) max rel deviation {dev:.3e} "
        f"(bar 1e-3)")
    if not dev <= 1e-3:
        raise AssertionError(f"{what}: SA and classical traces differ")


def solve_counted(problem, cfg, want):
    """The main path of a phase: one solve with every count set to 0 just
    before and read just after; raises unless they equal ``want``."""
    import torch
    from repro_torch import api
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(problem, cfg)
    obj = res.objective.cpu()
    wall = time.perf_counter() - t0
    got = read_counts()
    outer = cfg.outer_iterations
    log(f"  launches in the solve: {got} (expected {want})")
    log(f"  wall {wall:.4f} s, {wall / outer * 1e3:.4f} ms per outer "
        f"iteration (first solve); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; inner_impl "
        f"{res.aux['inner_impl']}, spmm_impl {res.aux.get('spmm_impl')}")
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    if (res.aux["inner_impl"], res.aux.get("spmm_impl")) != ("cuda", "cuda"):
        raise AssertionError("the solve did not report the CUDA kernels")
    return res, obj, got


def steady(problem, cfg, n=5):
    import torch
    from repro_torch import api
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.solve(problem, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / cfg.outer_iterations * 1e3)
    log(f"  steady solves: ms per outer iteration "
        f"{' '.join(f'{w:.4f}' for w in walls)} (median "
        f"{sorted(walls)[n // 2]:.4f})")


def traced(prog, problem, cfg, patches):
    """One more solve of ``prog`` with CUDA events around its callbacks and
    around each (owner, attribute, label) of ``patches``; returns the
    PhaseTimer and the solve's wall time."""
    import dataclasses
    import torch
    from repro_torch.core import engine
    timer = PhaseTimer()
    wrapped = dataclasses.replace(
        prog, **{k: timer.wrap(k, getattr(prog, k)) for k in
                 ("assemble", "reduce", "inner", "defer", "finalize")})
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for (o, a, label), (_, _, fn) in zip(patches, saved):
        setattr(o, a, timer.wrap(label, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_program(wrapped, problem, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    return timer, wall


def log_split(split, outer, wall):
    log(f"  where the time goes (device time per outer iteration, traced "
        f"solve wall {wall / outer * 1e3:.4f} ms/outer):")
    for k, v in split.items():
        log(f"    {k:36s} {v / outer:.4f} ms")


def spmm_row(args, kw):
    """The spmm kernel row on the arguments the main path gave it: error
    and time against the plain version, ``torch.sparse.mm`` on a CSR
    tensor of the same rows, and the bound from the slots this call
    reads (active nonzeros, the distinct D rows they touch)."""
    import torch
    from repro_torch.kernels.spmm import ell_spmm
    from repro_torch.kernels.spmm.ref import ell_spmm_ref
    vals, idx, blocks, D = args
    ell_block = kw.get("ell_block", 8)
    (R, K), (C, Q) = vals.shape, D.shape
    active = torch.arange(K, device="cuda")[None, :] \
        < blocks[:, None] * ell_block
    nnz = int(active.sum())
    touched = int(torch.unique(idx[active]).numel())
    isz = D.element_size()
    nbytes = nnz * (4 + isz) + R * 4 + touched * Q * isz + R * Q * isz
    b, why = bound_ms(nbytes, 2.0 * nnz * Q)
    out = ell_spmm(*args, **kw)
    err = check_close(f"spmm on the path's inputs (R={R} K={K} C={C} "
                      f"Q={Q}, {nnz} active slots)", out,
                      ell_spmm_ref(vals, idx, D), 1e-4, 1e-4)
    crow = torch.zeros(R + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(active.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, idx[active].to(torch.int64),
                                  vals[active], size=(R, C))
    lib_err = float((torch.sparse.mm(csr, D) - out).abs().max())
    row = {"name": "spmm", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spmm.cu",
           "replaces": "src/repro/kernels/spmm/kernel.py:62",
           "max_abs_err": err,
           "ms": time_ms(lambda: ell_spmm(*args, **kw), 50, 3),
           "plain_ms": time_ms(lambda: ell_spmm_ref(vals, idx, D), 3, 1),
           "bound_ms": b, "bound_by": why,
           "library_ms": time_ms(lambda: torch.sparse.mm(csr, D), 50, 3)}
    log(f"  spmm at this shape: {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f}, torch.sparse.mm {row['library_ms']:.4f} "
        f"[max abs diff {lib_err:.2e}], bound {b:.5f} ms by {why}: "
        f"{nbytes / 1e6:.2f} MB, {2.0 * nnz * Q / 1e6:.2f} MFLOP)")
    return row


def svm_inner_row(args, kw):
    """The svm_inner kernel row on the arguments the main path gave it."""
    import torch
    from repro_torch.kernels.svm_inner import svm_inner_loop
    from repro_torch.kernels.svm_inner.ref import svm_inner_ref
    G, proj, b_sel, a_vals, idx = args
    s, mu = proj.shape
    smu, isz = s * mu, G.element_size()
    th, dl = svm_inner_loop(*args, **kw)
    th_r, dl_r = svm_inner_ref(*args, kw["gamma"], kw["nu"],
                               kw["power_iters"])
    err = check_close(f"svm_inner on the path's inputs (s={s}, mu={mu}) "
                      f"theta", th, th_r, 1e-4, 1e-5)
    check_close("svm_inner on the path's inputs dual increments", dl, dl_r,
                1e-4, 1e-4)
    nbytes = (smu * smu + 3 * smu + smu + s) * isz + smu * 8
    b, why = bound_ms(nbytes, svm_inner_flops(s, mu, kw["power_iters"]))
    row = {"name": "svm_inner", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/svm_inner.cu",
           "replaces": "src/repro/kernels/svm_inner/kernel.py:91",
           "max_abs_err": err,
           "ms": time_ms(lambda: svm_inner_loop(*args, **kw), 200, 5),
           "plain_ms": time_ms(lambda: svm_inner_ref(
               *args, kw["gamma"], kw["nu"], kw["power_iters"]), 3, 1),
           "bound_ms": b, "bound_by": why, "library_ms": None}
    log(f"  svm_inner at this shape: {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f}, bound {b:.6f} ms by {why})")
    return row


def phase_svm():
    import dataclasses
    import importlib
    import torch
    from repro_torch import api
    from repro_torch.core import engine, sparse_exec
    from repro_torch.kernels import spmm, svm_inner
    # (the package's name sa_svm is the solver function, as in repro)
    sa_svm = importlib.import_module("repro_torch.core.sa_svm")

    log(f"phase 4: sparse SVM path, news20.binary shape {M_NEWS} x "
        f"{N_NEWS} f32, SVM-L1 SA-BDCD mu=1 s={S_SVM} H={H_SVM}")
    t0 = time.perf_counter()
    problem = news20_problem(seed=0)
    torch.cuda.synchronize()
    A = problem.A
    log(f"  operand made on the card in {time.perf_counter() - t0:.2f} s: "
        f"nnz {A.nnz}, row ELL {tuple(A.row_cols.shape)}, column ELL "
        f"{tuple(A.col_rows.shape)}")
    cfg = api.SolverConfig(block_size=1, s=S_SVM, iterations=H_SVM)
    outer = cfg.outer_iterations
    res, obj, launches = solve_counted(
        problem, cfg, {"gram": 0, "sa_inner": 0, "spmm": outer,
                       "svm_inner": outer})
    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    check_trace(obj, classical.objective.cpu(), "dual trace", descent=True)
    steady(problem, cfg)

    prog = sa_svm._BDCD_PROGRAM
    timer, wall = traced(prog, problem, cfg, [
        (engine, "sample_all", "sample"),
        (type(A), "gather_rows", "take"),
        (sparse_exec, "_fused_rhs", "densify"),
        (spmm, "ell_spmm", "spmm"),
        (svm_inner, "svm_inner_loop", "svm_inner")])
    tot = timer.totals_ms()
    log_split({
        "sample (threefry + sort)": tot["sample"],
        "take (gather ELL rows)": tot["take"],
        "densify D = [Y^T | x]": tot["densify"],
        "spmm kernel": tot["spmm"],
        "assemble rest": tot["assemble"] - tot["take"] - tot["densify"]
        - tot["spmm"],
        "reduce (+ gamma I)": tot["reduce"],
        "svm_inner kernel": tot["svm_inner"],
        "inner rest (gather b, alpha)": tot["inner"] - tot["svm_inner"],
        "alpha / x updates + trace": tot["defer"],
        "finalize": tot["finalize"],
    }, outer, wall)
    rows = {"spmm": spmm_row(*timer.first["spmm"]),
            "svm_inner": svm_inner_row(*timer.first["svm_inner"])}
    return rows, launches


def phase_url():
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core import engine, sa_lasso, sparse_exec
    from repro_torch.kernels import sa_inner, spmm

    log(f"phase 5: sparse Lasso path, url shape {M_URL} x {N_URL} f32, "
        f"SA-accBCD mu={MU} s={S} H={H}")
    t0 = time.perf_counter()
    problem = url_problem(seed=0)
    torch.cuda.synchronize()
    A = problem.A
    ell_bytes = sum(t.numel() * t.element_size() for t in (
        A.row_cols, A.row_vals, A.row_blocks, A.col_rows, A.col_vals,
        A.col_blocks))
    log(f"  operand made on the card in {time.perf_counter() - t0:.2f} s: "
        f"nnz {A.nnz}, row ELL {tuple(A.row_cols.shape)}, column ELL "
        f"{tuple(A.col_rows.shape)}, {ell_bytes / 1e9:.3f} GB of ELL arrays")
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations
    res, obj, launches = solve_counted(
        problem, cfg, {"gram": 0, "sa_inner": outer, "spmm": outer,
                       "svm_inner": 0})
    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    check_trace(obj, classical.objective.cpu(), "objective", descent=False)
    del classical
    steady(problem, cfg)

    timer, wall = traced(sa_lasso._ACC_PROGRAM, problem, cfg, [
        (engine, "sample_all", "sample"),
        (type(A), "gather_cols", "take"),
        (sparse_exec, "_fused_rhs", "densify"),
        (spmm, "ell_spmm", "spmm"),
        (sa_inner, "sa_inner_loop", "sa_inner"),
        (sa_lasso, "deferred_steps", "deferred")])
    tot = timer.totals_ms()
    log_split({
        "sample (threefry + sort)": tot["sample"],
        "take (gather ELL columns)": tot["take"],
        "densify D = [Y | ytil | ztil]": tot["densify"],
        "spmm kernel": tot["spmm"],
        "assemble rest": tot["assemble"] - tot["take"] - tot["densify"]
        - tot["spmm"],
        "reduce (G, P views)": tot["reduce"],
        "sa_inner kernel": tot["sa_inner"],
        "inner rest (gather z, index_add)": tot["inner"] - tot["sa_inner"],
        "deferred scatter-adds": tot["deferred"],
        "objective stitching": tot["defer"] - tot["deferred"],
        "finalize": tot["finalize"],
    }, outer, wall)
    spmm_row(*timer.first["spmm"])
    return launches


def phase_f64_sparse():
    import torch
    from repro_torch import api
    from repro_torch.data.sparse import make_lasso_dataset, make_svm_dataset

    log("phase 6: f64 sparse solves on the card vs the CPU (SVM rcv1-like "
        "mu=4 s=8 H=256; Lasso news20-like mu=8 s=16 H=128)")
    out = {}
    for device in ("cuda", "cpu"):
        A, b = make_svm_dataset("rcv1-like", 0, as_operand=True,
                                device=device)
        zero_counts()
        svm = api.solve(api.SVMProblem(A=A, b=b), api.SolverConfig(
            block_size=4, s=8, iterations=256, dtype=torch.float64,
            device=device))
        got_svm = read_counts()
        A, b, lam_max = make_lasso_dataset("news20-like", 0, as_operand=True,
                                           device=device)
        zero_counts()
        lasso = api.solve(api.LassoProblem(A=A, b=b, lam=0.1 * lam_max),
                          api.SolverConfig(block_size=MU, s=S,
                                           iterations=128,
                                           dtype=torch.float64,
                                           device=device))
        got_lasso = read_counts()
        if device == "cuda":
            want_svm = {"gram": 0, "sa_inner": 0, "spmm": 32,
                        "svm_inner": 32}
            want_lasso = {"gram": 0, "sa_inner": 8, "spmm": 8,
                          "svm_inner": 0}
            if (got_svm, got_lasso) != (want_svm, want_lasso):
                raise AssertionError(f"f64 sparse launches {got_svm}, "
                                     f"{got_lasso}")
        out[device] = (svm, lasso)
    for i, what in enumerate(("SVM", "Lasso")):
        g, c = out["cuda"][i], out["cpu"][i]
        o_g, o_c = g.objective.cpu(), c.objective
        dev = float(((o_g - o_c).abs() / o_c.abs()).max())
        dx = float((g.x.cpu() - c.x).abs().max())
        extra = float((g.aux["alpha"].cpu() - c.aux["alpha"]).abs().max()) \
            if what == "SVM" else 0.0
        log(f"  {what}: max rel objective deviation {dev:.3e}, max |dx| "
            f"{dx:.3e}{f', max |dalpha| {extra:.3e}' if extra else ''} "
            f"(bar 1e-8; scatter-adds are atomics on the card)")
        if not (dev <= 1e-8 and dx <= 1e-8 and extra <= 1e-8):
            raise AssertionError(f"f64 sparse {what} card solve differs "
                                 f"from the CPU solve")


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)}; {smi}; "
        f"count {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    rows = phase_kernels()
    launches = phase_main_path()
    torch.cuda.empty_cache()
    phase_f64()
    svm_rows, svm_launches = phase_svm()
    torch.cuda.empty_cache()
    phase_url()
    torch.cuda.empty_cache()
    phase_f64_sparse()

    rows.update(svm_rows)
    for name, n in launches.items():
        rows[name]["launches"] = n
    for name in svm_rows:
        rows[name]["launches"] = svm_launches[name]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
