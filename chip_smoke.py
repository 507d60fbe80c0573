#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` and

1. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes, and times kernel, plain version
   and (for ``gram``) ``torch.matmul`` with CUDA events;
2. drives the main path — ``repro_torch.api.solve`` on a dense Lasso at the
   shape of LIBSVM ``epsilon`` (400,000 x 2,000, f32), SA-accBCD with
   mu = 8, s = 16, H = 512 — checks that ``gram`` and ``sa_inner`` each
   launched ceil(H/s) = 32 times, that the objective is finite and falls,
   and that the classical accBCD (s = 1) gives the same trace within rel
   1e-3; then times where each outer iteration's time goes;
3. runs an f64 solve on the card (epsilon-like, 8192 x 512) through the
   same kernels and holds it to the CPU solve within 1e-8.

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


def phase_kernels():
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.gram import gram_t
    from repro_torch.kernels.gram.ref import gram_t_ref
    from repro_torch.kernels.sa_inner import sa_inner_loop
    from repro_torch.kernels.sa_inner.ops import _declare as inner_declare
    from repro_torch.kernels.sa_inner.ref import sa_inner_ref

    log("phase 1: kernels against their plain versions")
    t0 = time.perf_counter()
    _build.build(["gram", "sa_inner"])      # one nvcc per source, together
    log(f"  built gram, sa_inner in {time.perf_counter() - t0:.1f} s")
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
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms,"
            f" bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    torch.cuda.synchronize()
    return rows


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
    """CUDA event pairs around named callables: device time per phase."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
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
    from repro_torch.kernels.gram import gram_t

    log(f"phase 2: main path, dense Lasso {M_EPS} x {N_EPS} f32, "
        f"SA-accBCD mu={MU} s={S} H={H}")
    problem = epsilon_problem(seed=0)
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations

    gram_t.launches = 0
    sa_inner.sa_inner_loop.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(problem, cfg)
    obj = res.objective.cpu()
    wall = time.perf_counter() - t0
    launches = {"gram": gram_t.launches,
                "sa_inner": sa_inner.sa_inner_loop.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the solve: {launches} (expected {outer} each)")
    log(f"  objective {float(obj[0]):.6g} -> {float(obj[-1]):.6g}; "
        f"inner_impl {res.aux['inner_impl']}")
    log(f"  wall {wall:.4f} s, {wall / outer * 1e3:.4f} ms per outer "
        f"iteration; peak device memory {peak / 2**30:.3f} GiB")
    if launches != {"gram": outer, "sa_inner": outer}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{outer} of each kernel")
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
    phase_f64()

    for name, n in launches.items():
        rows[name]["launches"] = n
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
