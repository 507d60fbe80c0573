#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` and

1. builds the kernels (one ``nvcc`` per source, together; ptxas's
   registers and spills of each ``gram``, ``flash_attention``, ``spmm``
   and ``svm_inner`` instance are printed, and a spill in a ``wgmma``
   body fails), holds each kernel against its plain PyTorch version on
   the card, at the main paths' shapes and at edge shapes, and times
   ``gram`` and ``sa_inner`` with their plain versions and (``gram``)
   ``torch.matmul`` with CUDA events. ``gram`` routes by
   ``dispatch.gram_route``: each case checks the body it took (``wgmma``
   for f32 where TMA can describe the operands, else ``simt``: f64, and
   f32 views at an unaligned start; a non-contiguous view is copied
   first), that two calls give the same bits, and the C side's tile plan
   and shared-memory formula against ``kernels/dispatch.py``; the path's
   call Y^T [Y | ytil | ztil] is timed with both bodies and
   ``torch.matmul`` (TF32 off), and a 1xTF32 emulation of it must miss
   K1's bar there. ``flash_attention`` runs on bf16 views one element
   into their storage, which it copies first. ``spmm`` (every case twice,
   bit for bit) and ``svm_inner`` (both bodies where the ``warp`` body
   serves, on both sides of its caps) run over their sweeps. A latency
   probe (``sync_step_probe`` in ``csrc/sa_inner.cu``) times one shuffle
   reduction and block barrier, the latency bound of ``sa_inner`` and
   ``svm_inner`` per dependent step;
2. drives the dense Lasso path — ``repro_torch.api.solve`` on a dense
   Lasso at the shape of LIBSVM ``epsilon`` (400,000 x 2,000, f32),
   SA-accBCD with mu = 8, s = 16, H = 512 — checks that ``gram`` (all
   through its ``wgmma`` body) and ``sa_inner`` each launched ceil(H/s) =
   32 times, that the objective is finite and falls, and that the
   classical accBCD (s = 1) gives the same trace within rel 1e-3; then
   times where each outer iteration's time goes;
3. runs an f64 solve on the card (epsilon-like, 8192 x 512) through the
   same kernels (``gram``'s ``simt`` body) and holds it to the CPU solve
   within 1e-8;
4. drives the sparse SVM path — ``api.solve`` on a linear SVM-L1 at the
   shape of LIBSVM ``news20.binary`` (19,996 x 1,355,191, ~9.1 M nonzeros,
   a SparseOperand made on the card), SA-BDCD mu = 1, s = 64, H = 4096 —
   checks 64 launches each of ``spmm`` and ``svm_inner`` (all of its
   ``warp`` body) and none of ``gram``, a finite falling dual trace and
   the classical BDCD (s = 1) within rel 1e-3, times the phases, and
   times ``spmm`` and ``svm_inner`` on the inputs the solve gave them
   against their plain versions, ``spmm`` in turns with
   ``torch.sparse.mm`` and ``svm_inner`` beside its ``block`` body;
5. drives the sparse Lasso path — SA-accBCD mu = 8, s = 16, H = 512 on a
   sparse Lasso at the shape of LIBSVM ``url`` (2,396,130 x 3,231,961,
   ~279 M nonzeros) — with the same checks (32 launches each of ``spmm``
   and ``sa_inner``, none of ``gram``) and phase split;
6. runs f64 sparse solves on the card (SVM rcv1-like, Lasso news20-like)
   through ``spmm``, ``svm_inner`` and ``sa_inner`` and holds them to the
   CPU solves within 1e-8;
7. holds ``flash_attention`` against its plain version at every case of
   tests/test_kernels.py's ATTN_CASES and more (ragged lengths, windows,
   decode-like Sq = 1, bidirectional, strided views, stablelm-12b's
   D = 160), at f32 (atol 2e-3) and bf16 (atol 2e-2), checking that each
   call took the body ``dispatch.flash_attention_route`` names (bf16 at
   D = 64 and 128: ``wgmma``; the rest: ``simt``), checks both bodies'
   tile sizes and shared-memory formulas against ``kernels/dispatch.py``,
   and one gradient against the plain version's autograd;
8. drives the LM prefill — ``LM.prefill`` of llama3-8b at full width
   (32 layers, 8.03 B parameters, bf16, random from a seed) on B = 1,
   S = 8192 — checks 32 launches of ``flash_attention``, all of its
   ``wgmma`` body, and none of the other kernels and finite logits,
   times the steady prefill and where its time goes, then holds the
   kernel on the q/k/v of the first layer against the plain version
   (bf16 within one rounding step of the output, rtol 2^-7 and atol
   4e-3; the same q/k/v in f32 within atol 2e-4) and times it with the
   plain version, its ``simt`` body at bf16, its ``wgmma`` body without
   ping-pong and ``scaled_dot_product_attention``;
9. drives serving — ``BatchedServer.generate`` with batch 8, prompt 128,
   generate 32 on the same model — checks that it launched no kernel
   (decode attention is plain PyTorch, as in repro), times the decode
   steps and where their time goes, and holds the teacher-forced decode
   logits at the last prompt position to ``prefill``'s within atol 0.12,
   rtol 0.05;
10. runs tinyllama-1.1b widths cut to 2 layers at f32, B = 2, S = 512, on
   the card (through ``flash_attention``) and on the CPU (plain), and
   holds the logits within rel 1e-4 and the generated tokens equal.

Any failed check raises, so the exit code is non-zero. The last lines
are the kernels' JSON line (for each of ``gram``, ``sa_inner``, ``spmm``,
``svm_inner`` and ``flash_attention``: its launches on its main path,
its error against the plain version, its time through the wrapper
(``ms``, CUDA events over back-to-back calls, host work included), its
device time alone (``device_ms``: the summed kernel durations of a
torch.profiler trace of back-to-back calls; ``sa_inner``'s on the epsilon
path's inputs, ``spmm``'s and ``svm_inner``'s on news20.binary's), the
plain version's time, the bound and, where one PyTorch call computes the
same function, that call's time), the card's name and power limit as
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

# The latency probe's time per dependent step, from phase 1.
PROBE = {}

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, TF32 and bf16 on the dense tensor cores, and HBM3 bandwidth.
F32_FLOPS = 67e12
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

M_EPS, N_EPS = 400_000, 2_000           # LIBSVM epsilon
# Phase 2's label of K1's call, Y^T [Y | ytil | ztil] read in place.
GRAM_PHASE = "gram kernel (Y^T [Y | V], no cat)"
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

# The LM serving path: llama3-8b at full width (32 layers, bf16). The
# prefill is cut from repro's prefill_32k shape (configs.SHAPES; B 32,
# S 32,768) to B 1 at Llama 3's published context of 8192, for the run's
# time limit.
LLAMA = "llama3-8b"
PREFILL_B, PREFILL_S = 1, 8192
SERVE_B, SERVE_P, SERVE_G = 8, 128, 32
# f32 card vs CPU: tinyllama-1.1b widths cut to 2 layers (~0.9 GB f32).
TINY, TINY_LAYERS, TINY_B, TINY_S = "tinyllama-1.1b", 2, 2, 512
# (B, Hq, Hkv, Sq, Sk, D, causal, window): tests/test_kernels.py
# ATTN_CASES, then ragged keys, a ragged window, 4:1 GQA at D = 128 over a
# partial last tile, a bidirectional Sq < Sk, and stablelm-12b's heads
# (32 over 8 of D = 160) over a partial last tile.
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 2, 256, 256, 64, True, 64),
    (1, 4, 4, 100, 100, 32, True, 0),
    (1, 2, 1, 1, 384, 64, True, 0),
    (1, 2, 1, 1, 384, 64, True, 128),
    (2, 2, 2, 64, 64, 128, False, 0),
    (2, 4, 2, 100, 228, 32, True, 0),
    (1, 8, 2, 300, 300, 128, True, 100),
    (1, 32, 8, 1000, 1000, 128, True, 0),
    (1, 4, 1, 128, 256, 64, False, 0),
    (1, 32, 8, 520, 520, 160, True, 0),
]


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


def device_ms(fn, n: int = 50):
    """Device time per call of ``fn``: from a torch.profiler trace (the
    same machinery as ``device_profile``) of ``n`` back-to-back calls,
    the mean duration of each kernel ``fn`` launches, summed over its
    kernels, so the host's launch work between them is left out. Means,
    not totals over ``n``: a trace can miss a call's record (the first,
    in some runs), and that is logged. None when it holds no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "device_ms_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_name.setdefault(e["name"], []).append(float(e["dur"]))
    if not by_name:
        return None
    counts = sorted(len(d) for d in by_name.values())
    if counts != [n] * len(counts):
        log(f"  (device time: the trace holds {counts} records of "
            f"{len(counts)} kernel(s) over {n} calls)")
    return sum(sum(d) / len(d) for d in by_name.values()) / 1e3


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def bound_ms(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    """(least time in ms, what bounds it) on the published peaks: bytes at
    the HBM rate, operations at ``peak_flops`` (their type's rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
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


def log_ptxas(name: str) -> None:
    """ptxas's registers and spills for each kernel of library ``name``,
    from the build this process ran (-Xptxas -v)."""
    import re
    from repro_torch.kernels import _build
    out = _build.BUILD_LOG.get(name)
    if out is None:
        log(f"  {name}: built before this process; no ptxas report")
        return
    entry, spill = None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            dim = re.search(r"Li(\d+)E", entry)
            dim = dim.group(1) if dim else "?"
            prec = "f64" if re.search(r"kernelId", entry) else "f32"
            if name == "spmm":
                body = f"{prec} col_groups={dim}"
            elif name == "svm_inner":
                body = (f"warp {prec} rows/lane={dim}" if "warp" in entry
                        else f"block {prec} G " + (
                            "smem" if "Lb1E" in entry else "global"))
            elif name == "gram":
                kind = re.search(r"(gram_[a-z]+_kernel)I(\w)", entry)
                prec = "f64" if kind.group(2) == "d" else "f32"
                body = (f"{kind.group(1)} N={dim}" if "wgmma" in entry
                        else f"{kind.group(1)} {prec}")
            else:
                body = ("wgmma bf16" if "wgmma" in entry else
                        "simt f32" if "kernelIf" in entry else
                        "simt bf16") + f" D={dim}"
            log(f"  ptxas {name} {body}: {m.group(1)} registers; {spill}")
            if "wgmma" in entry and ", 0 bytes spill stores" not in spill:
                raise AssertionError(f"ptxas: {name} {body} spills: {spill}")
            entry = None


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


def gram_case(name, fn, want, route, rtol, atol):
    """One call of K1 against its plain version: the body it took must be
    ``route``, and a second call must give the same bits."""
    import torch
    from repro_torch.kernels.gram import gram_t
    before = dict(gram_t.route_launches)
    got = fn()
    torch.cuda.synchronize()
    took = [r for r, n in gram_t.route_launches.items() if n != before[r]]
    if took != [route]:
        raise AssertionError(f"gram {name}: took {took}, route {route}")
    err = check_close(f"gram {name} ({route})", got, want, rtol, atol)
    if not torch.equal(got, fn()):
        raise AssertionError(f"gram {name}: two calls differ")
    return err


def phase_gram(gen):
    """K1: both bodies against the plain version at the main path's call
    and at edge shapes, the C side's plan against dispatch's, and the
    times of the path's call."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.gram import gram_fused, gram_t
    from repro_torch.kernels.gram.ops import _declare, _launch
    from repro_torch.kernels.gram.ref import (gram_fused_ref, gram_t_ref,
                                              gram_t_tf32)
    lib = _build.load("gram", _declare)
    log_ptxas("gram")
    got = (lib.gram_wgmma_tile_p(), lib.gram_wgmma_block_k(),
           lib.gram_wgmma_max_vecs())
    want = (dispatch.GRAM_WGMMA_TILE_P, dispatch.GRAM_WGMMA_BLOCK_K,
            dispatch.GRAM_WGMMA_MAX_VECS)
    if got != want:
        raise AssertionError(f"gram wgmma constants: C {got} vs {want}")
    for q in (1, 24, 25, 65, 72, 73, 130, 136, 137, 514):
        if lib.gram_wgmma_tile_n(q) != dispatch.gram_tile_n(q):
            raise AssertionError(f"gram tile of q = {q} differs")
    for same, p, q in ((1, 128, 130), (1, 64, 65), (1, 512, 514),
                       (0, 128, 130), (1, 4, 6), (1, 128, 8)):
        if bool(lib.gram_wgmma_shared(same, p, q)) != \
                dispatch.gram_wgmma_shared(bool(same), p, q):
            raise AssertionError(f"gram sharing differs at {(same, p, q)}")
    for tn in dispatch.GRAM_WGMMA_TILE_NS:
        for sh in (False, True):
            c_bytes = lib.gram_wgmma_smem_bytes(tn, int(sh))
            rings = (lib.gram_wgmma_raw_stages(int(sh)),
                     lib.gram_wgmma_op_stages(int(sh)))
            if c_bytes != dispatch.gram_wgmma_smem_bytes(tn, sh) or \
                    rings != (dispatch.gram_wgmma_raw_stages(sh),
                              dispatch.gram_wgmma_op_stages(sh)):
                raise AssertionError(f"gram smem layout differs at {tn}, "
                                     f"{sh}: C {c_bytes}")
    f32, f64 = torch.float32, torch.float64

    def bar(m):
        return 2e-4, 2e-4 * math.sqrt(m)

    # The path's call: Y (m, s mu) against [Y | ytil | ztil], the vectors
    # as the (2, m) stack the solver passes.
    m, p, k = M_EPS, S * MU, 2
    Y = torch.randn(m, p, generator=gen, device="cuda")
    V = torch.randn(k, m, generator=gen, device="cuda")
    want = gram_fused_ref(Y, V)
    err = gram_case(f"Y^T [Y | V] ({m}, {p}, k={k})",
                    lambda: gram_fused(Y, V), want, "wgmma", *bar(m))
    W = torch.cat([Y, V.T], dim=1)
    emu = float((gram_fused(Y, V) - gram_t_tf32(Y, W)).abs().max())

    def bar_ratio(got):
        # max over entries of |got - want| / (atol + rtol |want|): above 1
        # where check_close's torch.allclose fails
        rtol, atol = bar(m)
        return float(((got - want).abs() / (atol + rtol * want.abs())).max())
    ratio, one_ratio = bar_ratio(gram_fused(Y, V)), \
        bar_ratio(gram_t_tf32(Y, W, passes=1))
    log(f"  gram path call vs the 3xTF32 emulation: max_abs_err {emu:.3e};"
        f" max err / limit: the kernel {ratio:.4f}, the 1xTF32 emulation "
        f"{one_ratio:.4f}")
    # The bar must tell the kernel from one that drops the lo terms.
    if one_ratio <= 1.0:
        raise AssertionError(f"gram: 1xTF32 meets K1's bar at m = {m}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.matmul would time TF32, not f32")
    ms = time_ms(lambda: gram_fused(Y, V), 20)
    row = {
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:48",
        "max_abs_err": err, "ms": ms,
        "plain_ms": time_ms(lambda: gram_fused_ref(Y, V), 20),
        "library_ms": time_ms(lambda: torch.matmul(Y.T, W), 20)}
    # Least time for the same f32-accurate work: Y and V read once, the
    # output written once; three TF32 products on the tensor cores for
    # the entries the function needs: G's upper half (it is symmetric)
    # and P.
    q = p + k
    entries = p * (p + 1) // 2 + p * k
    row["bound_ms"], row["bound_by"] = bound_ms(
        (m * p + k * m + p * q) * 4, 3 * 2.0 * m * entries, TF32_FLOPS)
    ops_ms = 3 * 2.0 * m * entries / TF32_FLOPS * 1e3
    fma = 2.0 * m * p * q / F32_FLOPS * 1e3
    row["device_ms"] = device_ms(lambda: gram_fused(Y, V), 20)
    simt_ms = time_ms(lambda: _launch(Y, Y, V, route="simt"), 20)
    cat_ms = time_ms(lambda: torch.matmul(Y.T, torch.cat([Y, V.T], 1)), 20)
    log(f"  gram path call: wgmma {ms:.4f} ms (device "
        f"{fmt_ms(row['device_ms'])}), simt body {simt_ms:.4f}, "
        f"torch.matmul {row['library_ms']:.4f} (with the cat "
        f"{cat_ms:.4f}); bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} (3xTF32 on {entries} entries at "
        f"{TF32_FLOPS / 1e12:g} TFLOP/s {ops_ms:.4f}; f32 FMA on all "
        f"{p * q} {fma:.4f})")
    # x^T y at the path's shape: q = 130 is not whole 16-byte rows, so
    # the simt body serves it.
    x, y = Y, W.contiguous()
    gram_case(f"x^T y ({m}, {p}, {q})", lambda: gram_t(x, y),
              gram_t_ref(x, y), dispatch.gram_route(f32, m, p, q), *bar(m))
    b_xy, _ = bound_ms((m * p + m * q + p * q) * 4, 2.0 * m * p * q)
    xy_ms = time_ms(lambda: gram_t(x, y), 20)
    mm_ms = time_ms(lambda: torch.matmul(x.T, y), 20)
    log(f"  gram x^T y ({m}, {p}, {q}): {xy_ms:.4f} ms, torch.matmul "
        f"{mm_ms:.4f}, f32-FMA bound {b_xy:.4f}")
    del Y, V, W, x, y, want
    # Edge shapes (f32): the fused call at s 64, mu 8 (A not shared: four
    # tiles of p and of q); the dense SVM's Y^T [Y | x] over epsilon's
    # 2,000 features; m below one 32-row stage; p = 1; x^T y at p = 257
    # (simt) and p = 256 (wgmma, the 24-wide tile); Y^T Y (A shared, no
    # vectors); more vectors than the wgmma body takes.
    for m, p, k in ((M_EPS, 512, 2), (N_EPS, 64, 1), (20, 128, 2),
                    (1000, 1, 1), (5000, 128, 0), (3000, 64, 9)):
        Y = torch.randn(m, p, generator=gen, device="cuda")
        V = torch.randn(k, m, generator=gen, device="cuda")
        route = dispatch.gram_route(f32, m, p, p + k, y_cols=p)
        if k:
            gram_case(f"Y^T [Y | V] ({m}, {p}, k={k})",
                      lambda: gram_fused(Y, V), gram_fused_ref(Y, V),
                      route, *bar(m))
        else:
            gram_case(f"Y^T Y ({m}, {p})", lambda: gram_t(Y, Y),
                      gram_t_ref(Y, Y), route, *bar(m))
    for (m, p, q), dtype in (((513, 257, 3), f32), ((513, 256, 4), f32),
                             ((513, 257, 3), f64)):
        x = torch.randn(m, p, generator=gen, device="cuda", dtype=dtype)
        y = torch.randn(m, q, generator=gen, device="cuda", dtype=dtype)
        tol = bar(m) if dtype == f32 else (1e-12, 1e-12)
        gram_case(f"{dtype} x^T y ({m}, {p}, {q})", lambda: gram_t(x, y),
                  gram_t_ref(x, y), dispatch.gram_route(dtype, m, p, q),
                  *tol)
    Y = torch.randn(8192, S * MU, generator=gen, device="cuda", dtype=f64)
    V = torch.randn(2, 8192, generator=gen, device="cuda", dtype=f64)
    gram_case("f64 Y^T [Y | V] (8192, 128, k=2)", lambda: gram_fused(Y, V),
              gram_fused_ref(Y, V), "simt", 1e-12, 1e-12)
    # f32 views TMA cannot describe: one element into fresh storage (a
    # start 4 bytes past 16-byte alignment) goes to the simt body, which
    # reads scalars; a column slice (not contiguous) is copied first and
    # keeps the wgmma body.
    m, p = 20_000, S * MU
    buf = torch.randn(m * p + 1, generator=gen, device="cuda")
    x = buf[1:].view(m, p)
    y = torch.randn(m, p, generator=gen, device="cuda")
    gram_case(f"x^T y ({m}, {p}, {p}), x at element offset 1",
              lambda: gram_t(x, y), gram_t_ref(x, y), "simt", *bar(m))
    gram_case(f"x^T x ({m}, {p}) at element offset 1", lambda: gram_t(x, x),
              gram_t_ref(x, x), "simt", *bar(m))
    w = torch.randn(m, p + 1, generator=gen, device="cuda")[:, :p]
    gram_case(f"x^T x ({m}, {p}), a column slice of rows of {p + 1}",
              lambda: gram_t(w, w), gram_t_ref(w, w), "wgmma", *bar(m))
    return row


def sync_step_ms(lib):
    """(ms per step, ms per empty launch) of ``sync_step_probe`` in
    ``csrc/sa_inner.cu``: 2^14 rounds of a shuffle reduction and a block
    barrier against none, back to back by CUDA events."""
    import ctypes
    import torch
    fn = lib.sync_step_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        rc = fn(steps, out.data_ptr(), 0, stream)
        if rc:
            raise RuntimeError(f"sync_step_probe: CUDA error {rc}")
    n = 1 << 14
    empty = time_ms(lambda: run(0), 200, 5)
    return (time_ms(lambda: run(n), 20, 2) - empty) / n, empty


def phase_kernels():
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.sa_inner import sa_inner_loop
    from repro_torch.kernels.sa_inner.ops import _declare as inner_declare
    from repro_torch.kernels.sa_inner.ref import sa_inner_ref

    log("phase 1: kernels against their plain versions")
    t0 = time.perf_counter()
    names = ["gram", "sa_inner", "spmm", "svm_inner", "flash_attention"]
    _build.build(names)                     # one nvcc per source, together
    log(f"  built {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    for name in ("flash_attention", "spmm", "svm_inner"):
        log_ptxas(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    rows["gram"] = phase_gram(gen)
    flash_offset_case(gen)

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
                "device_ms": device_ms(lambda: sa_inner_loop(*ins, **kw)),
                "bound_ms": b, "bound_by": why, "library_ms": None}

    # The latency bound of sa_inner (s = 16) and svm_inner (s = 64): the
    # inner steps form one dependent chain, each step at least one warp
    # shuffle reduction and one block barrier in a block of 16 warps.
    step, empty = sync_step_ms(lib)
    PROBE["step_ms"] = step
    log(f"  latency probe: {step * 1e3:.4f} us per step (shuffle reduction "
        f"+ block barrier, 16 warps), empty launch {empty:.4f} ms; latency "
        f"bounds sa_inner (s={S}) {S * step:.6f} ms, svm_inner "
        f"(s={S_SVM}) {S_SVM * step:.6f} ms")

    phase_spmm_sweep(gen)
    phase_svm_inner_sweep(gen)
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (device "
            f"{fmt_ms(r['device_ms'])}; plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    torch.cuda.synchronize()
    return rows


def empty_ell(R, K, dtype):
    """(vals, idx, blocks) of R ELL rows of width K with no active block
    (padded slots: index 0, value 0), made on the card."""
    import torch
    return (torch.zeros(R, K, device="cuda", dtype=dtype),
            torch.zeros(R, K, device="cuda", dtype=torch.int32),
            torch.zeros(R, device="cuda", dtype=torch.int32))


def spmm_case(name, vals, idx, blocks, D, tol):
    """One ``ell_spmm`` call against its plain version; a second call must
    give the same bits (the cluster sums in a fixed order)."""
    import torch
    from repro_torch.kernels.spmm import ell_spmm
    from repro_torch.kernels.spmm.ref import ell_spmm_ref
    got = ell_spmm(vals, idx, blocks, D)
    err = check_close(name, got, ell_spmm_ref(vals, idx, D), *tol)
    if not torch.equal(got, ell_spmm(vals, idx, blocks, D)):
        raise AssertionError(f"spmm {name}: two calls differ")
    return err


def phase_spmm_sweep(gen):
    """K4 against its plain version: the SVM path's shape (64 rows of ~455
    slots, D 1,355,191 x 65) and its classical call (R = 1, Q = 2), the
    url Lasso path's (128 of ~86, D 2,396,130 x 130), the
    test_spmm_kernel_sweep shapes, R = 1 with Q = 2, two q tiles (Q =
    300), every column-group instance at f32 and f64, rows with no slots
    and all rows empty; the C side's constants against dispatch's."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.spmm.ops import _declare
    lib = _build.load("spmm", _declare)
    got = (lib.spmm_q_tile(), lib.spmm_warps(), lib.spmm_max_splits())
    want = (dispatch.SPMM_Q_TILE, dispatch.SPMM_WARPS,
            dispatch.SPMM_MAX_SPLITS)
    if got != want:
        raise AssertionError(f"spmm constants: C {got} vs dispatch {want}")
    log(f"  spmm: {dispatch.SPMM_WARPS} warps a block, clusters of up to "
        f"{dispatch.SPMM_MAX_SPLITS}, D-row reads in flight per warp by "
        f"column groups: " + ", ".join(
            f"{g}: {lib.spmm_in_flight(g)}" for g in range(1, 9)))
    f32, f64 = torch.float32, torch.float64
    for R, C, Q, per_row, dtype, empty in (
            (64, N_NEWS, S_SVM + 1, F_NEWS * N_NEWS, f32, 0),
            (1, N_NEWS, 2, F_NEWS * N_NEWS, f32, 0),
            (S * MU, M_URL, S * MU + 2, F_URL * M_URL, f32, 0),
            (12, 40, 5, 12, f32, 0),
            (33, 128, 17, 6.4, f32, 0),
            (64, 200, 1, 100, f32, 0),
            (7, 16, 130, 6.4, f32, 0),
            (1, 50, 2, 10, f32, 0),
            (40, 3000, 300, 12, f32, 5),
            (7, 16, 130, 6.4, f64, 2),
            (S * MU, M_URL, S * MU + 2, F_URL * M_URL, f64, 0)):
        vals, idx, blocks = random_ell(R, C, per_row, gen, dtype, empty)
        D = torch.randn(C, Q, generator=gen, device="cuda", dtype=dtype)
        plan = dispatch.spmm_plan(R, idx.shape[1], Q)
        tol = (1e-4, 1e-4) if dtype == f32 else (1e-12, 1e-12)
        spmm_case(f"spmm {dtype} R={R} K={idx.shape[1]} C={C} Q={Q}"
                  f"{f' ({empty} empty rows)' if empty else ''} [col_groups "
                  f"{plan.col_groups}, q_tiles {plan.q_tiles}, splits "
                  f"{plan.splits}]", vals, idx, blocks, D, tol)
        del D
    # Every column-group instance (1-8 groups of 32), f32 and f64.
    for dtype in (f32, f64):
        tol = (1e-4, 1e-4) if dtype == f32 else (1e-12, 1e-12)
        for Q in (29, 61, 93, 125, 157, 189, 221, 256):
            vals, idx, blocks = random_ell(5, 3000, 200, gen, dtype)
            D = torch.randn(3000, Q, generator=gen, device="cuda",
                            dtype=dtype)
            plan = dispatch.spmm_plan(5, idx.shape[1], Q)
            spmm_case(f"spmm {dtype} R=5 K={idx.shape[1]} Q={Q} [col_groups "
                      f"{plan.col_groups}, splits {plan.splits}]", vals, idx,
                      blocks, D, tol)
    for R, K, Q, dtype in ((3, 16, 65, f32), (1, 8, 2, f64)):
        vals, idx, blocks = empty_ell(R, K, dtype)
        D = torch.randn(40, Q, generator=gen, device="cuda", dtype=dtype)
        spmm_case(f"spmm {dtype} R={R} K={K} Q={Q}, every row empty", vals,
                  idx, blocks, D, (0.0, 0.0))


def phase_svm_inner_sweep(gen):
    """K3's two bodies against the plain version: where the warp body
    serves, the block body too (forced); shapes on both sides of the
    warp body's caps (mu = 32 | 33; s mu at its shared-memory limit, f32
    and f64); G in global memory; ids from 0..11 so blocks collide; hinge
    (nu = 1) and squared hinge (nu = inf); the C side's two layouts
    against dispatch's."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.svm_inner import svm_inner_loop
    from repro_torch.kernels.svm_inner.ops import _declare, _launch
    from repro_torch.kernels.svm_inner.ref import svm_inner_ref
    lib = _build.load("svm_inner", _declare)
    for s, mu, isz in ((64, 1, 4), (16, 8, 4), (64, 8, 4), (16, 8, 8),
                       (238, 1, 4), (167, 1, 8), (2, 32, 4), (237, 1, 4),
                       (166, 1, 8)):
        for g in (True, False):
            want = dispatch.svm_inner_smem_bytes(s, mu, isz, g)
            got = lib.svm_inner_smem_bytes(s, mu, isz, int(g))
            if got != want:
                raise AssertionError(f"svm_inner smem layout differs: C "
                                     f"{got} vs dispatch {want} at "
                                     f"{(s, mu, isz)}")
        got = lib.svm_inner_warp_smem_bytes(s, mu, isz)
        if got != dispatch.svm_inner_warp_smem_bytes(s, mu, isz):
            raise AssertionError(f"svm_inner warp layout differs: C {got} at "
                                 f"{(s, mu, isz)}")
    f32, f64 = torch.float32, torch.float64
    # (s, mu, dtype, route, G in shared memory for the block body)
    for s, mu, dtype, route, smem in ((64, 1, f32, "warp", True),
                                      (16, 8, f32, "warp", True),
                                      (3, 5, f32, "warp", True),
                                      (2, 32, f32, "warp", True),
                                      (2, 33, f32, "block", True),
                                      (237, 1, f32, "warp", True),
                                      (238, 1, f32, "block", True),
                                      (64, 8, f32, "block", False),
                                      (64, 1, f64, "warp", True),
                                      (16, 8, f64, "warp", True),
                                      (166, 1, f64, "warp", True),
                                      (167, 1, f64, "block", True),
                                      (64, 8, f64, "block", False)):
        isz = 4 if dtype == f32 else 8
        if dispatch.svm_inner_route(s, mu, isz) != route or \
                dispatch.svm_inner_g_in_smem(s, mu, isz) != smem:
            raise AssertionError(f"svm_inner ({s}, {mu}) route / G placement")
        tol_th = (1e-4, 1e-5) if dtype == f32 else (1e-12, 1e-12)
        tol_dl = (1e-4, 1e-4) if dtype == f32 else (1e-12, 1e-12)
        bodies = ("warp", "block") if route == "warp" else ("block",)
        for nu in (1.0, float("inf")):
            ins = svm_inputs(s, mu, 12, dtype, gen)
            th_r, dl_r = svm_inner_ref(*ins, 0.3, nu)
            for body in bodies:
                before = dict(svm_inner_loop.route_launches)
                th, dl = (svm_inner_loop(*ins, gamma=0.3, nu=nu)
                          if body == route else
                          _launch(*ins, 0.3, nu, 32, route=body))
                took = [r for r, n in svm_inner_loop.route_launches.items()
                        if n != before[r]]
                if took != [body]:
                    raise AssertionError(f"svm_inner ({s}, {mu}) took {took}")
                where = "smem" if body == "warp" or smem else "global"
                check_close(f"svm_inner {dtype} (s={s}, mu={mu}, nu={nu}) "
                            f"[{body}, G {where}] theta", th, th_r, *tol_th)
                check_close(f"svm_inner {dtype} (s={s}, mu={mu}, nu={nu}) "
                            f"[{body}] dual increments", dl, dl_r, *tol_dl)


def flash_offset_case(gen):
    """K5 on bf16 q, k, v one element into fresh storage (2 bytes past
    16-byte alignment): each is copied into aligned storage, and the
    wgmma body runs on the copies."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    shape = (1, 4, 256, 128)
    n = math.prod(shape)
    q, k, v = (torch.randn(n + 1, generator=gen, device="cuda").mul(
        0.3).to(torch.bfloat16)[1:].view(shape) for _ in range(3))
    before = dict(flash_attention.route_launches)
    out = flash_attention(q, k, v)
    taken = {r: c - before[r] for r, c in
             flash_attention.route_launches.items() if c != before[r]}
    if taken != {"wgmma": 1}:
        raise AssertionError(f"flash_attention offset views: {taken}")
    check_close(f"flash_attention bf16 {shape} at element offset 1 (copied) "
                f"[wgmma]", out.float(),
                attention_ref(q, k, v).float(), 0.0, 2e-2)


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
    from repro_torch.kernels.gram import gram_t

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
    bodies = dict(gram_t.route_launches)
    launches = {"gram": counts["gram"], "sa_inner": counts["sa_inner"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the solve: {counts} (expected {outer} each of "
        f"gram and sa_inner); gram by body {bodies} (expected {outer} "
        f"wgmma)")
    log(f"  objective {float(obj[0]):.6g} -> {float(obj[-1]):.6g}; "
        f"inner_impl {res.aux['inner_impl']}")
    log(f"  wall {wall:.4f} s, {wall / outer * 1e3:.4f} ms per outer "
        f"iteration; peak device memory {peak / 2**30:.3f} GiB")
    if counts != {"gram": outer, "sa_inner": outer, "spmm": 0,
                  "svm_inner": 0, "flash_attention": 0}:
        raise AssertionError(f"main path launches {counts}, expected "
                             f"{outer} of gram and sa_inner")
    if bodies != {"wgmma": outer, "simt": 0}:
        raise AssertionError(f"gram bodies {bodies}, expected {outer} "
                             f"wgmma")
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
    sa_lasso.gram_local = timer.wrap(GRAM_PHASE, saved[1])
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
        "gather Y = A[:, blocks]": tot["assemble"] - tot[GRAM_PHASE],
        GRAM_PHASE: tot[GRAM_PHASE],
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
    args, kw = timer.first["sa_inner kernel"]
    k2 = device_ms(lambda: sa_inner.sa_inner_loop(*args, **kw))
    log(f"  sa_inner on the path's inputs: device {fmt_ms(k2)} ms per call")
    return launches, k2


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
        zero_counts()
        out[device] = api.solve(api.LassoProblem(A=A, b=b,
                                                 lam=0.1 * lam_max), cfg)
        if device == "cuda":
            n = (gram_t.launches, sa_inner.sa_inner_loop.launches,
                 gram_t.route_launches["simt"])
            if n != (8, 8, 8):
                raise AssertionError(f"f64 solve launches {n}, expected 8 "
                                     f"(gram all simt)")
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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gram import gram_t
    return {"gram": gram_t, "sa_inner": sa_inner.sa_inner_loop,
            "spmm": spmm.ell_spmm, "svm_inner": svm_inner.svm_inner_loop,
            "flash_attention": flash_attention}


def zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gram import gram_t
    for fn in counters().values():
        fn.launches = 0
    from repro_torch.kernels.svm_inner import svm_inner_loop
    flash_attention.route_launches.update(wgmma=0, simt=0)
    gram_t.route_launches.update(wgmma=0, simt=0)
    svm_inner_loop.route_launches.update(warp=0, block=0)


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
    from repro_torch.kernels import dispatch
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
    if not torch.equal(out, ell_spmm(*args, **kw)):
        raise AssertionError("spmm on the path's inputs: two calls differ")
    crow = torch.zeros(R + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(active.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, idx[active].to(torch.int64),
                                  vals[active], size=(R, C))
    lib_err = float((torch.sparse.mm(csr, D) - out).abs().max())
    row = {"name": "spmm", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spmm.cu",
           "replaces": "src/repro/kernels/spmm/kernel.py:62",
           "max_abs_err": err,
           "plain_ms": time_ms(lambda: ell_spmm_ref(vals, idx, D), 3, 1),
           "bound_ms": b, "bound_by": why}
    # The kernel and torch.sparse.mm in turns, three rounds; medians.
    timed = {"ms": lambda: ell_spmm(*args, **kw),
             "library_ms": lambda: torch.sparse.mm(csr, D)}
    rounds = {name: [] for name in timed}
    for _ in range(3):
        for name, fn in timed.items():
            rounds[name].append(time_ms(fn, 50, 3))
    row.update({name: sorted(ts)[1] for name, ts in rounds.items()})
    row["device_ms"] = device_ms(lambda: ell_spmm(*args, **kw))
    lib_dev = device_ms(lambda: torch.sparse.mm(csr, D))
    plan = dispatch.spmm_plan(R, K, Q, torch.cuda.get_device_properties(
        0).multi_processor_count)
    dev = row["device_ms"]
    log(f"  spmm at this shape: {row['ms']:.4f} ms, device {fmt_ms(dev)} "
        f"({fmt_ms(dev and dev / b)}x the bound; {plan}); "
        f"torch.sparse.mm {row['library_ms']:.4f} ms, device "
        f"{fmt_ms(lib_dev)} [max abs diff {lib_err:.2e}]; plain "
        f"{row['plain_ms']:.4f}; bound {b:.5f} ms by {why}: "
        f"{nbytes / 1e6:.2f} MB, {2.0 * nnz * Q / 1e6:.2f} MFLOP (rounds, "
        f"ms: " + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                            for n, ts in rounds.items()) + ")")
    return row


def svm_inner_row(args, kw):
    """The svm_inner kernel row on the arguments the main path gave it:
    the body the route picks against the plain version, its time through
    the wrapper and on the device alone, and the block body's beside it."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.svm_inner import svm_inner_loop
    from repro_torch.kernels.svm_inner.ops import _launch
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
           "device_ms": device_ms(lambda: svm_inner_loop(*args, **kw)),
           "bound_ms": b, "bound_by": why, "library_ms": None}
    route = dispatch.svm_inner_route(s, mu, isz)
    block = (*args, kw["gamma"], kw["nu"], kw["power_iters"])
    th_b, dl_b = _launch(*block, route="block")
    check_close("the block body on the same inputs, theta", th_b, th_r,
                1e-4, 1e-5)
    check_close("the block body on the same inputs, dual increments",
                dl_b, dl_r, 1e-4, 1e-4)
    block_ms = time_ms(lambda: _launch(*block, route="block"), 200, 5)
    block_dev = device_ms(lambda: _launch(*block, route="block"))
    step = PROBE.get("step_ms")
    lat = None if step is None else s * step
    ratio = None if lat is None or row["device_ms"] is None \
        else row["device_ms"] / lat
    log(f"  svm_inner at this shape [{route}]: {row['ms']:.4f} ms, device "
        f"{fmt_ms(row['device_ms'])} ({fmt_ms(ratio)}x the latency bound "
        f"{fmt_ms(lat)} ms of {s} probe steps); block body "
        f"{block_ms:.4f} ms, device {fmt_ms(block_dev)}; plain "
        f"{row['plain_ms']:.4f}; bound {b:.6f} ms by {why}")
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
                       "svm_inner": outer, "flash_attention": 0})
    bodies = dict(svm_inner.svm_inner_loop.route_launches)
    log(f"  svm_inner by body {bodies} (expected {outer} warp)")
    if bodies != {"warp": outer, "block": 0}:
        raise AssertionError(f"svm_inner bodies {bodies}, expected {outer} "
                             f"warp")
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
                       "svm_inner": 0, "flash_attention": 0})
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
                        "svm_inner": 32, "flash_attention": 0}
            want_lasso = {"gram": 0, "sa_inner": 8, "spmm": 8,
                          "svm_inner": 0, "flash_attention": 0}
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


# ---------------------------------------------------------------------------
# Phases 7-10: the LM serving path.
# ---------------------------------------------------------------------------

def attn_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen):
    import torch
    q = 0.3 * torch.randn(B, Hq, Sq, D, generator=gen, device="cuda")
    k = 0.3 * torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
    v = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def phase_attention_kernel():
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _declare
    from repro_torch.kernels.flash_attention.ref import attention_ref

    log("phase 7: flash_attention against its plain version (atol 2e-3 at "
        "f32, 2e-2 at bf16)")
    lib = _build.load("flash_attention", _declare)
    tiles = (lib.flash_attention_block_q(), lib.flash_attention_block_k())
    if tiles != (dispatch.FLASH_BLOCK_Q, dispatch.FLASH_BLOCK_K):
        raise AssertionError(f"flash_attention tiles: C {tiles} vs dispatch")
    tiles = (lib.flash_attention_wgmma_block_q(),
             lib.flash_attention_wgmma_block_k(),
             lib.flash_attention_wgmma_stages())
    if tiles != (dispatch.FLASH_WGMMA_BLOCK_Q, dispatch.FLASH_WGMMA_BLOCK_K,
                 dispatch.FLASH_WGMMA_STAGES):
        raise AssertionError(f"flash_attention wgmma tiles and stages: C "
                             f"{tiles} vs dispatch")
    for D in dispatch.FLASH_HEAD_DIMS:
        got = lib.flash_attention_smem_bytes(D)
        if got != dispatch.flash_attention_smem_bytes(D):
            raise AssertionError(f"flash_attention smem at D={D}: C {got} "
                                 f"vs dispatch")
    for D in dispatch.FLASH_WGMMA_HEAD_DIMS:
        got = lib.flash_attention_wgmma_smem_bytes(D)
        if got != dispatch.flash_attention_smem_bytes(D, "wgmma"):
            raise AssertionError(f"flash_attention wgmma smem at D={D}: C "
                                 f"{got} vs dispatch")
    log(f"  tiles and shared memory agree with dispatch: simt "
        f"{dispatch.FLASH_BLOCK_Q} x {dispatch.FLASH_BLOCK_K}, wgmma "
        f"{dispatch.FLASH_WGMMA_BLOCK_Q} x {dispatch.FLASH_WGMMA_BLOCK_K} "
        f"over {dispatch.FLASH_WGMMA_STAGES} stages "
        f"({dispatch.flash_attention_smem_bytes(128, 'wgmma')} bytes at "
        f"D = 128)")

    def routed(what, q, k, v, **kw):
        """flash_attention(q, k, v) -> out; raises unless exactly one
        launch of the body dispatch routes (dtype, D) to was counted."""
        want = dispatch.flash_attention_route(q.dtype, q.shape[3])
        before = dict(flash_attention.route_launches)
        out = flash_attention(q, k, v, **kw)
        taken = {r: n - before[r] for r, n in
                 flash_attention.route_launches.items() if n != before[r]}
        if taken != {want: 1}:
            raise AssertionError(f"flash_attention {what}: launched {taken}, "
                                 f"expected one of the {want} body")
        return out, want

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for case in ATTN_CASES:
        B, Hq, Hkv, Sq, Sk, D, causal, window = case
        for dtype, atol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
            q, k, v = attn_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen)
            out, route = routed(case, q, k, v, causal=causal, window=window)
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError(f"flash_attention {case} gave "
                                     f"{out.dtype} {tuple(out.shape)}")
            check_close(f"flash_attention {dtype} {case} [{route}]",
                        out.float(),
                        attention_ref(q, k, v, causal=causal,
                                      window=window).float(), 0.0, atol)
    # q, k, v as attention_train hands them over without rope: transposed
    # views of (B, S, H, D) projections, not contiguous.
    x = torch.randn(2, 200, 8 + 2 * 2, 128, generator=gen,
                    device="cuda").to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in x.split([8, 2, 2], dim=2))
    out, route = routed("strided views", q, k, v)
    check_close(f"flash_attention bf16 strided views (2, 8/2, 200, 128) "
                f"[{route}]", out.float(), attention_ref(q, k, v).float(),
                0.0, 2e-2)
    # The backward is the plain version's VJP, as in repro.
    q, k, v = (t.requires_grad_() for t in
               attn_inputs(1, 2, 1, 64, 64, 32, torch.float32, gen))
    flash_attention(q, k, v, window=24).sum().backward()
    grads = [t.grad for t in (q, k, v)]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attention_ref(*leaves, window=24).sum().backward()
    for name, g, leaf in zip("qkv", grads, leaves):
        check_close(f"flash_attention d{name} (1, 2/1, 64, 32) f32", g,
                    leaf.grad, 0.0, 2e-3)
    torch.cuda.synchronize()


def live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal/window band, per head."""
    n = 0
    for i in range(Sq):
        qpos = i + Sk - Sq
        hi = min(qpos, Sk - 1) if causal else Sk - 1
        lo = max(qpos - window + 1, 0) if window > 0 else 0
        n += max(hi - lo + 1, 0)
    return n


def flash_row(args, kw):
    """The flash_attention kernel row on the q/k/v that the prefill's first
    layer gave it: error and time against the plain version (run one KV
    head group at a time: all 32 heads at once would hold ~35 GB of f32
    scores), its simt body at bf16 (forced through ``_launch``'s route),
    its wgmma body without ping-pong and SDPA, and the bound from this
    call's live pairs.

    Outputs here are means of v over up to 8192 keys, ~0.02-0.03 in most
    rows, so repro's bf16 bar of 2e-2 could not tell a dropped key tile
    from rounding. Kernel and plain version both round once to bf16 at
    the end, so they may differ by one rounding step of the output: at
    most 2^-7 of its size (rtol), plus atol 4e-3 for the rest (the wgmma
    body's bf16 P, as in FA3 and SDPA, and f32 reordering). The same
    q/k/v in f32 (the simt body) are held at atol 2e-4 (f32 reordering
    gives ~1e-6 there)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _launch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = args
    (B, Hq, Sq, D), (Hkv, Sk) = q.shape, k.shape[1:3]
    g = Hq // Hkv

    def plain():
        return torch.cat([attention_ref(q[:, i * g:(i + 1) * g],
                                        k[:, i:i + 1], v[:, i:i + 1], **kw)
                          for i in range(Hkv)], dim=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    def simt():
        return _launch(q, k, v, kw.get("causal", True), kw.get("window", 0),
                       D ** -0.5, route="simt")

    out = flash_attention(q, k, v, **kw)
    want = plain().float()
    err = check_close(f"flash_attention on layer 0's q/k/v of the prefill "
                      f"{tuple(q.shape)} / {tuple(k.shape)} {q.dtype} "
                      f"[{dispatch.flash_attention_route(q.dtype, D)}]",
                      out.float(), want, 2.0 ** -7, 4e-3)
    mean_ref = float(want.abs().mean())
    log(f"  mean |plain| {mean_ref:.3e}: max err / mean |plain| "
        f"{err / mean_ref:.3e}")
    check_close("the simt body on the same q/k/v (bf16)", simt().float(),
                want, 2.0 ** -7, 4e-3)
    del want
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want32 = torch.cat([attention_ref(q32[:, i * g:(i + 1) * g],
                                      k32[:, i:i + 1], v32[:, i:i + 1], **kw)
                        for i in range(Hkv)], dim=1)
    err32 = check_close("the same q/k/v in float32",
                        flash_attention(q32, k32, v32, **kw), want32, 0.0,
                        2e-4)
    log(f"  mean |plain| {float(want32.abs().mean()):.3e}: max err / mean "
        f"|plain| {err32 / float(want32.abs().mean()):.3e}")
    del q32, k32, v32, want32
    lib_err = float((sdpa().float() - out.float()).abs().max())
    pairs = B * live_pairs(Sq, Sk, kw.get("causal", True),
                           kw.get("window", 0))
    flops = 4.0 * Hq * D * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b, why = bound_ms(nbytes, flops, BF16_FLOPS)
    # The wgmma body, SDPA and the wgmma body without ping-pong in turns,
    # three rounds of ten calls each (the card's clocks drift over a run,
    # so back-to-back blocks would favour whichever went first); medians.
    timed = {"ms": lambda: flash_attention(q, k, v, **kw),
             "library_ms": sdpa,
             "no_pingpong_ms": lambda: _launch(
                 q, k, v, kw.get("causal", True), kw.get("window", 0),
                 D ** -0.5, pingpong=False)}
    rounds = {name: [] for name in timed}
    for _ in range(3):
        for name, fn in timed.items():
            rounds[name].append(time_ms(fn, 10, 1))
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
           "max_abs_err": err,
           "plain_ms": time_ms(plain, 2, 1),
           "bound_ms": b, "bound_by": why,
           "simt_ms": time_ms(simt, 3, 1),
           **{name: sorted(ts)[1] for name, ts in rounds.items()}}
    row["device_ms"] = device_ms(lambda: flash_attention(q, k, v, **kw), 5)
    log(f"  flash_attention at this shape: {row['ms']:.4f} ms (device "
        f"{fmt_ms(row['device_ms'])}), "
        f"{flops / row['ms'] / 1e9:.2f} TFLOP/s, {b / row['ms']:.3f} of "
        f"the bound; without ping-pong {row['no_pingpong_ms']:.4f} ms; "
        f"SDPA {row['library_ms']:.4f} ms, "
        f"{flops / row['library_ms'] / 1e9:.2f} TFLOP/s [max abs diff "
        f"{lib_err:.2e}] (rounds, ms: "
        + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                    for n, ts in rounds.items()) + ")")
    log(f"  simt body at bf16 {row['simt_ms']:.4f} ms, "
        f"{flops / row['simt_ms'] / 1e9:.2f} TFLOP/s; plain "
        f"{row['plain_ms']:.4f} ms; bound {b:.4f} ms by {why}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP at the bf16 "
        f"tensor-core peak")
    return row


def llama_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    arch = get_config(LLAMA)
    t0 = time.perf_counter()
    model = lm.init_params(arch, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, "
        f"{arch.n_heads}/{arch.n_kv_heads} heads of {arch.head_dim_}, d_ff "
        f"{arch.d_ff}, vocab {arch.vocab_size}, {arch.dtype}: {n / 1e9:.3f} "
        f"B parameters ({nbytes / 1e9:.2f} GB), random from seed 0, made on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    return arch, model


def device_profile(fn, top: int = 6):
    """(device busy ms, device operations run, [(name, ms), ...] of the
    ``top`` kernels) of one call of ``fn`` under torch.profiler: the
    union of the kernel, memcpy and memset intervals of its trace (so
    nothing is counted twice), or (None, 0, []) when the trace holds no
    device events on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(ROOT, "build", "profile_trace.json")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
    except Exception as exc:            # untried profiler: report, go on
        log(f"  torch.profiler gave no device trace ({exc!r})")
        return None, 0, []
    dev = [e for e in events if e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        return None, 0, []
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    ranked = sorted(by_name.items(), key=lambda r: -r[1])[:top]
    return busy / 1e3, len(dev), [(n, us / 1e3) for n, us in ranked]


def log_profile(what, prof, wall_ms, n):
    """Device-busy share of ``n`` steps whose untraced wall per step is
    ``wall_ms``, and the kernels that take most of it."""
    total, ops, top = prof
    if total is None:
        log(f"  {what}: device busy time not measured")
        return
    log(f"  {what}: device busy {total / n:.4f} ms per step of "
        f"{wall_ms:.4f} ms wall (idle share {1 - total / n / wall_ms:.3f}; "
        f"torch.profiler trace); {ops / n:.1f} device operations per "
        f"step; top kernels, ms per step:")
    for name, ms in top:
        log(f"    {ms / n:9.4f}  {name[:100]}")


def phase_prefill(arch, model):
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    B, S = PREFILL_B, PREFILL_S
    full = SHAPES["prefill_32k"]
    log(f"phase 8: prefill, {arch.name} at full width, B={B} S={S} (cut "
        f"from repro's {full.name}: B={full.global_batch} S={full.seq_len})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks = torch.randint(0, arch.vocab_size, (B, S), generator=gen,
                         device="cuda")
    with torch.no_grad():
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(toks)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        got = read_counts()
        routes = dict(flash_attention.route_launches)
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = arch.n_layers
        want_routes = {"wgmma": arch.n_layers, "simt": 0}
        log(f"  launches in the prefill: {got} (expected {want}); "
            f"flash_attention by body {routes} (expected {want_routes})")
        log(f"  first prefill {cold:.4f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if got != want or routes != want_routes:
            raise AssertionError(f"prefill launches {got} {routes}, "
                                 f"expected {want} {want_routes}")
        if logits.shape != (B, 1, arch.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                                 f"finite of shape (B, 1, V)")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(toks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = sorted(walls)[1]
        log(f"  steady prefills: {' '.join(f'{w:.4f}' for w in walls)} s "
            f"(median {med:.4f} s, {B * S / med:.1f} tokens/s)")

        timer = PhaseTimer()
        patches = [(L, "flash_attention", "kernel"),
                   (L, "project_qkv", "proj"), (L, "apply_rope", "rope"),
                   (L, "attention_train", "attn"), (L, "mlp", "mlp"),
                   (L, "rmsnorm", "norm"), (lm.LM, "_logits", "logits")]
        saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
        for o, a, label in patches:
            setattr(o, a, timer.wrap(label, getattr(o, a)))
        try:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            model.prefill(toks)
            e1.record()
            torch.cuda.synchronize()
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)
        tot = timer.totals_ms()
        total = e0.elapsed_time(e1)
        e_norm = timer.events["norm"][-1]
        unembed = tot["logits"] - e_norm[0].elapsed_time(e_norm[1])
        split = {
            "flash_attention kernel": tot["kernel"],
            "q/k/v projections (GEMMs)": tot["proj"],
            "rope (q, k)": tot["rope"],
            "attention out (o relayout + wo GEMM)": tot["attn"]
            - tot["proj"] - tot["rope"] - tot["kernel"],
            "MLP (gate/up/down GEMMs, SiLU mul)": tot["mlp"],
            "rmsnorm (2 per layer + final)": tot["norm"],
            "unembed GEMM (last position)": unembed,
            "rest (embed gather, residual adds)": total - tot["attn"]
            - tot["mlp"] - tot["norm"] - unembed,
        }
        log(f"  where a prefill's time goes (device time, ms; traced "
            f"prefill {total:.3f} ms):")
        for name, ms in split.items():
            log(f"    {name:40s} {ms:10.3f}  {100 * ms / total:5.1f}%")
        log_profile("one prefill", device_profile(
            lambda: model.prefill(toks)), med * 1e3, 1)
        row = flash_row(*timer.first["kernel"])
    return row, got["flash_attention"]


def phase_serve(arch, model):
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    B, P, G = SERVE_B, SERVE_P, SERVE_G
    log(f"phase 9: serving, {arch.name} at full width, "
        f"BatchedServer.generate batch {B}, prompt {P}, generate {G}")
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab_size, (B, P)).astype(np.int32)
    server = BatchedServer(arch, model, max_seq=P + G)
    server.generate(prompts[:, :4], 2)                  # warm-up
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.generate(prompts, G)
    wall = time.perf_counter() - t0
    got = read_counts()
    steps = P + G
    log(f"  launches in generate: {got} (expected none: decode attention "
        f"is plain PyTorch, as in repro)")
    log(f"  {steps} decode steps in {wall:.4f} s: {wall / steps * 1e3:.4f} "
        f"ms per step, {B * G / wall:.1f} generated tokens/s "
        f"({B * steps / wall:.1f} tokens/s through the decode path); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; sample {out[0][:8].tolist()}")
    if any(got.values()):
        raise AssertionError(f"generate launched kernels: {got}")
    if out.shape != (B, G) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < arch.vocab_size)).all():
        raise AssertionError(f"generate gave {out.dtype} {out.shape}")

    # Where a decode step's time goes: CUDA events over 16 steps of
    # another generate (prompt 8, generate 8).
    timer = PhaseTimer()
    patches = [(L, "attention_decode", "attn"), (L, "project_qkv", "proj"),
               (L, "apply_rope", "rope"), (L, "mlp", "mlp"),
               (L, "rmsnorm", "norm"), (lm.LM, "_logits", "logits")]
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, label in patches:
        setattr(o, a, timer.wrap(label, getattr(o, a)))
    try:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        server.generate(prompts[:, :8], 8)
        e1.record()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    tot = timer.totals_ms()
    n = 16
    total = e0.elapsed_time(e1)
    split = {
        "q/k/v projections (GEMVs)": tot["proj"],
        "rope (q, k)": tot["rope"],
        "attention (cache write, repeat, softmax, wo)": tot["attn"]
        - tot["proj"] - tot["rope"],
        "MLP (gate/up/down GEMVs, SiLU mul)": tot["mlp"],
        "rmsnorm": tot["norm"],
        "final norm + unembed": tot["logits"],
        "rest (embed gather, residual adds, argmax)": total - tot["attn"]
        - tot["mlp"] - tot["norm"] - tot["logits"],
    }
    log(f"  where a decode step's time goes (CUDA events, ms per step; "
        f"traced wall {traced / n * 1e3:.3f} ms per step; where the device "
        f"idles between launches these intervals are mostly host time):")
    for name, ms in split.items():
        log(f"    {name:44s} {ms / n:8.4f}  {100 * ms / total:5.1f}%")
    log_profile("16 decode steps", device_profile(
        lambda: server.generate(prompts[:, :8], 8)), wall / steps * 1e3, n)

    # The kernel path against the decode path at full width: teacher-forced
    # decode's logits at the last prompt position against prefill's.
    with torch.no_grad():
        toks = torch.as_tensor(prompts, device="cuda")
        cache = lm.init_cache(arch, B, P, "cuda")
        for t in range(P):
            logits, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        last = model.prefill(toks)
    check_close(f"decode logits at position {P - 1} vs prefill (B={B})",
                logits.float(), last.float(), 0.05, 0.12)


def phase_f32_lm():
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import lm

    arch = dataclasses.replace(get_config(TINY), n_layers=TINY_LAYERS,
                               dtype="float32")
    B, S = TINY_B, TINY_S
    log(f"phase 10: f32 {TINY} widths at {TINY_LAYERS} layers, B={B} S={S},"
        f" the card (flash_attention) vs the CPU (plain)")
    gpu = lm.init_params(arch, seed=0, device="cuda")
    cpu = lm.LM(arch, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(1).integers(
        0, arch.vocab_size, (B, S)).astype(np.int32)
    with torch.no_grad():
        flash_attention.launches = 0
        lg = gpu.forward(torch.as_tensor(toks, device="cuda")).cpu()
        if flash_attention.launches != TINY_LAYERS:
            raise AssertionError(f"f32 forward launched flash_attention "
                                 f"{flash_attention.launches} times")
        lc = cpu.forward(torch.as_tensor(toks))
    rel = float((lg - lc).abs().max() / lc.abs().max())
    log(f"  logits {tuple(lg.shape)}: max |card - cpu| / max |cpu| "
        f"{rel:.3e} (bar 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("f32 card logits differ from the CPU's")
    t_gpu = BatchedServer(arch, gpu, 24).generate(toks[:, :16], 8)
    t_cpu = BatchedServer(arch, cpu, 24).generate(toks[:, :16], 8)
    log(f"  generated tokens equal: {bool((t_gpu == t_cpu).all())} "
        f"({t_gpu[0].tolist()})")
    if not (t_gpu == t_cpu).all():
        raise AssertionError("f32 card and CPU generate different tokens")


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
    launches, rows["sa_inner"]["device_ms"] = phase_main_path()
    torch.cuda.empty_cache()
    phase_f64()
    svm_rows, svm_launches = phase_svm()
    torch.cuda.empty_cache()
    phase_url()
    torch.cuda.empty_cache()
    phase_f64_sparse()
    torch.cuda.empty_cache()
    phase_attention_kernel()
    arch, model = llama_model()
    rows["flash_attention"], fa_launches = phase_prefill(arch, model)
    phase_serve(arch, model)
    del model
    torch.cuda.empty_cache()
    phase_f32_lm()

    rows.update(svm_rows)
    rows["flash_attention"]["launches"] = fa_launches
    for name, n in launches.items():
        rows[name]["launches"] = n
    for name in svm_rows:
        rows[name]["launches"] = svm_launches[name]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
