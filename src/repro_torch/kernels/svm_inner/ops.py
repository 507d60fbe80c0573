"""Public wrapper for the fused SVM inner s-loop (K3, ``csrc/svm_inner.cu``).

On CPU tensors the plain version (``ref.svm_inner_ref``) runs; on CUDA
tensors the one-block kernel launches, or the call raises. Whether G
stays in shared memory is the kernel's template parameter, chosen from
the Hopper budget table (``dispatch.svm_inner_g_in_smem``), not a
fallback. ``svm_inner_loop.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.svm_inner import ref as _ref

_C_FN = {torch.float32: ("svm_inner_f32", ctypes.c_float),
         torch.float64: ("svm_inner_f64", ctypes.c_double)}


def inner_impl(device) -> str:
    """The inner loop that runs for a solve on ``device``: "cuda" (the
    kernel) on a card, "torch" (the plain loop) on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _declare(lib):
    for fn, cfloat in _C_FN.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 \
            + [cfloat] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.svm_inner_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.svm_inner_smem_bytes.restype = ctypes.c_longlong
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(G, proj, b_sel, a_vals, idx):
    s, mu = proj.shape
    want = {"G": (s * mu, s * mu), "b_sel": (s, mu), "a_vals": (s, mu),
            "idx": (s, mu)}
    got = {"G": G, "b_sel": b_sel, "a_vals": a_vals, "idx": idx}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"svm_inner_loop: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.device != proj.device:
            raise ValueError(f"svm_inner_loop: {name} on {t.device}, proj "
                             f"on {proj.device}")
    if G.dtype not in _C_FN or any(t.dtype != G.dtype
                                   for t in (proj, b_sel, a_vals)):
        raise TypeError("svm_inner_loop takes float32 or float64 inputs of "
                        "one dtype")
    if idx.dtype != torch.int64:
        raise TypeError(f"svm_inner_loop: idx must be int64, got {idx.dtype}")


def svm_inner_loop(G, proj, b_sel, a_vals, idx, gamma: float, nu: float,
                   power_iters: int = 32):
    """Run the s-step SVM inner loop (see ``ref.py`` for semantics) ->
    (theta (s, mu), dual_deltas (s,)). nu = inf clips at 0 only."""
    _check(G, proj, b_sel, a_vals, idx)
    if G.device.type == "cpu":
        return _ref.svm_inner_ref(G, proj, b_sel, a_vals, idx, gamma, nu,
                                  power_iters)
    if G.device.type != "cuda":
        raise ValueError(f"svm_inner_loop runs on cpu or cuda tensors, not "
                         f"{G.device}")
    ins = (G, proj, b_sel, a_vals, idx)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("svm_inner_loop needs contiguous inputs")
    lib = _build.load("svm_inner", _declare)
    s, mu = proj.shape
    theta = torch.empty((s, mu), dtype=G.dtype, device=G.device)
    deltas = torch.empty((s,), dtype=G.dtype, device=G.device)
    fn, _ = _C_FN[G.dtype]
    g_in_smem = dispatch.svm_inner_g_in_smem(s, mu, G.element_size())
    rc = getattr(lib, fn)(
        *(t.data_ptr() for t in ins), theta.data_ptr(), deltas.data_ptr(),
        s, mu, float(gamma), float(nu), int(power_iters), int(g_in_smem),
        G.device.index or 0, torch.cuda.current_stream(G.device).cuda_stream)
    _build.check(lib, rc, "svm_inner_loop")
    svm_inner_loop.launches += 1
    return theta, deltas


svm_inner_loop.launches = 0
