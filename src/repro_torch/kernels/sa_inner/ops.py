"""Public wrapper for the fused SA inner loop (K2, ``csrc/sa_inner.cu``).

On CPU tensors the plain version (``ref.sa_inner_ref``) runs; on CUDA
tensors the one-block kernel launches, or the call raises. Whether G
stays in shared memory is the kernel's template parameter, chosen from
the Hopper budget table (``dispatch.sa_inner_g_in_smem``), not a
fallback. ``sa_inner_loop.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.sa_inner import ref as _ref

_C_FN = {torch.float32: ("sa_inner_f32", ctypes.c_float),
         torch.float64: ("sa_inner_f64", ctypes.c_double)}


def inner_impl(device, group_lasso: bool = False) -> str:
    """The inner loop that runs for a solve on ``device``: "cuda" (the
    kernel) for the Lasso / elastic-net prox on a card, "torch" for the
    plain loop (on the CPU, or group lasso, whose block prox the kernel
    does not compute)."""
    return "cuda" if torch.device(device).type == "cuda" \
        and not group_lasso else "torch"


def _declare(lib):
    for fn, cfloat in _C_FN.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 \
            + [cfloat] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.sa_inner_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sa_inner_smem_bytes.restype = ctypes.c_longlong
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(G, y_proj, z_proj, z_vals, idx, th_prev, coefU):
    s, mu = y_proj.shape
    want = {"G": (s * mu, s * mu), "z_proj": (s, mu), "z_vals": (s, mu),
            "idx": (s, mu), "th_prev": (s,), "coefU": (s,)}
    got = {"G": G, "z_proj": z_proj, "z_vals": z_vals, "idx": idx,
           "th_prev": th_prev, "coefU": coefU}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"sa_inner_loop: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.device != G.device:
            raise ValueError(f"sa_inner_loop: {name} on {t.device}, G on "
                             f"{G.device}")
    floats = (G, y_proj, z_proj, z_vals, th_prev, coefU)
    if G.dtype not in _C_FN or any(t.dtype != G.dtype for t in floats):
        raise TypeError("sa_inner_loop takes float32 or float64 inputs of "
                        "one dtype")
    if idx.dtype != torch.int64:
        raise TypeError(f"sa_inner_loop: idx must be int64, got {idx.dtype}")


def sa_inner_loop(G, y_proj, z_proj, z_vals, idx, th_prev, coefU,
                  q: float, lam1: float, lam2: float = 0.0,
                  power_iters: int = 32):
    """Run the s-step SA inner loop (see ``ref.py`` for semantics) ->
    (dz (s, mu), etas (s,))."""
    _check(G, y_proj, z_proj, z_vals, idx, th_prev, coefU)
    if G.device.type == "cpu":
        return _ref.sa_inner_ref(G, y_proj, z_proj, z_vals, idx, th_prev,
                                 coefU, q, lam1, lam2, power_iters)
    if G.device.type != "cuda":
        raise ValueError(f"sa_inner_loop runs on cpu or cuda tensors, not "
                         f"{G.device}")
    ins = (G, y_proj, z_proj, z_vals, idx, th_prev, coefU)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("sa_inner_loop needs contiguous inputs")
    lib = _build.load("sa_inner", _declare)
    s, mu = y_proj.shape
    dz = torch.empty((s, mu), dtype=G.dtype, device=G.device)
    eta = torch.empty((s,), dtype=G.dtype, device=G.device)
    fn, _ = _C_FN[G.dtype]
    g_in_smem = dispatch.sa_inner_g_in_smem(s, mu, G.element_size())
    rc = getattr(lib, fn)(
        *(t.data_ptr() for t in ins), dz.data_ptr(), eta.data_ptr(),
        s, mu, float(q), float(lam1), float(lam2), int(power_iters),
        int(g_in_smem), G.device.index or 0,
        torch.cuda.current_stream(G.device).cuda_stream)
    _build.check(lib, rc, "sa_inner_loop")
    sa_inner_loop.launches += 1
    return dz, eta


sa_inner_loop.launches = 0
