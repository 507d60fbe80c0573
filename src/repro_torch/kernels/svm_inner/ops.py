"""Public wrapper for the fused SVM inner s-loop (K3, ``csrc/svm_inner.cu``).

On CPU tensors the plain version (``ref.svm_inner_ref``) runs; on CUDA
tensors the one-block kernel launches, or the call raises. The kernel has
two bodies, chosen by ``dispatch.svm_inner_route``: ``warp`` (mu <= 32
and its layout in shared memory: the chain in one warp, right-looking)
and ``block`` (the rest: one warp per row of a block and a block barrier
per step). Whether the block body keeps G in shared memory is its
template parameter, chosen from the Hopper budget table
(``dispatch.svm_inner_g_in_smem``), not a fallback; neither body stands
in for the other. ``svm_inner_loop.launches`` counts launches and
``svm_inner_loop.route_launches`` the launches of each body.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.svm_inner import ref as _ref

_C_FN = {torch.float32: ("svm_inner_f32", ctypes.c_float),
         torch.float64: ("svm_inner_f64", ctypes.c_double)}
# The C entry's body argument.
_BODY = {("block", False): 0, ("block", True): 1, ("warp", True): 2}
# (s, mu, itemsize, forced route) -> (route, body argument).
_ROUTES: dict = {}


def inner_impl(device) -> str:
    """The inner loop that runs for a solve on ``device``: "cuda" (the
    kernel) on a card, "torch" (the plain loop) on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _declare(lib):
    for fn, cfloat in _C_FN.values():
        f = getattr(lib, fn)
        # G, proj, b, a, idx, theta, delta, s, mu, gamma, nu, iters, body,
        # device, stream
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 \
            + [cfloat] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.svm_inner_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.svm_inner_smem_bytes.restype = ctypes.c_longlong
    lib.svm_inner_warp_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.svm_inner_warp_smem_bytes.restype = ctypes.c_longlong
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(G, proj, b_sel, a_vals, idx):
    if proj.dim() != 2:
        raise ValueError(f"svm_inner_loop: proj has shape "
                         f"{tuple(proj.shape)}, expected (s, mu)")
    shape, dev, dt = proj.shape, proj.device, proj.dtype
    smu = shape[0] * shape[1]
    if G.shape != (smu, smu) or b_sel.shape != shape \
            or a_vals.shape != shape or idx.shape != shape:
        for name, t, want in (("G", G, (smu, smu)), ("b_sel", b_sel, shape),
                              ("a_vals", a_vals, shape), ("idx", idx, shape)):
            if t.shape != want:
                raise ValueError(f"svm_inner_loop: {name} has shape "
                                 f"{tuple(t.shape)}, expected {tuple(want)}")
    if G.device != dev or b_sel.device != dev or a_vals.device != dev \
            or idx.device != dev:
        raise ValueError(f"svm_inner_loop: G on {G.device}, b_sel on "
                         f"{b_sel.device}, a_vals on {a_vals.device}, idx "
                         f"on {idx.device}, proj on {dev}")
    if dt not in _C_FN or G.dtype != dt or b_sel.dtype != dt \
            or a_vals.dtype != dt:
        raise TypeError("svm_inner_loop takes float32 or float64 inputs of "
                        "one dtype")
    if idx.dtype != torch.int64:
        raise TypeError(f"svm_inner_loop: idx must be int64, got {idx.dtype}")


def _route(s: int, mu: int, itemsize: int, route: str | None):
    """(route, the C entry's body argument) at (s, mu), cached: the route
    ``dispatch.svm_inner_route`` picks, or the forced ``route``."""
    key = (s, mu, itemsize, route)
    got = _ROUTES.get(key)
    if got is None:
        r = route or dispatch.svm_inner_route(s, mu, itemsize)
        smem = r == "warp" or dispatch.svm_inner_g_in_smem(s, mu, itemsize)
        if (r, smem) not in _BODY or (
                r == "warp" and dispatch.svm_inner_route(s, mu, itemsize)
                != "warp"):
            raise ValueError(f"svm_inner has no {r!r} body at s={s}, "
                             f"mu={mu}, itemsize {itemsize}")
        got = _ROUTES[key] = (r, _BODY[r, smem])
    return got


def _launch(G, proj, b_sel, a_vals, idx, gamma: float, nu: float,
            power_iters: int, route: str | None = None):
    """The kernel on CUDA tensors -> (theta, dual_deltas), views of one
    allocation, through the body ``dispatch.svm_inner_route`` picks.
    ``route`` forces a body, for measurement only: ``chip_smoke.py``
    holds the block body against the plain version that way."""
    dev = G.device
    if dev.type != "cuda":
        raise ValueError(f"svm_inner_loop runs on cpu or cuda tensors, not "
                         f"{dev}")
    if not (G.is_contiguous() and proj.is_contiguous()
            and b_sel.is_contiguous() and a_vals.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("svm_inner_loop needs contiguous inputs")
    s, mu = proj.shape
    taken, body = _route(s, mu, G.element_size(), route)
    lib = _build.load("svm_inner", _declare)
    smu = s * mu
    out = torch.empty(smu + s, dtype=G.dtype, device=dev)
    theta = out.as_strided((s, mu), (mu, 1))
    deltas = out.as_strided((s,), (1,), smu)
    ptr = out.data_ptr()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    rc = getattr(lib, _C_FN[G.dtype][0])(
        G.data_ptr(), proj.data_ptr(), b_sel.data_ptr(), a_vals.data_ptr(),
        idx.data_ptr(), ptr, ptr + smu * out.element_size(), s, mu,
        float(gamma), float(nu), int(power_iters), body, index,
        _build.raw_stream(index))
    _build.check(lib, rc, f"svm_inner_loop ({taken})")
    svm_inner_loop.launches += 1
    svm_inner_loop.route_launches[taken] += 1
    return theta, deltas


def svm_inner_loop(G, proj, b_sel, a_vals, idx, gamma: float, nu: float,
                   power_iters: int = 32):
    """Run the s-step SVM inner loop (see ``ref.py`` for semantics) ->
    (theta (s, mu), dual_deltas (s,)). nu = inf clips at 0 only."""
    _check(G, proj, b_sel, a_vals, idx)
    if G.device.type == "cpu":
        return _ref.svm_inner_ref(G, proj, b_sel, a_vals, idx, gamma, nu,
                                  power_iters)
    return _launch(G, proj, b_sel, a_vals, idx, gamma, nu, power_iters)


svm_inner_loop.launches = 0
svm_inner_loop.route_launches = {"warp": 0, "block": 0}
