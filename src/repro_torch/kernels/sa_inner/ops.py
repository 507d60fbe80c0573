"""Public wrapper for the fused SA inner loop (K2, ``csrc/sa_inner.cu``).

On CPU tensors the plain version (``ref.sa_inner_ref``) runs; on CUDA
tensors the one-block kernel launches, or the call raises. The kernel has
two bodies, chosen by ``dispatch.sa_inner_route``: ``warp`` (mu <= 32 and
its layout in shared memory: the power iterations in registers, the chain
in one warp, right-looking) and ``block`` (the rest: one warp per row of
a block and a block barrier per step). Whether the block body keeps G in
shared memory is its template parameter, chosen from the Hopper budget
table (``dispatch.sa_inner_g_in_smem``), not a fallback; neither body
stands in for the other. ``sa_inner_loop.launches`` counts launches and
``sa_inner_loop.route_launches`` the launches of each body.
``sa_inner_loop`` is a recording seam (``repro_torch.seams``): an open
recorder sees one event per call, with the body it takes and the flops of
the plain version's products (``inner_flops``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import seams
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.sa_inner import ref as _ref

_C_FN = {torch.float32: ("sa_inner_f32", ctypes.c_float),
         torch.float64: ("sa_inner_f64", ctypes.c_double)}
# The C entry's body argument.
_BODY = {("block", False): 0, ("block", True): 1, ("warp", True): 2}
# (s, mu, itemsize, forced route) -> (route, body argument).
_ROUTES: dict = {}


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
        # G, y_proj, z_proj, z_vals, idx, th_prev, coefU, dz, eta, s, mu,
        # q, lam1, lam2, iters, body, device, stream
        f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 \
            + [cfloat] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.sa_inner_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sa_inner_smem_bytes.restype = ctypes.c_longlong
    lib.sa_inner_warp_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sa_inner_warp_smem_bytes.restype = ctypes.c_longlong
    lib.sa_inner_power_warps.argtypes = [ctypes.c_int] * 2
    lib.sa_inner_power_warps.restype = ctypes.c_int
    lib.sa_inner_warp_fits.argtypes = [ctypes.c_int] * 3
    lib.sa_inner_warp_fits.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(G, y_proj, z_proj, z_vals, idx, th_prev, coefU):
    if y_proj.dim() != 2:
        raise ValueError(f"sa_inner_loop: y_proj has shape "
                         f"{tuple(y_proj.shape)}, expected (s, mu)")
    shape, dev, dt = y_proj.shape, y_proj.device, y_proj.dtype
    s, mu = shape
    if G.shape != (s * mu, s * mu) or z_proj.shape != shape \
            or z_vals.shape != shape or idx.shape != shape \
            or th_prev.shape != (s,) or coefU.shape != (s,):
        for name, t, want in (("G", G, (s * mu, s * mu)),
                              ("z_proj", z_proj, shape),
                              ("z_vals", z_vals, shape), ("idx", idx, shape),
                              ("th_prev", th_prev, (s,)),
                              ("coefU", coefU, (s,))):
            if t.shape != want:
                raise ValueError(f"sa_inner_loop: {name} has shape "
                                 f"{tuple(t.shape)}, expected {tuple(want)}")
    if G.device != dev or z_proj.device != dev or z_vals.device != dev \
            or idx.device != dev or th_prev.device != dev \
            or coefU.device != dev:
        raise ValueError(f"sa_inner_loop: G on {G.device}, z_proj on "
                         f"{z_proj.device}, z_vals on {z_vals.device}, idx "
                         f"on {idx.device}, th_prev on {th_prev.device}, "
                         f"coefU on {coefU.device}, y_proj on {dev}")
    if dt not in _C_FN or G.dtype != dt or z_proj.dtype != dt \
            or z_vals.dtype != dt or th_prev.dtype != dt \
            or coefU.dtype != dt:
        raise TypeError("sa_inner_loop takes float32 or float64 inputs of "
                        "one dtype")
    if idx.dtype != torch.int64:
        raise TypeError(f"sa_inner_loop: idx must be int64, got {idx.dtype}")


def _route(s: int, mu: int, itemsize: int, route: str | None):
    """(route, the C entry's body argument) at (s, mu), cached: the route
    ``dispatch.sa_inner_route`` picks, or the forced ``route``."""
    key = (s, mu, itemsize, route)
    got = _ROUTES.get(key)
    if got is None:
        r = route or dispatch.sa_inner_route(s, mu, itemsize)
        smem = r == "warp" or dispatch.sa_inner_g_in_smem(s, mu, itemsize)
        if (r, smem) not in _BODY or (
                r == "warp" and dispatch.sa_inner_route(s, mu, itemsize)
                != "warp"):
            raise ValueError(f"sa_inner has no {r!r} body at s={s}, "
                             f"mu={mu}, itemsize {itemsize}")
        got = _ROUTES[key] = (r, _BODY[r, smem])
    return got


def _launch(G, y_proj, z_proj, z_vals, idx, th_prev, coefU, q: float,
            lam1: float, lam2: float, power_iters: int,
            route: str | None = None):
    """The kernel on CUDA tensors -> (dz, etas), views of one allocation,
    through the body ``dispatch.sa_inner_route`` picks. ``route`` forces a
    body, for measurement only: ``chip_smoke.py`` holds the block body
    against the plain version that way."""
    dev = G.device
    if dev.type != "cuda":
        raise ValueError(f"sa_inner_loop runs on cpu or cuda tensors, not "
                         f"{dev}")
    if not (G.is_contiguous() and y_proj.is_contiguous()
            and z_proj.is_contiguous() and z_vals.is_contiguous()
            and idx.is_contiguous() and th_prev.is_contiguous()
            and coefU.is_contiguous()):
        raise ValueError("sa_inner_loop needs contiguous inputs")
    s, mu = y_proj.shape
    taken, body = _route(s, mu, G.element_size(), route)
    lib = _build.load("sa_inner", _declare)
    smu = s * mu
    out = torch.empty(smu + s, dtype=G.dtype, device=dev)
    dz = out.as_strided((s, mu), (mu, 1))
    eta = out.as_strided((s,), (1,), smu)
    ptr = out.data_ptr()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    rc = getattr(lib, _C_FN[G.dtype][0])(
        G.data_ptr(), y_proj.data_ptr(), z_proj.data_ptr(),
        z_vals.data_ptr(), idx.data_ptr(), th_prev.data_ptr(),
        coefU.data_ptr(), ptr, ptr + smu * out.element_size(), s, mu,
        float(q), float(lam1), float(lam2), int(power_iters), body, index,
        _build.raw_stream(index))
    _build.check(lib, rc, f"sa_inner_loop ({taken})")
    sa_inner_loop.launches += 1
    sa_inner_loop.route_launches[taken] += 1
    return dz, eta


def inner_flops(s: int, mu: int, power_iters: int) -> float:
    """Flops of the s steps of ``ref.sa_inner_ref``, 2 x output x
    contraction for each product: per step the cross terms G_jt dz_t
    (2 s mu^2), their masked sum (2 s mu), the collision correction
    eq @ w (2 s mu^2) and the power iterations."""
    return s * (4.0 * s * mu * mu + 2.0 * s * mu
                + seams.power_flops(mu, power_iters))


def _event(G, y_proj, z_proj, z_vals, idx, th_prev, coefU, q, lam1,
           lam2=0.0, power_iters=32):
    s, mu = y_proj.shape
    route = "plain" if G.device.type == "cpu" else \
        dispatch.sa_inner_route(s, mu, G.element_size())
    return seams.KernelEvent("sa_inner", "sa_inner_loop",
                             (tuple(G.shape), tuple(y_proj.shape)),
                             G.dtype, G.dtype, route,
                             inner_flops(s, mu, power_iters))


@seams.kernel_seam(_event)
def sa_inner_loop(G, y_proj, z_proj, z_vals, idx, th_prev, coefU,
                  q: float, lam1: float, lam2: float = 0.0,
                  power_iters: int = 32):
    """Run the s-step SA inner loop (see ``ref.py`` for semantics) ->
    (dz (s, mu), etas (s,))."""
    _check(G, y_proj, z_proj, z_vals, idx, th_prev, coefU)
    if G.device.type == "cpu":
        return _ref.sa_inner_ref(G, y_proj, z_proj, z_vals, idx, th_prev,
                                 coefU, q, lam1, lam2, power_iters)
    return _launch(G, y_proj, z_proj, z_vals, idx, th_prev, coefU, q, lam1,
                   lam2, power_iters)


sa_inner_loop.launches = 0
sa_inner_loop.route_launches = {"warp": 0, "block": 0}
