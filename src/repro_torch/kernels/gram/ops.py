"""Public wrappers for the fused Gram + projection kernel (K1,
``csrc/gram.cu``).

``gram_t(x, y)`` is x^T y; ``gram_fused(Y, V)`` is Y^T [Y | V^T] for the
k vectors V (k, m), the solvers' call, which the kernel reads where they
lie (no concatenated copy). On a CPU tensor the plain version
(``ref.gram_t_ref``) runs; on a CUDA tensor the hand-written kernel
launches, or the call raises. The kernel has two bodies, chosen by
``dispatch.gram_route``: ``wgmma`` (f32 at f32 accuracy from three TF32
tensor-core products, fed by TMA) and ``simt`` (f64, and f32 shapes TMA
cannot describe, such as a view at an unaligned start). A failed build or
launch raises; neither body stands in for the other. The wrappers check
device, dtype and shape, copy a non-contiguous view into fresh storage,
allocate the output and the split-K partials with ``torch.empty``,
launch on the current stream and do not synchronise. ``gram_t.launches``
counts launches through either entry and ``gram_t.route_launches`` the
launches of each body.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.gram import ref as _ref

_C_FN = {("simt", torch.float32): "gram_simt_f32",
         ("simt", torch.float64): "gram_simt_f64",
         ("wgmma", torch.float32): "gram_wgmma_f32"}


def _declare(lib):
    for fn in _C_FN.values():
        f = getattr(lib, fn)
        # x, p, y, qy, v, ldv, k, partial, out, m, splits, rows, device,
        # stream
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    for fn in ("gram_wgmma_tile_p", "gram_wgmma_block_k",
               "gram_wgmma_max_vecs"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("gram_wgmma_tile_n", "gram_wgmma_raw_stages",
               "gram_wgmma_op_stages"):
        getattr(lib, fn).argtypes = [ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    lib.gram_wgmma_shared.argtypes = [ctypes.c_int] * 3
    lib.gram_wgmma_shared.restype = ctypes.c_int
    lib.gram_wgmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gram_wgmma_smem_bytes.restype = ctypes.c_longlong
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(x, y):
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"gram_t expects x (m, p) and y (m, q); got {tuple(x.shape)} "
            f"and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"gram_t takes float32 or float64 operands of one dtype; got "
            f"{x.dtype} and {y.dtype}")
    if min(x.shape) < 1 or y.shape[1] < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)}, {tuple(y.shape)}")


def _operands(x, y):
    """x and y as the kernel reads them: row-major and contiguous. A view
    that is not is copied first (a copy, not a fallback: the kernel still
    runs); y stays x where it was x."""
    same = y is x
    x = x.contiguous()
    return x, (x if same else y.contiguous())


def _route(x, y, k: int) -> str:
    """The body ``dispatch.gram_route`` picks for x^T [y | v^T] with k
    vectors, from the shapes and from x's and y's strides and start
    addresses: an f32 operand that TMA cannot describe (a start that is
    not 16-byte aligned) goes to the simt body."""
    (m, p), qy = x.shape, y.shape[1]
    return dispatch.gram_route(
        x.dtype, m, p, qy + k, y_cols=qy,
        operands=[(t.stride(), t.data_ptr()) for t in (x, y)])


def _launch(x, y, v=None, route: str | None = None):
    """The kernel on CUDA tensors: x^T [y | v^T] -> (p, qy + k), through
    the body ``dispatch.gram_route`` picks. Any operand that ``gram_t``
    takes runs: a non-contiguous view is copied, and an unaligned one
    goes to the simt body. ``route`` forces a body, for measurement only
    (``chip_smoke.py`` times the simt body that way), and raises where
    that body cannot read the operands."""
    if x.device.type != "cuda":
        raise ValueError(f"gram_t runs on cpu or cuda tensors, not "
                         f"{x.device}")
    x, y = _operands(x, y)
    (m, p), qy = x.shape, y.shape[1]
    k = 0 if v is None else v.shape[0]
    if route is None:
        route = _route(x, y, k)
    if (route, x.dtype) not in _C_FN:
        raise ValueError(f"gram has no {route!r} body for {x.dtype}")
    if route == "wgmma":
        for name, t in (("x", x), ("y", y)):
            if not dispatch.tma_strides_ok(t.stride(), t.data_ptr(),
                                           t.element_size()):
                raise ValueError(
                    f"gram: TMA needs {name} with a row stride that is a "
                    f"multiple of 16 bytes and a 16-byte aligned start; "
                    f"got strides {t.stride()}")
    plan = dispatch.gram_plan(
        m, p, qy + k, route, num_sms=torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    lib = _build.load("gram", _declare)
    partial = torch.empty((plan.splits, p, qy + k), dtype=x.dtype,
                          device=x.device)
    out = torch.empty((p, qy + k), dtype=x.dtype, device=x.device)
    rc = getattr(lib, _C_FN[route, x.dtype])(
        x.data_ptr(), p, y.data_ptr(), qy,
        0 if v is None else v.data_ptr(), 0 if v is None else v.stride(0),
        k, partial.data_ptr(), out.data_ptr(), m, plan.splits, plan.rows,
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"gram ({route})")
    gram_t.launches += 1
    gram_t.route_launches[route] += 1
    return out


def gram_t(x, y):
    """x^T @ y for x (m, p), y (m, q) -> (p, q) in x's dtype."""
    _check(x, y)
    if x.device.type == "cpu":
        return _ref.gram_t_ref(x, y)
    return _launch(x, y)


gram_t.launches = 0
gram_t.route_launches = {"wgmma": 0, "simt": 0}


def gram_fused(Y, V):
    """Y^T [Y | V^T] for Y (m, p) and k vectors V (k, m) -> (p, p + k):
    the fused Gram + projection block of paper Alg. 2 lines 11-12. The
    kernel reads V's rows in place where they are contiguous (a unit
    stride along m), else from a contiguous copy."""
    if V.dim() != 2 or V.shape[1] != Y.shape[0]:
        raise ValueError(f"gram_fused expects Y (m, p) and V (k, m); got "
                         f"{tuple(Y.shape)} and {tuple(V.shape)}")
    _check(Y, V.T)
    if Y.device.type == "cpu":
        return _ref.gram_fused_ref(Y, V)
    if V.stride(1) != 1:
        V = V.contiguous()
    return _launch(Y, Y, V)


def gram_and_proj(Y, V):
    """Fused  Y^T [Y | V]  ->  (G, P)  — paper Alg. 2 lines 11-12: one
    pass over Y per outer iteration gives the (c, c) Gram matrix and the
    (c, k) projections. V is (m, k), as in ``repro``."""
    c = Y.shape[1]
    out = gram_fused(Y, V.T)
    return out[:, :c], out[:, c:]
