"""Public wrapper for the fused Gram + projection kernel (K1,
``csrc/gram.cu``).

On a CPU tensor the plain version (``ref.gram_t_ref``) runs; on a CUDA
tensor the hand-written split-K kernel launches, or the call raises. The
wrapper checks device, dtype, shape and contiguity, allocates the output
and the split-K partials with ``torch.empty``, launches on the current
stream and does not synchronise. ``gram_t.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.gram import ref as _ref

_C_FN = {torch.float32: "gram_t_f32", torch.float64: "gram_t_f64"}


def _declare(lib):
    for fn in _C_FN.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(x, y):
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"gram_t expects x (m, p) and y (m, q); got {tuple(x.shape)} "
            f"and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.dtype != y.dtype or x.dtype not in _C_FN:
        raise TypeError(
            f"gram_t takes float32 or float64 operands of one dtype; got "
            f"{x.dtype} and {y.dtype}")
    if min(x.shape) < 1 or y.shape[1] < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)}, {tuple(y.shape)}")


def gram_t(x, y):
    """x^T @ y for x (m, p), y (m, q) -> (p, q) in x's dtype."""
    _check(x, y)
    if x.device.type == "cpu":
        return _ref.gram_t_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gram_t runs on cpu or cuda tensors, not "
                         f"{x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gram_t needs contiguous row-major operands")
    lib = _build.load("gram", _declare)
    (m, p), q = x.shape, y.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, rows = dispatch.gram_splits(m, p, q, sms)
    partial = torch.empty((splits, p, q), dtype=x.dtype, device=x.device)
    out = torch.empty((p, q), dtype=x.dtype, device=x.device)
    rc = getattr(lib, _C_FN[x.dtype])(
        x.data_ptr(), y.data_ptr(), partial.data_ptr(), out.data_ptr(),
        m, p, q, splits, rows, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "gram_t")
    gram_t.launches += 1
    return out


gram_t.launches = 0


def gram_and_proj(Y, V):
    """Fused  Y^T [Y | V]  ->  (G, P)  — paper Alg. 2 lines 11-12: one
    pass over Y per outer iteration gives the (c, c) Gram matrix and the
    (c, k) projections."""
    c = Y.shape[1]
    out = gram_t(Y, torch.cat([Y, V], dim=1))
    return out[:, :c], out[:, c:]
