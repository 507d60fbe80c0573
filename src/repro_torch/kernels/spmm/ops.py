"""Public wrapper for the blocked-ELL SpMM (K4, ``csrc/spmm.cu``) plus the
gather/scatter companions the sparse solver paths are built from.

On CPU tensors the plain version (``ref.ell_spmm_ref``) runs; on CUDA
tensors the kernel launches, or the call raises. ``ell_spmm.launches``
counts launches.

Padding contract (see ``repro_torch.core.types.SparseOperand``): padded
ELL slots hold index 0 and value 0, so every operation below is exact
with no masking. That is also why every scatter here ADDS
(``index_put_(..., accumulate=True)``): an indexed assignment would let a
padded slot's 0 overwrite a real value stored at index 0. On a card the
adds are atomics, so sums of several values at one index may round
differently from run to run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.spmm import ref as _ref

_C_FN = {torch.float32: "ell_spmm_f32", torch.float64: "ell_spmm_f64"}
# (R, K, Q, device index) -> dispatch.spmm_plan's arguments to the C entry.
_PLANS: dict = {}


def spmm_impl(device) -> str:
    """The SpMM that runs for operands on ``device``: "cuda" (the kernel)
    on a card, "torch" (the plain version) on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _declare(lib):
    for fn in _C_FN.values():
        f = getattr(lib, fn)
        # vals, idx, blocks, D, out, R, K, Q, ell_block, col_groups,
        # q_tiles, splits, device, stream
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    for fn in ("spmm_q_tile", "spmm_warps", "spmm_max_splits"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    lib.spmm_in_flight.argtypes = [ctypes.c_int]
    lib.spmm_in_flight.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(vals, idx, blocks, D, ell_block):
    shape = vals.shape
    if len(shape) != 2 or idx.shape != shape or D.dim() != 2 \
            or blocks.shape != shape[:1]:
        raise ValueError(
            f"ell_spmm expects vals/idx (R, K), blocks (R,) and D (C, Q); "
            f"got {tuple(shape)}, {tuple(idx.shape)}, "
            f"{tuple(blocks.shape)}, {tuple(D.shape)}")
    dev = vals.device
    if idx.device != dev or blocks.device != dev or D.device != dev:
        raise ValueError(f"ell_spmm: vals on {dev}, idx on {idx.device}, "
                         f"blocks on {blocks.device}, D on {D.device}")
    dt = vals.dtype
    if D.dtype != dt or dt not in _C_FN:
        raise TypeError(f"ell_spmm takes float32 or float64 vals and D of "
                        f"one dtype; got {dt} and {D.dtype}")
    if idx.dtype != torch.int32 or blocks.dtype != torch.int32:
        raise TypeError(f"ell_spmm: idx and blocks must be int32, got "
                        f"{idx.dtype} and {blocks.dtype}")
    if shape[0] < 1 or shape[1] < 1 or D.shape[0] < 1 or D.shape[1] < 1:
        raise ValueError(f"empty operand: {tuple(shape)}, "
                         f"{tuple(D.shape)}")
    if shape[1] % ell_block != 0:
        raise ValueError(f"ELL width {shape[1]} is not a multiple of "
                         f"ell_block={ell_block}")


def _plan(R: int, K: int, Q: int, device) -> tuple:
    """(col_groups, q_tiles, splits) of ``dispatch.spmm_plan`` on the
    card's SM count, cached per shape and card."""
    key = (R, K, Q, device.index)
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        p = dispatch.spmm_plan(R, K, Q, sms)
        plan = _PLANS[key] = (p.col_groups, p.q_tiles, p.splits)
    return plan


def ell_spmm(vals, idx, blocks, D, ell_block: int = 8):
    """out[r, q] = sum_k vals[r, k] * D[idx[r, k], q] -> (R, Q) in D's
    dtype. vals/idx (R, K) padded ELL rows, K a multiple of
    ``ell_block``; blocks (R,) each row's active K-block count (the
    kernel skips the rest, which hold zeros); D (C, Q) dense."""
    _check(vals, idx, blocks, D, ell_block)
    dev = vals.device
    if dev.type == "cpu":
        return _ref.ell_spmm_ref(vals, idx, D)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmm runs on cpu or cuda tensors, not {dev}")
    if not (vals.is_contiguous() and idx.is_contiguous()
            and blocks.is_contiguous() and D.is_contiguous()):
        raise ValueError("ell_spmm needs contiguous operands")
    lib = _build.load("spmm", _declare)
    (R, K), Q = vals.shape, D.shape[1]
    out = torch.empty((R, Q), dtype=D.dtype, device=dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    rc = getattr(lib, _C_FN[D.dtype])(
        vals.data_ptr(), idx.data_ptr(), blocks.data_ptr(), D.data_ptr(),
        out.data_ptr(), R, K, Q, ell_block, *_plan(R, K, Q, dev), index,
        _build.raw_stream(index))
    _build.check(lib, rc, "ell_spmm")
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0


def scatter_dense(idx, vals, size: int):
    """Densify gathered ELL rows: idx/vals (r, K) -> (size, r) whose
    column j is the j-th gathered sparse row scattered into R^size."""
    return scatter_dense_into(
        torch.zeros((size, idx.shape[0]), dtype=vals.dtype,
                    device=vals.device), idx, vals)


def scatter_dense_into(out, idx, vals):
    """Add gathered ELL rows into the first r columns of ``out`` (size,
    >= r) in place: column j += the j-th gathered sparse row. The sparse
    solvers' fused right operand [Y^T | vecs] is one allocation whose
    column ranges are written in place, so it is never copied."""
    cols = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return out.index_put_((idx, cols.expand_as(idx)), vals, accumulate=True)


def scatter_add(vec, idx, vals, coef):
    """vec + sum_j coef[j] * (j-th gathered sparse row), as a new tensor:
    the ELL form of the deferred updates r += A_B dx / x += Y^T (b theta)."""
    return vec.index_put((idx,), vals * coef[:, None], accumulate=True)


def scatter_steps(idx, vals, coef, size: int):
    """Per-step deferred vectors for the SA solvers: idx/vals (s, mu, K),
    coef (s, mu) -> (s, size) whose row t is block t's update
    A_{B_t} dx_t."""
    s = idx.shape[0]
    rows = torch.arange(s, device=idx.device)[:, None, None].expand_as(idx)
    return torch.zeros((s, size), dtype=vals.dtype,
                       device=vals.device).index_put_(
        (rows, idx), vals * coef[..., None], accumulate=True)
