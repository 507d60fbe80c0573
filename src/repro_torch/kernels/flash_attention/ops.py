"""Public wrapper for flash attention (K5, ``csrc/flash_attention.cu``):
dispatch, the chunked path and autograd (the port of
``repro/kernels/flash_attention/ops.py``).

Forward: on a CUDA tensor the hand-written kernel launches, or the call
raises; on a CPU tensor the plain version runs (``ref.attention_ref``, or
``attention_chunked`` from ``CHUNKED_THRESHOLD`` query rows on, as
``repro`` dispatches its non-Pallas backends). The kernel has two bodies,
chosen by ``dispatch.flash_attention_route``: ``wgmma`` (bf16 at D = 64
and 128, fed by TMA) and ``simt`` (f32, and bf16 at D = 32 and 160). A
failed build or launch raises; neither body stands in for the other. The
kernel takes ragged lengths as they are (no padding), so the
causal/window band sits at the unpadded offset Sk - Sq. An operand whose
strides or start the chosen body cannot read (an unaligned view, a head
dimension that is not contiguous) is copied into fresh, aligned storage
first (``_readable``), and the kernel runs on the copy. Backward: the
plain version's VJP, as ``repro``'s ``_flash_bwd``; no backward kernel
exists there. ``flash_attention.launches`` counts kernel launches and
``flash_attention.route_launches`` the launches of each body.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.flash_attention import ref as _ref

# Query lengths at or above this use the chunked path on the CPU (the
# S x S score tensor would dominate memory otherwise).
CHUNKED_THRESHOLD = 2048

_C_FN = {("simt", torch.float32): "flash_attention_f32",
         ("simt", torch.bfloat16): "flash_attention_bf16",
         ("wgmma", torch.bfloat16): "flash_attention_bf16_wgmma"}


def _declare(lib):
    for (route, _), fn in _C_FN.items():
        f = getattr(lib, fn)
        # The wgmma body takes one more int: whether its consumers take
        # turns (ping-pong).
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3 \
            + [ctypes.c_float] + [ctypes.c_int] * (1 + (route == "wgmma")) \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    for fn in ("flash_attention_block_q", "flash_attention_block_k",
               "flash_attention_wgmma_block_q",
               "flash_attention_wgmma_block_k",
               "flash_attention_wgmma_stages"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("flash_attention_smem_bytes",
               "flash_attention_wgmma_smem_bytes"):
        getattr(lib, fn).argtypes = [ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_longlong
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"flash_attention expects q (B, Hq, Sq, D) and k, v (B, Hkv, "
            f"Sk, D) with Hq a multiple of Hkv; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v of dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if min(q.shape) < 1 or k.shape[2] < 1:
        raise ValueError(f"empty operand: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def _readable(t, route: str):
    """``t`` where ``route``'s body can read it in place
    (``dispatch.flash_operand_ok``: TMA's stride and alignment rule for
    wgmma, a unit stride along D, strides of whole 16-byte units and an
    aligned start for simt), else a copy in fresh storage, which
    PyTorch's allocator aligns and lays out contiguously, so that either
    body reads it. The kernel runs on the copy; nothing falls back."""
    if dispatch.flash_operand_ok(t.stride(), t.data_ptr(), t.element_size(),
                                 route):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal: bool, window: int, scale: float,
            route: str | None = None, pingpong: bool = True):
    """The kernel on CUDA tensors -> (B, Hq, Sq, D) in q's dtype, through
    the body ``dispatch.flash_attention_route`` picks. ``route`` forces a
    body and ``pingpong=False`` stops the wgmma body's consumers from
    taking turns: ``chip_smoke.py`` times both beside the default that
    way."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention's kernel takes float32 or "
                        f"bfloat16, not {q.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D not in dispatch.FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head dimensions "
                         f"{dispatch.FLASH_HEAD_DIMS}, not {D}")
    if route is None:
        route = dispatch.flash_attention_route(q.dtype, D)
    if (route, q.dtype) not in _C_FN or (
            route == "wgmma" and D not in dispatch.FLASH_WGMMA_HEAD_DIMS):
        raise ValueError(f"flash_attention has no {route!r} body for "
                         f"{q.dtype} at D = {D}")
    q, k, v = (_readable(t, route) for t in (q, k, v))
    lib = _build.load("flash_attention", _declare)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    schedule = (int(pingpong),) if route == "wgmma" else ()
    rc = getattr(lib, _C_FN[route, q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), int(window), Sk - Sq, float(scale),
        *schedule, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


class _Flash(torch.autograd.Function):
    """Kernel (CUDA) or plain (CPU) forward; the plain version's VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        if q.device.type == "cpu":
            return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                      scale=scale)
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.mask
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _ref.attention_ref(*leaves, causal=causal, window=window,
                                     scale=scale)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      scale: float | None = None, q_chunk: int = 1024):
    """Memory-bounded plain attention: a loop over query chunks, so the
    live score block is (B, H, q_chunk, Sk) instead of (B, H, Sq, Sk).
    Same math as ``ref.attention_ref``; differentiable. With ``window``
    > 0 each chunk reads only the q_chunk + window keys it can see. GQA
    is computed grouped (no repeat of k and v)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    bq = min(q_chunk, Sq)
    offset = Sk - Sq
    qg = q.reshape(B, Hkv, g, Sq, D)
    use_kslice = window > 0 and window + bq < Sk
    kwin = min(window + bq, Sk)
    chunks = []
    for lo in range(0, Sq, bq):
        qs = qg[:, :, :, lo:lo + bq]
        qpos = lo + offset + torch.arange(qs.shape[3], device=q.device)
        start = 0
        ks, vs = k, v
        if use_kslice:
            # keys visible to this chunk: [q_start - window + 1, q_end]
            start = min(max(lo + offset - window + 1, 0), Sk - kwin)
            ks, vs = k[:, :, start:start + kwin], v[:, :, start:start + kwin]
        kpos = start + torch.arange(ks.shape[2], device=q.device)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qs.float(), ks.float()) * scale
        mask = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vs.float())
        chunks.append(o.to(q.dtype))
    return torch.cat(chunks, dim=3).reshape(B, Hq, Sq, D)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Blocked GQA attention. q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) ->
    (B, Hq, Sq, D) in q's dtype.

    ``causal`` masks the future; ``window`` > 0 adds a sliding window
    (queries attend at most the last ``window`` keys). A bidirectional
    call needs lengths that divide min(128, length), as ``repro``'s
    kernel path does (its padding would unmask keys)."""
    _check(q, k, v)
    Sq, Sk = q.shape[2], k.shape[2]
    if not causal and window == 0 and (Sq % min(128, Sq) or
                                       Sk % min(128, Sk)):
        raise ValueError("bidirectional attention needs sequence lengths "
                         "divisible by min(128, length) (padding would "
                         "unmask)")
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cpu" and Sq >= CHUNKED_THRESHOLD:
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 scale=scale)
    return _Flash.apply(q, k, v, causal, window, scale)


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "simt": 0}
