"""Hopper budget table for the hand-written kernels (the port of
``repro/kernels/dispatch.py``).

The TPU package capped each kernel's VMEM-resident set at half of a v5e's
16 MB and fell back to the jnp reference above it. On an H100 the scarce
resource is a block's shared memory, 227 KB (232,448 bytes) of the SM's
256 KB, and nothing falls back: a configuration picks a variant of the
same kernel.

* ``gram``: fixed (64, 64) output tiles fed by (32, 64) slices of x and
  y in static shared memory (16 KB at f32, 32 KB at f64); the tall m
  axis is split across blocks (split-K), the split count chosen to put a
  few blocks on every SM.
* ``sa_inner``: G stays in shared memory while the kernel's whole
  footprint fits; above that the same kernel reads G's rows from global
  memory (through L2). ``sa_inner_smem_bytes`` must match the layout in
  ``csrc/sa_inner.cu`` (which exports the same formula;
  ``chip_smoke.py`` checks that they agree).
* ``svm_inner``: the same placement rule for its G, with
  ``svm_inner_smem_bytes`` matching ``csrc/svm_inner.cu``.
* ``spmm``: one block per output row and 256-wide tile of the dense
  operand's columns (``spmm_q_tiles`` of them along grid y); the kernel
  exports its tile width as ``spmm_q_tile`` for the same cross-check.
* ``flash_attention``: two bodies, chosen by ``flash_attention_route``.
  The ``wgmma`` body (bf16 at D = 64 and 128) runs one block of three
  warpgroups per 128-row query tile and (batch, query head); Q and a
  two-stage ring of 128-row K and V tiles sit in dynamic shared memory
  as bf16 (161 KB at D = 128), loaded by TMA, whose strides and starts
  ``tma_strides_ok`` checks. ``flash_tile_plan`` is the Python mirror of
  the live key tiles it walks and the tiles it masks. The ``simt`` body
  (f32, and bf16 at D = 32 and 160) runs one block per 64-row query tile
  over 64-row key tiles held as f32 (115 KB at D = 128, 139 KB at D =
  160). ``csrc/flash_attention.cu`` exports each body's tile sizes and
  shared-memory formula for the cross-check.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

SMEM_PER_BLOCK = 232_448      # H100: opt-in dynamic shared memory per block
NUM_SMS_H100 = 132

GRAM_TILE_P = 64
GRAM_TILE_Q = 64
GRAM_BLOCK_K = 32
GRAM_BLOCKS_PER_SM = 4

SA_INNER_WARPS = 16
SVM_INNER_WARPS = 16
SPMM_Q_TILE = 256

FLASH_BLOCK_Q = 64
FLASH_BLOCK_K = 64
FLASH_PAD = 4                 # f32 of padding per Q/K/P tile row
# 128: llama3-8b, qwen1.5-4b; 64: tinyllama-1.1b; 160: stablelm-12b.
FLASH_HEAD_DIMS = (32, 64, 128, 160)
FLASH_WGMMA_BLOCK_Q = 128
FLASH_WGMMA_BLOCK_K = 128
FLASH_WGMMA_STAGES = 2
# Head dimensions of the wgmma body (whole 128-byte rows of bf16). D = 32
# and D = 160 stay on the simt body for now.
FLASH_WGMMA_HEAD_DIMS = (64, 128)


def sa_inner_smem_bytes(s: int, mu: int, itemsize: int = 4,
                        g_in_smem: bool = True) -> int:
    """int64 sampled ids (s*mu), then at ``itemsize``: G (if resident),
    the dz history (s*mu), theta/coefU/eta (3 s) and each warp's two
    power-iteration vectors (2 mu)."""
    smu = s * mu
    elems = (smu * smu if g_in_smem else 0) + smu + 3 * s \
        + SA_INNER_WARPS * 2 * mu
    return smu * 8 + elems * itemsize


def sa_inner_g_in_smem(s: int, mu: int, itemsize: int = 4) -> bool:
    """Does ``sa_inner`` keep G in shared memory at (s, mu)?"""
    return sa_inner_smem_bytes(s, mu, itemsize, True) <= SMEM_PER_BLOCK


def svm_inner_smem_bytes(s: int, mu: int, itemsize: int = 4,
                         g_in_smem: bool = True) -> int:
    """int64 sampled ids (s*mu), then at ``itemsize``: G (if resident),
    the theta, b*theta and gradient histories (3 s*mu), lambda_max per
    step (s) and each warp's two power-iteration vectors (2 mu)."""
    smu = s * mu
    elems = (smu * smu if g_in_smem else 0) + 3 * smu + s \
        + SVM_INNER_WARPS * 2 * mu
    return smu * 8 + elems * itemsize


def svm_inner_g_in_smem(s: int, mu: int, itemsize: int = 4) -> bool:
    """Does ``svm_inner`` keep G in shared memory at (s, mu)?"""
    return svm_inner_smem_bytes(s, mu, itemsize, True) <= SMEM_PER_BLOCK


def flash_attention_route(dtype, D: int) -> str:
    """The body of ``csrc/flash_attention.cu`` that serves (dtype, D):
    ``"wgmma"`` for bf16 at D in ``FLASH_WGMMA_HEAD_DIMS``, else
    ``"simt"`` (f32 at every D: TF32 products would not meet its bars;
    bf16 at D = 32 and 160). ``dtype`` is a torch dtype or its name."""
    name = str(dtype).rsplit(".", 1)[-1]
    if name == "bfloat16" and D in FLASH_WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def flash_attention_smem_bytes(D: int, route: str = "simt") -> int:
    """Dynamic shared memory of one ``flash_attention`` block at head
    dimension D. simt: the Q and K tiles at row pitch D + FLASH_PAD, the V
    tile at pitch D and the probability tile at pitch FLASH_BLOCK_K +
    FLASH_PAD, all f32. wgmma: 1024 bytes to align the buffers, the bf16 Q
    tile, ``FLASH_WGMMA_STAGES`` K and V tiles, and the 8-byte barriers
    (one for Q; a full and an empty one for K and for V per stage)."""
    if route == "wgmma":
        return 1024 + 2 * D * (FLASH_WGMMA_BLOCK_Q + 2 * FLASH_WGMMA_STAGES
                               * FLASH_WGMMA_BLOCK_K) \
            + 8 * (1 + 4 * FLASH_WGMMA_STAGES)
    if route != "simt":
        raise ValueError(f"unknown flash_attention route {route!r}")
    return 4 * ((FLASH_BLOCK_Q + FLASH_BLOCK_K) * (D + FLASH_PAD)
                + FLASH_BLOCK_K * D
                + FLASH_BLOCK_Q * (FLASH_BLOCK_K + FLASH_PAD))


def flash_tile_plan(Sq: int, Sk: int, causal: bool, window: int,
                    block_q: int, block_k: int
                    ) -> List[Tuple[int, int, Tuple[bool, ...]]]:
    """What the wgmma body's producer loads and its consumers mask, per
    query tile iq (in order): ``(lo, hi, masked)`` with live key tiles
    [lo, hi) and ``masked[i]`` True when key tile lo + i holds a (query,
    key) pair of the tile that the mask hides. The rows of tile iq sit at
    positions iq * block_q + Sk - Sq + [0, block_q); a key tile is live
    by the test of repro's kernel.py:56-64 (causal: k_lo <= q_hi; window:
    k_hi > q_lo - window), and masked when it reaches past Sk, above the
    causal diagonal (k_hi > q_lo) or below the window (k_lo <= q_hi -
    window)."""
    n_k = -(-Sk // block_k)
    plan = []
    for iq in range(-(-Sq // block_q)):
        q_lo = iq * block_q + Sk - Sq
        q_hi = q_lo + block_q - 1
        lo, hi = 0, n_k
        if causal:
            hi = 0 if q_hi < 0 else min(hi, q_hi // block_k + 1)
        if window > 0:
            lo = max(0, (q_lo - window + 1) // block_k)
        hi = max(lo, hi)
        masked = tuple(
            (kt + 1) * block_k > Sk
            or (causal and (kt + 1) * block_k - 1 > q_lo)
            or (window > 0 and kt * block_k <= q_hi - window)
            for kt in range(lo, hi))
        plan.append((lo, hi, masked))
    return plan


def tma_strides_ok(strides: Sequence[int], data_ptr: int,
                   itemsize: int) -> bool:
    """Can a TMA tensor map describe an operand with these element
    ``strides`` (innermost last) starting at ``data_ptr``? The innermost
    stride must be 1, every other a multiple of 16 bytes below 2^40
    bytes, and the start 16-byte aligned."""
    *outer, inner = strides
    return inner == 1 and data_ptr % 16 == 0 and all(
        s > 0 and s * itemsize % 16 == 0 and s * itemsize < 2 ** 40
        for s in outer)


def spmm_q_tiles(Q: int) -> int:
    """Grid y of the ``spmm`` launch: 256-wide tiles covering Q columns."""
    return -(-Q // SPMM_Q_TILE)


def gram_splits(m: int, p: int, q: int,
                num_sms: int = NUM_SMS_H100) -> Tuple[int, int]:
    """(splits, rows_per_split) for the split-K ``gram`` grid: enough
    splits of the m axis that the (p/64) x (q/64) output tiles times the
    splits put ``GRAM_BLOCKS_PER_SM`` blocks on every SM, each split a
    whole number of 32-row K steps."""
    tiles = -(-p // GRAM_TILE_P) * -(-q // GRAM_TILE_Q)
    k_steps = -(-m // GRAM_BLOCK_K)
    splits = max(1, min(k_steps, -(-num_sms * GRAM_BLOCKS_PER_SM // tiles),
                        65535))
    rows = -(-k_steps // splits) * GRAM_BLOCK_K
    return -(-m // rows), rows
