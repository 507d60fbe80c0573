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
"""
from __future__ import annotations

from typing import Tuple

SMEM_PER_BLOCK = 232_448      # H100: opt-in dynamic shared memory per block
NUM_SMS_H100 = 132

GRAM_TILE_P = 64
GRAM_TILE_Q = 64
GRAM_BLOCK_K = 32
GRAM_BLOCKS_PER_SM = 4

SA_INNER_WARPS = 16
SVM_INNER_WARPS = 16
SPMM_Q_TILE = 256


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
