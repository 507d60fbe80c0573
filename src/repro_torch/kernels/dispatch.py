"""Hopper budget table for the hand-written kernels (the port of
``repro/kernels/dispatch.py``).

The TPU package capped each kernel's VMEM-resident set at half of a v5e's
16 MB and fell back to the jnp reference above it. On an H100 the scarce
resource is a block's shared memory, 227 KB (232,448 bytes) of the SM's
256 KB, and nothing falls back: a configuration picks a variant of the
same kernel.

* ``gram``: two bodies, chosen by ``gram_route``; both split the tall m
  axis across blocks (split-K) and sum the partials in a fixed order.
  ``gram_plan`` is the Python mirror of either body's grid. The ``wgmma``
  body (f32 where TMA can describe the operands) runs one block of 640
  threads per (128-row tile of p, tile of q, range of m), a tile of q
  being the narrowest of the wgmma widths ``GRAM_WGMMA_TILE_NS`` that
  holds q; raw 32-row slices and their transposed tf32 hi/lo halves sit
  in two rings in dynamic shared memory (175 KB when A shares B's
  buffer, 201 KB when it does not, at q > 72), with one block on every
  SM. The ``simt`` body (f64, other f32 shapes) uses fixed (64, 64)
  output tiles fed by (32, 64) slices of x and y in static shared memory
  (16 KB at f32, 32 KB at f64), the split count chosen to put a few
  blocks on every SM. ``csrc/gram.cu`` exports the wgmma body's tile
  sizes and shared-memory formula for the cross-check.
* ``sa_inner``: G stays in shared memory while the kernel's whole
  footprint fits; above that the same kernel reads G's rows from global
  memory (through L2). ``sa_inner_smem_bytes`` must match the layout in
  ``csrc/sa_inner.cu`` (which exports the same formula;
  ``chip_smoke.py`` checks that they agree).
* ``svm_inner``: two bodies, chosen by ``svm_inner_route``. The
  ``warp`` body (mu <= 32, s mu <= 256, its layout in shared memory)
  runs the dependent chain in one warp, right-looking, over G's
  b-scaled columns held transposed; ``svm_inner_warp_smem_bytes`` is its
  layout. The ``block`` body keeps G in shared memory by the same
  placement rule as ``sa_inner`` (``svm_inner_smem_bytes``), else reads
  it from global memory. ``csrc/svm_inner.cu`` exports both formulas.
* ``spmm``: ``spmm_plan`` is the Python mirror of the grid. A warp
  covers a tile of the dense operand's columns in ``col_groups`` groups
  of 32 (at most ``SPMM_MAX_COL_GROUPS``, a 256-wide tile; wider Q takes
  ``spmm_q_tiles`` tiles along grid y); each output row's slots are
  split over a cluster of ``splits`` blocks of ``SPMM_WARPS`` warps,
  each warp a contiguous range (``spmm_worker_range``), and the
  cluster's partial rows are summed in a fixed order through
  distributed shared memory. The kernel exports its constants for the
  cross-check.
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

from typing import List, NamedTuple, Optional, Sequence, Tuple

SMEM_PER_BLOCK = 232_448      # H100: opt-in dynamic shared memory per block
NUM_SMS_H100 = 132

GRAM_TILE_P = 64
GRAM_TILE_Q = 64
GRAM_BLOCK_K = 32
GRAM_BLOCKS_PER_SM = 4
GRAM_WGMMA_TILE_P = 128       # two consumer warpgroups of 64 output rows
GRAM_WGMMA_BLOCK_K = 32       # rows of m per stage (one 128-byte row)
GRAM_WGMMA_MAX_VECS = 8       # k of a fused call: vectors read in place
GRAM_WGMMA_TILE_NS = (24, 72, 136)   # wgmma widths N of the tiles of q

SA_INNER_WARPS = 16
SVM_INNER_WARPS = 16
# The warp body of svm_inner: blocks of at most one warp's width, and at
# most this many rows per lane (s mu <= 256).
SVM_INNER_WARP_MAX_MU = 32
SVM_INNER_WARP_MAX_ROWS_PER_LANE = 8
SPMM_Q_TILE = 256             # widest tile of Q: SPMM_MAX_COL_GROUPS x 32
SPMM_MAX_COL_GROUPS = SPMM_Q_TILE // 32
SPMM_WARPS = 4                # warps of one spmm block
SPMM_MAX_SPLITS = 8           # blocks of a cluster (the portable size)
SPMM_BLOCKS_PER_SM = 4        # split rows until the grid has this many
SPMM_MIN_SLOTS = 8            # ... but not below this many slots a warp
GRID_X_MAX = 2 ** 31 - 1       # blocks along grid x

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


def svm_inner_warp_smem_bytes(s: int, mu: int, itemsize: int = 4) -> int:
    """The warp body's layout: int64 sampled ids (s*mu), then at
    ``itemsize``: G's b-scaled columns transposed at a pitch of s*mu + 1
    (s*mu rows), the diagonal blocks (s*mu*mu), the theta, gradient and
    b*theta histories (3 s*mu), 1 / lambda_max per step (s) and each
    warp's two power-iteration vectors (2 mu)."""
    smu = s * mu
    elems = smu * (smu + 1) + smu * mu + 3 * smu + s \
        + SVM_INNER_WARPS * 2 * mu
    return smu * 8 + elems * itemsize


def svm_inner_route(s: int, mu: int, itemsize: int = 4) -> str:
    """The body of ``csrc/svm_inner.cu`` that serves (s, mu): ``"warp"``
    where mu <= ``SVM_INNER_WARP_MAX_MU``, each lane owns at most
    ``SVM_INNER_WARP_MAX_ROWS_PER_LANE`` of the s*mu rows and the warp
    body's layout fits a block's shared memory; else ``"block"``."""
    smu = s * mu
    if mu <= SVM_INNER_WARP_MAX_MU \
            and smu <= 32 * SVM_INNER_WARP_MAX_ROWS_PER_LANE \
            and svm_inner_warp_smem_bytes(s, mu, itemsize) <= SMEM_PER_BLOCK:
        return "warp"
    return "block"


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


def flash_operand_ok(strides: Sequence[int], data_ptr: int, itemsize: int,
                     route: str) -> bool:
    """Can ``route``'s body of ``flash_attention`` read a (B, H, S, D)
    operand with these element ``strides`` at ``data_ptr`` in place?
    wgmma: ``tma_strides_ok``; simt: a unit stride along D, the others
    multiples of 4 elements, and a 16-byte aligned start. The wrapper
    copies an operand that fails into fresh (aligned, contiguous)
    storage."""
    if route == "wgmma":
        return tma_strides_ok(strides, data_ptr, itemsize)
    return strides[-1] == 1 and all(s % 4 == 0 for s in strides[:-1]) \
        and data_ptr % 16 == 0


def spmm_q_tiles(Q: int) -> int:
    """Grid y of the ``spmm`` launch: tiles of at most ``SPMM_Q_TILE``
    columns covering Q."""
    return -(-Q // SPMM_Q_TILE)


class SpmmPlan(NamedTuple):
    """The grid of one ``spmm`` launch: ``splits`` blocks (a cluster) per
    output row and ``q_tiles`` tiles of ``col_groups`` x 32 columns;
    grid (rows x splits, q_tiles), ``SPMM_WARPS`` warps a block."""
    col_groups: int
    q_tiles: int
    splits: int
    grid_x: int
    grid_y: int


def spmm_plan(R: int, K: int, Q: int,
              num_sms: int = NUM_SMS_H100) -> SpmmPlan:
    """The ``spmm`` grid for R rows of K padded ELL slots against a
    Q-wide D: the column groups a warp covers (ceil(Q/32), at most
    ``SPMM_MAX_COL_GROUPS``, then more tiles of q), and enough blocks per
    row (at most ``SPMM_MAX_SPLITS``, one cluster) that the grid puts
    ``SPMM_BLOCKS_PER_SM`` blocks on every SM, unless a warp would get
    fewer than ``SPMM_MIN_SLOTS`` of the K slots."""
    groups = min(-(-Q // 32), SPMM_MAX_COL_GROUPS)
    q_tiles = spmm_q_tiles(Q)
    want = -(-SPMM_BLOCKS_PER_SM * num_sms // (R * q_tiles))
    splits = max(1, min(SPMM_MAX_SPLITS, want,
                        -(-K // (SPMM_WARPS * SPMM_MIN_SLOTS)),
                        GRID_X_MAX // R))
    return SpmmPlan(groups, q_tiles, splits, R * splits, q_tiles)


def spmm_worker_range(K: int, active: int, workers: int,
                      worker: int) -> Tuple[int, int]:
    """The slots [lo, hi) of one row that warp ``worker`` of ``workers``
    (splits x SPMM_WARPS, block-rank major) reads: an even share of the K
    padded slots, cut at the row's ``active`` slots (the rest hold
    zeros)."""
    lo = worker * K // workers
    hi = (worker + 1) * K // workers
    return min(lo, active), min(hi, active)


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


def gram_route(dtype, m: int, p: int, q: int,
               y_cols: Optional[int] = None,
               operands: Sequence[Tuple[Sequence[int], int]] = ()) -> str:
    """The body of ``csrc/gram.cu`` that serves x (m, p) against a q-wide
    y (``y_cols`` of it read from a row-major tensor, the other q -
    y_cols vectors read in place; default all q): ``"wgmma"`` for f32
    when TMA can describe x and y, i.e. p and ``y_cols`` are multiples of
    4 (row strides of whole 16-byte units), every (strides, data_ptr) of
    ``operands`` (x's and y's, where the caller has them) passes
    ``tma_strides_ok``, and there are at most ``GRAM_WGMMA_MAX_VECS``
    vectors; else ``"simt"`` (f64 always: TF32 products would not keep
    its accuracy; an f32 operand at an unaligned start: the simt body
    reads scalars). ``dtype`` is a torch dtype or its name."""
    name = str(dtype).rsplit(".", 1)[-1]
    y_cols = q if y_cols is None else y_cols
    if name == "float32" and min(m, p, y_cols) >= 1 and p % 4 == 0 \
            and y_cols % 4 == 0 and q - y_cols <= GRAM_WGMMA_MAX_VECS \
            and all(tma_strides_ok(st, ptr, 4) for st, ptr in operands):
        return "wgmma"
    return "simt"


def gram_tile_n(q: int) -> int:
    """Width of the wgmma body's tiles of q: the narrowest of
    ``GRAM_WGMMA_TILE_NS`` that holds q, else the widest."""
    return next((n for n in GRAM_WGMMA_TILE_NS if q <= n),
                GRAM_WGMMA_TILE_NS[-1])


def gram_wgmma_shared(same: bool, p: int, q: int) -> bool:
    """Does the wgmma body read A from B's buffer? When x and y are one
    tensor and one tile holds the whole output: then x is read from
    device memory once."""
    tn = gram_tile_n(q)
    return same and p <= GRAM_WGMMA_TILE_P and q <= tn \
        and tn >= 64 * -(-p // 64)


def gram_wgmma_raw_stages(shared: bool) -> int:
    """Depth of the wgmma body's ring of raw TMA slices: 4 where A shares
    B's buffer (half the bytes a stage), else 2."""
    return 4 if shared else 2


def gram_wgmma_op_stages(shared: bool) -> int:
    """Depth of the wgmma body's ring of transposed tf32 hi/lo stages: 3
    where A shares B's buffer, else 2."""
    return 3 if shared else 2


def gram_wgmma_smem_bytes(tile_n: int, shared: bool) -> int:
    """Dynamic shared memory of one wgmma ``gram`` block: 1024 bytes to
    align the buffers; for every transposed row (B's ``tile_n``, plus A's
    ``GRAM_WGMMA_TILE_P`` unless A shares B's buffer) 128 bytes each of
    tf32 hi and lo per op stage and 128 bytes of raw slice per raw stage,
    plus ``GRAM_WGMMA_MAX_VECS`` vectors' 32 values per raw stage; then a
    full and an empty 8-byte barrier per stage of each ring."""
    rows = tile_n + (0 if shared else GRAM_WGMMA_TILE_P)
    raw, op = gram_wgmma_raw_stages(shared), gram_wgmma_op_stages(shared)
    return 1024 + op * 2 * rows * 128 \
        + raw * (rows + GRAM_WGMMA_MAX_VECS) * 128 + 8 * 2 * (op + raw)


class GramPlan(NamedTuple):
    """The grid of one ``gram`` launch: (q_tiles, p_tiles, splits) blocks
    of (tile_p, tile_n) outputs over ``rows`` rows of m each (the last
    split ragged), ``shared`` when A is read from B's buffer, and the
    block's shared memory."""
    route: str
    tile_p: int
    tile_n: int
    p_tiles: int
    q_tiles: int
    splits: int
    rows: int
    shared: bool
    smem_bytes: int


def gram_plan(m: int, p: int, q: int, route: str, same: bool = False,
              num_sms: int = NUM_SMS_H100, itemsize: int = 4) -> GramPlan:
    """The grid ``route``'s body runs for x (m, p) against a q-wide y
    (``same``: x is y's first p columns' tensor, as in the solvers' fused
    call). wgmma: enough splits of m, each a whole number of 32-row
    stages, that the tiles times the splits give every SM a block. simt:
    ``gram_splits``."""
    if route == "simt":
        splits, rows = gram_splits(m, p, q, num_sms)
        return GramPlan("simt", GRAM_TILE_P, GRAM_TILE_Q,
                        -(-p // GRAM_TILE_P), -(-q // GRAM_TILE_Q), splits,
                        rows, False,
                        GRAM_BLOCK_K * (GRAM_TILE_P + GRAM_TILE_Q) * itemsize)
    if route != "wgmma":
        raise ValueError(f"unknown gram route {route!r}")
    tn = gram_tile_n(q)
    p_tiles, q_tiles = -(-p // GRAM_WGMMA_TILE_P), -(-q // tn)
    k_steps = -(-m // GRAM_WGMMA_BLOCK_K)
    splits = max(1, min(k_steps, -(-num_sms // (p_tiles * q_tiles)),
                        65535))
    rows = -(-k_steps // splits) * GRAM_WGMMA_BLOCK_K
    shared = gram_wgmma_shared(same, p, q)
    return GramPlan("wgmma", GRAM_WGMMA_TILE_P, tn, p_tiles, q_tiles,
                    -(-m // rows), rows, shared,
                    gram_wgmma_smem_bytes(tn, shared))
