"""Kernel safety pass (the port of ``repro/analysis/kernels.py``).

The hand-written Hopper kernels under ``repro_torch.kernels`` rest on
hand-maintained contracts between ``kernels/dispatch.py`` (the Python
mirror of each kernel's routes, plans and shared-memory formulas) and
the CUDA sources. ``repro``'s three Pallas checks become these:

  * **guard drift** — every ``// dispatch.NAME`` constant in
    ``kernels/csrc/*.cu*`` equals ``dispatch.NAME``, and the shared
    memory of every body that a ``*_route`` picks over each registered
    family's ``tune_space`` (K1-K3, f32 and f64) and over the ported LM
    archs' head dimensions (K5) stays within ``SMEM_PER_BLOCK`` (a
    static ``__shared__`` body within the 48 KB static limit);
  * **output injectivity** — each plan writes every output element
    exactly once: ``gram_plan``'s tiles of p and q and its splits of m,
    ``spmm_plan``'s tiles of Q and ``spmm_worker_range``'s slot ranges,
    ``flash_tile_plan``'s query tiles, the inner kernels' output layout
    and power-iteration groups;
  * **bounds** — every plan stays inside its operands' shapes, its grid
    inside ``GRID_X_MAX`` (65,535 along y and z), and the certification
    operands' ELL indices inside the dense operand they gather from.

Every package named in ``repro_torch.kernels.KERNEL_PACKAGES`` must have
a describer here — a package without one is an error, and so is a
describer that names no package.

``repro``'s ``KernelCapture``, ``SpecView``, ``capture_pallas_calls`` and
``capture_footprint`` read Pallas BlockSpecs; they have no counterpart.
"""
from __future__ import annotations

import pathlib
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.common import Diagnostic

__all__ = ["check_kernels", "guard_drift_diags", "output_injectivity_diags",
           "index_map_bounds_diags", "dispatch_tags", "DESCRIBERS"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc"
STATIC_SMEM_MAX = 49_152       # static __shared__ bytes per block
GRID_YZ_MAX = 65_535           # blocks along grid y and z

_TAIL = re.compile(r"constexpr\s+int\s+\w+\s*=\s*(\d+)\s*;\s*//\s*"
                   r"dispatch\.([A-Z][A-Z0-9_]*)")
_HEAD = re.compile(
    r"^[ \t]*//\s*dispatch\.([A-Z][A-Z0-9_]*)[ \t]*\n\s*constexpr\s+int\s+"
    r"\w+\s*=\s*(\d+)\s*;", re.MULTILINE)


def dispatch_tags(source: str) -> List[Tuple[str, int, int]]:
    """(NAME, value, line) of every constant a source ties to
    ``dispatch.NAME``, by a tag after it on its line or on the line
    before it."""
    out = []
    for m in _TAIL.finditer(source):
        out.append((m.group(2), int(m.group(1)),
                    source.count("\n", 0, m.start()) + 1))
    for m in _HEAD.finditer(source):
        out.append((m.group(1), int(m.group(2)),
                    source.count("\n", 0, m.start()) + 2))
    return sorted(out, key=lambda t: t[2])


def guard_drift_diags(path: pathlib.Path, dispatch) -> List[Diagnostic]:
    """One error per ``// dispatch.NAME`` constant of ``path`` that
    differs from ``dispatch.NAME`` (or names nothing there)."""
    diags = []
    for name, value, line in dispatch_tags(path.read_text()):
        where = f"{path.name}:{line}"
        want = getattr(dispatch, name, None)
        if want is None:
            diags.append(Diagnostic(
                "kernels", "error", where,
                f"guard drift: the source ties a constant to "
                f"dispatch.{name}, which kernels/dispatch.py does not "
                f"define"))
        elif value != want:
            diags.append(Diagnostic(
                "kernels", "error", where,
                f"guard drift: the source has {value} where "
                f"dispatch.{name} = {want} — the Python mirror plans "
                f"launches the kernel does not make"))
    return diags


def output_injectivity_diags(where: str, label: str,
                             ranges: Sequence[Tuple[int, int]],
                             extent: int) -> List[Diagnostic]:
    """The [lo, hi) ranges a plan writes (or reads, for a contraction)
    must cover [0, extent) exactly once: no element twice (a write race,
    or a term summed twice) and none left out."""
    spans = sorted((lo, hi) for lo, hi in ranges if hi > lo)
    pos, twice, gaps = 0, [], []
    for lo, hi in spans:
        if lo < pos:
            twice.append((lo, min(hi, pos)))
        elif lo > pos:
            gaps.append((pos, lo))
        pos = max(pos, hi)
    if pos < extent:
        gaps.append((pos, extent))
    diags = []
    if twice:
        diags.append(Diagnostic(
            "kernels", "error", where,
            f"write race on {label}: [{twice[0][0]}, {twice[0][1]}) is "
            f"covered twice ({len(twice)} overlap(s)) — each element must "
            f"be written exactly once"))
    if gaps:
        diags.append(Diagnostic(
            "kernels", "error", where,
            f"{label}: [{gaps[0][0]}, {gaps[0][1]}) of [0, {extent}) is "
            f"covered by no part of the plan ({len(gaps)} gap(s))"))
    return diags


def index_map_bounds_diags(where: str, label: str,
                 ranges: Sequence[Tuple[int, int]], extent: int
                 ) -> List[Diagnostic]:
    """Every [lo, hi) range a plan addresses (a block index mapped to
    the elements it reads or writes) lies inside [0, extent)."""
    bad = [(lo, hi) for lo, hi in ranges
           if lo < 0 or hi > extent or lo > hi]
    if not bad:
        return []
    return [Diagnostic(
        "kernels", "error", where,
        f"out of bounds on {label}: [{bad[0][0]}, {bad[0][1]}) against "
        f"an extent of {extent} ({len(bad)} range(s))")]


def _limit(where: str, what: str, value: int, limit: int
           ) -> List[Diagnostic]:
    if value <= limit:
        return []
    return [Diagnostic("kernels", "error", where,
                       f"{what} {value} exceeds {limit}")]


def _tiles(n_tiles: int, tile: int, extent: int):
    return [(i * tile, min(extent, (i + 1) * tile)) for i in range(n_tiles)]


def _space() -> List[Tuple[int, int]]:
    """Every (s, mu) of every registered family's tune_space, and the
    paths' incumbents."""
    from repro_torch.core.api import FAMILIES
    pts = {(16, 8), (64, 1), (16, 4)}
    for fam in FAMILIES.values():
        space = dict(fam.tune_space)
        pts |= {(s, mu) for s in space.get("s", ()) for mu in
                space.get("mu", ())}
    return sorted(pts)


# ---------------------------------------------------------------------------
# Per-package describers: (diagnostics, subjects checked).
# ---------------------------------------------------------------------------

def _describe_gram(dispatch) -> Tuple[List[Diagnostic], int]:
    diags: List[Diagnostic] = []
    n = 0
    for tile_n in dispatch.GRAM_WGMMA_TILE_NS:
        for shared in (False, True):
            diags += _limit(f"gram[wgmma,tile_n={tile_n},shared={shared}]",
                            "shared memory",
                            dispatch.gram_wgmma_smem_bytes(tile_n, shared),
                            dispatch.SMEM_PER_BLOCK)
    for itemsize in (4, 8):
        diags += _limit(f"gram[simt,itemsize={itemsize}]",
                        "static shared memory",
                        dispatch.GRAM_BLOCK_K * (dispatch.GRAM_TILE_P
                                                 + dispatch.GRAM_TILE_Q)
                        * itemsize, STATIC_SMEM_MAX)
    for s, mu in _space():
        p = s * mu
        for k in (1, 2):
            q = p + k
            for dtype, itemsize in (("float32", 4), ("float64", 8)):
                for m in (384, 400_000):
                    route = dispatch.gram_route(dtype, m, p, q, y_cols=p)
                    plan = dispatch.gram_plan(m, p, q, route, same=True,
                                              itemsize=itemsize)
                    where = f"gram[{route},m={m},p={p},q={q},{dtype}]"
                    n += 1
                    diags += _limit(where, "shared memory", plan.smem_bytes,
                                    dispatch.SMEM_PER_BLOCK)
                    diags += _limit(where, "grid x (tiles of q)",
                                    plan.q_tiles, dispatch.GRID_X_MAX)
                    diags += _limit(where, "grid y (tiles of p)",
                                    plan.p_tiles, GRID_YZ_MAX)
                    diags += _limit(where, "grid z (splits of m)",
                                    plan.splits, GRID_YZ_MAX)
                    rows = _tiles(plan.p_tiles, plan.tile_p, p)
                    cols = _tiles(plan.q_tiles, plan.tile_n, q)
                    split = _tiles(plan.splits, plan.rows, m)
                    for label, rng, ext in (("output rows (p)", rows, p),
                                            ("output columns (q)", cols, q),
                                            ("splits of m", split, m)):
                        diags += index_map_bounds_diags(where, label, rng, ext)
                        diags += output_injectivity_diags(where, label, rng,
                                                          ext)
    return diags, n


def _spmm_shapes(dispatch):
    """(R, K, Q) of the SpMMs the sparse paths make: the fused Gram of
    the column (Q = s mu + 2) and row (Q = s mu + 1) layouts and the
    cross block A Y^T (R = m), over the tune spaces, at ELL widths of the
    certification operands (32), news20.binary (560) and wider."""
    out = set()
    for s, mu in _space():
        smu = s * mu
        for K in (8, 32, 560, 1024):
            out |= {(smu, K, smu + 2), (smu, K, smu + 1),
                    (19_996, K, smu), (128, K, smu)}
    return sorted(out)


def _describe_spmm(dispatch) -> Tuple[List[Diagnostic], int]:
    from repro_torch.analysis.costs import certification_operand
    from repro_torch.core.api import FAMILIES
    diags: List[Diagnostic] = []
    n = 0
    ranges_seen = set()
    for R, K, Q in _spmm_shapes(dispatch):
        plan = dispatch.spmm_plan(R, K, Q)
        where = f"spmm[R={R},K={K},Q={Q}]"
        n += 1
        diags += _limit(where, "grid x (rows x splits)", plan.grid_x,
                        dispatch.GRID_X_MAX)
        diags += _limit(where, "grid y (tiles of Q)", plan.grid_y,
                        GRID_YZ_MAX)
        diags += _limit(where, "cluster (splits)", plan.splits,
                        dispatch.SPMM_MAX_SPLITS)
        diags += _limit(where, "column groups", plan.col_groups,
                        dispatch.SPMM_MAX_COL_GROUPS)
        diags += _limit(where, "columns of a tile left without a lane",
                        min(Q, dispatch.SPMM_Q_TILE) - 32 * plan.col_groups,
                        0)
        cols = _tiles(plan.q_tiles, dispatch.SPMM_Q_TILE, Q)
        diags += index_map_bounds_diags(where, "output columns (Q)", cols, Q)
        diags += output_injectivity_diags(where, "output columns (Q)",
                                          cols, Q)
        workers = plan.splits * dispatch.SPMM_WARPS
        if (K, workers) in ranges_seen:
            continue
        ranges_seen.add((K, workers))
        for active in range(K + 1):
            slots = [dispatch.spmm_worker_range(K, active, workers, w)
                     for w in range(workers)]
            label = f"slots of a row ({active} active)"
            d = index_map_bounds_diags(where, label, slots, active) \
                + output_injectivity_diags(where, label, slots, active)
            if d:
                diags += d
                break
    for fam in FAMILIES.values():
        op = certification_operand(fam)
        m, n_cols = op.shape
        for label, idx, extent in (("row ELL columns", op.row_cols, n_cols),
                                   ("column ELL rows", op.col_rows, m)):
            lo, hi = int(idx.min()), int(idx.max())
            diags += index_map_bounds_diags(f"spmm[{fam.name} operand]", label,
                                  [(lo, hi + 1)], extent)
        n += 1
    return diags, n


def _inner_output(where: str, s: int, mu: int) -> List[Diagnostic]:
    """The inner kernels' output: one (s mu + s) allocation whose first
    s mu elements are the (s, mu) steps and last s the per-step
    scalars (``ops._launch``)."""
    smu = s * mu
    parts = [(0, smu), (smu, smu + s)]
    return index_map_bounds_diags(where, "output", parts, smu + s) \
        + output_injectivity_diags(where, "output", parts, smu + s)


def _describe_inner(dispatch, name: str) -> Tuple[List[Diagnostic], int]:
    prefix = "sa_inner" if name == "sa_inner" else "svm_inner"
    route_of = getattr(dispatch, f"{prefix}_route")
    warp_smem = getattr(dispatch, f"{prefix}_warp_smem_bytes")
    block_smem = getattr(dispatch, f"{prefix}_smem_bytes")
    g_in_smem = getattr(dispatch, f"{prefix}_g_in_smem")
    upper = prefix.upper()
    max_mu = getattr(dispatch, f"{upper}_WARP_MAX_MU")
    max_rpl = getattr(dispatch, f"{upper}_WARP_MAX_ROWS_PER_LANE")
    warps = getattr(dispatch, f"{upper}_WARPS")
    diags: List[Diagnostic] = []
    n = 0
    for s, mu in _space():
        for itemsize in (4, 8):
            route = route_of(s, mu, itemsize)
            where = f"{name}[{route},s={s},mu={mu},itemsize={itemsize}]"
            n += 1
            if route == "warp":
                diags += _limit(where, "shared memory",
                                warp_smem(s, mu, itemsize),
                                dispatch.SMEM_PER_BLOCK)
                diags += _limit(where, "block size mu", mu, max_mu)
                diags += _limit(where, "rows per lane",
                                -(-s * mu // 32), max_rpl)
                if name == "sa_inner" and mu > 1:
                    width = dispatch.sa_inner_group_width(mu)
                    pw = dispatch.sa_inner_power_warps(s, mu)
                    groups = [(j * width, j * width + width)
                              for j in range(s)]
                    diags += _limit(where, "power-iteration warps", pw,
                                    warps - 1)
                    diags += index_map_bounds_diags(
                        where, "power-iteration lanes", groups, 32 * pw)
                    diags += output_injectivity_diags(
                        where, "power-iteration lanes (one group a block)",
                        groups, s * width)
                    diags += _limit(where, "block wider than its group",
                                    mu, width)
            else:
                diags += _limit(
                    where, "shared memory",
                    block_smem(s, mu, itemsize, g_in_smem(s, mu, itemsize)),
                    dispatch.SMEM_PER_BLOCK)
            diags += _inner_output(where, s, mu)
    return diags, n


def _head_dims(dispatch) -> List[int]:
    """The head dimensions K5 serves: dispatch's, and those of every
    ported LM arch with an attention block (xlstm-350m has none)."""
    from repro_torch import configs
    from repro_torch.models.lm import check_ported, has_attention
    dims = set(dispatch.FLASH_HEAD_DIMS)
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        try:
            check_ported(cfg)
        except NotImplementedError:
            continue
        if has_attention(cfg):
            dims.add(cfg.head_dim_)
    return sorted(dims)


# (Sq, Sk, causal, window): the llama3-8b prefill, the mixtral-8x7b
# prefill (window 4096: whole key tiles skipped), decode against a cache,
# a ragged window, a bidirectional Sq < Sk, a partial last tile, and
# whisper-large-v3's bidirectional calls at ragged lengths: its encoder
# (1500 x 1500) and its cross-attention (448 decoder positions x 1500).
FLASH_CASES = ((8192, 8192, True, 0), (8192, 8192, True, 4096),
               (1, 384, True, 128), (300, 300, True, 100),
               (128, 256, False, 0), (520, 520, True, 0),
               (100, 228, True, 0), (1500, 1500, False, 0),
               (448, 1500, False, 0))


def _describe_flash_attention(dispatch) -> Tuple[List[Diagnostic], int]:
    diags: List[Diagnostic] = []
    n = 0
    for D in _head_dims(dispatch):
        for dtype in ("float32", "bfloat16"):
            route = dispatch.flash_attention_route(dtype, D)
            n += 1
            diags += _limit(f"flash_attention[{route},D={D},{dtype}]",
                            "shared memory",
                            dispatch.flash_attention_smem_bytes(D, route),
                            dispatch.SMEM_PER_BLOCK)
    blocks = ((dispatch.FLASH_WGMMA_BLOCK_Q, dispatch.FLASH_WGMMA_BLOCK_K),
              (dispatch.FLASH_BLOCK_Q, dispatch.FLASH_BLOCK_K))
    for Sq, Sk, causal, window in FLASH_CASES:
        for bq, bk in blocks:
            where = (f"flash_attention[Sq={Sq},Sk={Sk},causal={causal},"
                     f"window={window},tiles={bq}x{bk}]")
            n += 1
            plan = dispatch.flash_tile_plan(Sq, Sk, causal, window, bq, bk)
            n_k = -(-Sk // bk)
            rows = _tiles(len(plan), bq, Sq)
            diags += index_map_bounds_diags(where, "query rows", rows, Sq)
            diags += output_injectivity_diags(where, "query rows", rows, Sq)
            diags += index_map_bounds_diags(where, "live key tiles",
                                  [(lo, hi) for lo, hi, _ in plan], n_k)
            for iq, (lo, hi, masked) in enumerate(plan):
                if len(masked) != hi - lo:
                    diags.append(Diagnostic(
                        "kernels", "error", where,
                        f"query tile {iq}: {len(masked)} mask flags for "
                        f"{hi - lo} live key tiles"))
                    break
                q_lo = iq * bq + Sk - Sq
                q_hi = min(q_lo + bq, Sk) - 1
                k_first = max(0, q_lo - window + 1) if window > 0 else 0
                k_last = min(Sk - 1, q_hi) if causal else Sk - 1
                if k_first <= k_last and not (
                        lo * bk <= k_first and hi * bk > k_last):
                    diags.append(Diagnostic(
                        "kernels", "error", where,
                        f"query tile {iq}: visible keys [{k_first}, "
                        f"{k_last}] are not all in its live tiles "
                        f"[{lo}, {hi})"))
                    break
    return diags, n


DESCRIBERS: Dict[str, Callable] = {
    "gram": _describe_gram,
    "spmm": _describe_spmm,
    "sa_inner": lambda d: _describe_inner(d, "sa_inner"),
    "svm_inner": lambda d: _describe_inner(d, "svm_inner"),
    "flash_attention": _describe_flash_attention,
}


def check_kernels(csrc: Optional[pathlib.Path] = None,
                  packages: Optional[Iterable[str]] = None
                  ) -> Tuple[List[Diagnostic], List[str]]:
    """The kernel safety pass over every package of ``packages``
    (default ``KERNEL_PACKAGES``), with the CUDA sources read from
    ``csrc`` (default the package's ``kernels/csrc``): coverage, guard
    drift, output injectivity and bounds. Returns (diagnostics, checked
    package names); the number of plans checked rides along as info."""
    from repro_torch.kernels import KERNEL_PACKAGES, dispatch
    csrc = pathlib.Path(csrc) if csrc is not None else CSRC
    packages = tuple(KERNEL_PACKAGES if packages is None else packages)
    diags: List[Diagnostic] = []
    checked: List[str] = []
    for path in sorted(csrc.glob("*.cu*")):
        diags += guard_drift_diags(path, dispatch)
    for pkg in packages:
        if pkg not in DESCRIBERS:
            diags.append(Diagnostic(
                "kernels", "error", pkg,
                f"kernel package {pkg!r} has no safety-pass describer — "
                f"register one in repro_torch.analysis.kernels so its "
                f"shared memory and plans are verified"))
            continue
        if not (csrc / f"{pkg}.cu").exists():
            diags.append(Diagnostic(
                "kernels", "error", pkg,
                f"kernel package {pkg!r} has no source {pkg}.cu in "
                f"{csrc}"))
        checked.append(pkg)
        pkg_diags, n = DESCRIBERS[pkg](dispatch)
        diags += pkg_diags
        diags.append(Diagnostic(
            "kernels", "info", pkg,
            f"{n} routes and plans checked against SMEM_PER_BLOCK "
            f"{dispatch.SMEM_PER_BLOCK} B and the grid limits"))
    stray = sorted(set(DESCRIBERS) - set(packages))
    if stray:
        diags.append(Diagnostic(
            "kernels", "error", ",".join(stray),
            f"describer(s) {stray} name no package in "
            f"repro_torch.kernels.KERNEL_PACKAGES — stale registration"))
    return diags, checked
