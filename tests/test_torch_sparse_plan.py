"""K4's and K3's Hopper designs on the CPU: their plans, routes, layouts
and arithmetic; and the routing repairs of K1 and K5.

* ``dispatch.spmm_plan`` / ``spmm_worker_range``: every active slot of
  a row is read by exactly one warp, padded slots by none, with at most 8
  blocks a cluster and the grid inside CUDA's limits, at the sweep's and
  the paths' shapes; a blocked evaluator of the kernel's order (each
  warp's slots in order, the warps' rows in warp order, the cluster's in
  rank order) against repro's ``ell_spmm_ref`` (rtol 1e-4 / atol 1e-4 at
  f32, the card's bar) and the plain version (1e-12 at f64).
* ``dispatch.svm_inner_route``: ``warp`` exactly where mu <= 32, s mu <=
  256 and the warp body's layout fits a block's shared memory; both
  bodies' layouts laid out array by array as ``csrc/svm_inner.cu`` does;
  an evaluator of the warp body's right-looking chain (b-scaled columns,
  r and beta carried per row, sums in step order, a product with 1 /
  lambda_max for the division) against repro's
  ``svm_inner_ref`` at repro's f32 bar (theta rtol 1e-4 / atol 1e-5,
  increments 1e-4 / 1e-4) and the plain version at 1e-12 (f64), with
  collisions and nu = inf.
* ``dispatch.gram_route`` sends an f32 operand at an unaligned start, or
  with strides TMA cannot describe, to K1's simt body, and ``_launch``
  takes such operands (and non-contiguous views) without refusing.
* ``dispatch.flash_operand_ok`` and K5's ``_readable``: which operands
  are copied before the launch.
The kernels themselves run only on a card: chip_smoke.py holds them
against their plain versions there.
"""
import math
import pathlib
import re

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import SparseOperand as JSparseOperand
from repro.kernels.spmm.ref import ell_spmm_ref as j_ell_spmm_ref
from repro.kernels.svm_inner.ref import svm_inner_ref as j_svm_inner_ref
from repro_torch.core.linalg import power_iteration_max_eig
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.spmm.ref import ell_spmm_ref
from repro_torch.kernels.svm_inner import ops as svm_ops
from repro_torch.kernels.svm_inner import svm_inner_loop
from repro_torch.kernels.svm_inner.ref import svm_inner_ref

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels" / "csrc"
SMEM = dispatch.SMEM_PER_BLOCK
# (R, K, Q): the SVM path (news20.binary: 64 rows, ~455 of 552 slots
# active, Q = s mu + 1) and its classical solve (R = 1, Q = 2), the url
# Lasso path (128 gathered columns of ~86 of 136 slots, Q = 130), the
# sweep's shapes, a Q of two tiles, and a tall cross product (url's rows).
PLAN_SHAPES = [(64, 552, 65), (1, 552, 2), (128, 136, 130), (12, 40, 5),
               (33, 128, 17), (64, 200, 1), (7, 16, 130), (1, 56, 2),
               (40, 32, 300), (3, 8, 65), (2_396_130, 16, 130)]
# (R, C, Q, density, empty leading rows): the sweep's shapes, a Q of two
# tiles, all rows empty, an SVM-path-like row block and its classical
# (R = 1, Q = 2) call.
SPMM_CASES = [(12, 40, 5, 0.3, 0), (33, 128, 17, 0.05, 0),
              (64, 200, 1, 0.5, 0), (7, 16, 130, 0.4, 2),
              (1, 50, 2, 0.2, 0), (40, 300, 300, 0.04, 5),
              (3, 40, 65, 0.3, 3), (64, 600, 65, 0.4, 0),
              (1, 600, 2, 0.4, 0)]
# (s, mu, n_ids, nu): the test_svm_inner_kernel_sweep cases, the SVM
# path's (64, 1), a block of a full warp, and forced collisions.
SVM_CASES = [(s, mu, n, nu) for s, mu, n in ((4, 1, 12), (8, 4, 12),
                                             (16, 2, 12), (3, 5, 12),
                                             (64, 1, 12), (64, 1, 4000),
                                             (2, 32, 12), (24, 3, 4))
             for nu in (1.0, float("inf"))]


# --------------------------------------------------------------------------
# K4 spmm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,K,Q", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_spmm_plan_covers_every_slot_once(R, K, Q, sms):
    plan = dispatch.spmm_plan(R, K, Q, sms)
    tile = 32 * plan.col_groups
    assert 1 <= plan.col_groups <= dispatch.SPMM_MAX_COL_GROUPS
    assert plan.col_groups == min(-(-Q // 32), dispatch.SPMM_MAX_COL_GROUPS)
    assert (plan.q_tiles - 1) * tile < Q <= plan.q_tiles * tile
    assert 1 <= plan.splits <= dispatch.SPMM_MAX_SPLITS <= 8
    assert plan.grid_x == R * plan.splits <= dispatch.GRID_X_MAX
    assert plan.grid_y == plan.q_tiles <= 65535
    # enough blocks for every SM, unless the cluster or the slots stop it
    if plan.grid_x * plan.grid_y < dispatch.SPMM_BLOCKS_PER_SM * sms:
        assert plan.splits == dispatch.SPMM_MAX_SPLITS or plan.splits \
            * dispatch.SPMM_WARPS * dispatch.SPMM_MIN_SLOTS >= K
    workers = plan.splits * dispatch.SPMM_WARPS
    for active in sorted({0, 8, K // 2 // 8 * 8, K - 8, K} & set(
            range(0, K + 1, 8))):
        seen = np.zeros(K, np.int64)
        last = 0
        for w in range(workers):
            lo, hi = dispatch.spmm_worker_range(K, active, workers, w)
            assert lo <= hi and lo >= last or lo == hi
            seen[lo:hi] += 1
            last = max(last, hi)
        assert (seen[:active] == 1).all() and (seen[active:] == 0).all()


def test_spmm_plan_at_the_paths():
    """news20.binary's call fills the card with clusters of 8; url's with
    clusters of 5; a tall cross product needs no split."""
    assert dispatch.spmm_plan(64, 552, 65) == (3, 1, 8, 512, 1)
    assert dispatch.spmm_plan(128, 136, 130) == (5, 1, 5, 640, 1)
    assert dispatch.spmm_plan(2_396_130, 16, 130).splits == 1
    assert dispatch.spmm_plan(7, 16, 300).q_tiles == 2


def _spmm_inputs(R, C, Q, density, empty, dtype):
    rng = np.random.default_rng(R * 7 + C + Q)
    S = rng.standard_normal((R, C)).astype(np.float32)
    S[rng.random((R, C)) >= density] = 0.0
    S[:empty] = 0.0
    op = JSparseOperand.from_dense(S)
    D = rng.standard_normal((C, Q)).astype(dtype)
    return (np.asarray(op.row_vals).astype(dtype), np.asarray(op.row_cols),
            np.asarray(op.row_blocks), D, op.ell_block)


def spmm_blocked(vals, idx, blocks, D, ell_block, plan):
    """The kernel's arithmetic in its order: warp w of block `rank` sums
    its slots in order, a block its warps in warp order, the cluster its
    blocks in rank order; tiles of q side by side."""
    R, K = vals.shape
    Q = D.shape[1]
    tile = 32 * plan.col_groups
    workers = plan.splits * dispatch.SPMM_WARPS
    out = torch.zeros((R, Q), dtype=D.dtype)
    for r in range(R):
        active = min(int(blocks[r]), K // ell_block) * ell_block
        for t in range(plan.q_tiles):
            cols = slice(t * tile, min(Q, (t + 1) * tile))
            total = torch.zeros_like(D[0, cols])
            for rank in range(plan.splits):
                block = torch.zeros_like(total)
                for w in range(dispatch.SPMM_WARPS):
                    lo, hi = dispatch.spmm_worker_range(
                        K, active, workers, rank * dispatch.SPMM_WARPS + w)
                    acc = torch.zeros_like(total)
                    for k in range(lo, hi):
                        acc = acc + vals[r, k] * D[idx[r, k], cols]
                    block = block + acc
                total = total + block
            out[r, cols] = total
    return out


@pytest.mark.parametrize("R,C,Q,density,empty", SPMM_CASES)
def test_spmm_blocked_evaluator_matches_repro_f32(R, C, Q, density, empty):
    vals, idx, blocks, D, eb = _spmm_inputs(R, C, Q, density, empty,
                                            np.float32)
    plan = dispatch.spmm_plan(R, vals.shape[1], Q)
    got = spmm_blocked(*(torch.from_numpy(a) for a in (vals, idx, blocks,
                                                       D)), eb, plan)
    want = np.asarray(j_ell_spmm_ref(jnp.asarray(vals), jnp.asarray(idx),
                                     jnp.asarray(D)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if empty:
        assert (got[:empty] == 0).all()


@pytest.mark.parametrize("R,C,Q,density,empty", SPMM_CASES[:6])
def test_spmm_blocked_evaluator_matches_plain_f64(R, C, Q, density, empty):
    ins = [torch.from_numpy(a) for a in _spmm_inputs(R, C, Q, density,
                                                     empty, np.float64)[:4]]
    plan = dispatch.spmm_plan(R, ins[0].shape[1], Q)
    got = spmm_blocked(*ins, 8, plan)
    torch.testing.assert_close(got, ell_spmm_ref(ins[0], ins[1], ins[3]),
                               rtol=1e-12, atol=1e-12)


def _constants(name):
    src = (CSRC / name).read_text()
    return re.findall(r"constexpr int (\w+) = (\d+);\s*// dispatch\.(\w+)",
                      src)


@pytest.mark.parametrize("source,names", [
    ("spmm.cu", {"SPMM_WARPS", "SPMM_MAX_COL_GROUPS", "SPMM_MAX_SPLITS"}),
    ("svm_inner.cu", {"SVM_INNER_WARPS", "SVM_INNER_WARP_MAX_MU",
                      "SMEM_PER_BLOCK"})])
def test_kernel_constants_match_dispatch(source, names):
    """Each ``constexpr`` a source ties to a ``dispatch`` name has its
    value; the multi-line tag of the rows-per-lane cap too."""
    found = _constants(source)
    assert names <= {n for _, _, n in found}
    for _, value, name in found:
        assert int(value) == getattr(dispatch, name), name
    if source == "svm_inner.cu":
        m = re.search(r"dispatch\.SVM_INNER_WARP_MAX_ROWS_PER_LANE\s*\n"
                      r"constexpr int \w+ = (\d+);",
                      (CSRC / source).read_text())
        assert int(m.group(1)) == dispatch.SVM_INNER_WARP_MAX_ROWS_PER_LANE


def test_spmm_wrapper_refuses_before_the_card(monkeypatch):
    """On a CUDA tensor the wrapper launches or raises: a plan of the
    card's shape reaches the build (stopped here, with no nvcc)."""
    from repro_torch.kernels.spmm import ell_spmm, ops
    vals, idx, blocks, D, _ = _spmm_inputs(12, 40, 5, 0.3, 0, np.float32)
    ins = [torch.from_numpy(a) for a in (vals, idx, blocks, D)]
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))

    def build_stop(name, declare):
        raise LookupError(name)
    monkeypatch.setattr(ops._build, "load", build_stop)
    with pytest.raises(LookupError, match="spmm"):
        ell_spmm(*ins)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmm(ins[0], ins[1], ins[2], ins[3].T.contiguous().T)
    assert ell_spmm.launches == 0


# --------------------------------------------------------------------------
# K3 svm_inner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("s,mu", [(64, 1), (16, 8), (3, 5), (64, 8),
                                  (2, 32), (8, 32), (1, 33), (4, 33),
                                  (256, 1), (257, 1), (128, 2), (300, 1),
                                  (1, 1)])
def test_svm_inner_route(s, mu, itemsize):
    smu = s * mu
    warp_bytes = smu * 8 + (smu * (smu + 1) + smu * mu + 3 * smu + s
                            + 16 * 2 * mu) * itemsize
    want = "warp" if mu <= 32 and smu <= 256 and warp_bytes <= SMEM \
        else "block"
    assert dispatch.svm_inner_route(s, mu, itemsize) == want
    assert dispatch.svm_inner_warp_smem_bytes(s, mu, itemsize) == warp_bytes


@pytest.mark.parametrize("itemsize", [4, 8])
def test_svm_inner_warp_cap_straddles(itemsize):
    """At mu = 1 the warp body ends where its layout leaves shared memory,
    before a lane would own a ninth row: s = 237 at f32, 166 at f64; the
    SVM path's (64, 1) is well inside."""
    cap = max(s for s in range(1, 400)
              if dispatch.svm_inner_route(s, 1, itemsize) == "warp")
    assert dispatch.svm_inner_route(cap + 1, 1, itemsize) == "block"
    assert all(dispatch.svm_inner_route(s, 1, itemsize) == "warp"
               for s in range(1, cap + 1))
    assert cap == (237 if itemsize == 4 else 166)
    assert dispatch.svm_inner_route(64, 1, itemsize) == "warp"


def _layout(arrays):
    """End offset of arrays laid one after another from byte 0, each
    (count, itemsize), checking each starts on its own alignment."""
    off = 0
    for count, size in arrays:
        assert off % size == 0
        off += count * size
    return off


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("s,mu", [(64, 1), (16, 8), (3, 5), (2, 32),
                                  (64, 8), (238, 1)])
def test_svm_inner_layouts_mirror_the_kernel(s, mu, itemsize):
    """Both bodies' shared memory, array by array as the kernel carves it:
    int64 ids, then (block) G if resident, theta, b*theta, g, lambda and
    the power-iteration vectors; (warp) the b-scaled transposed columns
    at pitch s mu + 1, the packed diagonal blocks, theta, g, b*theta,
    lambda, the power-iteration vectors."""
    smu = s * mu
    pw = dispatch.SVM_INNER_WARPS * 2 * mu
    for g in (True, False):
        assert dispatch.svm_inner_smem_bytes(s, mu, itemsize, g) == _layout(
            [(smu, 8), (smu * smu if g else 0, itemsize), (smu, itemsize),
             (smu, itemsize), (smu, itemsize), (s, itemsize),
             (pw, itemsize)])
    assert dispatch.svm_inner_warp_smem_bytes(s, mu, itemsize) == _layout(
        [(smu, 8), (smu * (smu + 1), itemsize), (smu * mu, itemsize),
         (smu, itemsize), (smu, itemsize), (smu, itemsize), (s, itemsize),
         (pw, itemsize)])
    route = dispatch.svm_inner_route(s, mu, itemsize)
    used = dispatch.svm_inner_warp_smem_bytes(s, mu, itemsize) \
        if route == "warp" else dispatch.svm_inner_smem_bytes(
            s, mu, itemsize, dispatch.svm_inner_g_in_smem(s, mu, itemsize))
    assert used <= SMEM


def _svm_inputs(s, mu, n_ids, dtype):
    rng = np.random.default_rng(s * 10 + mu + n_ids)
    G0 = rng.standard_normal((64, s * mu))
    G = (G0.T @ G0 + 0.5 * np.eye(s * mu)).astype(dtype)
    proj = rng.standard_normal((s, mu)).astype(dtype)
    b = np.where(rng.standard_normal((s, mu)) < 0, -1.0, 1.0).astype(dtype)
    a_vals = (0.2 * rng.random((s, mu))).astype(dtype)
    idx = rng.integers(0, n_ids, (s, mu))
    return G, proj, b, a_vals, idx


def svm_warp_chain(G, proj, b, a_vals, idx, gamma, nu, power_iters=32):
    """The warp body's arithmetic: G's columns scaled by b, r and beta of
    every row carried from proj and a_vals, g times 1 / lambda_max, and
    after each step its mu thetas added into every row in order
    (right-looking); lambda_max and the dual increments off the chain,
    from the unscaled diagonal blocks."""
    s, mu = proj.shape
    smu = s * mu
    Gb = G * b.reshape(smu)[None, :]
    ids = idx.reshape(smu)
    r = proj.reshape(smu).clone()
    beta = a_vals.reshape(smu).clone()
    bf = b.reshape(smu)
    th = torch.zeros(smu, dtype=G.dtype)
    g = torch.zeros(smu, dtype=G.dtype)
    deltas = []
    for j in range(s):
        rows = slice(j * mu, (j + 1) * mu)
        Gjj = G[rows, rows]
        lam = Gjj[0, 0] if mu == 1 else power_iteration_max_eig(
            Gjj, power_iters)
        gj = bf[rows] * r[rows] - 1.0 + gamma * beta[rows]
        gbar = torch.abs(torch.clamp(beta[rows] - gj, 0.0, nu) - beta[rows])
        tj = torch.where(gbar != 0.0,
                         torch.clamp(beta[rows] - gj * (1.0 / lam), 0.0, nu)
                         - beta[rows], torch.zeros_like(gj))
        th[rows], g[rows] = tj, gj
        for q in range(mu):
            col = j * mu + q
            r = r + Gb[:, col] * tj[q]
            beta = beta + torch.where(ids == ids[col], tj[q],
                                      torch.zeros_like(tj[q]))
        bt = bf[rows] * tj
        deltas.append(torch.sum(tj * gj) + 0.5 * bt @ (Gjj @ bt))
    return th.reshape(s, mu), torch.stack(deltas)


@pytest.mark.parametrize("s,mu,n_ids,nu", SVM_CASES)
def test_svm_warp_chain_matches_repro_f32(s, mu, n_ids, nu):
    ins = _svm_inputs(s, mu, n_ids, np.float32)
    th, dl = svm_warp_chain(*(torch.from_numpy(a) for a in ins), 0.3, nu)
    th_j, dl_j = j_svm_inner_ref(*(jnp.asarray(a) for a in ins), 0.3, nu)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s,mu,n_ids,nu", SVM_CASES[::2] + SVM_CASES[9:10])
def test_svm_warp_chain_matches_plain_f64(s, mu, n_ids, nu):
    ins = [torch.from_numpy(a) for a in _svm_inputs(s, mu, n_ids,
                                                    np.float64)]
    th, dl = svm_warp_chain(*ins, 0.3, nu)
    th_r, dl_r = svm_inner_ref(*ins, 0.3, nu)
    torch.testing.assert_close(th, th_r, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dl, dl_r, rtol=1e-12, atol=1e-12)


def test_svm_inner_forced_route_refuses_before_the_card(monkeypatch):
    """Forcing the warp body where it cannot run raises in the wrapper;
    the path's (64, 1) takes the warp body and reaches the build."""
    ins = [torch.from_numpy(a) for a in _svm_inputs(64, 8, 12, np.float32)]
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="no 'warp' body"):
        svm_ops._launch(*ins, 0.3, 1.0, 32, route="warp")

    def build_stop(name, declare):
        raise LookupError(name)
    monkeypatch.setattr(svm_ops._build, "load", build_stop)
    ins = [torch.from_numpy(a) for a in _svm_inputs(64, 1, 12, np.float32)]
    assert svm_ops._route(64, 1, 4, None) == ("warp", 2)
    assert svm_ops._route(64, 8, 4, None) == ("block", 0)
    assert svm_ops._route(64, 1, 4, "block") == ("block", 1)
    with pytest.raises(LookupError, match="svm_inner"):
        svm_inner_loop(*ins, gamma=0.3, nu=1.0)
    assert svm_inner_loop.route_launches == {"warp": 0, "block": 0}


# --------------------------------------------------------------------------
# K1 and K5: operands the fast bodies cannot read
# --------------------------------------------------------------------------

def _offset_view(shape, offset, dtype=torch.float32):
    """A contiguous view of ``shape`` ``offset`` elements into fresh
    storage (aligned), so its start is not 16-byte aligned for small
    offsets."""
    n = math.prod(shape)
    return torch.randn(n + offset, generator=torch.Generator().manual_seed(
        n), dtype=torch.float32).to(dtype)[offset:].view(shape)


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (1, "simt"),
                                          (2, "simt"), (4, "wgmma")])
def test_gram_route_follows_the_start_address(offset, route):
    x = _offset_view((300, 64), offset)
    assert x.is_contiguous()
    assert (x.data_ptr() % 16 == 0) == (route == "wgmma")
    ops = [(x.stride(), x.data_ptr())]
    assert dispatch.gram_route(torch.float32, 300, 64, 64,
                               operands=ops) == route
    assert gram_ops._route(x, x, 0) == route
    # f64 is simt whatever the address
    assert dispatch.gram_route(torch.float64, 300, 64, 64,
                               operands=ops) == "simt"


def test_gram_route_refuses_strides_tma_cannot_describe():
    """A row stride that is not whole 16-byte units (a column slice of a
    wider row), or a column stride other than 1, goes to simt; the
    solvers' shapes with no operand given keep the wgmma body."""
    base = torch.zeros(300, 65)
    x = base[:, :64]
    assert dispatch.gram_route(torch.float32, 300, 64, 64, operands=[
        (x.stride(), x.data_ptr())]) == "simt"
    xt = torch.zeros(64, 300).T
    assert dispatch.gram_route(torch.float32, 300, 64, 64, operands=[
        (xt.stride(), xt.data_ptr())]) == "simt"
    assert dispatch.gram_route(torch.float32, 400_000, 128, 130,
                               y_cols=128) == "wgmma"


def test_gram_launch_takes_unaligned_and_strided_operands(monkeypatch):
    """``_launch`` refuses none of them: a non-contiguous view is copied
    (then TMA can read it), an unaligned one goes to simt; the call
    reaches the plan and the build (stopped here, with no nvcc)."""
    taken = []
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    monkeypatch.setattr(gram_ops.dispatch, "gram_plan",
                        lambda m, p, q, route, **kw: taken.append(route)
                        or (_ for _ in ()).throw(LookupError(route)))
    monkeypatch.setattr(gram_ops.torch.cuda, "get_device_properties",
                        lambda d: type("P", (), {
                            "multi_processor_count": 132})())
    for x, y, want in ((_offset_view((300, 64), 1), None, "simt"),
                       (torch.zeros(300, 65)[:, :64], None, "wgmma"),
                       (_offset_view((300, 64), 0),
                        _offset_view((300, 8), 3), "simt"),
                       (torch.zeros(64, 300).T, None, "wgmma")):
        with pytest.raises(LookupError, match=want):
            gram_ops._launch(x, x if y is None else y)
    assert taken == ["simt", "wgmma", "simt", "wgmma"]


@pytest.mark.parametrize("offset,D,dtype,route,ok", [
    (0, 128, torch.bfloat16, "wgmma", True),
    (1, 128, torch.bfloat16, "wgmma", False),
    (8, 128, torch.bfloat16, "wgmma", True),
    (4, 128, torch.bfloat16, "wgmma", False),
    (1, 64, torch.float32, "simt", False),
    (4, 64, torch.float32, "simt", True),
    (2, 32, torch.bfloat16, "simt", False)])
def test_flash_copy_decision(offset, D, dtype, route, ok):
    """An operand the body cannot read where it lies is copied into fresh
    storage (aligned, contiguous), which both bodies read; one it can
    read is passed as it is."""
    q = _offset_view((1, 2, 16, D), offset, dtype)
    assert dispatch.flash_operand_ok(q.stride(), q.data_ptr(),
                                     q.element_size(), route) == ok
    got = flash_ops._readable(q, route)
    assert (got is q) == ok
    assert torch.equal(got, q)
    for body in ("wgmma", "simt"):
        assert ok or dispatch.flash_operand_ok(
            got.stride(), got.data_ptr(), got.element_size(), body)


def test_flash_copy_decision_on_strides():
    """A head dimension that is not contiguous, or rows of D = 36 bf16
    (72 bytes), are copied; a transposed (B, S, H, D) projection is read
    in place by the wgmma body."""
    v = torch.zeros(2, 200, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert flash_ops._readable(v, "wgmma") is v
    t = torch.zeros(1, 2, 128, 16, dtype=torch.bfloat16).transpose(2, 3)
    assert not dispatch.flash_operand_ok(t.stride(), t.data_ptr(), 2,
                                         "simt")
    assert flash_ops._readable(t, "simt").is_contiguous()
    w = torch.zeros(1, 2, 16, 36, dtype=torch.bfloat16)
    assert not dispatch.flash_operand_ok(w.stride(), w.data_ptr(), 2,
                                         "wgmma")
