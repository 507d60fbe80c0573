"""The port's sparse operands (repro_torch.core.types.SparseOperand,
core/sparse_exec.py, data/sparse.py as_operand=True) and the sparse Lasso
path against repro's, on the CPU.

* Operand arrays: the six ELL arrays (row/col indices, values, active
  block counts) equal repro's bit for bit — dtype, shape and values — from
  from_dense, from_coo (triplets in any order: the port sorts on the
  tensors' device by row * n + col) and make_*_dataset(as_operand=True).
* Products: matvec, rmatvec, the row/column gathers and todense against
  the dense matrix (exact where they only move values).
* Sparse Lasso: classical BCD/accBCD and SA-BCD/SA-accBCD, with the
  symmetric Gram, elastic net, group lasso and warm starts, through
  repro with jax_enable_x64 in ONE subprocess for this module; the port
  is held to x, the trace and every state leaf within 1e-10, and to its
  own dense solve of the same matrix within 1e-10.
"""
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest
import torch

from repro.core.types import SparseOperand as JSparseOperand
from repro.data import sparse as jdata
from repro_torch import api, convert
from repro_torch import core as tcore
from repro_torch.core.sparse_exec import (col_block_ops, cross_block,
                                          row_block_ops, spmm_aux)
from repro_torch.core.types import SparseOperand
from repro_torch.data import sparse as tdata

H = 37
L2 = 0.5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
XLA_FAST_COMPILE = "--xla_backend_optimization_level=0"
FIELDS = ("row_cols", "row_vals", "row_blocks", "col_rows", "col_vals",
          "col_blocks")


def _matrix(seed, m, n, density, empty_rows=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    A[rng.random((m, n)) >= density] = 0.0
    A[:empty_rows] = 0.0
    return A


def _assert_same_arrays(op, jop):
    assert op.ell_block == jop.ell_block and op.shape == tuple(jop.shape)
    for f in FIELDS:
        got, want = getattr(op, f).numpy(), np.asarray(getattr(jop, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f


MATRICES = [(0, 40, 30, 0.2, 0), (1, 7, 90, 0.05, 3), (2, 64, 64, 0.5, 0),
            (3, 5, 4, 0.0, 0), (4, 300, 20, 0.01, 10)]


@pytest.mark.parametrize("seed,m,n,density,empty", MATRICES)
def test_from_dense_matches_repro_bitwise(seed, m, n, density, empty):
    A = _matrix(seed, m, n, density, empty)
    op = SparseOperand.from_dense(torch.from_numpy(A))
    _assert_same_arrays(op, JSparseOperand.from_dense(A))
    assert op.nnz == int((A != 0).sum())
    assert np.array_equal(op.todense().numpy(), A)


@pytest.mark.parametrize("ell_block", [1, 8, 16])
def test_from_coo_shuffled_matches_repro_bitwise(ell_block):
    """Triplets in a random order: the device sort by row * n + col gives
    repro's host lexsort arrays, indices ascending within each row."""
    A = _matrix(7, 50, 80, 0.1, 2)
    rows, cols = np.nonzero(A)
    perm = np.random.default_rng(0).permutation(rows.size)
    r, c, v = rows[perm], cols[perm], A[rows, cols][perm]
    op = SparseOperand.from_coo(torch.from_numpy(r), torch.from_numpy(c),
                                torch.from_numpy(v), A.shape,
                                ell_block=ell_block)
    jop = JSparseOperand.from_coo(r, c, v, A.shape, ell_block=ell_block)
    _assert_same_arrays(op, jop)
    idx = op.row_cols.numpy()
    width = (op.row_vals != 0).sum(1).numpy()
    for i, w in enumerate(width):
        assert np.all(np.diff(idx[i, :w]) > 0)


@pytest.mark.parametrize("maker,name", [
    ("svm", "w1a-like"), ("svm", "rcv1-like"), ("lasso", "news20-like"),
    ("lasso", "url-like")])
def test_datasets_as_operand_match_repro_bitwise(maker, name):
    t_make = getattr(tdata, f"make_{maker}_dataset")
    j_make = getattr(jdata, f"make_{maker}_dataset")
    got = t_make(name, 3, as_operand=True, device="cpu")
    want = j_make(name, 3, as_operand=True)
    _assert_same_arrays(got[0], want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    dense = t_make(name, 3, device="cpu")[0]
    assert np.array_equal(got[0].todense().numpy(), dense.numpy())
    if maker == "lasso":
        assert got[2] == want[2]


def test_products_and_gathers():
    A = _matrix(11, 60, 45, 0.15, 4)
    op = SparseOperand.from_dense(A).astype(torch.float64)
    A64 = torch.from_numpy(A.astype(np.float64))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(45))
    y = torch.from_numpy(rng.standard_normal(60))
    assert op.dtype == torch.float64 and op.row_cols.dtype == torch.int32
    torch.testing.assert_close(op.matvec(x), A64 @ x, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(op.rmatvec(y), A64.T @ y, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(tcore.operand_matvec(op, x), A64 @ x,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(tcore.operand_rmatvec(A64, y), A64.T @ y)
    idx = torch.tensor([3, 0, 59, 3])
    rows, vals, blocks = op.gather_rows(idx)
    dense_rows = torch.zeros(4, 45, dtype=torch.float64).index_put_(
        (torch.arange(4)[:, None].expand_as(rows), rows), vals,
        accumulate=True)
    assert torch.equal(dense_rows, A64[idx])
    assert torch.equal(blocks, op.row_blocks[idx]) and int(blocks[1]) == 0
    cidx = torch.tensor([44, 1, 1])
    crows, cvals, _ = op.gather_cols(cidx)
    dense_cols = torch.zeros(60, 3, dtype=torch.float64).index_put_(
        (crows, torch.arange(3)[:, None].expand_as(crows)), cvals,
        accumulate=True)
    assert torch.equal(dense_cols, A64[:, cidx])
    r, c, v = op.host_coo()
    assert np.array_equal(np.stack(np.nonzero(A)), np.stack([r, c]))
    assert np.array_equal(v, A[A != 0])


def test_block_ops_match_dense():
    """The sparse closures of sparse_exec (fused Gram products through
    ell_spmm, scatters) equal the dense closures."""
    A = _matrix(12, 50, 40, 0.2, 0).astype(np.float64)
    op = SparseOperand.from_dense(A)
    At = torch.from_numpy(A)
    vecs = torch.from_numpy(np.random.default_rng(1).standard_normal((50, 2)))
    idx = torch.tensor([5, 17, 5, 39])
    (hs, gs), (hd, gd) = col_block_ops(op)[0](idx, vecs), \
        col_block_ops(At)[0](idx, vecs)
    torch.testing.assert_close(gs, gd, rtol=1e-12, atol=1e-12)
    coef = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.float64)
    torch.testing.assert_close(col_block_ops(op)[1](hs, coef),
                               col_block_ops(At)[1](hd, coef))
    ridx = torch.tensor([0, 49, 7])
    take_s, gram_s, dens_s, app_s = row_block_ops(op)
    take_d, gram_d, dens_d, app_d = row_block_ops(At)
    xv = vecs[:40, :1]
    torch.testing.assert_close(gram_s(take_s(ridx), xv),
                               gram_d(take_d(ridx), xv))
    assert torch.equal(dens_s(take_s(ridx)), dens_d(take_d(ridx)))
    c3 = coef[:3]
    torch.testing.assert_close(app_s(take_s(ridx), c3),
                               app_d(take_d(ridx), c3))
    YT = dens_d(take_d(ridx)).contiguous()
    torch.testing.assert_close(cross_block(op, YT), At @ YT)
    assert spmm_aux(op, "row_gram") == {"spmm_impl": "torch"}
    assert spmm_aux(At, "col_gram") == {}
    with pytest.raises(ValueError, match="layout"):
        spmm_aux(op, "diagonal")


def test_operand_from_numpy_roundtrip():
    A = _matrix(13, 30, 20, 0.3, 1)
    jop = JSparseOperand.from_dense(A)
    arrays = {f: np.asarray(getattr(jop, f)) for f in FIELDS}
    op = convert.operand_from_numpy(arrays, jop.ell_block, device="cpu")
    _assert_same_arrays(op, jop)
    op64 = convert.operand_from_numpy(jop, device="cpu", dtype=torch.float64)
    assert op64.dtype == torch.float64 and op64.col_rows.dtype == torch.int32
    prob = convert.problem_from_numpy(op64, np.ones(30), 0.1, device="cpu",
                                      dtype=torch.float64)
    assert prob.A.shape == (30, 20)


# name -> (solver, s, mu, prox, symmetric_gram, warm start)
CASES = {
    "bcd-mu4-lasso": ("bcd_lasso", 1, 4, "lasso", False, False),
    "acc-mu1-enet-x0": ("acc_bcd_lasso", 1, 1, "enet", False, True),
    "acc-mu4-group": ("acc_bcd_lasso", 1, 4, "group", False, False),
    "sa-s3-mu4-lasso": ("sa_bcd_lasso", 3, 4, "lasso", False, False),
    "sa-s8-mu1-enet-sym": ("sa_bcd_lasso", 8, 1, "enet", True, False),
    "sa_acc-s8-mu4-lasso": ("sa_acc_bcd_lasso", 8, 4, "lasso", False,
                            False),
    "sa_acc-s16-mu4-lasso-sym": ("sa_acc_bcd_lasso", 16, 4, "lasso", True,
                                 False),
    "sa_acc-s3-mu1-enet-x0": ("sa_acc_bcd_lasso", 3, 1, "enet", False,
                              True),
    "sa_acc-s16-mu4-group": ("sa_acc_bcd_lasso", 16, 4, "group", False,
                             False),
}

_HELPERS = r"""
import numpy as np


def problem_kwargs(n, mu, prox):
    groups = np.repeat(np.arange(n // mu), mu) if prox == "group" else None
    return {"l2": L2 if prox == "enet" else 0.0, "groups": groups}


def warm_start(n):
    return 0.1 * np.random.default_rng(3).standard_normal(n)
"""
exec(_HELPERS)

_REF_CODE = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro import core
CASES, H, L2 = json.loads(sys.argv[2])
""" + _HELPERS + r"""
d = np.load(sys.argv[1])
A = core.SparseOperand.from_dense(d["A"])
b, lam = d["b"], float(d["lam"])
out = {}
for name, (solver, s, mu, prox, sym, warm) in CASES.items():
    prob = core.LassoProblem(A=A, b=b, lam=lam,
                             **problem_kwargs(A.shape[1], mu, prox))
    cfg = core.SolverConfig(block_size=mu, s=s, iterations=H,
                            symmetric_gram=sym, dtype=jnp.float64)
    res = getattr(core, solver)(prob, cfg,
                                x0=warm_start(A.shape[1]) if warm else None)
    out[name + "/x"] = np.asarray(res.x)
    out[name + "/objective"] = np.asarray(res.objective)
    for k, v in res.aux["state"].carry.items():
        out[name + "/state/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def lasso_sparse():
    """72 x 48 at density 0.3 with no empty column, a planted 6-sparse x,
    lam = 0.1 ||A^T b||_inf."""
    A = _matrix(0, 72, 48, 0.3)
    rng = np.random.default_rng(1)
    for j in np.flatnonzero(~(A != 0).any(axis=0)):
        A[rng.integers(72), j] = 1.0
    xt = np.zeros(48, np.float32)
    xt[:6] = rng.standard_normal(6)
    b = (A @ xt + 0.1 * rng.standard_normal(72)).astype(np.float32)
    return A, b, 0.1 * float(np.abs(A.T @ b).max())


@pytest.fixture(scope="module")
def ref_f64(lasso_sparse, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sparse")
    A, b, lam = lasso_sparse
    np.savez(tmp / "data.npz", A=A, b=b, lam=lam)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE)
    out = subprocess.run(
        [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
         json.dumps([CASES, H, L2]), str(tmp / "ref.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "ref.npz"))


def _run_port(name, A, lasso_sparse):
    solver, s, mu, prox, sym, warm = CASES[name]
    _, b, lam = lasso_sparse
    n = A.shape[1]
    prob = tcore.LassoProblem(A=A, b=b, lam=lam,
                              **problem_kwargs(n, mu, prox))
    cfg = tcore.SolverConfig(block_size=mu, s=s, iterations=H,
                             symmetric_gram=sym, dtype=torch.float64,
                             device="cpu")
    return getattr(tcore, solver)(prob, cfg,
                                  x0=warm_start(n) if warm else None)


def _close(got, want, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= 1e-10, f"{what}: {err:.3e} > 1e-10"


def _rel_close(got, want, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    assert err <= 1e-10, f"{what}: rel {err:.3e} > 1e-10"


@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_lasso_matches_repro_f64(name, ref_f64, lasso_sparse):
    op = SparseOperand.from_dense(lasso_sparse[0])
    res = _run_port(name, op, lasso_sparse)
    _close(res.x, ref_f64[name + "/x"], "x")
    _rel_close(res.objective, ref_f64[name + "/objective"], "objective")
    leaves = [k for k in ref_f64 if k.startswith(name + "/state/")]
    assert sorted(k.rsplit("/", 1)[1] for k in leaves) \
        == sorted(res.aux["state"].carry)
    for k in leaves:
        _close(res.aux["state"].carry[k.rsplit("/", 1)[1]], ref_f64[k], k)
    assert res.aux["spmm_impl"] == "torch"
    # the same solve on the dense matrix.
    dense = _run_port(name, lasso_sparse[0], lasso_sparse)
    _rel_close(res.objective, dense.objective.numpy(), "sparse vs dense")
    _close(res.x, dense.x.numpy(), "sparse vs dense x")
    assert "spmm_impl" not in dense.aux


def test_sparse_lasso_objective_and_facade(lasso_sparse):
    A, b, lam = lasso_sparse
    op = SparseOperand.from_dense(A)
    prob = api.LassoProblem(A=op, b=b, lam=lam)
    cfg = api.SolverConfig(block_size=4, s=8, iterations=H,
                           dtype=torch.float64, device="cpu")
    res = api.solve(prob, cfg)
    assert res.aux["inner_impl"] == "torch"
    direct = api.resolve_family(prob).objective(
        api.LassoProblem(A=op.astype(torch.float64), b=b, lam=lam), res.x)
    assert abs(float(direct) / float(res.objective[-1]) - 1) <= 1e-10
    assert res.objective[-1] < res.objective[0]
