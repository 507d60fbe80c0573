"""The port's sharded backend (``api.solve(..., backend="sharded")``,
``repro_torch.core.api.solve_sharded`` over ``torch.distributed``) on the
CPU, in gloo processes started by ``core.distributed.run_ranks``.

Two jobs run per module: one of four processes and one of three. The
four-process job also makes a group of two (a P = 4 state resumed at
P = 2) and a group of one (P = 1). Rank 0 returns every result as numpy.
The port's sharded solves are held to:
  * ``repro``'s LOCAL backend at f64, trajectories and vectors within
    1e-10, at P = 3 and P = 4 (``repro``'s own sharded backend fails at
    its unpad step on jax 0.9, so it is not the oracle);
  * the same at f32 within rel 1e-4 (tests/test_distributed.py's bar);
  * the port's local backend bit for bit at P = 1.
``repro`` runs in ONE subprocess per module, while the jobs run: first
the f32 cases, then, with x64 turned on, the f64 ones. This module does
not import JAX, because every rank imports it.
Cases: lasso sa_accelerated, sa, accelerated and classical; svm SA-BDCD
and BDCD, l1 and l2; dense and sparse operands; m = 203 Lasso rows and
50 SVM columns, which P = 3 and P = 4 both pad; the symmetric Gram; tail
groups (H mod s != 0); warm starts. Also: the reductions each solve counts,
the replicated state equal bit for bit on every rank, the refusals, and
that ``all_reduce`` is called only in ``core/linalg.py``.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.core import distributed, linalg
from repro_torch.core.sparse_exec import pad_slice, shard_operand

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
XLA_FAST_COMPILE = "--xla_backend_optimization_level=0"
H, H1 = 32, 16              # iterations; the resume point
N_SVM = 50                  # SVM columns (the partitioned axis)

# name -> (family, accelerated, s, mu, loss, operand, symmetric_gram, warm)
CASES = {
    "lasso-sa_acc-dense-tail": ("lasso", True, 6, 4, "", "dense", False,
                                False),
    "lasso-sa_acc-sparse-sym": ("lasso", True, 8, 4, "", "sparse", True,
                                False),
    "lasso-sa-dense-x0": ("lasso", False, 8, 4, "", "dense", False, True),
    "lasso-sa-sparse": ("lasso", False, 16, 1, "", "sparse", False, False),
    "lasso-acc-sparse-x0": ("lasso", True, 1, 4, "", "sparse", False, True),
    "lasso-bcd-dense": ("lasso", False, 1, 4, "", "dense", False, False),
    "svm-sa-l1-dense": ("svm", True, 8, 4, "l1", "dense", False, False),
    "svm-sa-l2-sparse-sym": ("svm", True, 8, 2, "l2", "sparse", True,
                             False),
    "svm-sa-l1-sparse-x0": ("svm", True, 16, 1, "l1", "sparse", False,
                            True),
    "svm-sa-l2-dense-tail": ("svm", True, 5, 4, "l2", "dense", False,
                             False),
    "svm-bdcd-l2-dense-x0": ("svm", True, 1, 4, "l2", "dense", False, True),
    "svm-bdcd-l1-sparse": ("svm", True, 1, 1, "l1", "sparse", False, False),
}
F32_CASES = ["lasso-sa_acc-dense-tail", "lasso-acc-sparse-x0",
             "svm-sa-l2-sparse-sym"]
RESUME_CASES = ["lasso-sa_acc-dense-tail", "lasso-acc-sparse-x0",
                "svm-sa-l2-sparse-sym", "svm-bdcd-l2-dense-x0"]
AUX = {"lasso": "residual", "svm": "alpha"}
# The leaves replicated on every rank (the rest are gathered).
REPLICATED = {"lasso": ("x", "state/z", "state/y", "state/x"),
              "svm": ("alpha", "dual", "state/alpha", "state/dual")}


def _data():
    """m = 203 rows; Lasso over 60 features with a planted 6-sparse x
    (tests/test_distributed.py's recipe), SVM over the first 50 columns
    with {-1, +1} labels; the sparse operand keeps ~30% of A's entries
    and no empty column. Values are f32-exact, so f32 and f64 solves see
    the same numbers."""
    rng = np.random.default_rng(1)
    m, n = 203, 60
    A = rng.standard_normal((m, n)).astype(np.float32)
    xt = np.zeros(n)
    xt[:6] = rng.standard_normal(6)
    b = (A @ xt + 0.1 * rng.standard_normal(m)).astype(np.float32)
    labels = np.sign(A[:, :N_SVM] @ rng.standard_normal(N_SVM)
                     + 0.1 * rng.standard_normal(m)).astype(np.float32)
    labels[labels == 0] = 1.0
    As = A * (rng.random((m, n)) < 0.3)
    for j in np.flatnonzero(~(As != 0).any(axis=0)):
        As[rng.integers(m), j] = 1.0
    return {"A_dense": A, "A_sparse": As, "b": b, "labels": labels,
            "lam": 0.1 * float(np.abs(A.T @ b).max()),
            "x0_lasso": 0.1 * rng.standard_normal(n),
            "x0_svm": 0.3 * rng.random(m)}


def _problem(name, d):
    fam, acc, s, mu, loss, operand, sym, warm = CASES[name]
    A = d["A_" + operand]
    if fam == "svm":
        A = A[:, :N_SVM]
    if operand == "sparse":
        A = api.SparseOperand.from_dense(torch.as_tensor(A))
    if fam == "lasso":
        return api.LassoProblem(A=A, b=d["b"], lam=d["lam"])
    return api.SVMProblem(A=A, b=d["labels"], lam=1.0, loss=loss)


def _solve(name, d, dtype, backend="sharded", group=None, track=True,
           iterations=H, state=None):
    fam, acc, s, mu, loss, operand, sym, warm = CASES[name]
    cfg = api.SolverConfig(block_size=mu, s=s, iterations=iterations,
                           accelerated=acc, symmetric_gram=sym,
                           track_objective=track, dtype=dtype, device="cpu")
    x0 = d["x0_" + fam] if warm and state is None else None
    kw = {} if backend == "local" else {"group": group}
    return api.solve(_problem(name, d), cfg, backend, x0=x0, state=state,
                     **kw)


def _leaves(name, res):
    """The result's tensors by name: x, objective, the family's aux
    vector, the SVM dual, and the state leaves."""
    fam = CASES[name][0]
    out = {"x": res.x, "objective": res.objective,
           AUX[fam]: res.aux[AUX[fam]]}
    if fam == "svm":
        out["dual"] = res.aux["dual"]
    out.update({"state/" + k: v for k, v in res.aux["state"].carry.items()})
    return out


def _numpy(leaves):
    return {k: v.numpy() for k, v in leaves.items()}


def _on_every_rank(t, group):
    """Is ``t`` the same, bit for bit, on every rank of ``group`` (None:
    the default group)?"""
    rows = linalg.pgather(t.reshape(1, -1), group or dist.group.WORLD)
    assert rows.shape[0] == dist.get_world_size(group)
    return all(torch.equal(r, rows[0]) for r in rows)


def _record(out, key, name, res, group, count):
    leaves = _leaves(name, res)
    out[key] = _numpy(leaves)
    out[key]["count"] = count
    keep = REPLICATED[CASES[name][0]] + ("objective",)
    out[key]["same"] = {k: _on_every_rank(v, group)
                        for k, v in leaves.items() if k in keep}


def _solve_counted(name, d, dtype, group=None, **kw):
    with linalg.count_reductions() as c:
        res = _solve(name, d, dtype, group=group, **kw)
    return res, c.n


def _worker(rank, world):
    """One job's solves; rank 0 returns them as numpy."""
    d = _data()
    out = {}
    for name in CASES:
        res, n = _solve_counted(name, d, torch.float64)
        _record(out, (world, name, "f64"), name, res, None, n)
        out[(world, name, "untracked")] = _solve_counted(
            name, d, torch.float64, track=False)[1]
    if world != 4:
        return out
    for name in F32_CASES:
        out[(4, name, "f32")] = _numpy(_leaves(
            name, _solve(name, d, torch.float32)))
    # Every rank makes every group, in the same order.
    pair, single = dist.new_group([0, 1]), dist.new_group([0])
    for name in RESUME_CASES:
        first = _solve(name, d, torch.float64, iterations=H1)
        out[("first", name)] = _numpy(
            {k: v for k, v in first.aux["state"].carry.items()})
        if rank < 2:
            rest, n = _solve_counted(name, d, torch.float64, group=pair,
                                     iterations=H - H1,
                                     state=first.aux["state"])
            _record(out, (2, name, "resumed"), name, rest, pair, n)
    if rank == 0:
        for name in CASES:
            for dtype in (torch.float64, torch.float32):
                out[(1, name, str(dtype))] = _numpy(_leaves(
                    name, _solve(name, d, dtype, group=single)))
    return out


_REF_CODE = r"""
import json, sys
import jax
import numpy as np, jax.numpy as jnp
from repro import api, core
CASES, F32_CASES, H, N_SVM = json.loads(sys.argv[2])
d = np.load(sys.argv[1])
out = {}


def solve(name, dtype):
    fam, acc, s, mu, loss, operand, sym, warm = CASES[name]
    A = d["A_" + operand]
    if fam == "svm":
        A = A[:, :N_SVM]
    if operand == "sparse":
        A = core.SparseOperand.from_dense(A)
    prob = core.LassoProblem(A=A, b=d["b"], lam=float(d["lam"])) \
        if fam == "lasso" else \
        core.SVMProblem(A=A, b=d["labels"], lam=1.0, loss=loss)
    cfg = core.SolverConfig(block_size=mu, s=s, iterations=H,
                            accelerated=acc, symmetric_gram=sym,
                            dtype=dtype)
    return api.solve(prob, cfg, x0=d["x0_" + fam] if warm else None)


for name in F32_CASES:
    out[name + "/f32/objective"] = np.asarray(
        solve(name, jnp.float32).objective)
jax.config.update("jax_enable_x64", True)
for name, (fam, *_) in CASES.items():
    res = solve(name, jnp.float64)
    aux = "residual" if fam == "lasso" else "alpha"
    out[name + "/x"] = np.asarray(res.x)
    out[name + "/objective"] = np.asarray(res.objective)
    out[name + "/" + aux] = np.asarray(res.aux[aux])
    if fam == "svm":
        out[name + "/dual"] = np.asarray(res.aux["dual"])
    for k, v in res.aux["state"].carry.items():
        out[name + "/state/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's local results, {4: the four-process job's, 3: the
    three-process job's}). The reference subprocess runs while the jobs
    do."""
    tmp = tmp_path_factory.mktemp("torch_sharded")
    np.savez(tmp / "data.npz", **_data())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE)
    with open(tmp / "ref.err", "w") as err:
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
             json.dumps([CASES, F32_CASES, H, N_SVM]), str(tmp / "ref.npz")],
            env=env, stdout=subprocess.DEVNULL, stderr=err)
        try:
            four = distributed.run_ranks(_worker, 4, "gloo", device="cpu")
            three = distributed.run_ranks(_worker, 3, "gloo", device="cpu")
            ref.wait(timeout=600)
        finally:
            ref.kill()
    assert ref.returncode == 0, (tmp / "ref.err").read_text()[-3000:]
    return dict(np.load(tmp / "ref.npz")), {4: four, 3: three}


def _close(got, want, what, tol=1e-10):
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


def _rel_close(got, want, tol, what):
    err = float(np.max(np.abs(got - want)
                       / np.maximum(np.abs(want), 1e-9)))
    assert err <= tol, f"{what}: rel {err:.3e} > {tol}"


def _hold_to_ref(got, ref, name, start=0):
    """Every leaf of ``got`` against repro's f64 local solve ``ref``:
    the trace (from ``start``) relative, vectors against max(1, |ref|)."""
    _rel_close(got["objective"], ref[name + "/objective"][start:], 1e-10,
               "objective")
    vectors = [k for k in got if k not in ("objective", "count", "same")]
    assert len(vectors) >= 4
    for k in vectors:
        assert got[k].shape == ref[name + "/" + k].shape, k
        _close(got[k], ref[name + "/" + k], k)


@pytest.mark.parametrize("P", [3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_repro_local_f64(name, P, runs):
    ref, jobs = runs
    _hold_to_ref(jobs[P][(P, name, "f64")], ref, name)


@pytest.mark.parametrize("name", F32_CASES)
def test_sharded_matches_repro_local_f32(name, runs):
    ref, jobs = runs
    want = ref[name + "/f32/objective"]
    got = jobs[4][(4, name, "f32")]["objective"]
    assert got.dtype == want.dtype == np.float32
    _rel_close(got, want, 1e-4, "objective")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_at_one_rank_is_local_bit_for_bit(name, runs):
    d = _data()
    for dtype in (torch.float64, torch.float32):
        got = runs[1][4][(1, name, str(dtype))]
        want = _numpy(_leaves(name, _solve(name, d, dtype, "local")))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), f"{k} at {dtype}"


@pytest.mark.parametrize("name", RESUME_CASES)
def test_state_from_four_ranks_resumes_on_two(name, runs):
    """A logical SolveState of H1 iterations at P = 4 resumed at P = 2
    for H - H1 more equals the uninterrupted solve."""
    ref, jobs = runs
    first = jobs[4][("first", name)]
    for k, v in first.items():        # logical: unpadded, every leaf
        assert v.shape == ref[name + "/state/" + k].shape, k
    rest = jobs[4][(2, name, "resumed")]
    _hold_to_ref(rest, ref, name, start=H1)
    assert all(rest["same"].values()), rest["same"]


def _outer(s, iterations):
    return -(-iterations // s)


@pytest.mark.parametrize("P", [3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reductions_per_solve(name, P, runs):
    """One reduction per outer iteration (ceil(H/s); H for s = 1) with
    the objective untracked. Tracked, the Lasso adds one per outer
    iteration (its squared residual norms, all s in one); the SVM tracks
    its dual from the reduced block and adds none. An SVM warm start
    adds one (its starting dual's ||x||^2)."""
    fam, acc, s, mu, loss, operand, sym, warm = CASES[name]
    job = runs[1][P]
    outer = _outer(s, H)
    setup = int(fam == "svm" and warm)
    assert job[(P, name, "untracked")] == outer + setup
    tracked = 2 * outer if fam == "lasso" else outer + setup
    assert job[(P, name, "f64")]["count"] == tracked


def test_resumed_solve_counts_its_own_reductions(runs):
    for name in RESUME_CASES:
        fam, acc, s = CASES[name][:3]
        got = runs[1][4][(2, name, "resumed")]["count"]
        outer = _outer(s, H - H1)
        assert got == (2 * outer if fam == "lasso" else outer), name


@pytest.mark.parametrize("P", [3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_state_bit_identical_across_ranks(name, P, runs):
    same = runs[1][P][(P, name, "f64")]["same"]
    assert "objective" in same and len(same) >= 3
    assert all(same.values()), same


def test_sharded_refuses_without_a_process_group():
    assert not dist.is_initialized()
    d = _data()
    prob = _problem("lasso-sa_acc-dense-tail", d)
    cfg = api.SolverConfig(block_size=4, s=8, iterations=8, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        api.solve(prob, cfg, backend="sharded")
    with pytest.raises(ValueError, match="process group"):
        distributed.solve_lasso_sharded(prob, cfg)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"axes": "data"},
                                {"axes": ("pod", "data")},
                                {"tune": "auto"}])
def test_sharded_refuses_jax_mesh_arguments(kw):
    prob = _problem("svm-sa-l1-dense", _data())
    cfg = api.SolverConfig(block_size=4, s=8, iterations=8, device="cpu")
    with pytest.raises(ValueError, match="mesh|tune"):
        api.solve(prob, cfg, backend="sharded", **kw)


def test_local_backend_refuses_a_group():
    prob = _problem("svm-sa-l1-dense", _data())
    cfg = api.SolverConfig(block_size=4, s=8, iterations=8, device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        api.solve(prob, cfg, group=object())


def test_nccl_placement_check():
    """NCCL cannot put two ranks on one card: the check refuses before
    any process starts (the CPU has no NCCL; this is the check alone)."""
    with pytest.raises(ValueError, match="two ranks on one card"):
        distributed.check_placement("nccl", 2, "cuda", 1)
    with pytest.raises(ValueError, match="two ranks on one card"):
        distributed.check_placement("nccl", 4, "cuda", 2)
    with pytest.raises(ValueError, match="device='cuda'"):
        distributed.check_placement("nccl", 1, "cpu", 0)
    with pytest.raises(RuntimeError, match="no card"):
        distributed.check_placement("gloo", 4, "cuda", 0)
    distributed.check_placement("nccl", 1, "cuda", 1)
    distributed.check_placement("nccl", 4, "cuda", 4)
    distributed.check_placement("gloo", 4, "cuda", 1)
    distributed.check_placement("gloo", 4, "cpu", 0)
    # run_ranks checks before it spawns: this CPU has no card.
    with pytest.raises(RuntimeError, match="no card"):
        distributed.run_ranks(_worker, 2, "nccl", device="cuda")


@pytest.mark.parametrize("P", [1, 3, 4, 7])
@pytest.mark.parametrize("axis", [0, 1])
def test_shards_rebuild_the_padded_operand(axis, P):
    """The shards of a sparse operand, densified and joined in rank
    order, are the operand zero-padded to a multiple of P; a dense
    shard is the same block, and a view where no padding is needed."""
    A = torch.as_tensor(_data()["A_sparse"][:, :N_SVM], dtype=torch.float64)
    op = api.SparseOperand.from_dense(A)
    size = -(-A.shape[axis] // P)
    dense = [shard_operand(A, axis, r * size, size) for r in range(P)]
    sparse = [shard_operand(op, axis, r * size, size) for r in range(P)]
    want = pad_slice(A, axis, 0, size * P)
    assert torch.equal(torch.cat(dense, dim=axis), want)
    assert torch.equal(torch.cat([s.todense() for s in sparse], dim=axis),
                       want)
    for r, s in enumerate(sparse):
        assert s.shape == dense[r].shape
        assert s.row_cols.dtype == s.col_rows.dtype == torch.int32
        assert s.nnz == int((dense[r] != 0).sum())
    assert dense[0].data_ptr() == A.data_ptr()     # a view, not a copy


def test_all_reduce_is_called_only_in_preduce():
    """``linalg.preduce`` is the port's one all-reduce call site."""
    sites = []
    for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            name = node.attr if isinstance(node, ast.Attribute) \
                else node.id if isinstance(node, ast.Name) else None
            if name == "all_reduce":
                sites.append(str(f.relative_to(ROOT)))
    assert sites == ["src/repro_torch/core/linalg.py"], sites
