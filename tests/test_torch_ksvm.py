"""The port's kernel-SVM family (repro_torch.core.kernel_svm: K-BDCD and
SA-K-BDCD) against repro's on the same numpy-made inputs, on the CPU.

repro runs in ONE subprocess for this module (DESIGN.md "Test-process
device convention"): first the f32 cases, then, with x64 turned on, the
f64 ones; it writes an .npz. While it runs, a job of four gloo processes
(``core.distributed.run_ranks``; groups of 4, 2 and 1 inside it) runs the
port's sharded solves. This module imports no JAX, because every rank
imports it.

Held to repro at f64 within 1e-10 (trace relative, vectors absolute
against max(1, |ref|_inf)): x, alpha, f, the running dual, the dual trace
and every aux["state"] leaf, over K-BDCD and SA-K-BDCD, kernels linear,
poly and rbf, hinge and squared hinge, s in {1, 4, 8}, mu in {1, 2, 4},
H = 37 (a remainder group for every s > 1), dense and sparse operands,
warm starts, and a 10-row problem whose rows repeat within every group.
At f32: repro's own bars (rtol 1e-4 and atol 1e-4 on the trace, alpha
atol 1e-4, f atol 1e-3). Also: the tracked dual against
``kernel_dual_objective``, kernel="linear" against the linear SVM solvers,
a repro state resuming in the port, the port's resume at a group
boundary bit for bit, ``api.solve``'s routing, the launcher, and the
sharded backend at P = 1, 2 and 4 (ceil(H/s) reductions untracked, a warm
start one more; the local solve within 1e-10, bit for bit at P = 1).
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import api, convert
from repro_torch import core as tcore
from repro_torch.core import distributed, linalg
from repro_torch.launch import solve as launch_solve

H, H1 = 37, 16              # iterations; a resume point at a group boundary
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
XLA_FAST_COMPILE = "--xla_backend_optimization_level=0"
PARAMS = {"linear": None, "rbf": {"gamma": 0.05},
          "poly": {"degree": 3, "coef0": 1.0, "scale": 0.05}}

# name -> (solver, s, mu, kernel, loss, operand, warm start)
CASES = {
    "k-rbf-mu1-l1-dense": ("kbdcd_svm", 1, 1, "rbf", "l1", "dense", False),
    "k-poly-mu2-l2-sparse": ("kbdcd_svm", 1, 2, "poly", "l2", "sparse",
                             False),
    "k-linear-mu4-l1-dense-x0": ("kbdcd_svm", 1, 4, "linear", "l1",
                                 "dense", True),
    "k-rbf-mu4-l2-sparse-x0": ("kbdcd_svm", 1, 4, "rbf", "l2", "sparse",
                               True),
    "sa-poly-s1-mu2-l1-dense": ("sa_kbdcd_svm", 1, 2, "poly", "l1", "dense",
                                False),
    "sa-rbf-s4-mu1-l1-dense": ("sa_kbdcd_svm", 4, 1, "rbf", "l1", "dense",
                               False),
    "sa-rbf-s8-mu4-l2-sparse": ("sa_kbdcd_svm", 8, 4, "rbf", "l2",
                                "sparse", False),
    "sa-poly-s8-mu2-l1-dense": ("sa_kbdcd_svm", 8, 2, "poly", "l1", "dense",
                                False),
    "sa-poly-s4-mu4-l2-sparse-x0": ("sa_kbdcd_svm", 4, 4, "poly", "l2",
                                    "sparse", True),
    "sa-linear-s8-mu1-l1-sparse": ("sa_kbdcd_svm", 8, 1, "linear", "l1",
                                   "sparse", False),
    "sa-rbf-s8-mu2-l1-dense-x0": ("sa_kbdcd_svm", 8, 2, "rbf", "l1",
                                  "dense", True),
    "sa-rbf-s8-mu4-l1-collide": ("sa_kbdcd_svm", 8, 4, "rbf", "l1", "tiny",
                                 False),
    "sa-poly-s4-mu2-l2-collide": ("sa_kbdcd_svm", 4, 2, "poly", "l2",
                                  "tiny", False),
}
F32_CASES = ["sa-rbf-s8-mu4-l2-sparse", "sa-poly-s8-mu2-l1-dense",
             "k-rbf-mu1-l1-dense"]
DIRECT_CASES = ["sa-rbf-s8-mu4-l2-sparse", "sa-poly-s4-mu4-l2-sparse-x0"]
SHARDED_CASES = ["sa-rbf-s8-mu4-l2-sparse", "sa-poly-s8-mu2-l1-dense",
                 "k-rbf-mu1-l1-dense", "sa-rbf-s8-mu2-l1-dense-x0"]
REPLICATED = ("alpha", "f", "dual", "objective", "state/alpha", "state/f")


def _data():
    """72 x 42 (dense, and ~30% dense with no empty column) and a 10 x 24
    problem whose 10 rows repeat within every group of s mu >= 16 draws;
    {-1, +1} labels of planted scores plus noise; dual warm starts.
    Values are f32-exact, so f32 and f64 solves see the same numbers."""
    rng = np.random.default_rng(7)
    m, n = 72, 42
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = np.sign(A @ rng.standard_normal(n) + 0.1 * rng.standard_normal(m))
    As = A * (rng.random((m, n)) < 0.3)
    for j in np.flatnonzero(~(As != 0).any(axis=0)):
        As[rng.integers(m), j] = 1.0
    At = rng.standard_normal((10, 24)).astype(np.float32)
    bt = np.sign(At @ rng.standard_normal(24) + 0.1 * rng.standard_normal(10))
    out = {"A_dense": A, "A_sparse": As, "A_tiny": At,
           "b_dense": b, "b_sparse": b, "b_tiny": bt,
           "warm_dense": 0.3 * rng.random(m), "warm_sparse": 0.3 * rng.random(m),
           "warm_tiny": 0.3 * rng.random(10)}
    for k in ("b_dense", "b_sparse", "b_tiny"):
        out[k] = np.where(out[k] == 0, 1.0, out[k]).astype(np.float32)
    return out


_REF_CODE = r"""
import json, sys
import jax
import numpy as np, jax.numpy as jnp
from repro import core
from repro.core.kernel_svm import kernel_dual_objective
CASES, F32_CASES, DIRECT_CASES, PARAMS, H, H1 = json.loads(sys.argv[2])
d = np.load(sys.argv[1])


def problem(name, dtype=np.float32):
    solver, s, mu, kern, loss, operand, warm = CASES[name]
    A = d["A_" + operand].astype(dtype)
    if operand == "sparse":
        A = core.SparseOperand.from_dense(A)
    return core.SVMProblem(A=A, b=d["b_" + operand], lam=1.0, loss=loss,
                           kernel=kern, kernel_params=PARAMS[kern])


def run(name, dtype, iterations=H):
    solver, s, mu, kern, loss, operand, warm = CASES[name]
    cfg = core.SolverConfig(block_size=mu, s=s, iterations=iterations,
                            dtype=dtype)
    return getattr(core, solver)(
        problem(name), cfg,
        alpha0=d["warm_" + operand] if warm and iterations == H else None)


out = {}
for name in F32_CASES:
    res = run(name, jnp.float32)
    for k, v in (("objective", res.objective), ("alpha", res.aux["alpha"]),
                 ("f", res.aux["f"])):
        out[name + "/f32/" + k] = np.asarray(v)
jax.config.update("jax_enable_x64", True)
for name in CASES:
    res = run(name, jnp.float64)
    out[name + "/x"] = np.asarray(res.x)
    out[name + "/objective"] = np.asarray(res.objective)
    for k in ("alpha", "f", "dual"):
        out[name + "/" + k] = np.asarray(res.aux[k])
    for k, v in res.aux["state"].carry.items():
        out[name + "/state/" + k] = np.asarray(v)
    out[name + "/iteration"] = np.asarray(res.aux["state"].iteration)
    if name in DIRECT_CASES:
        out[name + "/direct"] = np.asarray(
            kernel_dual_objective(problem(name, np.float64),
                                  res.aux["alpha"]))
first = run("sa-rbf-s8-mu4-l2-sparse", jnp.float64, H1)
for k, v in first.aux["state"].carry.items():
    out["first/state/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _problem(name, d, dtype=np.float32):
    """The case's problem; ``dtype`` is A's (the solvers cast it to the
    solve's, the direct objective evaluates in it)."""
    solver, s, mu, kern, loss, operand, warm = CASES[name]
    A = d["A_" + operand].astype(dtype)
    if operand == "sparse":
        A = tcore.SparseOperand.from_dense(torch.as_tensor(A))
    return tcore.SVMProblem(A=A, b=d["b_" + operand], lam=1.0, loss=loss,
                            kernel=kern, kernel_params=PARAMS[kern])


def _cfg(name, dtype, iterations=H, track=True):
    solver, s, mu = CASES[name][:3]
    return tcore.SolverConfig(block_size=mu, s=s, iterations=iterations,
                              track_objective=track, dtype=dtype,
                              device="cpu")


def _warm(name, d):
    solver, s, mu, kern, loss, operand, warm = CASES[name]
    return d["warm_" + operand] if warm else None


def _run_port(name, d, dtype=torch.float64):
    return getattr(tcore, CASES[name][0])(_problem(name, d),
                                          _cfg(name, dtype),
                                          alpha0=_warm(name, d))


def _leaves(res):
    out = {"x": res.x, "objective": res.objective}
    out.update({k: res.aux[k] for k in ("alpha", "f", "dual")})
    out.update({"state/" + k: v for k, v in res.aux["state"].carry.items()})
    return out


def _numpy(leaves):
    return {k: v.detach().cpu().numpy() for k, v in leaves.items()}


def _on_every_rank(t, group):
    rows = linalg.pgather(t.reshape(1, -1), group or dist.group.WORLD)
    return all(torch.equal(r, rows[0]) for r in rows)


def _worker(rank, world):
    """The sharded solves at P = 4 (the default group), 2 and 1; rank 0
    returns them as numpy, with their reduction counts and whether each
    replicated leaf is the same bits on every rank."""
    d = _data()
    pair, single = dist.new_group([0, 1]), dist.new_group([0])
    out = {}
    for P, group in ((4, None), (2, pair), (1, single)):
        if rank >= P:
            continue
        for name in SHARDED_CASES:
            with linalg.count_reductions() as c:
                res = api.solve(_problem(name, d), _cfg(name, torch.float64),
                                "sharded", x0=_warm(name, d), group=group)
            leaves = _leaves(res)
            out[(P, name)] = _numpy(leaves)
            out[(P, name, "tracked")] = c.n
            out[(P, name, "same")] = {
                k: _on_every_rank(v, group) for k, v in leaves.items()
                if k in REPLICATED}
            with linalg.count_reductions() as c:
                api.solve(_problem(name, d),
                          _cfg(name, torch.float64, track=False), "sharded",
                          x0=_warm(name, d), group=group)
            out[(P, name, "untracked")] = c.n
    return out


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """(repro's results, the gloo job's). The reference subprocess runs
    while the job does."""
    tmp = tmp_path_factory.mktemp("torch_ksvm")
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE)
    with open(tmp / "ref.err", "w") as err:
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
             json.dumps([CASES, F32_CASES, DIRECT_CASES, PARAMS, H, H1]),
             str(tmp / "ref.npz")],
            env=env, stdout=subprocess.DEVNULL, stderr=err)
        try:
            job = distributed.run_ranks(_worker, 4, "gloo", device="cpu")
            ref.wait(timeout=600)
        finally:
            ref.kill()
    assert ref.returncode == 0, (tmp / "ref.err").read_text()[-3000:]
    return dict(np.load(tmp / "ref.npz")), job


def _close(got, want, what, tol=1e-10):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert np.shape(got) == np.shape(want), what
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


def _rel_close(got, want, tol, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    err = float(np.max(np.abs(got - want)
                       / np.maximum(np.abs(want), 1e-9)))
    assert err <= tol, f"{what}: rel {err:.3e} > {tol}"


def _hold_to_ref(got, ref, name):
    """Every leaf against repro's f64 solve: the trace and the running
    dual relative, vectors against max(1, |ref|)."""
    _rel_close(got["objective"], ref[name + "/objective"], 1e-10,
               "objective")
    _rel_close(got["dual"], ref[name + "/dual"], 1e-10, "dual")
    for k in got:
        if k not in ("objective", "dual"):
            _close(got[k], ref[name + "/" + k], k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_repro_f64(name, runs, data):
    ref, _ = runs
    res = _run_port(name, data)
    leaves = _numpy(_leaves(res))
    assert sorted(res.aux["state"].carry) == ["alpha", "dual", "f", "x"]
    assert res.aux["state"].iteration == int(ref[name + "/iteration"]) == H
    _hold_to_ref(leaves, ref, name)
    assert leaves["objective"][-1] < leaves["objective"][0]  # dual descent


@pytest.mark.parametrize("name", F32_CASES)
def test_port_matches_repro_f32(name, runs, data):
    """repro's own f32 bars for SA-K-BDCD against K-BDCD
    (tests/test_kernel_svm.py), here port against repro."""
    ref, _ = runs
    res = _run_port(name, data, torch.float32)
    assert res.objective.dtype == torch.float32
    np.testing.assert_allclose(res.objective.numpy(),
                               ref[name + "/f32/objective"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.aux["alpha"].numpy(),
                               ref[name + "/f32/alpha"], atol=1e-4)
    np.testing.assert_allclose(res.aux["f"].numpy(), ref[name + "/f32/f"],
                               atol=1e-3)


@pytest.mark.parametrize("name", DIRECT_CASES)
def test_tracked_dual_is_the_direct_one(name, runs, data):
    ref, _ = runs
    res = _run_port(name, data)
    direct = tcore.kernel_dual_objective(_problem(name, data, np.float64),
                                         res.aux["alpha"])
    _rel_close(direct, ref[name + "/direct"], 1e-10, "direct dual")
    _rel_close(res.aux["dual"], direct.numpy(), 1e-10, "tracked dual")


@pytest.mark.parametrize("operand", ["dense", "sparse"])
@pytest.mark.parametrize("s,mu", [(1, 1), (1, 4), (8, 2), (4, 4)])
def test_linear_kernel_reproduces_linear_svm(data, operand, s, mu):
    """kernel="linear" gives the linear SVM's iterates (f = A x)."""
    A = data["A_" + operand]
    if operand == "sparse":
        A = tcore.SparseOperand.from_dense(torch.as_tensor(A))
    cfg = tcore.SolverConfig(block_size=mu, s=s, iterations=H,
                             dtype=torch.float64, device="cpu")
    b = data["b_" + operand]
    lin = tcore.solve_svm(tcore.SVMProblem(A=A, b=b), cfg)
    ker = tcore.solve_ksvm(tcore.SVMProblem(A=A, b=b, kernel="linear"), cfg)
    _rel_close(ker.objective, lin.objective.numpy(), 1e-10, "objective")
    _close(ker.x, lin.x.numpy(), "x")
    _close(ker.aux["alpha"], lin.aux["alpha"].numpy(), "alpha")
    A64 = A.astype(torch.float64) if operand == "sparse" \
        else torch.as_tensor(A, dtype=torch.float64)
    _close(ker.aux["f"], tcore.operand_matvec(A64, ker.x).numpy(), "f")


def test_repro_state_resumes_in_port(runs, data):
    ref, _ = runs
    name = "sa-rbf-s8-mu4-l2-sparse"
    carry = {k.split("/")[-1]: ref[k] for k in ref
             if k.startswith("first/state/")}
    assert set(carry) == {"alpha", "x", "f", "dual"}
    state = convert.state_from_numpy(H1, carry, torch.float64, "cpu")
    op = convert.operand_from_numpy(
        tcore.SparseOperand.from_dense(torch.as_tensor(data["A_sparse"])),
        device="cpu", dtype=torch.float64)
    prob = convert.svm_problem_from_numpy(
        op, data["b_sparse"], loss="l2", kernel="rbf",
        kernel_params=PARAMS["rbf"], device="cpu", dtype=torch.float64)
    rest = api.solve(prob, _cfg(name, torch.float64, H - H1), state=state)
    assert rest.aux["state"].iteration == H
    _rel_close(rest.objective, ref[name + "/objective"][H1:], 1e-10,
               "resumed trace")
    for k in ("alpha", "f", "x"):
        got = rest.x if k == "x" else rest.aux[k]
        _close(got, ref[name + "/" + k], k)


@pytest.mark.parametrize("name", ["sa-rbf-s8-mu4-l2-sparse",
                                  "sa-poly-s8-mu2-l1-dense",
                                  "k-poly-mu2-l2-sparse"])
def test_port_resume_is_exact(name, data):
    """H1 iterations, then a resume from its state for the rest: the
    bits of the uninterrupted solve (H1 is a group boundary)."""
    prob = _problem(name, data)
    whole = api.solve(prob, _cfg(name, torch.float64))
    first = api.solve(prob, _cfg(name, torch.float64, H1))
    rest = api.solve(prob, _cfg(name, torch.float64, H - H1),
                     state=first.aux["state"])
    assert torch.equal(torch.cat([first.objective, rest.objective]),
                       whole.objective)
    for k, v in whole.aux["state"].carry.items():
        assert torch.equal(rest.aux["state"].carry[k], v), k


def test_api_routes_kernel_problems_to_ksvm(data):
    name = "sa-rbf-s8-mu4-l2-sparse"
    prob = _problem(name, data)
    assert api.resolve_family(prob).name == "ksvm"
    assert api.resolve_family(_problem("k-linear-mu4-l1-dense-x0",
                                       data)).name == "svm"
    assert "ksvm" in api.families() and len(api.families()) == 5
    cfg = _cfg(name, torch.float64)
    got = api.solve(prob, cfg)
    want = tcore.sa_kbdcd_svm(prob, cfg)
    via_svm = tcore.solve_svm(prob, cfg)
    for res in (got, via_svm):
        assert torch.equal(res.objective, want.objective)
        assert torch.equal(res.aux["alpha"], want.aux["alpha"])
    assert got.aux["inner_impl"] == "torch"
    assert got.aux["spmm_impl"] == "torch"


@pytest.mark.parametrize("extra", [
    [], ["--kernel", "poly", "--kernel-degree", "2", "--kernel-scale",
         "0.1", "--mu", "2", "--sparse"],
    ["--kernel", "rbf", "--kernel-gamma", "0.2", "--svm-loss", "l2",
     "--s", "1"]])
def test_launcher_runs_ksvm_on_cpu(extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_solve.main(["--problem", "ksvm", "--dataset", "w1a-like",
                           "--s", "8", "--iterations", "64",
                           "--device", "cpu", *extra])
    out = buf.getvalue()
    kernel = extra[extra.index("--kernel") + 1] if extra else "rbf"
    assert "ksvm-" in out and f"[{kernel}]" in out
    first, last = map(float, re.search(r"dual (\S+) -> (\S+),", out)
                      .groups())
    assert last < first


def test_kernel_params_reach_the_problem():
    args = launch_solve.build_parser().parse_args(
        ["--problem", "ksvm", "--kernel", "poly", "--kernel-coef0", "2.5"])
    assert tcore.build_kernel_params("poly", args) == {
        "degree": 3, "coef0": 2.5, "scale": 1.0}
    assert tcore.build_kernel_params("linear", args) is None
    assert sorted(tcore.KERNELS) == ["linear", "poly", "rbf"]


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_matches_local_f64(name, P, runs, data):
    """Sharded by columns at P ranks: repro's f64 solve within 1e-10, and
    the port's local solve within 1e-10 (bit for bit at P = 1)."""
    ref, job = runs
    got = job[(P, name)]
    _hold_to_ref(got, ref, name)
    local = _numpy(_leaves(_run_port(name, data)))
    assert sorted(got) == sorted(local)
    for k in local:
        if P == 1:
            assert np.array_equal(got[k], local[k]), k
        else:
            _close(got[k], local[k], k)


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_reductions_per_solve(name, P, runs):
    """ceil(H/s) reductions (H for s = 1) tracked or not: the dual is
    tracked from replicated data. A warm start adds one, its K(A, A)."""
    _, job = runs
    solver, s, mu, kern, loss, operand, warm = CASES[name]
    want = -(-H // s) + int(warm)
    assert job[(P, name, "untracked")] == want
    assert job[(P, name, "tracked")] == want


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_replicated_state_is_the_same_on_every_rank(name, P, runs):
    same = runs[1][(P, name, "same")]
    assert sorted(same) == sorted(REPLICATED)
    assert all(same.values()), same
