"""The port's linear SVM family (repro_torch.core.svm / sa_svm) against
repro's on the same numpy-made inputs, on the CPU.

f64: every case runs through repro with jax_enable_x64 in ONE subprocess
for this module, which writes an .npz; the port is held to x, the dual
trace, alpha, the running dual and every aux["state"] leaf within 1e-10
(trace relative, vectors absolute against max(1, |ref|_inf)). Cases cover
classical BDCD and SA-BDCD, hinge (l1) and squared hinge (l2), mu in
{1, 4}, s in {1, 3, 8, 16} with H = 37 (a remainder group for every
s > 1), dense and sparse operands (sparse rows collide across the s
blocks: m = 72 rows against up to 64 draws per group), warm starts and
the symmetric Gram. Also: the objectives and the duality gap, a repro
state resuming in the port, SA == classical in the port, the launcher,
and the linear solvers' refusal of a kernel problem (which ``api.solve``
routes to the ksvm family).
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import api, convert
from repro_torch import core as tcore
from repro_torch.launch import solve as launch_solve

H = 37                      # H mod s != 0 for every s > 1 below
H1 = 24                     # s-aligned resume point for s = 8
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
XLA_FAST_COMPILE = "--xla_backend_optimization_level=0"

# name -> (solver, s, mu, loss, operand, warm start, symmetric_gram)
CASES = {
    "dcd-l1-dense": ("bdcd_svm", 1, 1, "l1", "dense", False, False),
    "bdcd-mu4-l2-sparse": ("bdcd_svm", 1, 4, "l2", "sparse", False, False),
    "bdcd-mu4-l1-dense-x0": ("bdcd_svm", 1, 4, "l1", "dense", True, False),
    "dcd-l2-sparse-x0": ("bdcd_svm", 1, 1, "l2", "sparse", True, False),
    "sa-s1-mu4-l1-dense": ("sa_bdcd_svm", 1, 4, "l1", "dense", False, False),
    "sa-s3-mu1-l1-sparse": ("sa_bdcd_svm", 3, 1, "l1", "sparse", False,
                            False),
    "sa-s3-mu4-l2-sparse": ("sa_bdcd_svm", 3, 4, "l2", "sparse", False,
                            False),
    "sa-s8-mu4-l2-dense": ("sa_bdcd_svm", 8, 4, "l2", "dense", False, False),
    "sa-s8-mu4-l1-sparse-x0": ("sa_bdcd_svm", 8, 4, "l1", "sparse", True,
                               False),
    "sa-s16-mu1-l2-dense-sym": ("sa_bdcd_svm", 16, 1, "l2", "dense", False,
                                True),
    "sa-s16-mu4-l1-sparse": ("sa_bdcd_svm", 16, 4, "l1", "sparse", False,
                             False),
    "sa-s16-mu4-l1-dense": ("sa_bdcd_svm", 16, 4, "l1", "dense", False,
                            False),
}

_REF_CODE = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro import core
from repro.core.svm import dual_objective, duality_gap, primal_objective
CASES, H, H1 = json.loads(sys.argv[2])
d = np.load(sys.argv[1])
ops = {"dense": d["Ad"], "sparse": core.SparseOperand.from_dense(d["As"])}
labels = {"dense": d["bd"], "sparse": d["bs"]}
out = {}
for name, (solver, s, mu, loss, operand, warm, sym) in CASES.items():
    prob = core.SVMProblem(A=ops[operand], b=labels[operand], lam=1.0,
                           loss=loss)
    cfg = core.SolverConfig(block_size=mu, s=s, iterations=H,
                            symmetric_gram=sym, dtype=jnp.float64)
    alpha0 = d["warm_" + operand] if warm else None
    res = getattr(core, solver)(prob, cfg, alpha0=alpha0)
    out[name + "/x"] = np.asarray(res.x)
    out[name + "/objective"] = np.asarray(res.objective)
    out[name + "/alpha"] = np.asarray(res.aux["alpha"])
    out[name + "/dual"] = np.asarray(res.aux["dual"])
    for k, v in res.aux["state"].carry.items():
        out[name + "/state/" + k] = np.asarray(v)
    out[name + "/iteration"] = np.asarray(res.aux["state"].iteration)
    if name in ("sa-s16-mu4-l1-dense", "sa-s3-mu4-l2-sparse"):
        out[name + "/primal"] = np.asarray(primal_objective(prob, res.x))
        out[name + "/dual_direct"] = np.asarray(
            dual_objective(prob, res.aux["alpha"]))
        out[name + "/gap"] = np.asarray(
            duality_gap(prob, res.x, res.aux["alpha"]))
prob = core.SVMProblem(A=ops["sparse"], b=labels["sparse"], lam=1.0)
cfg = lambda it: core.SolverConfig(block_size=4, s=8, iterations=it,
                                   dtype=jnp.float64)
first = core.sa_bdcd_svm(prob, cfg(H1))
for k, v in first.aux["state"].carry.items():
    out["first/state/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _sparse_svm_data():
    """72 x 48 at density 0.3 with no empty column, and {-1, +1} labels
    of planted scores plus noise."""
    rng = np.random.default_rng(5)
    m, n = 72, 48
    A = rng.standard_normal((m, n)).astype(np.float32)
    A[rng.random((m, n)) >= 0.3] = 0.0
    for j in np.flatnonzero(~(A != 0).any(axis=0)):
        A[rng.integers(m), j] = 1.0
    b = np.sign(A @ rng.standard_normal(n).astype(np.float32)
                + 0.1 * rng.standard_normal(m)).astype(np.float32)
    b[b == 0] = 1.0
    return A, b


@pytest.fixture(scope="module")
def data(svm_data):
    Ad, bd = svm_data
    As, bs = _sparse_svm_data()
    rng = np.random.default_rng(9)
    return {"Ad": Ad, "bd": bd, "As": As, "bs": bs,
            "warm_dense": 0.3 * rng.random(Ad.shape[0]),
            "warm_sparse": 0.3 * rng.random(As.shape[0])}


@pytest.fixture(scope="module")
def ref_f64(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_svm")
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE)
    out = subprocess.run(
        [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
         json.dumps([CASES, H, H1]), str(tmp / "ref.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "ref.npz"))


def _problem(data, operand, loss="l1"):
    if operand == "dense":
        return tcore.SVMProblem(A=data["Ad"], b=data["bd"], loss=loss)
    return tcore.SVMProblem(A=tcore.SparseOperand.from_dense(data["As"]),
                            b=data["bs"], loss=loss)


def _run_port(name, data, dtype=torch.float64):
    solver, s, mu, loss, operand, warm, sym = CASES[name]
    cfg = tcore.SolverConfig(block_size=mu, s=s, iterations=H,
                             symmetric_gram=sym, dtype=dtype, device="cpu")
    return getattr(tcore, solver)(
        _problem(data, operand, loss), cfg,
        alpha0=data["warm_" + operand] if warm else None)


def _close(got, want, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= 1e-10, f"{what}: {err:.3e} > 1e-10"


def _rel_close(got, want, tol, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    assert err <= tol, f"{what}: rel {err:.3e} > {tol}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_repro_f64(name, ref_f64, data):
    res = _run_port(name, data)
    _close(res.x, ref_f64[name + "/x"], "x")
    _rel_close(res.objective, ref_f64[name + "/objective"], 1e-10,
               "objective")
    _close(res.aux["alpha"], ref_f64[name + "/alpha"], "alpha")
    _rel_close(res.aux["dual"], ref_f64[name + "/dual"], 1e-10, "dual")
    assert res.aux["state"].iteration == int(ref_f64[name + "/iteration"])
    leaves = [k for k in ref_f64 if k.startswith(name + "/state/")]
    assert sorted(k.rsplit("/", 1)[1] for k in leaves) \
        == sorted(res.aux["state"].carry) == ["alpha", "dual", "x"]
    for k in leaves:
        _close(res.aux["state"].carry[k.rsplit("/", 1)[1]], ref_f64[k], k)
    assert res.objective[-1] <= res.objective[0]     # dual descent


@pytest.mark.parametrize("name", ["sa-s16-mu4-l1-dense",
                                  "sa-s3-mu4-l2-sparse"])
def test_objectives_and_gap_match_repro_f64(name, ref_f64, data):
    solver, s, mu, loss, operand, warm, sym = CASES[name]
    res = _run_port(name, data)
    prob = _problem(data, operand, loss)           # evaluates in A's dtype
    A64 = prob.A.astype(torch.float64) if operand == "sparse" \
        else prob.A.astype(np.float64)
    prob = tcore.SVMProblem(A=A64, b=prob.b, loss=loss)
    primal = tcore.primal_objective(prob, res.x)
    dual = tcore.dual_objective(prob, res.aux["alpha"])
    gap = tcore.duality_gap(prob, res.x, res.aux["alpha"])
    _rel_close(primal, ref_f64[name + "/primal"], 1e-10, "primal")
    _rel_close(dual, ref_f64[name + "/dual_direct"], 1e-10, "dual")
    _rel_close(gap, ref_f64[name + "/gap"], 1e-10, "gap")
    # the tracked dual is the direct one, and weak duality holds.
    _rel_close(res.aux["dual"], dual.numpy(), 1e-10, "tracked dual")
    assert float(gap) >= -1e-12


def test_repro_state_resumes_in_port(ref_f64, data):
    carry = {k.split("/")[-1]: ref_f64[k] for k in ref_f64
             if k.startswith("first/state/")}
    assert set(carry) == {"alpha", "x", "dual"}
    state = convert.state_from_numpy(H1, carry, torch.float64, "cpu")
    op = convert.operand_from_numpy(
        tcore.SparseOperand.from_dense(data["As"]), device="cpu",
        dtype=torch.float64)
    prob = convert.svm_problem_from_numpy(op, data["bs"], device="cpu",
                                          dtype=torch.float64)
    cfg = tcore.SolverConfig(block_size=4, s=8, iterations=H - H1,
                             dtype=torch.float64, device="cpu")
    rest = api.solve(prob, cfg, state=state)
    whole = api.solve(prob, tcore.SolverConfig(
        block_size=4, s=8, iterations=H, dtype=torch.float64, device="cpu"))
    assert rest.aux["state"].iteration == H
    _rel_close(rest.objective, whole.objective[H1:].numpy(), 1e-10,
               "resumed trace")
    _close(rest.x, whole.x.numpy(), "x")
    _close(rest.aux["alpha"], whole.aux["alpha"].numpy(), "alpha")


@pytest.mark.parametrize("name", ["sa-s8-mu4-l2-dense",
                                  "sa-s3-mu1-l1-sparse"])
def test_port_matches_repro_f32_objective(name, data):
    solver, s, mu, loss, operand, warm, sym = CASES[name]
    A = data["Ad"] if operand == "dense" \
        else jcore.SparseOperand.from_dense(data["As"])
    b = data["bd"] if operand == "dense" else data["bs"]
    cfg = jcore.SolverConfig(block_size=mu, s=s, iterations=H,
                             symmetric_gram=sym, dtype=jnp.float32)
    want = np.asarray(getattr(jcore, solver)(
        jcore.SVMProblem(A=A, b=b, loss=loss), cfg).objective)
    got = _run_port(name, data, torch.float32).objective.numpy()
    assert got.dtype == np.float32
    _rel_close(got, want, 1e-4, "objective")


@pytest.mark.parametrize("operand", ["dense", "sparse"])
@pytest.mark.parametrize("s,mu,loss", [(3, 1, "l1"), (16, 4, "l2")])
def test_sa_equals_classical_in_port_f64(data, operand, s, mu, loss):
    prob = _problem(data, operand, loss)
    cfg = lambda s_: tcore.SolverConfig(block_size=mu, s=s_, iterations=H,
                                        dtype=torch.float64, device="cpu")
    base = tcore.solve_svm(prob, cfg(1))
    sa = tcore.solve_svm(prob, cfg(s))
    _rel_close(sa.objective, base.objective.numpy(), 1e-10, "objective")
    _close(sa.x, base.x.numpy(), "x")
    _close(sa.aux["alpha"], base.aux["alpha"].numpy(), "alpha")
    assert base.objective[-1] < base.objective[0]


def test_sparse_equals_dense_in_port_f64(data):
    cfg = tcore.SolverConfig(block_size=4, s=8, iterations=H,
                             dtype=torch.float64, device="cpu")
    dense = api.solve(tcore.SVMProblem(A=data["As"], b=data["bs"]), cfg)
    sparse = api.solve(_problem(data, "sparse"), cfg)
    _rel_close(sparse.objective, dense.objective.numpy(), 1e-10, "objective")
    _close(sparse.x, dense.x.numpy(), "x")
    assert "spmm_impl" not in dense.aux
    assert sparse.aux["spmm_impl"] == "torch"
    assert sparse.aux["inner_impl"] == dense.aux["inner_impl"] == "torch"


def test_kernel_svm_is_refused(data):
    """The linear solvers refuse a kernel problem, naming the ksvm family
    that ``api.solve`` and ``solve_svm`` route it to."""
    prob = tcore.SVMProblem(A=data["Ad"], b=data["bd"], kernel="rbf",
                            kernel_params={"gamma": 0.1})
    cfg = tcore.SolverConfig(block_size=2, s=4, iterations=8, device="cpu")
    assert api.resolve_family(prob).name == "ksvm"
    routed = api.solve(prob, cfg)
    assert torch.equal(routed.aux["f"], tcore.sa_kbdcd_svm(prob, cfg).aux["f"])
    assert torch.equal(tcore.solve_svm(prob, cfg).objective, routed.objective)
    for call in (lambda: tcore.bdcd_svm(prob, cfg),
                 lambda: tcore.sa_bdcd_svm(prob, cfg)):
        with pytest.raises(ValueError, match="'ksvm' family"):
            call()
    with pytest.raises(ValueError, match="unknown kernel"):
        tcore.SVMProblem(A=data["Ad"], b=data["bd"], kernel="sigmoid")
    with pytest.raises(ValueError, match="mu = 1|block_size == 1"):
        tcore.sa_svm(_problem(data, "dense"), cfg)


@pytest.mark.parametrize("extra", [[], ["--sparse", "--mu", "4",
                                        "--svm-loss", "l2"]])
def test_launcher_runs_svm_on_cpu(extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_solve.main(["--problem", "svm", "--dataset", "w1a-like",
                           "--s", "8", "--iterations", "64",
                           "--device", "cpu", *extra])
    first, last = map(float, re.search(r"dual (\S+) -> (\S+),",
                                       buf.getvalue()).groups())
    assert last < first
