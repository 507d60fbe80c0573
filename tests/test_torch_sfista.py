"""The port's SFISTA family (repro_torch.core.sfista: SFISTA and
CA-SFISTA) against repro's on the same numpy-made inputs, on the CPU.

repro runs in ONE subprocess for this module (DESIGN.md "Test-process
device convention"): first the f32 cases, then, with x64 turned on, the
f64 ones; it writes an .npz. While it runs, a job of four gloo processes
(``core.distributed.run_ranks``; groups of 4, 2 and 1 inside it) runs the
port's sharded solves. This module imports no JAX, because every rank
imports it.

Held to repro at f64 within 1e-10 (trace relative, vectors absolute
against max(1, |ref|_inf)): x, the residual, the objective trace and
every aux["state"] leaf (x, y, rx, ry), over SFISTA and CA-SFISTA, s in
{1, 4, 8, 16}, mu in {1, 2, 4}, lasso and elastic net, H = 37 (a
remainder group for every s > 1), dense and sparse operands, the
symmetric Gram, warm starts, and a 12-column problem whose columns repeat
within every group. At f32: repro's own bars (rtol 5e-5 on the trace, x
atol 2e-5). Also: the tracked objective against ``sfista_objective``, the
t-schedule against repro's, a repro state resuming in the port, the
port's resume at a group boundary bit for bit, ``api.solve``'s routing,
the launcher, and the sharded backend at P = 1, 2 and 4 (ceil(H/s)
reductions untracked, twice that tracked; the local solve within 1e-10,
bit for bit at P = 1).
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
L2 = 0.5

# name -> (solver, s, mu, l2, operand, symmetric_gram, warm start)
CASES = {
    "sf-mu4-dense": ("sfista", 1, 4, 0.0, "dense", False, False),
    "sf-mu1-sparse-x0": ("sfista", 1, 1, 0.0, "sparse", False, True),
    "sf-mu2-enet-dense": ("sfista", 1, 2, L2, "dense", False, False),
    "ca-s1-mu4-dense": ("ca_sfista", 1, 4, 0.0, "dense", False, False),
    "ca-s4-mu1-sparse": ("ca_sfista", 4, 1, 0.0, "sparse", False, False),
    "ca-s8-mu4-dense": ("ca_sfista", 8, 4, 0.0, "dense", False, False),
    "ca-s8-mu2-enet-sparse-x0": ("ca_sfista", 8, 2, L2, "sparse", False,
                                 True),
    "ca-s4-mu4-dense-sym": ("ca_sfista", 4, 4, 0.0, "dense", True, False),
    "ca-s8-mu4-sparse-sym-x0": ("ca_sfista", 8, 4, 0.0, "sparse", True,
                                True),
    "ca-s16-mu2-enet-dense-x0": ("ca_sfista", 16, 2, L2, "dense", False,
                                 True),
    "ca-s8-mu4-collide": ("ca_sfista", 8, 4, 0.0, "tiny", False, False),
    "ca-s4-mu2-enet-collide": ("ca_sfista", 4, 2, L2, "tiny", False, False),
}
F32_CASES = ["ca-s8-mu4-dense", "ca-s4-mu1-sparse", "sf-mu4-dense"]
DIRECT_CASES = ["ca-s8-mu4-dense", "ca-s8-mu2-enet-sparse-x0"]
SHARDED_CASES = ["ca-s8-mu4-dense", "ca-s8-mu4-sparse-sym-x0",
                 "sf-mu1-sparse-x0", "ca-s8-mu2-enet-sparse-x0"]
REPLICATED = ("x", "objective", "state/x", "state/y")


def _data():
    """90 x 48 (dense, and ~30% dense with no empty column) with a planted
    6-sparse x, and a 40 x 12 problem whose 12 columns repeat within every
    group of s mu >= 8 draws; lam = 0.1 ||A^T b||_inf each; warm starts.
    Values are f32-exact, so f32 and f64 solves see the same numbers."""
    rng = np.random.default_rng(3)
    out = {}
    for name, (m, n) in (("dense", (90, 48)), ("tiny", (40, 12))):
        A = rng.standard_normal((m, n)).astype(np.float32)
        xt = np.zeros(n)
        xt[:6] = rng.standard_normal(6)
        out["A_" + name] = A
        out["b_" + name] = (A @ xt + 0.1 * rng.standard_normal(m)).astype(
            np.float32)
        out["warm_" + name] = 0.1 * rng.standard_normal(n)
    As = out["A_dense"] * (rng.random((90, 48)) < 0.3)
    for j in np.flatnonzero(~(As != 0).any(axis=0)):
        As[rng.integers(90), j] = 1.0
    xt = np.zeros(48)
    xt[:6] = rng.standard_normal(6)
    out["A_sparse"] = As
    out["b_sparse"] = (As @ xt + 0.1 * rng.standard_normal(90)).astype(
        np.float32)
    out["warm_sparse"] = 0.1 * rng.standard_normal(48)
    for name in ("dense", "tiny", "sparse"):
        out["lam_" + name] = 0.1 * float(
            np.abs(out["A_" + name].T @ out["b_" + name]).max())
    return out


_REF_CODE = r"""
import json, sys
import jax
import numpy as np, jax.numpy as jnp
from repro import core
from repro.core import linalg
from repro.core.sfista import sfista_objective
CASES, F32_CASES, DIRECT_CASES, H, H1 = json.loads(sys.argv[2])
d = np.load(sys.argv[1])


def problem(name, dtype=np.float32):
    solver, s, mu, l2, operand, sym, warm = CASES[name]
    A = d["A_" + operand].astype(dtype)
    if operand == "sparse":
        A = core.SparseOperand.from_dense(A)
    return core.SFISTAProblem(A=A, b=d["b_" + operand],
                              lam=float(d["lam_" + operand]), l2=l2)


def run(name, dtype, iterations=H):
    solver, s, mu, l2, operand, sym, warm = CASES[name]
    cfg = core.SolverConfig(block_size=mu, s=s, iterations=iterations,
                            symmetric_gram=sym, dtype=dtype)
    return getattr(core, solver)(
        problem(name), cfg,
        x0=d["warm_" + operand] if warm and iterations == H else None)


out = {}
for name in F32_CASES:
    res = run(name, jnp.float32)
    out[name + "/f32/objective"] = np.asarray(res.objective)
    out[name + "/f32/x"] = np.asarray(res.x)
out["ts/f32"] = np.asarray(linalg.fista_t_schedule(200, jnp.float32))
jax.config.update("jax_enable_x64", True)
out["ts/f64"] = np.asarray(linalg.fista_t_schedule(200, jnp.float64))
for name in CASES:
    res = run(name, jnp.float64)
    out[name + "/x"] = np.asarray(res.x)
    out[name + "/objective"] = np.asarray(res.objective)
    out[name + "/residual"] = np.asarray(res.aux["residual"])
    for k, v in res.aux["state"].carry.items():
        out[name + "/state/" + k] = np.asarray(v)
    out[name + "/iteration"] = np.asarray(res.aux["state"].iteration)
    if name in DIRECT_CASES:
        out[name + "/direct"] = np.asarray(
            sfista_objective(problem(name, np.float64), res.x))
first = run("ca-s8-mu4-dense", jnp.float64, H1)
for k, v in first.aux["state"].carry.items():
    out["first/state/" + k] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""


def _problem(name, d, dtype=np.float32):
    """The case's problem; ``dtype`` is A's (the solvers cast it to the
    solve's, the direct objective evaluates in it)."""
    solver, s, mu, l2, operand, sym, warm = CASES[name]
    A = d["A_" + operand].astype(dtype)
    if operand == "sparse":
        A = tcore.SparseOperand.from_dense(torch.as_tensor(A))
    return tcore.SFISTAProblem(A=A, b=d["b_" + operand],
                               lam=float(d["lam_" + operand]), l2=l2)


def _cfg(name, dtype, iterations=H, track=True):
    solver, s, mu, l2, operand, sym, warm = CASES[name]
    return tcore.SolverConfig(block_size=mu, s=s, iterations=iterations,
                              symmetric_gram=sym, track_objective=track,
                              dtype=dtype, device="cpu")


def _warm(name, d):
    solver, s, mu, l2, operand, sym, warm = CASES[name]
    return d["warm_" + operand] if warm else None


def _run_port(name, d, dtype=torch.float64):
    return getattr(tcore, CASES[name][0])(_problem(name, d),
                                          _cfg(name, dtype),
                                          x0=_warm(name, d))


def _leaves(res):
    out = {"x": res.x, "objective": res.objective,
           "residual": res.aux["residual"]}
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
    tmp = tmp_path_factory.mktemp("torch_sfista")
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE)
    with open(tmp / "ref.err", "w") as err:
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
             json.dumps([CASES, F32_CASES, DIRECT_CASES, H, H1]),
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
    """Every leaf against repro's f64 solve: the trace relative, vectors
    against max(1, |ref|)."""
    _rel_close(got["objective"], ref[name + "/objective"], 1e-10,
               "objective")
    for k in got:
        if k != "objective":
            _close(got[k], ref[name + "/" + k], k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_repro_f64(name, runs, data):
    ref, _ = runs
    res = _run_port(name, data)
    leaves = _numpy(_leaves(res))
    assert sorted(res.aux["state"].carry) == ["rx", "ry", "x", "y"]
    assert res.aux["state"].iteration == int(ref[name + "/iteration"]) == H
    _hold_to_ref(leaves, ref, name)
    assert leaves["objective"][-1] < leaves["objective"][0]


@pytest.mark.parametrize("name", F32_CASES)
def test_port_matches_repro_f32(name, runs, data):
    """repro's own f32 bars for CA-SFISTA against SFISTA
    (tests/test_sfista.py), here port against repro."""
    ref, _ = runs
    res = _run_port(name, data, torch.float32)
    assert res.objective.dtype == torch.float32
    np.testing.assert_allclose(res.objective.numpy(),
                               ref[name + "/f32/objective"], rtol=5e-5)
    np.testing.assert_allclose(res.x.numpy(), ref[name + "/f32/x"],
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_t_schedule_matches_repro(dtype, runs):
    """The host recurrence rounds as JAX's does, in the solve's dtype."""
    ref, _ = runs
    got = linalg.fista_t_schedule(
        200, torch.float32 if dtype == "f32" else torch.float64)
    want = ref["ts/" + dtype]
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", DIRECT_CASES)
def test_tracked_objective_is_the_direct_one(name, runs, data):
    ref, _ = runs
    res = _run_port(name, data)
    direct = tcore.sfista_objective(_problem(name, data, np.float64), res.x)
    _rel_close(direct, ref[name + "/direct"], 1e-10, "direct objective")
    _rel_close(res.objective[-1], direct.numpy(), 1e-10, "tracked objective")


@pytest.mark.parametrize("operand", ["dense", "sparse"])
@pytest.mark.parametrize("s,mu", [(3, 1), (8, 4), (16, 2)])
def test_ca_equals_classical_in_port_f64(data, operand, s, mu):
    prob = _problem("sf-mu4-dense" if operand == "dense"
                    else "sf-mu1-sparse-x0", data)
    cfg = lambda s_: tcore.SolverConfig(block_size=mu, s=s_, iterations=H,
                                        dtype=torch.float64, device="cpu")
    base, ca = tcore.solve_sfista(prob, cfg(1)), tcore.solve_sfista(prob,
                                                                    cfg(s))
    _rel_close(ca.objective, base.objective.numpy(), 1e-10, "objective")
    _close(ca.x, base.x.numpy(), "x")
    _close(ca.aux["residual"], base.aux["residual"].numpy(), "residual")


def test_repro_state_resumes_in_port(runs, data):
    ref, _ = runs
    name = "ca-s8-mu4-dense"
    carry = {k.split("/")[-1]: ref[k] for k in ref
             if k.startswith("first/state/")}
    assert set(carry) == {"x", "y", "rx", "ry"}
    state = convert.state_from_numpy(H1, carry, torch.float64, "cpu")
    prob = convert.sfista_problem_from_numpy(
        data["A_dense"], data["b_dense"], lam=float(data["lam_dense"]),
        device="cpu", dtype=torch.float64)
    rest = api.solve(prob, _cfg(name, torch.float64, H - H1), state=state)
    assert rest.aux["state"].iteration == H
    _rel_close(rest.objective, ref[name + "/objective"][H1:], 1e-10,
               "resumed trace")
    _close(rest.x, ref[name + "/x"], "x")
    _close(rest.aux["residual"], ref[name + "/residual"], "residual")


@pytest.mark.parametrize("name", ["ca-s8-mu4-dense",
                                  "ca-s8-mu2-enet-sparse-x0",
                                  "sf-mu2-enet-dense"])
def test_port_resume_is_exact(name, data):
    """H1 iterations, then a resume from its state for the rest: the
    bits of the uninterrupted solve (H1 is a group boundary; the
    t-schedule is recomputed from the state's iteration)."""
    prob = _problem(name, data)
    whole = api.solve(prob, _cfg(name, torch.float64), x0=_warm(name, data))
    first = api.solve(prob, _cfg(name, torch.float64, H1),
                      x0=_warm(name, data))
    rest = api.solve(prob, _cfg(name, torch.float64, H - H1),
                     state=first.aux["state"])
    assert torch.equal(torch.cat([first.objective, rest.objective]),
                       whole.objective)
    for k, v in whole.aux["state"].carry.items():
        assert torch.equal(rest.aux["state"].carry[k], v), k


def test_api_routes_sfista_problems(data):
    name = "ca-s8-mu4-dense"
    prob = _problem(name, data)
    assert api.resolve_family(prob).name == "sfista"
    assert api.FAMILIES["sfista"].supports_symmetric_gram
    assert api.FAMILIES["sfista"].partition == "row"
    cfg = _cfg(name, torch.float64)
    got = api.solve(prob, cfg)
    want = tcore.ca_sfista(prob, cfg)
    assert torch.equal(got.objective, want.objective)
    assert torch.equal(got.x, want.x)
    sparse = api.solve(_problem("ca-s4-mu1-sparse", data),
                       _cfg("ca-s4-mu1-sparse", torch.float64))
    assert sparse.aux["spmm_impl"] == "torch" and "spmm_impl" not in got.aux


@pytest.mark.parametrize("extra", [[], ["--sparse", "--dataset",
                                        "news20-like", "--mu", "4"],
                                   ["--s", "1", "--lam-frac", "0.2"]])
def test_launcher_runs_sfista_on_cpu(extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_solve.main(["--problem", "sfista", "--dataset",
                           "epsilon-like", "--s", "8", "--iterations",
                           "64", "--device", "cpu", *extra])
    first, last = map(float, re.search(r"obj (\S+) -> (\S+),",
                                       buf.getvalue()).groups())
    assert buf.getvalue().startswith("sfista ") and last < first


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_matches_local_f64(name, P, runs, data):
    """Sharded by rows at P ranks (the residuals gathered): repro's f64
    solve within 1e-10, and the port's local solve within 1e-10 (bit for
    bit at P = 1)."""
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
    """ceil(H/s) reductions (H for s = 1) untracked; tracked, each outer
    iteration adds one, of its s squared residual norms. A warm start
    rebuilds its residual locally and adds none."""
    _, job = runs
    s = CASES[name][1]
    outer = -(-H // s)
    assert job[(P, name, "untracked")] == outer
    assert job[(P, name, "tracked")] == 2 * outer


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_replicated_state_is_the_same_on_every_rank(name, P, runs):
    same = runs[1][(P, name, "same")]
    assert sorted(same) == sorted(REPLICATED)
    assert all(same.values()), same
