"""The port's autotuner (repro_torch.tune) against repro's (repro.tune) on
the same inputs, and the port's own behaviour.

* Calibrate / select / tune, all five families, dense and sparse: the
  SAME deterministic measure_fn is injected into both packages, which
  must fit the same Machine (rel 1e-12), report the same pilot points and
  max_ratio, select the same (s, block_size, symmetric_gram) and predict
  the same time; also a group lasso (mu kept) and an explicit grid.
* problem_dims: the port's SparseOperand.nnz counts what repro's counts
  on the same COO triplets (stored zeros included in the input).
* Port only: the cache round trip (a cached tune runs no solve), a cache
  key that is not repro's, certified=True refused, a kernel route for
  every (s, mu) of every family's default grid at f32 and f64, the
  facade's refusals, the launcher's --list-families and --tune, real
  measurements on the CPU (microbench, calibrate, measure_solve), and
  the microbench's all-reduce across two gloo ranks.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import tune as jtune
from repro.core import cost_model as jcm
from repro_torch import api as tapi
from repro_torch import tune as ttune
from repro_torch.core import cost_model as tcm
from repro_torch.kernels import dispatch
from repro_torch.kernels.sa_inner import ops as sa_inner_ops
from repro_torch.kernels.svm_inner import ops as svm_inner_ops
from repro_torch.launch import solve as launch_solve

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
FAMILY_NAMES = ("lasso", "svm", "ksvm", "logreg", "sfista")
M, N = 48, 40


def _data(seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)).astype(np.float32)
    A[rng.random(A.shape) > density] = 0.0
    b = rng.standard_normal(M).astype(np.float32)
    return A, b


def _problems(family, operand, groups=None):
    """(repro problem, port problem) of ``family`` on the same arrays."""
    A, b = _data()
    y = np.where(b >= 0, 1.0, -1.0).astype(np.float32)
    if operand == "sparse":
        jA = japi.SparseOperand.from_dense(A)
        tA = tapi.SparseOperand.from_dense(torch.as_tensor(A))
    else:
        jA, tA = A, A
    out = []
    for pkg, Aop in ((japi, jA), (tapi, tA)):
        out.append({
            "lasso": lambda: pkg.LassoProblem(A=Aop, b=b, lam=0.1,
                                              groups=groups),
            "sfista": lambda: pkg.SFISTAProblem(A=Aop, b=b, lam=0.1),
            "svm": lambda: pkg.SVMProblem(A=Aop, b=y, lam=1.0),
            "ksvm": lambda: pkg.SVMProblem(A=Aop, b=y, lam=1.0,
                                           kernel="rbf",
                                           kernel_params={"gamma": 0.1}),
            "logreg": lambda: pkg.LogRegProblem(A=Aop, b=y, lam=1e-3),
        }[family]())
    return out


def fake_measure(cfg):
    """Deterministic 'measured' seconds of a config: a latency, overhead,
    message and flop term plus a (s, mu)-dependent wobble, so the fit is
    not exact and the pilot ratios differ from 1."""
    s, mu, H = cfg.s, cfg.block_size, cfg.iterations
    t = H * (2e-5 / s + 1e-6 + 3e-9 * s * mu * mu + 1e-9 * mu ** 3)
    return t * (1.0 + 0.1 * ((3 * s + 5 * mu) % 7) / 7.0)


def _cfgs(**kw):
    j = japi.SolverConfig(**kw)
    t = tapi.SolverConfig(device="cpu", **kw)
    return j, t


def _close(a, b, rel=1e-12):
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def _same_machine(jm, tm):
    assert all(_close(a, b) for a, b in zip(jcm.machine_vector(jm),
                                            tcm.machine_vector(tm))), \
        (jm, tm)


def _same_points(jrep, trep):
    assert len(jrep.points) == len(trep.points)
    for jp, tp in zip(jrep.points, trep.points):
        assert (jp["s"], jp["mu"], jp["measured_s"]) == \
            (tp["s"], tp["mu"], tp["measured_s"])
        assert _close(jp["predicted_s"], tp["predicted_s"])
        assert _close(jp["ratio"], tp["ratio"])
    assert _close(jrep.max_ratio, trep.max_ratio)
    assert trep.max_ratio > 1.0         # the wobble keeps the fit inexact


def _key(cfg):
    return (cfg.s, cfg.block_size, cfg.symmetric_gram)


CASES = [(f, op) for f in FAMILY_NAMES for op in ("dense", "sparse")]


@pytest.mark.parametrize("family,operand", CASES)
def test_calibrate_matches_repro(family, operand):
    jp, tp = _problems(family, operand)
    jcfg, tcfg = _cfgs(block_size=4, s=8, iterations=256)
    assert dataclasses.astuple(ttune.problem_dims(tp)) == \
        dataclasses.astuple(jtune.problem_dims(jp))
    jrep = jtune.calibrate(jp, jcfg, pilot_iters=32, measure_fn=fake_measure)
    trep = ttune.calibrate(tp, tcfg, pilot_iters=32, measure_fn=fake_measure)
    _same_machine(jrep.machine, trep.machine)
    _same_points(jrep, trep)
    assert json.dumps(trep.to_dict()["points"]) is not None


@pytest.mark.parametrize("family,operand", CASES)
def test_select_and_tune_match_repro(family, operand, tmp_path):
    jp, tp = _problems(family, operand)
    jcfg, tcfg = _cfgs(block_size=2, s=4, iterations=512,
                       track_objective=False)
    jm = jcm.Machine("lat", alpha=1e-2, beta=1e-12, gamma=1e-13, kappa=1e-9)
    tm = tcm.Machine("lat", alpha=1e-2, beta=1e-12, gamma=1e-13, kappa=1e-9)
    for P in (1, 64):
        assert _key(ttune.select_config(tp, tm, tcfg, P=P)) == \
            _key(jtune.select_config(jp, jm, jcfg, P=P))
    jres = jtune.tune(jp, jcfg, cache_dir=str(tmp_path / "j"),
                      measure_fn=fake_measure)
    tres = ttune.tune(tp, tcfg, cache_dir=str(tmp_path / "t"),
                      measure_fn=fake_measure)
    _same_machine(jres.machine, tres.machine)
    _same_points(jres.calibration, tres.calibration)
    assert _key(tres.config) == _key(jres.config)
    assert _close(tres.predicted_s, jres.predicted_s)
    assert _close(tres.predicted_default_s, jres.predicted_default_s)
    assert tres.guard_times == jres.guard_times
    # everything the tuner does not own is the caller's
    assert (tres.config.iterations, tres.config.device,
            tres.config.track_objective) == (512, "cpu", False)
    sel_j = jtune.select_config(jp, jres.machine, jcfg)
    sel_t = ttune.select_config(tp, tres.machine, tcfg)
    assert _key(sel_t) == _key(sel_j)


@pytest.mark.parametrize("grid", [None, [(1, 1), (4, 2), (16, 8), (64, 2)]])
def test_group_lasso_and_explicit_grid_match_repro(grid, tmp_path):
    """Group lasso: mu is the group size, in the pilot points and in the
    selection; an explicit grid is pinned to it too."""
    mu = 4
    groups = np.repeat(np.arange(N // mu), mu)
    jp, tp = _problems("lasso", "dense", groups=groups)
    jcfg, tcfg = _cfgs(block_size=mu, s=2, iterations=128)
    jrep = jtune.calibrate(jp, jcfg, pilot_iters=16, measure_fn=fake_measure)
    trep = ttune.calibrate(tp, tcfg, pilot_iters=16, measure_fn=fake_measure)
    assert {p["mu"] for p in trep.points} == {mu}
    _same_machine(jrep.machine, trep.machine)
    _same_points(jrep, trep)
    jres = jtune.tune(jp, jcfg, grid=grid, cache_dir=str(tmp_path / "j"),
                      measure_fn=fake_measure)
    tres = ttune.tune(tp, tcfg, grid=grid, cache_dir=str(tmp_path / "t"),
                      measure_fn=fake_measure)
    assert tres.config.block_size == mu
    assert _key(tres.config) == _key(jres.config)
    assert _close(tres.predicted_s, jres.predicted_s)
    # an explicit grid on the plain lasso: mu past the sampled axis dropped
    jp, tp = _problems("lasso", "dense")
    wide = [(2, 1), (8, N + 1), (32, 8)]
    assert _key(ttune.select_config(tp, trep.machine, tcfg, grid=wide)) == \
        _key(jtune.select_config(jp, jrep.machine, jcfg, grid=wide))
    with pytest.raises(ValueError, match="no executable"):
        ttune.select_config(tp, trep.machine, tcfg, grid=[(4, N + 1)])


def test_sparse_nnz_matches_repro_on_the_same_coo():
    rng = np.random.default_rng(3)
    m, n = 37, 53
    keys = rng.choice(m * n, size=200, replace=False)
    rows, cols = keys // n, keys % n
    vals = rng.standard_normal(200).astype(np.float32)
    vals[::17] = 0.0                          # stored zeros in the input
    jA = japi.SparseOperand.from_coo(rows, cols, vals, (m, n))
    tA = tapi.SparseOperand.from_coo(rows, cols, vals, (m, n))
    assert tA.nnz == jA.nnz == int((vals != 0).sum())
    b = np.ones(m, np.float32)
    assert dataclasses.astuple(ttune.problem_dims(
        tapi.LassoProblem(A=tA, b=b, lam=0.1))) == dataclasses.astuple(
        jtune.problem_dims(japi.LassoProblem(A=jA, b=b, lam=0.1)))
    dense = ttune.problem_dims(tapi.LassoProblem(A=tA.todense(), b=b,
                                                 lam=0.1))
    assert (dense.m, dense.n, dense.f) == (m, n, 1.0)


# ---------------------------------------------------------------------------
# The port's own behaviour.
# ---------------------------------------------------------------------------

def test_cache_roundtrip_and_cached_tune_runs_no_solve(tmp_path,
                                                       monkeypatch):
    _, tp = _problems("lasso", "dense")
    cfg = tapi.SolverConfig(block_size=4, s=2, iterations=64, device="cpu")
    calls = []

    def counting(c):
        calls.append(c)
        return fake_measure(c)

    first = ttune.tune(tp, cfg, cache_dir=str(tmp_path), measure_fn=counting)
    assert not first.from_cache and calls
    path = ttune.cache_path(tp, "lasso", str(tmp_path), dtype=cfg.dtype,
                            device="cpu")
    assert os.path.exists(path)
    assert ttune.load_cached_machine(path) == first.machine
    n_calls = len(calls)

    def no_solve(*a, **k):
        raise AssertionError("a cached tune ran a solve")

    monkeypatch.setattr(ttune, "measure_solve", no_solve)
    monkeypatch.setattr(ttune, "calibrate", no_solve)
    second = ttune.tune(tp, cfg, cache_dir=str(tmp_path), measure_fn=counting)
    assert second.from_cache and len(calls) == n_calls
    assert second.machine == first.machine and second.calibration is None
    assert second.guard_times is None
    assert _key(second.config) == _key(first.config)
    monkeypatch.undo()
    third = ttune.tune(tp, cfg, cache_dir=str(tmp_path), refresh=True,
                       measure_fn=counting)
    assert not third.from_cache and len(calls) > n_calls
    (tmp_path / "bad.json").write_text("{not json")
    assert ttune.load_cached_machine(str(tmp_path / "bad.json")) is None
    assert ttune.load_cached_machine(str(tmp_path / "none.json")) is None


def test_cache_key_is_not_repros(tmp_path):
    jp, tp = _problems("svm", "sparse")
    jpath = jtune.cache_path(jp, "svm", str(tmp_path), dtype=jnp.float32)
    tpath = ttune.cache_path(tp, "svm", str(tmp_path), dtype=torch.float32,
                             device="cpu")
    jname, tname = os.path.basename(jpath), os.path.basename(tpath)
    assert tname != jname and tname.startswith("torch-")
    assert tname == "torch-" + jname      # on the CPU: the same regime key
    assert ttune.cache_path(tp, "svm", str(tmp_path), dtype=torch.float64,
                            device="cpu") != tpath
    with pytest.raises(RuntimeError, match="cuda"):
        ttune.cache_path(tp, "svm", str(tmp_path))    # no card here


def test_certified_selection_is_not_ported():
    """certified=True was refused before the static contracts were
    ported; it now runs ``repro_torch.analysis.check_costs`` on the
    family (on cfg.device) and, the lasso hook being certified, selects
    what the uncertified sweep selects."""
    _, tp = _problems("lasso", "dense")
    cfg = tapi.SolverConfig(device="cpu")
    mach = tcm.Machine.cray_xc30()
    assert ttune.select_config(tp, mach, cfg, certified=True) \
        == ttune.select_config(tp, mach, cfg)


# Which kernels a family's solve reaches (tune/select.py's docstring):
# the inner kernel's wrapper module, and the vectors appended to Y^T Y by
# the fused Gram (dense) or col-Gram SpMM (sparse); cross-block families
# (ksvm, logreg) run K4 at R = m with Q = s*mu on a sparse operand.
ROUTES = {"lasso": (sa_inner_ops, 2), "sfista": (None, 1),
          "svm": (svm_inner_ops, 1), "ksvm": (svm_inner_ops, None),
          "logreg": (None, None)}


@pytest.mark.parametrize("family", FAMILY_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_default_grid_point_has_a_route(family, dtype):
    """Every (s, mu) of the family's tune_space has a body in
    kernels/dispatch.py: K2 and K3 route to warp or block (G in global
    memory past shared memory); K1's fused call plans a grid; K4 plans
    its grid at the col-Gram or cross shape."""
    fam = tapi.FAMILIES[family]
    inner, vecs = ROUTES[family]
    itemsize = torch.finfo(dtype).bits // 8
    m_eps, m_news, K = 400_000, 19_996, 64
    bodies = set()
    for s in fam.tune_space["s"]:
        for mu in fam.tune_space["mu"]:
            p = s * mu
            if inner is not None:
                route, _ = inner._route(s, mu, itemsize, None)
                bodies.add(route)
                assert route in ("warp", "block")
            if vecs is not None:
                q = p + vecs
                route = dispatch.gram_route(dtype, m_eps, p, q, y_cols=p)
                plan = dispatch.gram_plan(m_eps, p, q, route, same=True,
                                          itemsize=itemsize)
                assert plan.splits >= 1 and plan.p_tiles * plan.tile_p >= p
                R, Q = p, q
            else:
                R, Q = m_news, p
            sp = dispatch.spmm_plan(R, K, Q)
            assert 1 <= sp.grid_x <= dispatch.GRID_X_MAX
            assert sp.grid_y * dispatch.SPMM_Q_TILE >= Q
    if inner is not None:
        assert "warp" in bodies
        # the largest grid point (s*mu up to 1024) takes the block body
        assert "block" in bodies


def test_facade_tune_refusals():
    _, tp = _problems("lasso", "dense")
    cfg = tapi.SolverConfig(block_size=4, s=2, iterations=8, device="cpu")
    with pytest.raises(ValueError, match="backend='local'"):
        tapi.solve(tp, cfg, backend="sharded", tune="auto")
    with pytest.raises(ValueError, match="unknown tune mode"):
        tapi.solve(tp, cfg, tune="fast")


def test_launcher_lists_families_and_tunes_on_cpu(tmp_path, monkeypatch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_solve.main(["--list-families"])
    out = buf.getvalue()
    for name in FAMILY_NAMES:
        fam = tapi.FAMILIES[name]
        assert re.search(rf"^{name}  \({fam.problem_cls.__name__}", out,
                         re.M)
        assert f"s={list(fam.tune_space['s'])}" in out
    assert out.count("tune_space:") == 5
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_solve.main(["--problem", "svm", "--dataset", "w1a-like",
                           "--s", "8", "--iterations", "32", "--tune",
                           "--device", "cpu"])
    out = buf.getvalue()
    tuned = re.search(r"^tuned\[svm\]: s=(\d+) mu=(\d+) symmetric_gram="
                      r"(True|False) \(model (\S+)s vs incumbent (\S+)s\)",
                      out, re.M)
    assert tuned, out
    s, mu = tuned.group(1), tuned.group(2)
    assert f"s={s} mu={mu}" in out.splitlines()[-1]
    first, last = map(float, re.search(r"dual (\S+) -> (\S+),",
                                       out).groups())
    assert last < first
    assert [p.name for p in tmp_path.iterdir()][0].startswith("torch-")


def test_measured_machine_and_calibration_on_cpu():
    """Real measurements on the CPU: the microbench priors are finite and
    positive, and one measured calibrate on a tiny problem fits a
    nonnegative machine that predicts a positive time at every point."""
    mach = ttune.measure_machine(repeats=1, device="cpu")
    vec = tcm.machine_vector(mach)
    assert all(math.isfinite(v) and v > 0 for v in vec), mach
    assert mach.name.endswith("-cpu")
    _, tp = _problems("lasso", "dense")
    rep = ttune.calibrate(tp, tapi.SolverConfig(device="cpu"),
                          pilot_iters=8, repeats=1)
    vec = tcm.machine_vector(rep.machine)
    assert all(math.isfinite(v) and v >= 0 for v in vec) and sum(vec) > 0
    assert all(p["measured_s"] > 0 and p["predicted_s"] > 0
               for p in rep.points)
    assert math.isfinite(rep.max_ratio)


def test_measure_solve_moves_the_operands_once():
    """The pilot solves get A and b on cfg.device in cfg.dtype, the same
    tensors every call (moved once, before the timed calls), with the
    objective trace off."""
    _, tp = _problems("lasso", "dense")
    seen = []

    class Fam:
        @staticmethod
        def solve(problem, cfg):
            seen.append((problem.A, problem.b, cfg.track_objective))
            return tapi.SolverResult(x=torch.zeros(1), objective=None)

    cfg = tapi.SolverConfig(device="cpu", dtype=torch.float64)
    assert ttune.measure_solve(tp, Fam, cfg, repeats=2) >= 0
    assert len(seen) == 3
    A, b, track = seen[0]
    assert isinstance(A, torch.Tensor) and A.dtype == torch.float64
    assert b.dtype == torch.float64 and track is False
    assert all(a is A and bb is b for a, bb, _ in seen)


_RANKS = r"""
import sys
import torch.distributed as dist
from repro_torch.core import distributed, linalg
from repro_torch.tune import microbench


def _rank(rank, world):
    calls = []
    orig = dist.all_reduce

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    dist.all_reduce = counting
    with linalg.count_reductions() as c:
        alpha, beta = microbench.measure_alpha_beta(big=1 << 12, repeats=2,
                                                    device="cpu")
    return {"alpha": alpha, "beta": beta, "calls": len(calls),
            "counted": c.n}


if __name__ == "__main__":
    print(distributed.run_ranks(_rank, 2, "gloo", device="cpu"))
"""


def test_alpha_beta_reduce_across_ranks(tmp_path):
    """With a process group of two, alpha and beta time the all-reduce
    (linalg.preduce: one call per timed reduction, warm-up included) and
    leave the open count_reductions blocks alone."""
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = eval(out.stdout.strip().splitlines()[-1])
    assert got["calls"] == 2 * (1 + 2) and got["counted"] == 0
    assert got["alpha"] > 0 and got["beta"] > 0
