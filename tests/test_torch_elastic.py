"""The port's elastic runtime (``repro_torch.runtime.solve_elastic``,
``repro_torch.checkpoint``) on the CPU, at f32 and f64.

* Checkpoint round trips of solver state for every family x variant
  (``sfista`` included, which tests/test_elastic.py's CASES omit), dense
  and sparse: half a solve, save through ``repro_torch.checkpoint`` with
  the family's specs, restore, resume — bit for bit the full solve, x
  and trace.
* ``ElasticConfig`` validation; on a one-rank gloo group, the elastic
  solve with no failure equals the local solve bit for bit, and losing
  the one host raises "all hosts lost".
* The chaos tier (marked ``chaos``, as ``repro``'s is): every schedule of
  tests/test_chaos.py — its FAMILY_CASES, the back-to-back kills, the
  kill before the first checkpoint, the straggler eviction, and the
  seeded schedules of its randomized sweep — at P = 4 over gloo, in ONE
  four-process job (``core.distributed.run_ranks``) whose ranks each
  write their own results to a file, since a rank that dies (host 0
  among them) returns no solution. Each recovered solve is held to
  ``repro``'s ``solve_elastic`` on the same schedule (x and the trace
  within 1e-8 at f64, the chaos bar; events, recoveries, rebalances and
  live hosts equal) and to the port's undisturbed P = 4 solve (1e-8);
  the survivors hold the same bits, and the undisturbed elastic solve at
  P = 4 is the sharded solve bit for bit. The same job first makes
  ``core.distributed.survivor_group`` twice in a row over the same
  ranks, and again beside a group it still holds. ``repro`` runs in ONE JAX
  subprocess on four forced CPU devices at x64 while the job runs.
* The launcher: the elastic flags parse as ``repro``'s do; a one-rank
  ``--checkpoint-every 1 --device cpu`` run prints its backend line and
  the plain run's summary; ``torchrun`` with four ranks and
  ``--inject-failure 10:2`` (``repro``'s verify recipe) prints the
  failure and the restore and the undisturbed objective.

This module imports no JAX: the job's ranks import it.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.analysis.common import one_rank_group
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import distributed
from repro_torch.core.types import FAMILIES
from repro_torch.launch import solve as launch_solve
from repro_torch.runtime import (ElasticConfig, FailureInjector,
                                 StragglerMonitor, solve_elastic)
from repro_torch.runtime.elastic import _state_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
             "--xla_backend_optimization_level=0")
CHAOS_TOL = 1e-8

# tests/test_elastic.py's data: 24 x 40, f32-exact values.
_RNG = np.random.default_rng(11)
_M, _N = 24, 40
_A = _RNG.standard_normal((_M, _N)).astype(np.float32)
_B = _RNG.standard_normal(_M).astype(np.float32)
_SIGNS = np.sign(_RNG.standard_normal(_M)).astype(np.float32)
_LAM = 0.1 * float(np.abs(_A.T @ _B).max())


def _problem(family: str, A, b, signs, lam, sparse: bool = False):
    if sparse:
        A = api.SparseOperand.from_dense(torch.as_tensor(A))
    if family == "lasso":
        return api.LassoProblem(A=A, b=b, lam=lam)
    if family == "sfista":
        return api.SFISTAProblem(A=A, b=b, lam=lam)
    if family == "svm":
        return api.SVMProblem(A=A, b=signs, lam=0.5)
    if family == "ksvm":
        return api.SVMProblem(A=A, b=signs, lam=0.5, kernel="rbf",
                              kernel_params={"gamma": 0.3})
    if family == "logreg":
        return api.LogRegProblem(A=A, b=signs, lam=0.1)
    raise AssertionError(family)


def _small(family, sparse=False):
    return _problem(family, _A, _B, _SIGNS, _LAM, sparse)


# (family, s, accelerated): every registered family x variant. H = 12 and
# the cut at 6 are multiples of every s, so the cut is an outer-iteration
# boundary.
CASES = [
    ("lasso", 1, False), ("lasso", 1, True),
    ("lasso", 3, False), ("lasso", 3, True),
    ("svm", 1, False), ("svm", 2, False),
    ("ksvm", 1, False), ("ksvm", 2, False),
    ("logreg", 1, False), ("logreg", 2, False),
    ("sfista", 1, False), ("sfista", 2, False),
]
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _cfg(s, accelerated, iterations, dtype=torch.float32, **kw):
    return api.SolverConfig(block_size=4, s=s, iterations=iterations,
                            accelerated=accelerated, dtype=dtype,
                            device="cpu", **kw)


def _roundtrip_state(tmp_path, fam, cfg, state):
    """State -> checkpoint on disk -> state, through the real
    save/restore path with the family's specs."""
    axis = fam.default_axes if isinstance(fam.default_axes, str) else "data"
    save_checkpoint(str(tmp_path), state.iteration, dict(state.carry),
                    specs=_state_specs(fam.state_layout(cfg), axis),
                    extra={"iteration": state.iteration})
    tree, extra = restore_checkpoint(str(tmp_path), device="cpu")
    return api.SolveState(int(extra["iteration"]), dict(tree))


def _resume_matches_full(tmp_path, family, s, accelerated, dtype, sparse):
    fam = FAMILIES[family]
    prob = _small(family, sparse)
    full = api.solve(prob, _cfg(s, accelerated, 12, dtype), family=family)
    cfg6 = _cfg(s, accelerated, 6, dtype)
    half = api.solve(prob, cfg6, family=family)
    state = _roundtrip_state(tmp_path, fam, cfg6, half.aux["state"])
    assert state.iteration == 6
    assert all(v.dtype == half.aux["state"].carry[k].dtype
               for k, v in state.carry.items())
    resumed = api.solve(prob, cfg6, family=family, state=state)
    assert torch.equal(resumed.x, full.x)
    assert resumed.aux["state"].iteration == 12
    assert torch.equal(torch.cat([half.objective, resumed.objective]),
                       full.objective)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("family,s,accelerated", CASES)
def test_checkpoint_roundtrip_bit_identical(tmp_path, family, s,
                                            accelerated, dtype):
    _resume_matches_full(tmp_path, family, s, accelerated, DTYPES[dtype],
                         sparse=False)


@pytest.mark.parametrize("family,s", [("lasso", 3), ("logreg", 2),
                                      ("svm", 2), ("sfista", 2)])
def test_checkpoint_roundtrip_sparse_operand(tmp_path, family, s):
    """The checkpointed state holds only vectors, but the resumed solve
    must still run the sparse path and stay bit-identical."""
    _resume_matches_full(tmp_path, family, s, False, torch.float64,
                         sparse=True)


def test_state_and_x0_mutually_exclusive():
    prob = _small("lasso")
    cfg = _cfg(1, False, 4)
    state = api.solve(prob, cfg).aux["state"]
    with pytest.raises(ValueError, match="x0"):
        api.solve(prob, cfg, x0=np.zeros(_N), state=state)


def test_state_layout_covers_carry_for_every_family():
    for family, s, accelerated in CASES:
        fam = FAMILIES[family]
        cfg = _cfg(s, accelerated, max(s, 2) * 2)
        res = api.solve(_small(family), cfg, family=family)
        assert set(res.aux["state"].carry) == \
            {name for name, _ in fam.state_layout(cfg)}, (family, s)
        assert all(lay in ("replicated", "partition")
                   for _, lay in fam.state_layout(cfg))


def test_resolve_family_state_layout_registered_everywhere():
    for name, fam in FAMILIES.items():
        assert fam.state_layout is not None, name


def test_elastic_config_validation():
    with pytest.raises(ValueError, match="checkpoint_every"):
        ElasticConfig(checkpoint_every=0)
    with pytest.raises(ValueError, match="keep"):
        ElasticConfig(keep=0)
    ElasticConfig(checkpoint_every=1, keep=1)


# (family, s, accelerated, dtype, sparse, checkpoint_every, async_save)
ONE_RANK = [
    ("lasso", 3, False, "f32", False, 2, True),
    ("lasso", 4, True, "f64", False, 1, False),
    ("svm", 2, False, "f64", True, 3, True),
    ("ksvm", 2, False, "f32", False, 2, True),
    ("logreg", 2, False, "f64", False, 1, True),
    ("sfista", 2, False, "f32", False, 2, True),
]


@pytest.mark.parametrize("case", ONE_RANK, ids=lambda c: "-".join(map(str, c)))
def test_solve_elastic_one_rank_matches_local(tmp_path, case):
    """The elastic driver on a one-rank group with no failure equals the
    local solve bit for bit (segmentation at outer boundaries is exact),
    the trace tracked, and leaves ``keep`` checkpoints with the state's
    leaves."""
    family, s, acc, dtype, sparse, every, async_save = case
    prob = _small(family, sparse)
    cfg = _cfg(s, acc, 13, DTYPES[dtype])
    ref = api.solve(prob, cfg, family=family)
    with one_rank_group("cpu"):
        res = solve_elastic(prob, cfg, family=family, elastic=ElasticConfig(
            checkpoint_dir=str(tmp_path), checkpoint_every=every,
            keep=2, async_save=async_save))
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.objective, ref.objective)
    report = res.aux["elastic"]
    assert report["recoveries"] == [] and report["events"] == []
    assert report["live_hosts"] == [0] and not report["lost"]
    steps = sorted(p.name for p in tmp_path.iterdir())
    outer = -(-13 // s)
    bounds = [min(k * every * s, 13) for k in range(1, -(-outer // every) + 1)]
    assert steps == [f"step_{b:08d}" for b in bounds[-2:]]
    manifest = json.loads((tmp_path / steps[-1] / "manifest.json").read_text())
    fam = FAMILIES[family]
    layout = dict(fam.state_layout(cfg))
    assert {leaf["path"]: leaf["spec"] for leaf in manifest["leaves"]} == {
        k: ([fam.default_axes] if lay == "partition" else [])
        for k, lay in layout.items()}


def test_solve_elastic_all_hosts_lost_raises(tmp_path):
    with one_rank_group("cpu"):
        with pytest.raises(RuntimeError, match="all hosts lost"):
            solve_elastic(_small("lasso"), _cfg(1, False, 4),
                          elastic=ElasticConfig(checkpoint_dir=str(tmp_path)),
                          injector=FailureInjector(failures={2: [0]}))


def test_solve_elastic_needs_a_group(tmp_path):
    with pytest.raises(ValueError, match="process group"):
        solve_elastic(_small("lasso"), _cfg(1, False, 4),
                      elastic=ElasticConfig(checkpoint_dir=str(tmp_path)))


# ---------------------------------------------------------------------------
# The chaos tier: tests/test_chaos.py's schedules at P = 4 over gloo.
# ---------------------------------------------------------------------------

def _seeded_schedules(n_schedules: int):
    """tests/test_chaos.py's ``_schedules``: the seeded draws its
    randomized sweep uses where hypothesis is absent."""
    rng = np.random.default_rng(2026)
    scheds = []
    for _ in range(n_schedules):
        n_fail = int(rng.integers(1, 3))
        steps = sorted(rng.choice(np.arange(1, 14), size=n_fail,
                                  replace=False).tolist())
        hosts = rng.choice(4, size=n_fail, replace=False).tolist()
        scheds.append({int(t): [int(h)] for t, h in zip(steps, hosts)})
    return scheds


def _scenarios():
    """name -> (family, s, accelerated, H, failures, checkpoint_every,
    straggler); repro's SolverConfig default (accelerated) where
    test_chaos.py leaves it."""
    out = {
        f"{fam}-s{s}{'-acc' if acc else ''}": (fam, s, acc, H, fails, 1,
                                               False)
        for fam, s, acc, H, fails in [
            ("lasso", 1, False, 11, {5: [2]}),
            ("lasso", 4, False, 14, {6: [1]}),
            ("lasso", 4, True, 14, {6: [3]}),
            ("svm", 3, False, 13, {7: [0]}),
            ("ksvm", 3, False, 13, {8: [2]}),
            ("logreg", 3, False, 13, {5: [1]}),
        ]}
    out["back-to-back"] = ("lasso", 3, True, 14, {4: [3], 5: [1]}, 1, False)
    out["first-segment"] = ("svm", 3, True, 9, {2: [0]}, 2, False)
    out["straggler-evict"] = ("lasso", 2, True, 12, {}, 1, True)
    for fam, sched in zip(["lasso", "svm", "logreg"], _seeded_schedules(3)):
        out[f"seeded-{fam}"] = (fam, 3, True, 14, sched, 1, False)
    return out


SCENARIOS = _scenarios()


def _chaos_data():
    """tests/test_chaos.py's problem: numpy seed 5, 30 x 44, f64."""
    rng = np.random.default_rng(5)
    m, n = 30, 44
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    signs = np.sign(rng.standard_normal(m))
    return A, b, signs, 0.1 * float(np.abs(A.T @ b).max())


def _strip(report):
    """A report without its timings, as plain Python."""
    return {"events": list(report["events"]),
            "recoveries": [{k: v for k, v in r.items()
                            if not k.endswith("_seconds")}
                           for r in report["recoveries"]],
            "rebalances": [dict(r) for r in report["rebalances"]],
            "live_hosts": list(report["live_hosts"]),
            "lost": report.get("lost", False)}


def _chaos_kwargs(failures, straggler):
    kw = {"injector": FailureInjector(
        failures={int(k): list(v) for k, v in failures.items()})}
    if straggler:
        kw["monitor"] = StragglerMonitor(n_hosts=4, threshold=1.5,
                                         patience=1, evict_after=2)
        kw["host_times"] = lambda seg, live: {h: (6.0 if h == 2 else 1.0)
                                              for h in live}
    return kw


# Survivor groups made one after the other: twice over [0, 1, 3], the
# first destroyed before the second is made (torch gives both the same
# name), then twice over [1, 3] with the first still held, as the
# elastic driver holds its group while it builds the next.
SURVIVOR_GROUPS = [[0, 1, 3], [0, 1, 3], [1, 3], [1, 3]]


def _survivor_groups(rank):
    """(group rank, group size, all-reduced sum of global rank + 1) for
    each of SURVIVOR_GROUPS this rank is in; the others stay out."""
    import torch.distributed as dist
    got, held = [], None
    for hosts in SURVIVOR_GROUPS:
        if rank not in hosts:
            continue
        new = distributed.survivor_group(hosts)
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t, group=new)
        got.append((dist.get_rank(new), dist.get_world_size(new),
                    float(t)))
        if hosts == [1, 3] and held is None:
            held = new          # kept while the next group is built
        else:
            dist.destroy_process_group(new)
    if held is not None:
        dist.destroy_process_group(held)
    return got


def _chaos_rank(rank, world, tmp):
    """Every scenario on this rank: the undisturbed sharded solve, the
    undisturbed elastic solve and the disturbed one; the results go to
    this rank's own file. First, the survivor groups of
    SURVIVOR_GROUPS."""
    data = _chaos_data()
    out = {"survivor_groups": _survivor_groups(rank)}
    for name, (family, s, acc, H, failures, every, straggler) \
            in SCENARIOS.items():
        prob = _problem(family, *data)
        cfg = _cfg(s, acc, H, torch.float64)
        ref = api.solve(prob, cfg, backend="sharded", family=family)
        und = solve_elastic(prob, cfg, family=family, elastic=ElasticConfig(
            checkpoint_dir=os.path.join(tmp, name, "undisturbed"),
            checkpoint_every=every))
        res = solve_elastic(prob, cfg, family=family, elastic=ElasticConfig(
            checkpoint_dir=os.path.join(tmp, name, "chaos"),
            checkpoint_every=every), **_chaos_kwargs(failures, straggler))
        out[name] = {
            "ref": (ref.x.numpy(), ref.objective.numpy()),
            "undisturbed": (und.x.numpy(), und.objective.numpy()),
            "x": None if res.x is None else res.x.numpy(),
            "objective": None if res.x is None else res.objective.numpy(),
            "report": _strip(res.aux["elastic"])}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


_REF_CODE = r"""
import json, sys, tempfile
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.core.types import (LassoProblem, LogRegProblem, SVMProblem,
                              SolverConfig)
from repro.runtime import (ElasticConfig, FailureInjector, StragglerMonitor,
                           solve_elastic)

scenarios = json.loads(sys.argv[1])
rng = np.random.default_rng(5)
m, n = 30, 44
A = jnp.asarray(rng.standard_normal((m, n)), jnp.float64)
b = jnp.asarray(rng.standard_normal(m), jnp.float64)
signs = jnp.asarray(np.sign(rng.standard_normal(m)), jnp.float64)
lam = 0.1 * float(jnp.max(jnp.abs(A.T @ b)))
PROBLEMS = {
    "lasso": LassoProblem(A=A, b=b, lam=lam),
    "svm": SVMProblem(A=A, b=signs, lam=0.5),
    "ksvm": SVMProblem(A=A, b=signs, lam=0.5, kernel="rbf",
                       kernel_params={"gamma": 0.3}),
    "logreg": LogRegProblem(A=A, b=signs, lam=0.1),
}
arrays, reports = {}, {}
for name, (family, s, acc, H, failures, every, straggler) in \
        scenarios.items():
    cfg = SolverConfig(block_size=4, s=s, iterations=H, accelerated=acc,
                       dtype=jnp.float64)
    kw = {}
    if straggler:
        kw["monitor"] = StragglerMonitor(n_hosts=4, threshold=1.5,
                                         patience=1, evict_after=2)
        kw["host_times"] = lambda seg, live: {
            h: (6.0 if h == 2 else 1.0) for h in live}
    with tempfile.TemporaryDirectory() as d:
        res = solve_elastic(
            PROBLEMS[family], cfg, family=family,
            elastic=ElasticConfig(checkpoint_dir=d, checkpoint_every=every),
            injector=FailureInjector(failures={
                int(k): list(v) for k, v in failures.items()}), **kw)
    arrays[name + "/x"] = np.asarray(res.x)
    arrays[name + "/objective"] = np.asarray(res.objective)
    rep = res.aux["elastic"]
    reports[name] = {
        "events": rep["events"],
        "recoveries": [{k: v for k, v in r.items()
                        if not k.endswith("_seconds")}
                       for r in rep["recoveries"]],
        "rebalances": rep["rebalances"], "live_hosts": rep["live_hosts"]}
np.savez(sys.argv[2], **arrays)
with open(sys.argv[3], "w") as f:
    json.dump(reports, f)
"""


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """(repro's arrays, repro's reports, {rank: the rank's results}).
    The reference subprocess runs while the job does."""
    tmp = tmp_path_factory.mktemp("torch_chaos")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    with open(tmp / "ref.err", "w") as err:
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_CODE, json.dumps(SCENARIOS),
             str(tmp / "ref.npz"), str(tmp / "ref.json")],
            env=env, stdout=subprocess.DEVNULL, stderr=err)
        try:
            distributed.run_ranks(_chaos_rank, 4, "gloo", device="cpu",
                                  args=(str(tmp),))
            ref.wait(timeout=600)
        finally:
            ref.kill()
    assert ref.returncode == 0, (tmp / "ref.err").read_text()[-3000:]
    ranks = {r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)}
    return (dict(np.load(tmp / "ref.npz")),
            json.loads((tmp / "ref.json").read_text()), ranks)


def _close(got, want, what, tol=CHAOS_TOL):
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


def _survivors(report):
    return report["live_hosts"]


CHAOS = sorted(SCENARIOS)


@pytest.mark.chaos
@pytest.mark.parametrize("name", CHAOS)
def test_chaos_matches_repro(name, chaos):
    arrays, reports, ranks = chaos
    live = reports[name]["live_hosts"]
    assert len(live) < 4
    for h in live:
        got = ranks[h][name]
        _close(got["x"], arrays[name + "/x"], f"{name} x, host {h}")
        _close(got["objective"], arrays[name + "/objective"],
               f"{name} trace, host {h}")


@pytest.mark.chaos
@pytest.mark.parametrize("name", CHAOS)
def test_chaos_report_matches_repro(name, chaos):
    """Events, recoveries, rebalances and live hosts equal repro's on
    every survivor; a rank that left holds the log up to its leaving and
    is marked lost."""
    _, reports, ranks = chaos
    want = reports[name]
    assert want["recoveries"], "no recovery happened"
    for h in range(4):
        got = ranks[h][name]["report"]
        if h in want["live_hosts"]:
            assert not got["lost"]
            assert got["events"] == want["events"]
            assert got["recoveries"] == want["recoveries"]
            assert got["live_hosts"] == want["live_hosts"]
            assert len(got["rebalances"]) == len(want["rebalances"])
            for g, w in zip(got["rebalances"], want["rebalances"]):
                assert g["iteration"] == w["iteration"]
                assert g["hosts"] == w["hosts"]
                np.testing.assert_allclose(g["microbatch_weights"],
                                           w["microbatch_weights"],
                                           rtol=1e-12)
        else:
            assert got["lost"] and ranks[h][name]["x"] is None
            assert got["events"] == want["events"][:len(got["events"])]
            assert h not in got["live_hosts"]


@pytest.mark.chaos
@pytest.mark.parametrize("name", CHAOS)
def test_chaos_matches_undisturbed(name, chaos):
    _, reports, ranks = chaos
    for h in reports[name]["live_hosts"]:
        got = ranks[h][name]
        _close(got["x"], got["ref"][0], f"{name} x, host {h}")


@pytest.mark.chaos
@pytest.mark.parametrize("name", CHAOS)
def test_chaos_survivors_hold_the_same_bits(name, chaos):
    _, reports, ranks = chaos
    live = reports[name]["live_hosts"]
    first = ranks[live[0]][name]
    assert first["objective"].shape == (SCENARIOS[name][3],)
    for h in live[1:]:
        np.testing.assert_array_equal(ranks[h][name]["x"], first["x"])
        np.testing.assert_array_equal(ranks[h][name]["objective"],
                                      first["objective"])


@pytest.mark.chaos
@pytest.mark.parametrize("rank", range(4))
def test_survivor_groups_in_a_row(rank, chaos):
    """``survivor_group`` made again over the same ranks once the last
    is destroyed, and inside a held group: each all-reduces over its
    members alone, renumbered in rank order (rank 2 takes no part)."""
    _, _, ranks = chaos
    want = [(sorted(h).index(rank), len(h), float(sum(r + 1 for r in h)))
            for h in SURVIVOR_GROUPS if rank in h]
    assert ranks[rank]["survivor_groups"] == want


@pytest.mark.chaos
@pytest.mark.parametrize("name", CHAOS)
def test_undisturbed_elastic_is_sharded_bit_for_bit(name, chaos):
    """Segmenting at outer boundaries is exact at P = 4 too."""
    _, _, ranks = chaos
    for h in range(4):
        got = ranks[h][name]
        np.testing.assert_array_equal(got["undisturbed"][0], got["ref"][0])
        np.testing.assert_array_equal(got["undisturbed"][1], got["ref"][1])


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

FLAGS = [
    ["--checkpoint-every", "2"],
    ["--checkpoint-dir", "DIR"],
    ["--inject-failure", "10:2", "--inject-failure", "10:3",
     "--inject-failure", "4:1", "--checkpoint-dir", "DIR"],
    ["--checkpoint-every", "3", "--checkpoint-dir", "DIR",
     "--inject-failure", "7:0"],
    [],
]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "none")
def test_launcher_flags_parse_as_repro(flags, tmp_path):
    from repro.launch import solve as repro_solve
    argv = [str(tmp_path) if f == "DIR" else f for f in flags]
    args = launch_solve.build_parser().parse_args(argv)
    theirs = repro_solve._elastic_kwargs(repro_solve.build_parser()
                                         .parse_args(argv))
    assert launch_solve._elastic_requested(args) == (theirs is not None)
    if theirs is None:
        return
    ours = launch_solve._elastic_kwargs(args)
    a, b = ours["elastic"], theirs["elastic"]
    assert (a.checkpoint_every, a.keep, a.async_save) == \
        (b.checkpoint_every, b.keep, b.async_save)
    if "DIR" in flags:
        assert a.checkpoint_dir == b.checkpoint_dir == str(tmp_path)
    else:
        assert os.path.isdir(a.checkpoint_dir)
        assert os.path.basename(a.checkpoint_dir).startswith(
            "repro_elastic_")
    assert (ours["injector"] is None) == (theirs["injector"] is None)
    if ours["injector"] is not None:
        assert ours["injector"].failures == theirs["injector"].failures


_SUMMARY = re.compile(r"obj ([^,\s]+) -> ([^,\s]+)")
RECIPE = ["--problem", "lasso", "--dataset", "w1a-like", "--s", "4",
          "--iterations", "24", "--device", "cpu"]


def _summary(line):
    """The summary line without its timing."""
    return line.rsplit(",", 1)[0]


def test_launcher_one_rank_prints_its_backend_and_summary(tmp_path, capsys):
    launch_solve.main(RECIPE)
    plain = capsys.readouterr().out.strip().splitlines()
    launch_solve.main(RECIPE + ["--checkpoint-every", "1",
                                "--checkpoint-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("elastic: backend gloo, world size 1, "
                               "device cpu")
    assert not any(ln.startswith("elastic: ") for ln in lines[1:])
    assert _summary(lines[-1]) == _summary(plain[-1])
    assert len(os.listdir(tmp_path)) == 3        # keep = 3 of 6 boundaries


def test_launcher_torchrun_recovers():
    """``repro``'s verify recipe over four gloo ranks on the CPU: a
    failure of host 2 at inner iteration 10, restored at 8 onto three
    hosts; the final objective is the undisturbed run's (rel 1e-3)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    # --standalone: the rendezvous takes a free port, not torchrun's
    # default 29500, which any other job on the machine may hold.
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "--", "repro_torch.launch.solve"]
    out = subprocess.run(cmd + RECIPE + ["--checkpoint-every", "1",
                                         "--inject-failure", "10:2"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("elastic: backend gloo, world size 4")
    assert "elastic: hosts [2] failed in segment after iteration 8 — " \
           "segment work lost" in lines
    assert "elastic: failure of hosts [2]: restored iteration 8 onto 3 " \
           "hosts" in lines
    got = _SUMMARY.search(lines[-1]).groups()
    plain = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve"]
                           + RECIPE, env=env, capture_output=True, text=True,
                           timeout=300)
    want = _SUMMARY.search(plain.stdout).groups()
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-3 * abs(float(w))
