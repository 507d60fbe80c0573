"""The port's checkpoints (``repro_torch.checkpoint``) and the elastic
runtime's bookkeeping (``repro_torch.runtime.failures`` /
``stragglers``), held against ``repro``'s objects on the same inputs in
this process (no spawn, JAX at f32).

* Every case of tests/test_checkpoint.py for the port's ``ckpt``: round
  trip, the specs in the manifest, retention, async save then restore,
  no partial directories, a missing checkpoint raising
  ``FileNotFoundError``, a partial step directory skipped, only partial
  directories meaning none, ``close`` joining the outstanding save, a
  sync manager needing no close; plus bfloat16 and float8 leaves and a
  failed async write raising on ``wait``.
* The format: a solver state written by ``repro.checkpoint`` restores in
  the port and one written by the port restores in ``repro``, with equal
  manifests (paths, shapes, dtypes, specs) and equal bits, bfloat16
  included.
* Every case of tests/test_runtime.py (the hypothesis properties too),
  with the port's ``record`` actions, ``microbatch_weights``, ``fired``
  and validation errors equal to ``repro``'s on each input.
"""
import json
import os
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import checkpoint as rckpt
from repro.core.types import LassoProblem as RLassoProblem
from repro.core.types import SolverConfig as RSolverConfig
from repro.core.types import SVMProblem as RSVMProblem
from repro.core.types import FAMILIES as RFAMILIES
from repro.runtime.failures import FailureInjector as RInjector
from repro.runtime.stragglers import StragglerMonitor as RMonitor
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.stragglers import StragglerMonitor


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32),
                       "c": torch.tensor(2.5)}}


def _leaves(tree):
    return [tree["a"], tree["nested"]["b"], tree["nested"]["c"]]


def _assert_same(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 7
    restored, extra = restore_checkpoint(str(tmp_path), tree_like=tree,
                                         device="cpu")
    assert extra["note"] == "x"
    _assert_same(restored, tree)


def test_specs_in_the_manifest(tmp_path):
    """The port has no mesh placement: specs go to the manifest as
    repro's JSON lists, and the leaves come back as they were."""
    tree = _tree()
    specs = {"a": [None, None], "nested": {"b": ("data",), "c": []}}
    save_checkpoint(str(tmp_path), 1, tree, specs=specs)
    manifest = json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
    assert {leaf["path"]: leaf["spec"] for leaf in manifest["leaves"]} == {
        "a": [None, None], "nested/b": ["data"], "nested/c": []}
    restored, _ = restore_checkpoint(str(tmp_path), tree_like=tree,
                                     device="cpu")
    _assert_same(restored, tree)


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = _tree()
    mgr.save(5, tree)
    # the save copied the leaves before its thread started
    tree["a"].add_(100.0)
    restored, _ = mgr.restore_latest(tree_like=tree, device="cpu")
    assert torch.equal(restored["a"], torch.arange(12.0).reshape(3, 4))


def test_atomicity_no_partial_dirs(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert [d for d in os.listdir(tmp_path) if d.startswith(".tmp")] == []


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), device="cpu")


def test_partial_step_dir_skipped(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree, extra={"iteration": 3})
    os.makedirs(tmp_path / "step_00000009")      # partial: no manifest
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path)) == rckpt.latest_step(str(tmp_path))
    restored, extra = restore_checkpoint(str(tmp_path), tree_like=tree,
                                         device="cpu")
    assert extra["iteration"] == 3
    _assert_same(restored, tree)


def test_only_partial_dirs_means_no_checkpoint(tmp_path):
    os.makedirs(tmp_path / "step_00000001")
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), device="cpu")


def test_close_joins_outstanding_async_save(tmp_path, monkeypatch):
    """close() (and the context-manager exit) JOINS the in-flight save:
    a deliberately slowed save is fully on disk after the with-block."""
    real_save = ckpt_mod.save_checkpoint
    started = threading.Event()

    def slow_save(*args, **kwargs):
        started.set()
        time.sleep(0.3)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow_save)
    tree = _tree()
    with CheckpointManager(str(tmp_path), async_save=True) as mgr:
        mgr.save(4, tree, extra={"iteration": 4})
        assert started.wait(timeout=5.0)
    assert mgr._thread is None
    assert latest_step(str(tmp_path)) == 4
    restored, extra = restore_checkpoint(str(tmp_path), tree_like=tree,
                                         device="cpu")
    assert extra["iteration"] == 4
    _assert_same(restored, tree)
    mgr.close()                                   # idempotent


def test_sync_manager_needs_no_close(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    assert mgr._thread is None
    assert latest_step(str(tmp_path)) == 1


def test_failed_async_write_raises_on_wait(tmp_path, monkeypatch):
    """A lost write is never passed over: the thread's error raises
    again from the manager."""
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", broken)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.close()                                   # raised once, not twice


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_low_precision_leaf_roundtrip(tmp_path, dtype):
    x = (torch.linspace(-3, 3, 24).reshape(4, 6)).to(dtype)
    tree = {"w": x, "n": torch.arange(3)}
    save_checkpoint(str(tmp_path), 2, tree)
    manifest = json.loads(
        (tmp_path / "step_00000002" / "manifest.json").read_text())
    names = {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
    assert names == {"n": "int64", "w": str(dtype).removeprefix("torch.")}
    restored, _ = restore_checkpoint(str(tmp_path), tree_like=tree,
                                     device="cpu")
    assert restored["w"].dtype == dtype
    assert torch.equal(restored["w"].view(torch.uint8),
                       x.view(torch.uint8))


# ---------------------------------------------------------------------------
# The format, across the two packages.
# ---------------------------------------------------------------------------

def _repro_state(family):
    """A real solver state of repro's at f32, with repro's specs."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((20, 12)).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    if family == "lasso":
        prob = RLassoProblem(A=jnp.asarray(A), b=jnp.asarray(b),
                             lam=0.1 * float(np.abs(A.T @ b).max()))
    else:
        prob = RSVMProblem(A=jnp.asarray(A), b=jnp.asarray(np.sign(b)),
                           lam=0.5)
    cfg = RSolverConfig(block_size=2, s=2, iterations=6, dtype=jnp.float32)
    fam = RFAMILIES[family]
    state = fam.solve(prob, cfg).aux["state"]
    axis = fam.default_axes
    specs = {name: (P(axis) if lay == "partition" else P())
             for name, lay in fam.state_layout(cfg)}
    tree = {k: np.asarray(v) for k, v in state.carry.items()}
    # an f64 and a bfloat16 leaf beside the f32 state
    tree["wide"] = rng.standard_normal(5)
    tree["low"] = rng.standard_normal(7).astype(ml_dtypes.bfloat16)
    specs["wide"], specs["low"] = P(), P(axis)
    return tree, specs, axis


def _manifest(d, step):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


@pytest.mark.parametrize("family", ["lasso", "svm"])
def test_repro_checkpoint_restores_in_the_port(tmp_path, family):
    tree, specs, _ = _repro_state(family)
    rckpt.save_checkpoint(str(tmp_path / "repro"), 6, tree, specs=specs,
                          extra={"iteration": 6})
    got, extra = restore_checkpoint(str(tmp_path / "repro"), device="cpu")
    assert extra == {"iteration": 6}
    assert sorted(got) == sorted(tree)
    for k, v in tree.items():
        want = torch.from_numpy(np.ascontiguousarray(v).view(np.int16)) \
            .view(torch.bfloat16) if k == "low" \
            else torch.from_numpy(np.array(v))
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
    # written again by the port: the same manifest
    port_specs = {k: list(s) for k, s in specs.items()}
    save_checkpoint(str(tmp_path / "port"), 6, got, specs=port_specs,
                    extra={"iteration": 6})
    assert _manifest(tmp_path / "port", 6) == _manifest(tmp_path / "repro",
                                                        6)


@pytest.mark.parametrize("family", ["lasso", "svm"])
def test_port_checkpoint_restores_in_repro(tmp_path, family):
    tree, specs, axis = _repro_state(family)
    port_tree = {k: torch.from_numpy(np.ascontiguousarray(v)
                                     .view(np.int16)).view(torch.bfloat16)
                 if k == "low" else torch.from_numpy(np.array(v))
                 for k, v in tree.items()}
    port_specs = {k: ([axis] if len(s) else []) for k, s in specs.items()}
    save_checkpoint(str(tmp_path / "port"), 6, port_tree, specs=port_specs,
                    extra={"iteration": 6})
    got, extra = rckpt.restore_checkpoint(str(tmp_path / "port"))
    assert extra == {"iteration": 6}
    for k, v in tree.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(
            np.asarray(got[k]).reshape(-1).view(np.uint8),
            np.asarray(v).reshape(-1).view(np.uint8))
    rckpt.save_checkpoint(str(tmp_path / "repro"), 6, got, specs=specs,
                          extra={"iteration": 6})
    assert _manifest(tmp_path / "port", 6) == _manifest(tmp_path / "repro",
                                                        6)


def test_tree_paths_follow_repro(tmp_path):
    """Nested dicts (sorted keys), lists and tuples flatten to repro's
    paths, in repro's order."""
    tree = {"z": [np.ones(2), (np.zeros(1), np.arange(3))],
            "a": {"y": np.float32(1.5), "b": None}}
    save_checkpoint(str(tmp_path / "port"), 1, tree)
    rckpt.save_checkpoint(str(tmp_path / "repro"), 1, tree)
    assert _manifest(tmp_path / "port", 1) == _manifest(tmp_path / "repro",
                                                        1)
    got, _ = restore_checkpoint(str(tmp_path / "repro"), tree_like=tree,
                                device="cpu")
    assert got["a"]["b"] is None
    assert torch.equal(got["z"][1][1], torch.arange(3))


# ---------------------------------------------------------------------------
# The failure injector and the straggler monitor, against repro's.
# ---------------------------------------------------------------------------

def _both_injectors(failures):
    copy = {k: list(v) for k, v in failures.items()}
    return (FailureInjector(failures=copy),
            RInjector(failures={k: list(v) for k, v in copy.items()}))


def _both_monitors(**kw):
    return StragglerMonitor(**kw), RMonitor(**kw)


def _record_both(pair, times):
    ours, theirs = pair
    got, want = ours.record(dict(times)), theirs.record(dict(times))
    assert got == want
    assert ours.microbatch_weights() == theirs.microbatch_weights()
    assert ours.live_hosts == theirs.live_hosts
    return got


def test_injector_fires_once():
    ours, theirs = _both_injectors({5: [2]})
    for t in (4, 5, 5):
        assert ours.check(t) == theirs.check(t)
    assert ours.fired == theirs.fired == [(5, 2)]


def test_straggler_detection_and_eviction():
    pair = _both_monitors(n_hosts=4, threshold=1.5, patience=2,
                          evict_after=4)
    seen = [_record_both(pair, {0: 1.0, 1: 1.0, 2: 1.0, 3: 5.0}).get(3)
            for _ in range(8)]
    assert "rebalance" in seen and "evict" in seen


def test_straggler_recovers():
    pair = _both_monitors(n_hosts=2, threshold=1.5, patience=2)
    for _ in range(3):
        _record_both(pair, {0: 1.0, 1: 4.0})
    for _ in range(6):
        actions = _record_both(pair, {0: 1.0, 1: 1.0})
    assert actions == {}


def test_rebalance_weights_inverse_to_speed():
    pair = _both_monitors(n_hosts=2)
    for _ in range(5):
        _record_both(pair, {0: 1.0, 1: 2.0})
    w = pair[0].microbatch_weights()
    assert w[0] > w[1]
    assert sum(w) == pytest.approx(2.0)


def test_drop_host():
    pair = _both_monitors(n_hosts=3)
    _record_both(pair, {0: 1.0, 1: 1.0, 2: 9.0})
    for m in pair:
        m.drop_host(2)
    assert _record_both(pair, {0: 1.0, 1: 1.0}) == {}
    assert len(pair[0].microbatch_weights()) == 2


def test_injector_fires_once_across_restore_and_replay():
    ours, theirs = _both_injectors({3: [1], 5: [0, 2]})
    for _ in range(2):
        assert [ours.check(t) for t in range(1, 7)] == \
            [theirs.check(t) for t in range(1, 7)]
    assert ours.fired == theirs.fired == [(3, 1), (5, 0), (5, 2)]


def test_injector_fired_records_step_host_in_order():
    ours, theirs = _both_injectors({7: [3], 2: [0, 1]})
    for t in range(1, 10):
        ours.check(t)
        theirs.check(t)
    assert ours.fired == theirs.fired == [(2, 0), (2, 1), (7, 3)]


def test_injector_unscheduled_steps_noop():
    ours, theirs = _both_injectors({})
    assert ours.check(1) == theirs.check(1) == []
    assert ours.fired == theirs.fired == []


@pytest.mark.parametrize("kw,match", [
    ({"n_hosts": 0}, "n_hosts"),
    ({"n_hosts": 2, "ema_decay": 1.0}, "ema_decay"),
    ({"n_hosts": 2, "ema_decay": 0.0}, "ema_decay"),
    ({"n_hosts": 2, "threshold": 0.5}, "threshold"),
    ({"n_hosts": 2, "patience": 0}, "patience"),
    ({"n_hosts": 2, "patience": 3, "evict_after": 2}, "evict_after"),
])
def test_monitor_validation(kw, match):
    with pytest.raises(ValueError, match=match) as ours:
        StragglerMonitor(**kw)
    with pytest.raises(ValueError) as theirs:
        RMonitor(**kw)
    assert str(ours.value) == str(theirs.value)


def test_strikes_reset_on_recovery_before_evict():
    pair = _both_monitors(n_hosts=3, ema_decay=0.1, threshold=1.5,
                          patience=2, evict_after=4)
    for _ in range(3):
        _record_both(pair, {0: 1.0, 1: 1.0, 2: 5.0})
    _record_both(pair, {0: 1.0, 1: 1.0, 2: 1.0})
    for _ in range(3):
        actions = _record_both(pair, {0: 1.0, 1: 1.0, 2: 5.0})
    assert actions.get(2) == "rebalance"
    assert _record_both(pair, {0: 1.0, 1: 1.0, 2: 5.0}).get(2) == "evict"


def test_dropped_host_never_in_actions():
    pair = _both_monitors(n_hosts=3, threshold=1.5, patience=1)
    for _ in range(4):
        _record_both(pair, {0: 1.0, 1: 1.0, 2: 9.0})
    for m in pair:
        m.drop_host(2)
    assert 2 not in _record_both(pair, {0: 1.0, 1: 1.0, 2: 9.0})
    assert pair[0].live_hosts == [0, 1]


def test_single_live_host_median_well_defined():
    pair = _both_monitors(n_hosts=3, threshold=1.5, patience=1)
    for m in pair:
        m.drop_host(0)
        m.drop_host(1)
    for _ in range(10):
        actions = _record_both(pair, {2: 100.0})
    assert actions == {}


def test_rebalance_precedes_evict():
    pair = _both_monitors(n_hosts=3, threshold=1.5, patience=2,
                          evict_after=5)
    seen = [_record_both(pair, {0: 1.0, 1: 1.0, 2: 9.0}).get(2)
            for _ in range(7)]
    assert next(a for a in seen if a is not None) == "rebalance"
    assert seen.index("evict") > seen.index("rebalance")


# The hypothesis sweeps run where hypothesis is installed, as in
# tests/test_runtime.py; the cases above always run.
try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

    def given(*a, **k):              # the undecorated test then skips
        return lambda fn: fn

    settings = given

    class _St:                       # strategy placeholders, never drawn
        def __getattr__(self, name):
            return lambda *a, **k: None
    st = _St()

needs_hypothesis = pytest.mark.skipif(
    not _HAVE_HYPOTHESIS, reason="hypothesis not installed")

_times = st.floats(min_value=0.01, max_value=100.0,
                   allow_nan=False, allow_infinity=False)


@needs_hypothesis
@settings(max_examples=50, deadline=None)
@given(st.lists(st.dictionaries(st.integers(0, 3), _times, min_size=1),
                min_size=1, max_size=20),
       st.integers(0, 3))
def test_prop_dropped_host_never_returned(steps, victim):
    pair = _both_monitors(n_hosts=4, threshold=1.5, patience=1,
                          evict_after=2)
    for m in pair:
        m.drop_host(victim)
    for times in steps:
        assert victim not in _record_both(pair, times)
        assert victim not in pair[0].live_hosts


@needs_hypothesis
@settings(max_examples=50, deadline=None)
@given(st.lists(_times, min_size=1, max_size=30))
def test_prop_single_live_host_never_flagged(series):
    pair = _both_monitors(n_hosts=1, threshold=1.5, patience=1)
    for t in series:
        assert _record_both(pair, {0: t}) == {}


@needs_hypothesis
@settings(max_examples=50, deadline=None)
@given(st.lists(st.booleans(), min_size=1, max_size=40),
       st.integers(2, 4), st.integers(1, 4))
def test_prop_rebalance_escalates_into_evict(slow_steps, patience, extra):
    pair = _both_monitors(n_hosts=3, threshold=1.5, patience=patience,
                          evict_after=patience + extra)
    seen = []
    for i, slow in enumerate(slow_steps):
        actions = _record_both(pair, {0: 1.0, 1: 1.0,
                                      2: 9.0 if slow else 1.0})
        act = actions.get(2)
        assert actions.get(0) is None and actions.get(1) is None
        if act is not None:
            assert i + 1 >= patience
        seen.append(act)
    for i, act in enumerate(seen):
        if act == "evict":
            assert "rebalance" in seen[:i]


@needs_hypothesis
@settings(max_examples=50, deadline=None)
@given(st.dictionaries(st.integers(1, 30),
                       st.lists(st.integers(0, 3), min_size=1,
                                max_size=2, unique=True),
                       min_size=0, max_size=5))
def test_prop_injector_total_fire_count(failures):
    ours, theirs = _both_injectors(failures)
    for _ in range(2):
        for t in range(1, 31):
            assert ours.check(t) == theirs.check(t)
    expected = [(t, h) for t in sorted(failures) for h in failures[t]]
    assert ours.fired == theirs.fired == expected


@needs_hypothesis
@settings(max_examples=50, deadline=None)
@given(st.integers(1, 5), st.floats(0.05, 0.95), st.floats(1.0, 3.0),
       st.integers(1, 4), st.integers(0, 4),
       st.lists(st.lists(_times, min_size=5, max_size=5), min_size=1,
                max_size=15),
       st.lists(st.integers(0, 4), max_size=3))
def test_prop_monitor_matches_repro(n, decay, threshold, patience, extra,
                                    series, drops):
    """Any monitor settings, times and drops: the same actions and
    weights as repro's, record after record."""
    pair = _both_monitors(n_hosts=n, ema_decay=decay, threshold=threshold,
                          patience=patience, evict_after=patience + extra)
    for i, row in enumerate(series):
        if i < len(drops) and drops[i] < n:
            for m in pair:
                m.drop_host(drops[i])
        _record_both(pair, {h: row[h] for h in range(n)})
