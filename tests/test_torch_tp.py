"""Tensor, expert and sequence parallelism and FSDP in the trainer
(``repro_torch.parallel.tensor`` and ``parallel.fsdp`` with ``models``,
``runtime.driver``, ``optim.adamw`` and ``convert``), held against
``repro``'s ``Trainer`` on (data 2, model 2) and (data 4, model 1) meshes
of four host devices. With a data axis of D > 1 every port run here is
FSDP-sharded, as ``repro``'s are.

* ``repro``'s ``Trainer`` at ``model_axis=2`` runs in ONE subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) at f32, 3
  steps, on the smoke configs: tinyllama with ``shard_acts``, granite (4
  experts: EP), granite with 3 experts (expert-TP), hymba with
  ``shard_acts`` (its 5 heads and its SSM split by flat columns) and
  xlstm (its mLSTM and sLSTM split by heads), while one
  four-rank gloo job runs the port's ``Trainer`` on the same weights (the
  port's draws of seed 0, placed in each ``repro`` trainer and cut to each
  port rank's shards), with and
  without ``shard_acts``; qwen (its QKV biases drawn, split by heads) and
  pixtral (no patches, as ``repro``'s ``Trainer`` sees it) too. Each loss is within rel 1e-4 of ``repro``'s,
  the bar of ``test_trainer_matches_repro_f32``. The same subprocess runs
  tinyllama at ``model_axis=1`` (data 4) and granite at (data 2, model 2)
  in 2 microbatches of the global batch 4: an MoE routes ``repro``'s
  microbatch j as one group (``runtime.driver.microbatch_rows``).
* (data 4, model 1): tinyllama and granite against one process (losses
  and step 1's gathered gradients within rel 1e-5), tinyllama against
  ``repro`` (rel 1e-4).
* The port at m = 2 against m = 1 (one process): the losses and the
  gathered gradients of step 1 within rel 1e-5; whisper-smoke and
  pixtral-smoke (through ``make_train_step``, with their frames or patch
  rows) run here only, since ``repro``'s ``Trainer`` drops the extras.
* A failure at m = 2: host 1 killed at step 2; the survivors [0, 2, 3]
  keep [0, 2] (data 1 x model 2, rank 2 moved to model index 1) and match
  the undisturbed losses (rel 1e-5).
* One data-group reduction a step for microbatches 1 and 4, a
  reduce-scatter, counted by ``linalg.count_reductions``; the
  ``Recorder``'s tally by process group of steps 2 and 3 (step 1's
  update gathers the gradients the tests compare) is pinned exactly: the
  FSDP gathers (a layer each and the leaves outside the layers, per
  microbatch; the whole leaves' gradients once a step), the clip's norm,
  and for granite its MoE routing's two collectives for each MoE layer
  and microbatch.
* Checkpoints across grids: the port's step-2 checkpoint written at m = 2
  restores at m = 1 in the port and in ``repro`` (the subprocess waits
  for it once its own runs are done), one written at m = 1 restores at
  m = 2 in both, one written at (data 4, model 1) restores in one
  process and in ``repro``, and the next loss is within rel 1e-4 of the
  undisturbed run; the on-disk tree equals ``repro``'s.
* The whole leaves of the split mixers (``tp_partial``) get the
  one-process gradient at m = 2 without SP, and the recurrent archs'
  checkpoints written at m = 2 resume in one process.
* The layout equal to ``repro``'s rules for every leaf of all ten archs
  at 1x2, 1x4, 1x8, 1x16 (the production mesh's model axis), 2x1, 4x1
  and 2x2, the cutting and gathering,
  ``convert`` with an axis, the dry run's argument bytes at those meshes
  against a rank's, and ``build_grid``'s order.

The module imports no JAX. Every run here, the subprocess's included,
starts from the port's weights of seed 0 (``lm.init_params``, in
``repro``'s tree through ``convert.lm_params_to_numpy``).
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.analysis.record import Recorder
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import distributed, linalg
from repro_torch.data import TokenPipeline
from repro_torch.models import lm
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import fsdp, sharding
from repro_torch.parallel import tensor as par
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
from repro_torch.runtime.driver import make_train_step, microbatch_rows

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
XLA_FAST_COMPILE = "--xla_backend_optimization_level=0"
GB, SEQ, STEPS, EVERY = 4, 32, 3, 2
# key -> (arch, replaced fields, repro's shard_acts)
CASES = {"tinyllama": ("tinyllama-1.1b", {}, True),
         "granite": ("granite-moe-1b-a400m", {}, False),
         "granite_etp": ("granite-moe-1b-a400m", {"n_experts": 3}, False),
         "hymba": ("hymba-1.5b", {}, True),
         "xlstm": ("xlstm-350m", {}, False),
         "qwen": ("qwen1.5-4b", {}, True),
         "pixtral": ("pixtral-12b", {}, False)}
# through make_train_step with their extras in the batch (``repro``'s
# Trainer passes only tokens and targets): whisper's frames, pixtral's
# patch rows (prefix rows, on the first model rank under shard_acts)
PORT_ONLY = {"whisper": ("whisper-large-v3", {}, True),
             "pixtral_patches": ("pixtral-12b", {}, True)}
# the cases whose recurrent mixers the model axis splits
RECURRENT = ("hymba", "xlstm")
KILL = (2, [1])


def _arch(key):
    name, kw, _ = {**CASES, **PORT_ONLY}[key]
    return dataclasses.replace(get_smoke_config(name), dtype="float32", **kw)


def _cfg(tmp, name, m=1, sp=False, k=1, steps=STEPS):
    return TrainerConfig(steps=steps, ckpt_dir=os.path.join(tmp, name),
                         ckpt_every=EVERY, microbatches=k, model_axis=m,
                         shard_acts=sp)


class _Recording:
    """An AdamW that keeps the gradients of its first update, the shards
    gathered over the data group, then the model group, to whole leaves
    (float32 numpy)."""

    def __init__(self):
        self.opt = AdamW(learning_rate=cosine_schedule(1e-3, 1, STEPS))
        self.grads = None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, axis=None, split=frozenset(),
               data=None, data_split=frozenset()):
        if self.grads is None:
            m = axis.size if axis else 1
            lay = par.layout(self.arch, m) if axis else {}
            dlay = fsdp.grid_data_layout(self.arch, data.size, m) \
                if data else {}
            whole = dict(grads)
            whole.update(fsdp.gather_packed(whole, dlay, data))
            whole.update(fsdp.gather_packed(whole, lay, axis))
            self.grads = {n: g.detach().numpy().copy()
                          for n, g in sorted(whole.items())}
        kw = {"axis": axis, "split": split} if axis else {}
        if data:
            kw.update(data=data, data_split=data_split)
        return self.opt.update(grads, state, params, **kw)


def _held(tr):
    """The bytes a rank holds of the model and the AdamW state."""
    st = tr.opt_state
    return sum(t.numel() * t.element_size()
               for t in [*tr.model.parameters(), *st.mu.values(),
                         *st.nu.values(), st.step])


def _train(arch, tree, tmp, name, group, m=1, sp=False, k=1, gb=GB,
           **kw):
    rec = _Recording()
    rec.arch = arch
    tr = Trainer(arch, rec, TokenPipeline(arch.vocab_size, gb, SEQ),
                 _cfg(tmp, name, m, sp, k), group=group, device="cpu",
                 model=convert.lm_params_from_numpy(arch, tree, "cpu"), **kw)
    held = _held(tr) if tr.grid is not None else 0
    r, inner = Recorder(), tr.step_fn

    def step(*args):        # steps 2 on: step 1's update gathers rec.grads
        if rec.grads is None:
            return inner(*args)
        with r:
            return inner(*args)
    tr.step_fn = step
    with linalg.count_reductions() as c:
        out = tr.run()
    out.update(grads=rec.grads, reductions=c.n, live=list(tr.live),
               held=held)
    if tr.grid is not None and not out["lost"]:
        groups = r.collectives_by_group()
        data = tr.grid.data.group
        out["data_group"] = groups.get(data.group_name, {}) \
            if data is not None else {}
        model = tr.grid.model.group
        out["model_group"] = groups.get(model.group_name, {}) \
            if model is not None else {}
    return out


def _extras(arch, seed=0):
    """{"frames": (GB, encoder_seq, D)} or {"patches": (GB, n_patches,
    D)}, f32 numpy."""
    rng = np.random.default_rng(seed)
    name, rows = ("frames", arch.encoder_seq) if arch.is_encdec \
        else ("patches", arch.n_patches)
    return {name: rng.standard_normal((GB, rows, arch.d_model)).astype(
        np.float32)}


def _step_frames(arch, group, m, sp=False):
    """whisper (frames) or pixtral (patches) through ``make_train_step``
    (the trainer's batch has no extras): losses of STEPS steps and step
    1's gathered gradients."""
    rec = _Recording()
    rec.arch = arch
    if group is None:
        grid = par.build_grid(None, 1)
    else:
        grid = par.build_grid(group, m)
    model = lm.init_params(arch, 0, "cpu", grid.model)
    fsdp.shard_params(model, fsdp.grid_data_layout(arch, grid.data.size, m),
                      grid.data)
    model.requires_grad_(True)
    state = rec.init(dict(model.named_parameters()))
    step = make_train_step(arch, rec, _cfg("", "-", m, sp), grid=grid)
    pipe = TokenPipeline(arch.vocab_size, GB, SEQ)
    extras = _extras(arch)
    per = GB // grid.data.size
    rows = slice(grid.data.index * per, (grid.data.index + 1) * per)
    losses = []
    for s in range(STEPS):
        tokens, targets = pipe.shard_at(s, grid.data.index, grid.data.size)
        losses.append(float(step(model, state, dict(
            tokens=tokens, targets=targets,
            **{k: v[rows] for k, v in extras.items()}))))
    for g in grid.made:
        torch.distributed.destroy_process_group(g)
    return {"losses": losses, "grads": rec.grads}


def _only_step(src, dst, step):
    shutil.copytree(os.path.join(src, f"step_{step:08d}"),
                    os.path.join(dst, f"step_{step:08d}"))
    return dst


def _hand_to_repro(tmp, run, grid):
    """A copy of ``run``'s step-2 checkpoint for ``repro``'s restore of
    the checkpoint written on ``grid`` ("m2": model 2, "m1": one process,
    "d4": data 4), then its READY marker."""
    dst = _only_step(os.path.join(tmp, run),
                     os.path.join(tmp, f"{grid}_at_2_repro"), EVERY)
    open(os.path.join(dst, "READY"), "w").close()


def _resume(arch, ckpt, group, m, sp):
    """A trainer on ``ckpt`` (a step-2 checkpoint), restored and run to
    STEPS: the losses after the restore."""
    tr = Trainer(arch, AdamW(learning_rate=cosine_schedule(1e-3, 1, STEPS)),
                 TokenPipeline(arch.vocab_size, GB, SEQ),
                 TrainerConfig(steps=STEPS, ckpt_dir=ckpt, ckpt_every=100,
                               model_axis=m, shard_acts=sp),
                 group=group, device="cpu", model=lm.init_params(
                     arch, 7, "cpu"))
    tr._restore()
    assert tr.step == EVERY
    return tr.run()["losses"]


def _rank(rank, world, tmp, trees):
    import torch.distributed as dist
    torch.set_num_threads(1)        # four ranks share the host's cores
    W = dist.group.WORLD
    out = {}
    for key in CASES:
        arch = _arch(key)
        for sp in (True, False):
            name = f"{key}_m2_{sp}"
            out[name] = _train(arch, trees[key], tmp, name, W, 2, sp)
            if name == "tinyllama_m2_True" and rank == 0:
                _hand_to_repro(tmp, name, "m2")
    for key in ("tinyllama", "granite"):
        out[f"{key}_d4"] = _train(_arch(key), trees[key], tmp, f"{key}_d4",
                                  W)
        if key == "tinyllama" and rank == 0:
            _hand_to_repro(tmp, "tinyllama_d4", "d4")
    out["granite_k2"] = _train(_arch("granite"), trees["granite"], tmp,
                               "granite_k2", W, 2, k=2)
    for key in PORT_ONLY:
        for sp in (True, False):
            out[f"{key}_m2_{sp}"] = _step_frames(_arch(key), W, 2, sp)
    arch = _arch("tinyllama")
    out["failure"] = _train(arch, trees["tinyllama"], tmp, "failure", W, 2,
                            True, failure_injector=FailureInjector(
                                failures={KILL[0]: list(KILL[1])}))
    for key, sp in (("tinyllama", True), ("granite", False)):
        for k in (1, 4):
            out[f"{key}_k{k}"] = _train(_arch(key), trees[key], tmp,
                                        f"{key}_k{k}", W, 2, sp, k=k, gb=8)
    ckpt = _only_step(os.path.join(tmp, "tinyllama_m1"),
                      os.path.join(tmp, "m1_at_2"), EVERY) \
        if rank == 0 else os.path.join(tmp, "m1_at_2")
    dist.barrier()
    out["resume_m1_at_m2"] = _resume(arch, ckpt, W, 2, True)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


_REF_CODE = r"""
import dataclasses, json, os, sys, time
import numpy as np
import jax
from repro.configs import get_smoke_config
from repro.data.tokens import TokenPipeline
from repro.models import lm as jlm
from repro.optim.adamw import AdamW, cosine_schedule
from repro.runtime.driver import Trainer, TrainerConfig

tmp, cases, (GB, SEQ, STEPS, EVERY) = (sys.argv[1], json.loads(sys.argv[2]),
                                      json.loads(sys.argv[3]))
assert len(jax.devices()) == 4


# the port's draws of seed 0, in repro's tree, which every run starts from
trees = {}
with np.load(f"{tmp}/trees.npz") as f:
    for name in f.files:
        key, path = name.split("|")
        node = trees.setdefault(key, {})
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = f[name]


def trainer(key, m, sp, ckpt, every=EVERY, k=1):
    # repro's Trainer, whose draw of its parameters returns the case's
    # tree (the trainer places it on its mesh)
    name, kw, _ = cases[key]
    arch = dataclasses.replace(get_smoke_config(name), dtype="float32", **kw)
    jlm.init_params = lambda *_: trees[key]
    return Trainer(arch, AdamW(learning_rate=cosine_schedule(1e-3, 1, STEPS)),
                   TokenPipeline(arch.vocab_size, GB, SEQ),
                   TrainerConfig(steps=STEPS, ckpt_dir=ckpt, ckpt_every=every,
                                 model_axis=m, shard_acts=sp, microbatches=k))


out = {}
runs = [(key, key, 2, sp, 1) for key, (_, _, sp) in cases.items()]
runs += [("tinyllama_d4", "tinyllama", 1, True, 1),
         ("granite_k2", "granite", 2, False, 2)]
for run, key, m, sp, k in runs:
    tr = trainer(key, m, sp, f"{tmp}/repro_{run}", k=k)
    out[run] = np.asarray(tr.run()["losses"])
    out[run + "/mesh"] = np.asarray(list(tr.mesh.shape.values()))
# the port's checkpoints, as the port's runs hand them over
for name, m, ckpt in (("m2_at_m1", 1, f"{tmp}/m2_at_2_repro"),
                      ("m1_at_m2", 2, f"{tmp}/m1_at_2_repro"),
                      ("d4_at_m1", 1, f"{tmp}/d4_at_2_repro")):
    t0 = time.time()
    while not os.path.exists(f"{ckpt}/READY"):
        assert time.time() - t0 < 600, ckpt
        time.sleep(0.2)
    tr = trainer("tinyllama", m, True, ckpt, every=100)
    tr._restore()
    assert tr.step == EVERY
    out[name] = np.asarray(tr.run()["losses"])
np.savez(f"{tmp}/ref.npz", **out)
"""


def _repro(tmp):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE
               + " --xla_force_host_platform_device_count=4")
    with open(os.path.join(tmp, "ref.err"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", _REF_CODE, tmp, json.dumps(CASES),
             json.dumps([GB, SEQ, STEPS, EVERY])],
            env=env, stdout=subprocess.DEVNULL, stderr=err)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _biased(tree, rng):
    """``tree`` with its QKV biases (zeros at init, in both packages)
    drawn from ``rng``, so that their split over the model axis shows in
    the losses."""
    if not isinstance(tree, dict):
        return tree
    return {k: (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            if k in ("bq", "bk", "bv") else _biased(v, rng)
            for k, v in tree.items()}


def _trees(tmp):
    """{case: the port's parameters of seed 0 in ``repro``'s tree (numpy),
    qwen's QKV biases drawn (``_biased``)}, written to ``trees.npz`` for
    the subprocess, whose trainers start from them too."""
    trees = {key: _biased(convert.lm_params_to_numpy(lm.init_params(
        _arch(key), 0, "cpu")), np.random.default_rng(1)) for key in CASES}
    np.savez(os.path.join(tmp, "trees.npz"),
             **{f"{key}|{p}": v for key, tree in trees.items()
                for p, v in _flat(tree)})
    return trees


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """{"repro": repro's losses, "one": the port's one-process runs,
    "ranks": {rank: its results}, "resume_m2_at_m1": the port's m = 1
    resume of the m = 2 checkpoint}."""
    tmp = str(tmp_path_factory.mktemp("torch_tp"))
    trees = _trees(tmp)
    ref = _repro(tmp)
    try:
        one = {key: _train(_arch(key), trees[key], tmp, f"{key}_m1", None)
               for key in CASES}
        _hand_to_repro(tmp, "tinyllama_m1", "m1")
        one.update((key, _step_frames(_arch(key), None, 1))
                   for key in PORT_ONLY)
        distributed.run_ranks(_rank, 4, "gloo", device="cpu",
                              args=(tmp, trees))
        ranks = {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False) for r in range(4)}
        ckpt = _only_step(os.path.join(tmp, "tinyllama_m2_True"),
                          os.path.join(tmp, "m2_at_2"), EVERY)
        resume = _resume(_arch("tinyllama"), ckpt, None, 1, False)
        ckpt = _only_step(os.path.join(tmp, "tinyllama_d4"),
                          os.path.join(tmp, "d4_at_2"), EVERY)
        resume_d4 = _resume(_arch("tinyllama"), ckpt, None, 1, False)
        recurrent = {}
        for key in RECURRENT:
            ckpt = _only_step(os.path.join(tmp, f"{key}_m2_False"),
                              os.path.join(tmp, f"{key}_m2_at_2"), EVERY)
            recurrent[key] = _resume(_arch(key), ckpt, None, 1, False)
        ref.wait(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, open(os.path.join(tmp, "ref.err")).read()[
        -3000:]
    want = dict(np.load(os.path.join(tmp, "ref.npz")))
    return {"repro": want, "one": one, "ranks": ranks, "tmp": tmp,
            "resume_m2_at_m1": resume, "resume_d4_at_m1": resume_d4,
            "recurrent_m2_at_m1": recurrent}


def _rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


def _grads_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for n in want:
        err = float(np.max(np.abs(got[n] - want[n])))
        scale = float(np.max(np.abs(want[n])))
        assert err <= tol * scale, f"{what} {n}: {err:.3e} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# Against repro, and m = 2 against m = 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("key", list(CASES))
def test_model_axis_two_matches_repro(job, key, sp):
    want = job["repro"][key]
    assert list(job["repro"][key + "/mesh"]) == [2, 2]
    for r in range(4):
        got = job["ranks"][r][f"{key}_m2_{sp}"]
        assert got["events"] == [] and not got["lost"]
        assert got["final_step"] == STEPS
        _rel(got["losses"], want, 1e-4, f"{key} rank {r}")


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("key", list(CASES) + list(PORT_ONLY))
def test_model_axis_two_matches_one(job, key, sp):
    one = job["one"][key]
    got = job["ranks"][0][f"{key}_m2_{sp}"]
    _rel(got["losses"], one["losses"], 1e-5, key)
    _grads_close(got["grads"], one["grads"], 1e-5, key)
    for r in range(1, 4):
        _rel(job["ranks"][r][f"{key}_m2_{sp}"]["losses"], got["losses"],
             1e-6, f"{key} rank {r}")


@pytest.mark.parametrize("key", RECURRENT)
def test_split_mixers_whole_leaves_are_summed_over_the_model_group(job, key):
    """The leaves ``repro`` replicates inside a split mixer (hymba's
    ``w_decay`` / ``b_decay``, the mLSTM's ``b_f``, the sLSTM's ``r_*``)
    get the one-process gradient at m = 2 without SP: each rank's part
    from its heads or columns, summed over the model group."""
    partial = par.tp_partial(_arch(key), 2)
    leaves = {n.split(".", 2)[-1] for n in partial}
    assert leaves == {"hymba": {"ssm.w_decay", "ssm.b_decay"},
                      "xlstm": {"mlstm.b_f", "slstm.r_z", "slstm.r_i",
                                "slstm.r_f", "slstm.r_o"}}[key]
    want = {n: g for n, g in job["one"][key]["grads"].items()
            if n in partial}
    assert len(want) == len(partial)
    for r in range(4):
        got = job["ranks"][r][f"{key}_m2_False"]["grads"]
        _grads_close({n: got[n] for n in want}, want, 1e-5, f"rank {r}")


def test_failure_regrids_and_matches_the_undisturbed_run(job):
    undisturbed = job["ranks"][0]["tinyllama_m2_True"]["losses"]
    for r in range(4):
        out = job["ranks"][r]["failure"]
        if r == 1:
            assert out["lost"] and out["live"] == [0, 2, 3]
            continue
        if r == 3:      # beyond the usable prefix [0, 2]
            assert out["lost"] and out["live"] == [0, 2]
            continue
        assert not out["lost"] and out["live"] == [0, 2]
        assert out["events"] == [
            f"step {KILL[0]}: hosts {KILL[1]} failed",
            "re-meshed to 3 devices ({'data': 1, 'model': 2}), resumed at "
            f"step {EVERY}"]
        _rel(out["losses"], undisturbed, 1e-5, f"failure rank {r}")


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("key", ["tinyllama", "granite"])
def test_one_data_group_reduction_per_step(job, key, k):
    arch = _arch(key)
    moe = sum(arch.block_at(i) == "moe" for i in range(arch.n_layers))
    assert (key == "granite") == (moe > 0)
    seen = STEPS - 1        # the steps the Recorder saw (2 and 3)
    # FSDP's gathers per microbatch: one a layer, one for the leaves
    # outside the layers (every one of them holds a data-split leaf)
    dims = fsdp.grid_data_layout(arch, 2, 2)
    groups = {fsdp._group_of(n) for n, d in dims.items() if d is not None}
    assert len(groups) == arch.n_layers + 1
    for r in range(4):
        out = job["ranks"][r][f"{key}_k{k}"]
        assert out["reductions"] == STEPS
        # a step: the one gradient reduce-scatter; the clip's norm (an
        # all-reduce of the shards' squares); the whole leaves' gradients
        # gathered once; the weights gathered per layer and microbatch;
        # each MoE layer's routing, for each microbatch, sums the mean
        # probabilities and gathers the pick counts (``layers.moe_route``)
        assert out["data_group"] == {
            "reduce-scatter": seen,
            "all-reduce": seen * (1 + moe * k),
            "all-gather": seen * (1 + k * len(groups) + moe * k)}
        if key == "tinyllama":
            model = out["model_group"]
            # per step: the SP sum and the clip's norm; per microbatch the
            # vocab-parallel loss (its max and its sums)
            assert model["all-reduce"] == seen * (2 + 2 * k)
            assert model["all-gather"] > 0 and model["reduce-scatter"] > 0
    if key == "tinyllama":
        _rel(job["ranks"][0]["tinyllama_k4"]["losses"],
             job["ranks"][0]["tinyllama_k1"]["losses"], 1e-5, "microbatches")


# ---------------------------------------------------------------------------
# FSDP over the data axis, and the MoE's microbatches over it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["tinyllama", "granite"])
def test_data_axis_four_matches_one(job, key):
    one = job["one"][key]
    got = job["ranks"][0][f"{key}_d4"]
    assert got["events"] == [] and got["final_step"] == STEPS
    _rel(got["losses"], one["losses"], 1e-5, key)
    _grads_close(got["grads"], one["grads"], 1e-5, key)
    for r in range(1, 4):
        assert job["ranks"][r][f"{key}_d4"]["losses"] == got["losses"]


def test_data_axis_four_matches_repro(job):
    assert list(job["repro"]["tinyllama_d4/mesh"]) == [4, 1]
    for r in range(4):
        _rel(job["ranks"][r]["tinyllama_d4"]["losses"],
             job["repro"]["tinyllama_d4"], 1e-4, f"rank {r}")


def test_moe_microbatches_over_the_data_axis_match_repro(job):
    """granite at (data 2, model 2) in 2 microbatches of the global batch
    4: rank d's microbatch j holds global row 2 j + d, so each MoE layer
    routes repro's microbatch j (rows 2 j, 2 j + 1) as one group."""
    assert list(job["repro"]["granite_k2/mesh"]) == [2, 2]
    for r in range(4):
        got = job["ranks"][r]["granite_k2"]
        assert got["reductions"] == STEPS
        _rel(got["losses"], job["repro"]["granite_k2"], 1e-4, f"rank {r}")


def test_microbatch_rows_are_repros_blocks():
    B, k, D = 8, 2, 2
    rows = [microbatch_rows(B, k, D, d) for d in range(D)]
    for j in range(k):
        got = sorted(np.concatenate([r[j * 2:(j + 1) * 2] for r in rows]))
        assert got == list(range(j * 4, (j + 1) * 4))
    assert list(microbatch_rows(B, 1, 4, 3)) == [6, 7]
    assert list(microbatch_rows(B, 4, 1, 0)) == list(range(8))


# ---------------------------------------------------------------------------
# Checkpoints across grids
# ---------------------------------------------------------------------------

def test_checkpoint_written_at_m2_resumes_at_m1(job):
    undisturbed = job["ranks"][0]["tinyllama_m2_True"]["losses"]
    _rel(job["resume_m2_at_m1"], undisturbed[EVERY:], 1e-4, "port")
    _rel(job["repro"]["m2_at_m1"], undisturbed[EVERY:], 1e-4, "repro")


def test_checkpoint_written_at_m1_resumes_at_m2(job):
    undisturbed = job["one"]["tinyllama"]["losses"]
    for r in range(4):
        _rel(job["ranks"][r]["resume_m1_at_m2"], undisturbed[EVERY:], 1e-4,
             f"port rank {r}")
    _rel(job["repro"]["m1_at_m2"], undisturbed[EVERY:], 1e-4, "repro")


def _tree(tmp, run):
    man = json.loads(open(os.path.join(
        tmp, run, f"step_{STEPS:08d}", "manifest.json")).read())
    return {l["path"]: (l["shape"], l["dtype"]) for l in man["leaves"]}


def test_checkpoint_tree_is_repros_at_m2(job):
    assert _tree(job["tmp"], "tinyllama_m2_True") \
        == _tree(job["tmp"], "repro_tinyllama")


@pytest.mark.parametrize("key", RECURRENT)
def test_recurrent_checkpoint_written_at_m2_resumes_at_m1(job, key):
    """The split mixers' leaves gather to ``repro``'s tree: the port's
    step-2 checkpoint of the m = 2 run restores in one process and takes
    the undisturbed step 3, and its tree is ``repro``'s."""
    undisturbed = job["ranks"][0][f"{key}_m2_False"]["losses"]
    _rel(job["recurrent_m2_at_m1"][key], undisturbed[EVERY:], 1e-4, key)
    assert _tree(job["tmp"], f"{key}_m2_False") \
        == _tree(job["tmp"], f"repro_{key}")


def test_checkpoint_written_at_d4_resumes_in_one_process_and_repro(job):
    undisturbed = job["ranks"][0]["tinyllama_d4"]["losses"]
    _rel(job["resume_d4_at_m1"], undisturbed[EVERY:], 1e-4, "port")
    _rel(job["repro"]["d4_at_m1"], undisturbed[EVERY:], 1e-4, "repro")
    assert _tree(job["tmp"], "tinyllama_d4") \
        == _tree(job["tmp"], "repro_tinyllama_d4")


# ---------------------------------------------------------------------------
# The layout, cutting and gathering (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("name", list_archs())
def test_layout_is_repros_rules(name, m):
    """Every leaf's split dim on a model axis of m is the one of
    ``repro``'s sanitized spec: xlstm at m = 8 cuts its heads of 256 in
    half and keeps ``w_i`` / ``w_f`` (D, 4) whole (the flat column
    form), hymba's 25 / 5 heads are cut by flat columns at every m."""
    from repro_torch.launch.mesh import make_mesh
    arch = get_config(name)
    mesh = make_mesh((1, m), ("data", "model"))
    rules = sharding.param_partition_specs(lm.param_specs(arch), mesh)
    mine = par.partition_specs(arch, mesh)
    lay = par.layout(arch, m)
    assert sorted(rules) == sorted(mine)
    for leaf, spec in rules.items():
        theirs = tuple(p if p == "model" else None for p in spec)
        assert theirs == tuple(mine[leaf]), (leaf, spec, mine[leaf])
        assert lay[leaf] == (theirs.index("model") if "model" in theirs
                             else None)
    if name == "xlstm-350m" and m == 8:
        assert lay["layers.0.mlstm.w_i"] is None
        assert lay["layers.0.mlstm.wq"] == 1


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-350m"])
def test_dryrun_parameter_bytes_at_1x2_are_repros_shards(name):
    """The dry run's parameter bytes a rank at 1x2: ``repro``'s sanitized
    shards, 1,539,289,600 B for hymba-1.5b and 279,431,360 B for
    xlstm-350m."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    arch = get_config(name)
    mesh = make_mesh((1, 2), ("data", "model"))
    fn, args, specs = dryrun.build_step(arch, SHAPES["train_4k"], mesh,
                                        dryrun.DryrunOptions())
    got = dryrun.argument_bytes(args[:1], specs[:1], mesh)
    full = lm.param_specs(arch)
    rules = sharding.param_partition_specs(full, mesh)
    theirs = sum(math.prod(sharding.shard_shape(tuple(p.shape), rules[n],
                                                mesh)) * p.element_size()
                 for n, p in full.named_parameters())
    assert got == theirs == {"hymba-1.5b": 1_539_289_600,
                             "xlstm-350m": 279_431_360}[name]


FSDP_MESHES = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2)}


def _rank_shapes(arch, D, M, d, i):
    """The shapes rank (d, i) of a (D, M) grid holds, as the trainer cuts
    them: the model rank's leaves (``lm.LM`` on the model axis), then the
    data cut (``fsdp.shard_params``), on the meta device."""
    model = lm.param_specs(arch, par.Axis(None, M, i))
    fsdp.shard_params(model, fsdp.grid_data_layout(arch, D, M),
                      par.Axis(None, D, d))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("mesh", list(FSDP_MESHES))
@pytest.mark.parametrize("name", list_archs())
def test_fsdp_layout_is_repros_rules(name, mesh):
    """Each leaf a rank holds has ``repro``'s sanitized spec's shard
    shape, on the model axis and the data axis."""
    from repro_torch.launch.mesh import make_mesh
    arch = get_config(name)
    D, M = FSDP_MESHES[mesh]
    grid = make_mesh((D, M), ("data", "model"))
    full = lm.param_specs(arch)
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    rules = sharding.param_partition_specs(full, grid)
    mine = par.partition_specs(arch, grid)
    held = _rank_shapes(arch, D, M, D - 1, M - 1)
    assert held == _rank_shapes(arch, D, M, 0, 0)
    split = 0
    for leaf, spec in rules.items():
        want = sharding.shard_shape(shapes[leaf], spec, grid)
        assert held[leaf] == want, (leaf, spec, held[leaf])
        assert sharding.shard_shape(shapes[leaf], mine[leaf], grid) == want
        split += "data" in tuple(spec)
    assert split > len(rules) // 2


def test_cut_and_gather_and_convert_with_an_axis():
    arch = _arch("granite")
    full = lm.init_params(arch, 3, "cpu")
    lay = par.layout(arch, 2)
    tree = convert.lm_params_to_numpy(full)
    for i in range(2):
        ax = par.Axis(None, 2, i)
        mine = par.shard_model(full, ax)
        from_np = convert.lm_params_from_numpy(arch, tree, "cpu", ax)
        drawn = lm.init_params(arch, 3, "cpu", ax)
        for n, p in mine.named_parameters():
            assert torch.equal(p, dict(from_np.named_parameters())[n]), n
            assert torch.equal(p, dict(drawn.named_parameters())[n]), n
            assert p.shape == par.cut(dict(full.named_parameters())[n],
                                      lay[n], ax).shape
    assert lay["layers.0.moe.w_gate"] == 0 and lay["embed"] == 0
    assert lay["layers.0.moe.router"] is None
    etp = par.layout(_arch("granite_etp"), 2)
    assert etp["layers.0.moe.w_gate"] == 2 and etp["layers.0.moe.w_down"] == 1
    assert par.full_shape((4, 8), 1, 2) == (4, 16)


def test_shard_acts_needs_a_sequence_the_axis_divides():
    arch = _arch("tinyllama")
    model = lm.init_params(arch, 0, "cpu", par.Axis(None, 2, 0))
    with pytest.raises(ValueError, match="do not divide by 2"):
        lm.train_loss(model, {"tokens": np.zeros((1, 7), np.int32),
                              "targets": np.zeros((1, 7), np.int32)},
                      shard_acts=True)
    # a split model decodes (tests/test_torch_serve_tp.py) against a
    # rank's shares of the cache, which know the whole sequence
    mine = lm.init_cache(arch, 1, 8, "cpu", par.Axis(None, 2, 0))
    assert mine.seq_len == 8 and mine["k"][0].shape[2] == 4
    with pytest.raises(ValueError, match="decodes against a rank's cache"):
        model.decode_step(torch.zeros((1, 1), dtype=torch.long),
                          dict(mine), 0)


def test_dryrun_argument_bytes_at_1x2_are_a_ranks():
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    arch = dataclasses.replace(get_config("hymba-1.5b"), n_layers=1)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=64)
    mesh = make_mesh((1, 2), ("data", "model"))
    fn, args, specs = dryrun.build_step(arch, shape, mesh,
                                        dryrun.DryrunOptions())
    got = dryrun.argument_bytes(args, specs, mesh)
    model = lm.param_specs(arch, par.Axis(None, 2, 0))
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert got == params + 2 * 4 * n + 4 + 2 * 2 * 64 * 4


def _dryrun_bytes(arch, D, M):
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=GB,
                                seq_len=SEQ)
    mesh = make_mesh((D, M), ("data", "model"))
    fn, args, specs = dryrun.build_step(arch, shape, mesh,
                                        dryrun.DryrunOptions())
    return dryrun.argument_bytes(args, specs, mesh)


@pytest.mark.parametrize("mesh", list(FSDP_MESHES))
def test_dryrun_argument_bytes_are_a_ranks(job, mesh):
    """The dry run's argument bytes at 2x1, 4x1 and 2x2: what a rank of
    the four-rank job holds (the model's and AdamW's shards, at 4x1 and
    2x2), or the trainer's cut on the meta device (2x1), plus the rank's
    rows of the batch (int32 tokens and targets)."""
    D, M = FSDP_MESHES[mesh]
    batch = 2 * (GB // D) * SEQ * 4
    runs = {"4x1": ["tinyllama_d4", "granite_d4"],
            "2x2": ["tinyllama_m2_True", "hymba_m2_True", "granite_m2_False"],
            "2x1": []}[mesh]
    for run in runs:
        key = run.split("_")[0]
        held = {job["ranks"][r][run]["held"] for r in range(4)}
        assert len(held) == 1, (run, held)
        assert _dryrun_bytes(_arch(key), D, M) == held.pop() + batch, run
    if not runs:
        for key in ("tinyllama", "hymba"):
            arch = _arch(key)
            shapes = _rank_shapes(arch, D, M, 0, 0)
            n = sum(math.prod(s) for s in shapes.values())
            assert _dryrun_bytes(arch, D, M) == (4 + 2 * 4) * n + 4 + batch
