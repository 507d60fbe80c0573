"""The port's trainer over ``torch.distributed`` on the CPU: gloo ranks,
one job for the file.

ONE four-process gloo job (``core.distributed.run_ranks``, marked
``chaos`` as tests/test_torch_elastic.py's is) on tinyllama-smoke at f32
with repro's weights carried across, global batch 8, seq 32; each rank
writes its results to its own file, since a rank that fails returns
early:

* ranks [0, 1] as a group of two (``survivor_group``): exactly one
  counted reduction per step at microbatches 1 and 4, the losses within
  rel 1e-5 of one process training on the whole batch;
* ``compressed_all_reduce`` over the four ranks against a numpy
  evaluation of repro's ``compressed_psum`` (max of the scales, int32 sum
  of the payload): the same bits, and the same residuals;
* the undisturbed four-rank run (12 steps, a checkpoint every 4), within
  rel 1e-4 of repro's single-device ``Trainer`` on the same weights;
* a failure at step 6 that kills ranks [2, 3]: the survivors [0, 1]
  resume at step 4 and end at 12 with a "re-meshed" event, their losses
  within rel 1e-5 of the undisturbed run and 1e-4 of repro's;
* a straggler evicted after step 5 (host 3): the survivors [0, 1, 2] keep
  the largest prefix whose count divides the batch ([0, 1]; rank 2
  leaves), resume at the step-4 checkpoint and end at 12, within rel
  1e-5 of the undisturbed run.

repro runs in this process (JAX at f32) while no job runs. This module
imports no JAX at the top: the job's ranks import it.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import distributed, linalg
from repro_torch.data import TokenPipeline
from repro_torch.optim import (AdamW, ErrorFeedback, compressed_all_reduce,
                               cosine_schedule)
from repro_torch.runtime import (FailureInjector, StragglerMonitor, Trainer,
                                 TrainerConfig)

GB, SEQ, STEPS, EVERY = 8, 32, 12, 4
KILL = (6, [2, 3])


class _EvictAt(StragglerMonitor):
    """A monitor that evicts host 3 at its fifth record (after step 5);
    the same on every rank."""

    def __init__(self):
        super().__init__(n_hosts=4)
        self.calls = 0

    def record(self, host_times):
        self.calls += 1
        return {3: "evict"} if self.calls == 5 else {}


def _arch():
    return dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                               dtype="float32")


def _train(tree, tmp, name, group, steps=STEPS, k=1, **kw):
    arch = _arch()
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 2, steps))
    cfg = TrainerConfig(steps=steps, ckpt_dir=os.path.join(tmp, name),
                        ckpt_every=EVERY, microbatches=k)
    tr = Trainer(arch, opt, TokenPipeline(arch.vocab_size, GB, SEQ), cfg,
                 group=group, device="cpu",
                 model=convert.lm_params_from_numpy(arch, tree, "cpu"), **kw)
    with linalg.count_reductions() as c:
        out = tr.run()
    out["reductions"] = c.n
    out["live"] = list(tr.live)
    return out


def _compress_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return ({"a": rng.standard_normal((6, 5)).astype(np.float32),
             "b": (rank + 1.0) * rng.standard_normal(7).astype(np.float32)},
            {"a": (1e-2 * rng.standard_normal((6, 5))).astype(np.float32),
             "b": np.zeros(7, np.float32)})


def _rank(rank, world, tmp, tree):
    import torch.distributed as dist
    torch.set_num_threads(1)        # four ranks share the host's cores
    out = {}
    if rank in (0, 1):
        pair = distributed.survivor_group([0, 1])
        for k in (1, 4):
            out[f"pair_k{k}"] = _train(tree, tmp, f"pair{k}_{rank}", pair,
                                       steps=3, k=k)
            out[f"alone_k{k}"] = _train(tree, tmp, f"alone{k}_{rank}", None,
                                        steps=3, k=k)
        dist.destroy_process_group(pair)
    g, r = _compress_inputs(rank)
    with linalg.count_reductions() as c:
        mean, ef = compressed_all_reduce(
            {key: torch.tensor(v) for key, v in g.items()},
            ErrorFeedback(residual={key: torch.tensor(v)
                                    for key, v in r.items()}),
            dist.group.WORLD, n_shards=world)
    out["compress"] = ({key: v.numpy() for key, v in mean.items()},
                       {key: v.numpy() for key, v in ef.residual.items()},
                       (c.n, c.max))
    out["undisturbed"] = _train(tree, tmp, "undisturbed", dist.group.WORLD)
    out["failure"] = _train(tree, tmp, "failure", dist.group.WORLD,
                            failure_injector=FailureInjector(
                                failures={KILL[0]: list(KILL[1])}))
    out["evict"] = _train(tree, tmp, "evict", dist.group.WORLD,
                          straggler_monitor=_EvictAt())
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """({rank: its results}, repro's single-device losses)."""
    import jax
    from repro.configs import get_smoke_config as j_smoke
    from repro.data.tokens import TokenPipeline as JPipeline
    from repro.models import lm as jlm
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.adamw import cosine_schedule as j_cosine
    from repro.runtime.driver import Trainer as JTrainer
    from repro.runtime.driver import TrainerConfig as JTrainerConfig

    tmp = tmp_path_factory.mktemp("torch_train_chaos")
    ja = dataclasses.replace(j_smoke("tinyllama-1.1b"), dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.init_params(ja, jax.random.key(0)))
    jtr = JTrainer(ja, JAdamW(learning_rate=j_cosine(3e-4, 2, STEPS)),
                   JPipeline(ja.vocab_size, GB, SEQ),
                   JTrainerConfig(steps=STEPS, ckpt_dir=str(tmp / "repro"),
                                  ckpt_every=EVERY))
    want = jtr.run()["losses"]
    distributed.run_ranks(_rank, 4, "gloo", device="cpu",
                          args=(str(tmp), tree))
    return ({r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)}, want)


def _rel(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


@pytest.mark.chaos
@pytest.mark.parametrize("k", [1, 4])
def test_one_reduction_per_step_on_two_ranks(job, k):
    ranks, _ = job
    for r in (0, 1):
        pair, alone = ranks[r][f"pair_k{k}"], ranks[r][f"alone_k{k}"]
        assert pair["reductions"] == 3 and alone["reductions"] == 0
        assert pair["losses"] == ranks[0][f"pair_k{k}"]["losses"]
        _rel(pair["losses"], alone["losses"], 1e-5, f"k={k} rank {r}")


@pytest.mark.chaos
def test_compressed_all_reduce_matches_repros_formula(job):
    ranks, _ = job
    ins = [_compress_inputs(r) for r in range(4)]
    for key in ("a", "b"):
        corrected = [g[key] + r[key] for g, r in ins]
        scales = [np.maximum(np.max(np.abs(c)), np.float32(1e-12))
                  / np.float32(127.0) for c in corrected]
        gscale = np.float32(max(scales))
        q = [np.clip(np.round(c / gscale), -127, 127) for c in corrected]
        total = np.sum([x.astype(np.int32) for x in q], axis=0)
        mean = total.astype(np.float32) * gscale / np.float32(4)
        for r in range(4):
            got_mean, got_res, counts = ranks[r]["compress"]
            assert counts == (2, 2)                 # one sum, one max a leaf
            assert np.array_equal(got_mean[key], mean), (key, r)
            assert np.array_equal(got_res[key],
                                  corrected[r] - q[r] * gscale), (key, r)


@pytest.mark.chaos
def test_undisturbed_matches_repro(job):
    ranks, want = job
    for r in range(4):
        out = ranks[r]["undisturbed"]
        assert out["final_step"] == STEPS and not out["lost"]
        assert out["events"] == [] and out["reductions"] == STEPS
        assert out["losses"] == ranks[0]["undisturbed"]["losses"]
    _rel(ranks[0]["undisturbed"]["losses"], want, 1e-4, "4 ranks vs repro")


@pytest.mark.chaos
def test_failure_resumes_on_the_survivors(job):
    ranks, want = job
    step, dead = KILL
    und = ranks[0]["undisturbed"]["losses"]
    for r in dead:
        out = ranks[r]["failure"]
        assert out["lost"] and out["final_step"] == step
        assert out["events"] == [f"step {step}: hosts {dead} failed"]
        assert len(out["losses"]) == step
    for r in (0, 1):
        out = ranks[r]["failure"]
        assert not out["lost"] and out["final_step"] == STEPS
        assert out["live"] == [0, 1]
        assert out["events"] == [
            f"step {step}: hosts {dead} failed",
            "re-meshed to 2 devices ({'data': 2, 'model': 1}), resumed at "
            "step 4"]
        # steps 0-5 on four ranks, then 4-11 again on two
        assert len(out["losses"]) == step + STEPS - 4
        assert out["losses"][:step] == und[:step]
        _rel(out["losses"][step:], und[4:], 1e-5, f"rank {r} vs undisturbed")
        _rel(out["losses"][step:], want[4:], 1e-4, f"rank {r} vs repro")
        assert out["losses"] == ranks[0]["failure"]["losses"]


@pytest.mark.chaos
def test_straggler_eviction_regroups_on_a_usable_prefix(job):
    ranks, _ = job
    und = ranks[0]["undisturbed"]["losses"]
    assert ranks[3]["evict"]["lost"] and ranks[3]["evict"]["final_step"] == 5
    assert ranks[2]["evict"]["lost"]            # 3 ranks do not divide 8
    for r in (0, 1):
        out = ranks[r]["evict"]
        assert not out["lost"] and out["final_step"] == STEPS
        assert out["events"] == [
            "step 5: hosts [3] failed",
            "re-meshed to 3 devices ({'data': 2, 'model': 1}), resumed at "
            "step 4"]
        _rel(out["losses"][5:], und[4:], 1e-5, f"rank {r}")
