"""The port's LM training on the CPU, held against repro's on the same
numpy inputs and weights (JAX at f32 in-process, the test_torch_lm.py
convention).

* ``TokenPipeline``: ``batch_at``, ``shard_at``, the iterator,
  ``checkpoint`` and ``restore`` bit for bit repro's, over several seeds,
  shapes and steps.
* ``cosine_schedule`` and ``AdamW.update`` against repro's on random
  trees over 5 steps, with and without clipping: f32 within rel 1e-6 of
  each leaf's max; bf16 parameters equal or 1 ulp apart.
* ``quantize_int8`` / ``dequantize_int8`` bit for bit; at one rank
  ``compressed_all_reduce`` bit for bit repro's ``compressed_psum`` (under
  ``jax.vmap`` with an axis of one) and the error-feedback identity
  g + r == q scale + r' bit for bit.
* ``lm.train_loss`` and its gradients against ``jax.value_and_grad`` of
  repro's on tinyllama-smoke and qwen-smoke (QKV bias): f32 loss within
  rel 1e-5 and every gradient within 1e-4 of its leaf's max; bf16 within
  test_torch_lm.py's bar (atol 0.12, rtol 0.05); ``remat`` "full" and
  "dots" the same bits as "none".
* The trainer on tinyllama-smoke with repro's weights carried across,
  global batch 8, seq 32, 8 steps (6 asked, the cross-package cut at 4
  and 8 needs 8): f32 at microbatches 1 and 4, each step's loss within
  rel 1e-4 of repro's ``Trainer`` and the final parameters within 1e-3 of
  each leaf's max |value|; bf16 losses within rtol 0.05.
* Checkpoints across the packages: repro's ``Trainer`` saves at step 4,
  the port's restores it and runs to 8, equal to the port's own run
  within the f32 bar; then the other way round.
* Exactly one counted reduction per step on a one-rank gloo group (the
  two-rank group is in tests/test_torch_train_elastic.py's job), none
  with ``group=None``; the optimizer state across ``convert``; the
  launcher's flags against repro's, and the refusals.
"""
import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data.tokens import TokenPipeline as JPipeline
from repro.launch import train as j_launch
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.runtime.driver import Trainer as JTrainer
from repro.runtime.driver import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch.analysis.common import one_rank_group
from repro_torch.configs import get_smoke_config
from repro_torch.core import linalg
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.optim import (AdamW, ErrorFeedback, compressed_all_reduce,
                               cosine_schedule, dequantize_int8,
                               quantize_int8)
from repro_torch.runtime import Trainer, TrainerConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

GB, SEQ, STEPS = 8, 32, 8


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (what, err, scale)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# The token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,V,gb,S", [(0, 256, 8, 32), (3, 1000, 4, 17),
                                         (12345, 32000, 6, 64),
                                         (7, 50, 2, 7)])
def test_token_pipeline_bit_equal(seed, V, gb, S):
    j, t = JPipeline(V, gb, S, seed=seed), TokenPipeline(V, gb, S, seed=seed)
    for step in (0, 1, 5, 1000, 2 ** 31 + 3):
        for a, b in zip(t.batch_at(step), j.batch_at(step)):
            assert a.dtype == np.int32 and np.array_equal(a, b)
        for n in [d for d in range(1, gb + 1) if gb % d == 0]:
            for shard in range(n):
                for a, b in zip(t.shard_at(step, shard, n),
                                j.shard_at(step, shard, n)):
                    assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        t.shard_at(0, 0, gb + 1)
    for _ in range(3):
        for a, b in zip(next(t), next(j)):
            assert np.array_equal(a, b)
    assert t.checkpoint() == j.checkpoint()
    t2, j2 = TokenPipeline.restore(t.checkpoint()), JPipeline.restore(
        j.checkpoint())
    assert t2.state.step == 3
    for a, b in zip(next(t2), next(j2)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,warm,total", [(3e-4, 2, 6), (1e-3, 10, 50),
                                             (2e-4, 0, 7)])
def test_cosine_schedule_matches_repro(base, warm, total):
    sched, jsched = cosine_schedule(base, warm, total), \
        jadamw.cosine_schedule(base, warm, total)
    for step in range(total + 4):
        got = sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, jsched(jnp.int32(step)), 1e-6, step)


SHAPES = {"w": (16, 8), "b": (8,), "e": (5, 3)}


def _adamw_case(dtype, clip, schedule, steps=5):
    """(port params, moments), (repro params, moments) after ``steps``
    updates from the same random params and grads."""
    rng = np.random.default_rng(4)
    lr = cosine_schedule(3e-3, 2, steps) if schedule else 3e-3
    jlr = jadamw.cosine_schedule(3e-3, 2, steps) if schedule else 3e-3
    opt = AdamW(learning_rate=lr, clip_norm=clip)
    jopt = jadamw.AdamW(learning_rate=jlr, clip_norm=clip)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    params = {k: torch.tensor(v).to(tdt) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v).astype(dtype) for k, v in p0.items()}
    state, jstate = opt.init(params), jopt.init(jparams)
    for _ in range(steps):
        # grads of norm ~10 (clipped at 1.0) in the parameters' dtype
        g = {k: (2.0 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
        grads = {k: torch.tensor(v).to(tdt) for k, v in g.items()}
        jgrads = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
        out, state = opt.update(grads, state, params)
        assert out is params
        jparams, jstate = jopt.update(jgrads, jstate, jparams)
    assert int(state.step) == int(jstate.step) == steps
    return (params, state), (jparams, jstate)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_matches_repro_f32(clip, schedule):
    (params, state), (jparams, jstate) = _adamw_case("float32", clip,
                                                     schedule)
    for k in SHAPES:
        assert params[k].dtype == state.mu[k].dtype == torch.float32
        _close(params[k], jparams[k], 1e-6, k)
        _close(state.mu[k], jstate.mu[k], 1e-6, k)
        _close(state.nu[k], jstate.nu[k], 1e-6, k)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_matches_repro_bf16(clip):
    """bf16 parameters (f32 moments) are equal or one ulp apart."""
    (params, state), (jparams, jstate) = _adamw_case("bfloat16", clip, True)
    for k in SHAPES:
        assert params[k].dtype == torch.bfloat16
        assert state.mu[k].dtype == torch.float32
        got = params[k].view(torch.int16).numpy().astype(np.int32)
        want = np.asarray(jparams[k]).view(np.int16).astype(np.int32)
        assert np.abs(got - want).max() <= 1, k
        _close(state.mu[k], jstate.mu[k], 1e-5, k)


def test_adamw_takes_lists():
    opt = AdamW(learning_rate=1e-2)
    params = [torch.ones(3), torch.zeros(2)]
    state = opt.init(params)
    opt.update([torch.ones(3), -torch.ones(2)], state, params)
    assert int(state.step) == 1
    assert bool((params[0] < 1).all()) and bool((params[1] > 0).all())


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(8)
    return [rng.standard_normal((7, 9)).astype(np.float32),
            (1e-3 * rng.standard_normal(40)).astype(np.float32),
            np.zeros(5, np.float32)]


def test_quantize_int8_bit_equal():
    for x in _quant_inputs():
        q, s = quantize_int8(torch.tensor(x))
        jq, js = jcompress.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)
        assert np.array_equal(dequantize_int8(q, s).numpy(),
                              np.asarray(jcompress.dequantize_int8(jq, js)))
    q, _ = quantize_int8(torch.tensor(_quant_inputs()[0]).bfloat16())
    jq, _ = jcompress.quantize_int8(jnp.asarray(_quant_inputs()[0],
                                                jnp.bfloat16))
    assert np.array_equal(q.numpy(), np.asarray(jq))


def test_compressed_all_reduce_one_rank_matches_repro():
    """At one rank the sum is this rank's dequantized payload: bit for
    bit repro's compressed_psum over an axis of one, and the error
    feedback keeps g + r == q scale + r' exactly."""
    g = dict(zip("abc", _quant_inputs()))
    r = {k: (1e-2 * np.random.default_rng(9).standard_normal(v.shape))
         .astype(np.float32) for k, v in g.items()}
    tg = {k: torch.tensor(v) for k, v in g.items()}
    ef = ErrorFeedback(residual={k: torch.tensor(v) for k, v in r.items()})
    with linalg.count_reductions() as c:
        mean, ef2 = compressed_all_reduce(tg, ef, None, n_shards=None)
    assert c.n == c.max == 0

    def one(gg, rr):
        return jcompress.compressed_psum(
            gg, jcompress.ErrorFeedback(residual=rr), "i")

    jmean, jef = jax.vmap(one, axis_name="i")(
        {k: jnp.asarray(v)[None] for k, v in g.items()},
        {k: jnp.asarray(v)[None] for k, v in r.items()})
    for k in g:
        assert np.array_equal(mean[k].numpy(), np.asarray(jmean[k][0]))
        assert np.array_equal(ef2.residual[k].numpy(),
                              np.asarray(jef.residual[k][0]))
        assert torch.equal(mean[k] + ef2.residual[k], tg[k] + ef.residual[k])
    lst, _ = compressed_all_reduce([tg["a"]], ErrorFeedback.init([tg["a"]]),
                                   None, n_shards=2)
    q, s = quantize_int8(tg["a"])
    assert torch.equal(lst[0], dequantize_int8(q, s) / 2)


# ---------------------------------------------------------------------------
# The training loss and its gradients
# ---------------------------------------------------------------------------

def _pair(name, dtype, seed=0):
    """repro's params at ``dtype`` (QKV biases made nonzero), the port's
    model with the same weights, and both configs."""
    ja = dataclasses.replace(j_smoke(name), dtype=dtype)
    ta = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(ja, jax.random.key(seed)))
    if ja.qkv_bias:
        rng = np.random.default_rng(5)
        for b in ("bq", "bk", "bv"):
            leaf = tree["layers"]["slot0_attn_mlp"]["attn"][b]
            tree["layers"]["slot0_attn_mlp"]["attn"][b] = (
                0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return ja, ta, tree, convert.lm_params_from_numpy(ta, tree, "cpu")


def _port_grads(model, batch, remat="none"):
    model.requires_grad_(True)
    named = list(model.named_parameters())
    loss = lm.train_loss(model, batch, remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def _batch(V, B=2, S=16, seed=6):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
            "targets": rng.integers(0, V, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen1.5-4b"])
def test_train_loss_and_grads_match_repro(name, dtype):
    ja, ta, tree, model = _pair(name, dtype)
    batch = _batch(ja.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(p, ja, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, tree))
    loss, grads = _port_grads(model, batch)
    assert loss.dtype == torch.float32
    got = _leaves(convert.lm_tree(ta, {k: g.float().numpy()
                                       for k, g in grads.items()}))
    want = _leaves(jgrads)
    assert got.keys() == want.keys()
    if dtype == "float32":
        _close(loss, jloss, 1e-5)
        for k in want:
            _close(got[k], want[k], 1e-4, k)
    else:
        np.testing.assert_allclose(float(loss), float(jloss), atol=0.12,
                                   rtol=0.05)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=0.12, rtol=0.05)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen1.5-4b"])
def test_remat_matches_no_remat(name, remat):
    _, _, _, model = _pair(name, "float32")
    batch = _batch(model.arch.vocab_size)
    loss, grads = _port_grads(model, batch)
    rloss, rgrads = _port_grads(model, batch, remat)
    assert torch.equal(rloss, loss)
    for k in grads:
        assert torch.equal(rgrads[k], grads[k]), k


def test_train_loss_refuses_shard_acts_and_unknown_remat():
    """An unknown ``remat`` is refused; ``shard_acts`` (sequence
    parallelism over a model axis) is not any more, and on one rank it
    changes nothing: the loss and gradients equal those without it."""
    model = lm.init_params(get_smoke_config("llama3-8b"), 0, "cpu")
    batch = _batch(model.arch.vocab_size)
    loss, grads = _port_grads(model, batch)
    model.requires_grad_(True)
    sp = lm.train_loss(model, batch, shard_acts=True)
    assert torch.equal(sp, loss)
    for (name, _), g in zip(model.named_parameters(), torch.autograd.grad(
            sp, list(model.parameters()))):
        assert torch.equal(g, grads[name]), name
    with pytest.raises(ValueError, match="remat"):
        lm.train_loss(model, batch, remat="some")


# ---------------------------------------------------------------------------
# The trainer against repro's
# ---------------------------------------------------------------------------

def _configs(tmp, k, dtype="float32", steps=STEPS, every=4):
    ja = dataclasses.replace(j_smoke("tinyllama-1.1b"), dtype=dtype)
    ta = dataclasses.replace(get_smoke_config("tinyllama-1.1b"), dtype=dtype)
    kw = dict(steps=steps, ckpt_dir=str(tmp), ckpt_every=every,
              microbatches=k)
    return ja, ta, JTrainerConfig(**kw), TrainerConfig(**kw)


def _opts(steps=STEPS):
    return (jadamw.AdamW(learning_rate=jadamw.cosine_schedule(3e-4, 2, steps)),
            AdamW(learning_rate=cosine_schedule(3e-4, 2, steps)))


def _repro_weights(ja, ta, seed=0):
    """The port's model holding the weights repro's Trainer draws."""
    tree = jax.tree.map(np.asarray, jlm.init_params(ja, jax.random.key(seed)))
    return convert.lm_params_from_numpy(ta, tree, "cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's trainer, the port's trainer, their outputs) per (k,
    dtype), each from repro's weights and checkpointing at 4 and 8."""
    out = {}
    for k, dtype in [(1, "float32"), (4, "float32"), (1, "bfloat16")]:
        tmp = tmp_path_factory.mktemp(f"train_{k}_{dtype}")
        ja, ta, jcfg, cfg = _configs(tmp / "repro", k, dtype)
        jopt, opt = _opts()
        jtr = JTrainer(ja, jopt, JPipeline(ja.vocab_size, GB, SEQ), jcfg)
        jout = jtr.run()
        tr = Trainer(ta, opt, TokenPipeline(ta.vocab_size, GB, SEQ),
                     dataclasses.replace(cfg, ckpt_dir=str(tmp / "port")),
                     device="cpu", model=_repro_weights(ja, ta))
        with linalg.count_reductions() as c:
            tout = tr.run()
        assert c.n == 0                    # group=None: nothing to reduce
        out[k, dtype] = (jtr, tr, jout, tout, tmp)
    return out


@pytest.mark.parametrize("k", [1, 4])
def test_trainer_matches_repro_f32(runs, k):
    jtr, tr, jout, tout, _ = runs[k, "float32"]
    assert tout["final_step"] == jout["final_step"] == STEPS
    assert tout["events"] == jout["events"] == [] and not tout["lost"]
    assert len(tout["losses"]) == STEPS
    for step, (a, b) in enumerate(zip(tout["losses"], jout["losses"])):
        assert abs(a - b) <= 1e-4 * abs(b), (step, a, b)
    got = _leaves(convert.lm_params_to_numpy(tr.model))
    want = _leaves(jtr.params)
    for key in want:
        _close(got[key], want[key], 1e-3, key)
    assert int(tr.opt_state.step) == int(jtr.opt_state.step) == STEPS


def test_trainer_matches_repro_bf16(runs):
    jtr, tr, jout, tout, _ = runs[1, "bfloat16"]
    assert all(p.dtype == torch.bfloat16 for p in tr.model.parameters())
    assert all(m.dtype == torch.float32 for m in tr.opt_state.mu.values())
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=0.05)


def test_microbatches_agree(runs):
    one, four = runs[1, "float32"][3], runs[4, "float32"][3]
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=1e-5)


def _only_step(src, dst, step):
    """A copy of checkpoint directory ``src`` holding only ``step``."""
    shutil.copytree(src / f"step_{step:08d}", dst / f"step_{step:08d}")
    return dst


def test_checkpoint_from_repro_resumes_in_the_port(runs):
    """repro's Trainer saved at step 4; the port's restores it and runs to
    8, as the port's own run (which started from the same weights)."""
    jtr, tr, jout, tout, tmp = runs[1, "float32"]
    ckpt = _only_step(tmp / "repro", tmp / "repro_at_4", 4)
    ja, ta, _, cfg = _configs(ckpt, 1)
    _, opt = _opts()
    res = Trainer(ta, opt, TokenPipeline(ta.vocab_size, GB, SEQ), cfg,
                  device="cpu", model=lm.init_params(ta, 7, "cpu"))
    res._restore()
    assert res.step == 4 and int(res.opt_state.step) == 4
    out = res.run()
    assert out["final_step"] == STEPS and len(out["losses"]) == 4
    for a, b in zip(out["losses"], tout["losses"][4:]):
        assert abs(a - b) <= 1e-4 * abs(b)
    got = _leaves(convert.lm_params_to_numpy(res.model))
    mine = _leaves(convert.lm_params_to_numpy(tr.model))
    for key in mine:
        _close(got[key], mine[key], 1e-3, key)


def test_checkpoint_from_the_port_resumes_in_repro(runs):
    """The port's Trainer saved at step 4; repro's restores it and runs
    to 8, as repro's own run."""
    jtr, tr, jout, tout, tmp = runs[1, "float32"]
    ckpt = _only_step(tmp / "port", tmp / "port_at_4", 4)
    ja, _, jcfg, _ = _configs(ckpt, 1)
    jopt, _ = _opts()
    res = JTrainer(ja, jopt, JPipeline(ja.vocab_size, GB, SEQ), jcfg)
    res._restore()
    assert res.step == 4
    out = res.run()
    assert out["final_step"] == STEPS and len(out["losses"]) == 4
    for a, b in zip(out["losses"], jout["losses"][4:]):
        assert abs(a - b) <= 1e-4 * abs(b)
    got, want = _leaves(res.params), _leaves(jtr.params)
    for key in want:
        _close(got[key], want[key], 1e-3, key)


def test_checkpoint_tree_is_repros(runs):
    """The port writes repro's leaf paths, shapes and dtypes."""
    import json
    _, _, _, _, tmp = runs[1, "bfloat16"]
    leaves = {}
    for side in ("repro", "port"):
        man = json.loads((tmp / side / f"step_{STEPS:08d}" /
                          "manifest.json").read_text())
        leaves[side] = {l["path"]: (l["shape"], l["dtype"])
                        for l in man["leaves"]}
        assert man["extra"]["step"] == STEPS
        assert man["extra"]["pipeline"]["global_batch"] == GB
    assert leaves["port"] == leaves["repro"]
    assert leaves["port"]["params/embed"][1] == "bfloat16"
    assert leaves["port"]["opt/step"] == ([], "int32")


@pytest.mark.parametrize("k", [1, 4])
def test_one_reduction_per_step_on_a_group(tmp_path, k):
    ja, ta, _, cfg = _configs(tmp_path, k, steps=3)
    _, opt = _opts(3)
    with one_rank_group("cpu") as group:
        tr = Trainer(ta, opt, TokenPipeline(ta.vocab_size, GB, SEQ), cfg,
                     group=group, device="cpu", model=_repro_weights(ja, ta))
        with linalg.count_reductions() as c:
            out = tr.run()
    assert c.n == 3 and c.max == 0
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()


def test_adamw_state_round_trip():
    ja, ta, tree, model = _pair("qwen1.5-4b", "float32")
    rng = np.random.default_rng(2)
    moments = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    jstate = jadamw.AdamWState(step=np.int32(5), mu=moments,
                               nu=jax.tree.map(np.abs, moments))
    st = convert.adamw_state_from_numpy(ta, jstate, "cpu")
    assert int(st.step) == 5 and st.step.dtype == torch.int32
    assert set(st.mu) == {n for n, _ in model.named_parameters()}
    back = convert.adamw_state_to_numpy(ta, st)
    assert back.step.dtype == np.int32 and int(back.step) == 5
    for a, b in ((back.mu, jstate.mu), (back.nu, jstate.nu)):
        assert jax.tree.all(jax.tree.map(np.array_equal, a, b))


# ---------------------------------------------------------------------------
# The launcher and the refusals
# ---------------------------------------------------------------------------

def _repro_parser(monkeypatch):
    """The parser repro's launcher builds (captured at parse_args)."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        j_launch.main()
    monkeypatch.undo()
    return seen["parser"]


def test_launcher_flags_parse_as_repros(monkeypatch):
    jp, tp = _repro_parser(monkeypatch), launch_train.build_parser()
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3",
            "--global-batch", "4", "--seq-len", "16", "--lr", "1e-3",
            "--warmup", "1", "--microbatches", "2", "--model-axis", "1",
            "--remat", "dots", "--ckpt-dir", "d", "--ckpt-every", "2",
            "--seed", "3"]
    want = vars(jp.parse_args(argv))
    got = vars(tp.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    defaults = vars(jp.parse_args(["--arch", "a"]))
    mine = vars(tp.parse_args(["--arch", "a"]))
    assert mine.pop("ckpt_dir") is None           # a temporary directory
    defaults.pop("ckpt_dir")
    mine.pop("device")
    assert mine == defaults


def test_launcher_refuses_model_axis(tmp_path):
    """``--model-axis 2`` trains under two gloo ranks (torchrun: one model
    group of 2), as in one process at 1; one process with a model axis
    of 2 raises ``repro``'s "no usable device configuration", from the
    launcher and from the ``Trainer``."""
    with pytest.raises(RuntimeError, match="no usable device configuration"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                           "--model-axis", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no usable device configuration"):
        Trainer(get_smoke_config("tinyllama-1.1b"), AdamW(), TokenPipeline(
            256, 8, 8), TrainerConfig(model_axis=2, shard_acts=True),
            device="cpu")
    recipe = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3",
              "--global-batch", "4", "--seq-len", "16", "--ckpt-every", "3",
              "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    runs = {}
    for m, cmd in ((2, ["-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "--",
                        "repro_torch.launch.train", "--model-axis", "2"]),
                   (1, ["-m", "repro_torch.launch.train"])):
        out = subprocess.run([sys.executable] + cmd + recipe + [
            "--ckpt-dir", str(tmp_path / f"m{m}")],
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        runs[m] = [float(x) for x in re.search(
            r"arch=tinyllama-smoke steps=3 loss (\S+) -> (\S+)",
            out.stdout).groups()]
    # bf16 (the smoke config's dtype): repro's bf16 trainer bar
    np.testing.assert_allclose(runs[2], runs[1], rtol=0.05)


def test_launcher_runs_on_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "4",
                       "--seq-len", "16", "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"arch=tinyllama-smoke steps=4 loss (\S+) -> (\S+)", out)
    assert m and all(np.isfinite(float(x)) for x in m.groups())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(get_smoke_config("tinyllama-1.1b"), AdamW(),
                TokenPipeline(256, 8, 8), TrainerConfig())
