"""Serving a model split over the model axis (``LM.prefill``,
``LM.forward``, ``LM.decode_step``, ``LM.fill_cross_cache``,
``BatchedServer.generate`` on a model built for ``parallel.tensor.Axis``
of m > 1), held against one rank and against ``repro`` on the CPU.

One four-rank gloo job (each rank at one thread) builds two grids over
the same ranks: (data 2, model 2), whose model groups {0, 1} and {2, 3}
serve the ten archs' smoke configs at m = 2, and (data 1, model 4), which
serves tinyllama-smoke and hymba-smoke at m = 4. Every rank draws the
weights of seed 0 (``lm.init_params`` draws each leaf whole and keeps the
rank's shard) and cuts a whole decode cache made from a seed with
``models.lm.shard_cache``, so the ranks and one rank (the main
process) start equal. At f32:

* prefill's last-position logits (all V of them, where the vocabulary
  splits) and 8 ``decode_step`` logits against one rank at rel 1e-5, and
  against ``repro``'s ``prefill`` and ``decode_step`` at
  ``test_torch_lm.py``'s bar (atol 1e-4);
* the cache: SEQ 48 slots (24 a rank at m = 2, 12 at m = 4), positions
  36-43, where hymba-smoke's and mixtral-smoke's rings of 32 wrap across
  the ranks' halves; tinyllama at 41 slots, which neither m divides (the
  whole cache on each rank); tinyllama at positions 4-11, where the
  second half's rank has no live slot; whisper-smoke's cross cache of 30
  frames split 15 / 15, filled by ``fill_cross_cache``;
* ``BatchedServer.generate``'s greedy tokens equal to ``repro``'s
  ``BatchedServer``;
* granite-smoke on (data 2, model 2) at a decode batch of 64: the four
  ranks' logits against ``repro``'s routing of the global batch (a
  capacity of 40 an expert; a rank routing its 32 tokens alone has 20
  and drops picks, and misses ``repro``);
* the split-KV merge with a rank none of whose slots is live.

In one process: the cache a rank holds (``init_cache(..., axis=,
data=)``, ``shard_cache``) against the sanitized ``batch_partition_specs``
for all ten full configs, and the dry run's 1x2 decode argument bytes
against a rank's parameters, cache shares, tokens and ``pos``.

The module imports no JAX (the ranks import it); ``repro`` runs in the
main process, one f32 pass an arch.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import distributed
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor as par

ARCHS = list_archs()
B, P, STEPS = 2, 12, 8
SEQ, FIRST = 48, 36          # the decode cache and its first position
WHOLE = 41                   # a cache length neither m divides
EARLY = 4                    # positions 4-11: the second half holds none
GEN_P, GEN = 6, 8            # generate: prompt and tokens
M4 = ("tinyllama-1.1b", "hymba-1.5b")
GRID = "granite-moe-1b-a400m"
GRID_B = 64                  # its decode batch on (data 2, model 2)


def _arch(name):
    return dataclasses.replace(get_smoke_config(name), dtype="float32")


def _inputs(arch, batch=B, seq=SEQ, seed=0):
    """The prompt (batch, P), its extras (frames or patches), the decode
    tokens (batch, STEPS) and a whole decode cache of ``seq`` slots, all
    drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    V, D = arch.vocab_size, arch.d_model
    prompt = rng.integers(0, V, (batch, P)).astype(np.int32)
    extras = {}
    if arch.is_encdec:
        extras["frames"] = rng.standard_normal(
            (batch, arch.encoder_seq, D)).astype(np.float32)
    elif arch.frontend == "vision_stub":
        extras["patches"] = rng.standard_normal(
            (batch, arch.n_patches, D)).astype(np.float32)
    toks = rng.integers(0, V, (batch, STEPS)).astype(np.int32)
    cache = lm.init_cache(arch, batch, seq, "cpu")
    with torch.no_grad():
        for layers in cache.values():
            for t in layers:
                if t is not None:
                    t.copy_(torch.from_numpy(
                        0.5 * rng.standard_normal(t.shape)))
    return prompt, extras, toks, cache


def _decode(model, toks, cache, first, data=None):
    """The logits (B, STEPS, V) of STEPS decode steps from ``first``."""
    out = []
    with torch.inference_mode():
        for s in range(STEPS):
            logits, cache = model.decode_step(
                torch.as_tensor(toks[:, s:s + 1]), cache, first + s, data)
            out.append(logits[:, 0].numpy().copy())
    return np.stack(out, 1)


def _serve(arch, model, axis, data=None, seq=SEQ, first=FIRST, seed=0,
           batch=B, generate=True, alone=False):
    """{prefill, decode[, generate]} of ``model`` (one rank when ``axis``
    is None) on the inputs of ``seed``: the rank's rows of the batch over
    ``data`` and the cache cut to the rank's; ``alone``: its MoE routes
    its rows by themselves (no data axis)."""
    prompt, extras, toks, cache = _inputs(arch, batch, seq, seed)
    if axis is not None:
        cache = lm.shard_cache(cache, axis, data)
    rows = par.cut(np.arange(batch), 0, data)
    with torch.inference_mode():
        last = model.prefill(torch.as_tensor(prompt[rows]),
                             {k: v[rows] for k, v in extras.items()})
    out = {"prefill": last.numpy().copy(),
           "decode": _decode(model, toks[rows], cache, first,
                             None if alone else data)}
    if generate:
        server = BatchedServer(arch, model, SEQ)
        out["generate"] = server.generate(prompt[:, :GEN_P], GEN)
    return out


def _one(name, **kw):
    arch = _arch(name)
    return _serve(arch, lm.init_params(arch, 0, "cpu"), None, **kw)


def _merge_case(axis):
    """The merge at m = 2 where this rank's slots are [8 i, 8 i + 8) of 16
    and only slots 0-5 are live (rank 1 holds none): the merged output,
    the whole softmax's, and rank 1's plain softmax over its masked
    slots."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 1, 8, generator=gen)
    k = torch.randn(2, 2, 16, 8, generator=gen)
    v = torch.randn(2, 2, 16, 8, generator=gen)
    live = torch.arange(16) <= 5
    first, n = par.cache_slots(16, axis)
    mine = slice(first, first + n)
    got = L.split_kv_attention(q, k[:, :, mine], v[:, :, mine], live[mine],
                               8, axis)
    whole = L.split_kv_attention(q, k, v, live, 8, None)
    kf = torch.repeat_interleave(k[:, :, mine], 2, dim=1)
    scores = torch.where(live[mine], torch.einsum(
        "bhqd,bhkd->bhqk", q, kf) / 8 ** 0.5, -1e30)
    plain = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1),
                         torch.repeat_interleave(v[:, :, mine], 2, dim=1))
    mean = torch.repeat_interleave(v[:, :, mine], 2, dim=1).mean(2,
                                                                keepdim=True)
    return {"got": got, "whole": whole, "plain": plain, "mean": mean}


def _drops_alone(arch, model, axis, data):
    """The granite grid's rank decoding its 32 rows alone (no data axis):
    its logits and the picks its MoE layers dropped."""
    dropped = []
    real = L.moe_dispatch

    def counting(*args, **kw):
        buf, row, keep = real(*args, **kw)
        dropped.append(int((~keep).sum()))
        return buf, row, keep
    L.moe_dispatch = counting
    try:
        got = _serve(arch, model, axis, data, batch=GRID_B, seed=1,
                     generate=False, alone=True)
    finally:
        L.moe_dispatch = real
    return got["decode"], dropped


def _rank(rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    W = dist.group.WORLD
    out = {}
    grid = par.build_grid(W, 2)
    ax = grid.model
    for name in ARCHS:
        arch = _arch(name)
        model = lm.init_params(arch, 0, "cpu", ax)
        out[name] = _serve(arch, model, ax)
        if name == "tinyllama-1.1b":
            out["whole"] = _serve(arch, model, ax, seq=WHOLE, first=30,
                                  generate=False)
            out["early"] = _serve(arch, model, ax, first=EARLY,
                                  generate=False)
            with torch.inference_mode():
                out["forward"] = model.forward(torch.as_tensor(
                    _inputs(arch)[0])).numpy()
            out["held"] = {e: [None if t is None else tuple(t.shape)
                               for t in ts] for e, ts in
                           lm.init_cache(arch, B, SEQ, "cpu", ax).items()}
        if name == "whisper-large-v3":
            out["cross"] = _cross(arch, model, ax)
    arch = _arch(GRID)
    model = lm.init_params(arch, 0, "cpu", ax)
    out["grid"] = _serve(arch, model, ax, grid.data, batch=GRID_B,
                         seed=1, generate=False)["decode"]
    out["grid_alone"] = _drops_alone(arch, model, ax, grid.data)
    out["grid_generate"] = BatchedServer(arch, model, SEQ, grid.data) \
        .generate(_inputs(arch, GRID_B, seed=1)[0][:, :GEN_P], GEN)
    out["merge"] = _merge_case(ax)
    for g in grid.made:
        dist.destroy_process_group(g)
    grid = par.build_grid(W, 4)
    for name in M4:
        arch = _arch(name)
        out[("m4", name)] = _serve(arch, lm.init_params(arch, 0, "cpu",
                                                        grid.model),
                                   grid.model, generate=False)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _cross(arch, model, axis):
    """whisper's cross cache filled on this rank from the frames of seed
    0, and the decode logits against it."""
    prompt, extras, toks, _ = _inputs(arch)
    cache = lm.init_cache(arch, B, SEQ, "cpu", axis)
    with torch.inference_mode():
        model.fill_cross_cache(cache, extras["frames"])
    held = [t.clone() for t in cache["cross_k"]]
    return {"cross_k": held, "decode": _decode(model, toks, cache, 0)}


# ---------------------------------------------------------------------------
# repro, in the main process
# ---------------------------------------------------------------------------

def _repro(name, model):
    """``repro``'s prefill, decode (from the same cache) and generate on
    the port's weights of seed 0, f32."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.serve import BatchedServer as JServer
    from repro.models import lm as jlm
    ja = dataclasses.replace(j_smoke(name), dtype="float32")
    arch = _arch(name)
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(model))
    prompt, extras, toks, cache = _inputs(arch)
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    server = JServer(ja, params, SEQ)
    jcache = jax.tree.map(jnp.asarray, convert.cache_to_numpy(arch, cache))
    logits = []
    for s in range(STEPS):
        out, jcache = server._decode(params, {
            "tokens": jnp.asarray(toks[:, s:s + 1]), "cache": jcache,
            "pos": jnp.int32(FIRST + s)})
        logits.append(np.asarray(out)[:, 0])
    return {"prefill": np.asarray(jlm.prefill(params, ja,
                                              jnp.asarray(prompt), jx)),
            "decode": np.stack(logits, 1),
            "generate": server.generate(prompt[:, :GEN_P], GEN)}


def _repro_grid(model):
    """``repro``'s decode of granite's global batch of 64 (seed 1)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.serve import BatchedServer as JServer
    from repro.models import lm as jlm
    ja = dataclasses.replace(j_smoke(GRID), dtype="float32")
    arch = _arch(GRID)
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(model))
    prompt, _, toks, cache = _inputs(arch, GRID_B, seed=1)
    step = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    jcache = jax.tree.map(jnp.asarray, convert.cache_to_numpy(arch, cache))
    logits = []
    for s in range(STEPS):
        out, jcache = step(params, {
            "tokens": jnp.asarray(toks[:, s:s + 1]), "cache": jcache,
            "pos": jnp.int32(FIRST + s)})
        logits.append(np.asarray(out)[:, 0])
    return {"decode": np.stack(logits, 1),
            "generate": JServer(ja, params, SEQ).generate(
                prompt[:, :GEN_P], GEN)}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_serve_tp"))
    distributed.run_ranks(_rank, 4, "gloo", device="cpu", args=(tmp,))
    ranks = {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(4)}
    one, repro = {}, {}
    for name in ARCHS:
        arch = _arch(name)
        model = lm.init_params(arch, 0, "cpu")
        one[name] = _serve(arch, model, None)
        repro[name] = _repro(name, model)
        if name == "tinyllama-1.1b":
            one["whole"] = _one(name, seq=WHOLE, first=30, generate=False)
            one["early"] = _one(name, first=EARLY, generate=False)
            with torch.inference_mode():
                one["forward"] = model.forward(torch.as_tensor(
                    _inputs(arch)[0])).numpy()
        if name == "whisper-large-v3":
            one["cross"] = _cross(arch, model, None)
    model = lm.init_params(_arch(GRID), 0, "cpu")
    repro["grid"] = _repro_grid(model)
    one["grid"] = _serve(_arch(GRID), model, None, batch=GRID_B, seed=1,
                         generate=False)["decode"]
    return {"ranks": ranks, "one": one, "repro": repro}


def _rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# ---------------------------------------------------------------------------
# m = 2 against one rank and against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_split_prefill_matches_one_rank(job, name):
    """All V of prefill's last-position logits on every rank (a split
    vocabulary's column blocks gathered) within rel 1e-5 of one rank."""
    want = job["one"][name]["prefill"]
    assert want.shape == (B, 1, _arch(name).vocab_size)
    for r in range(4):
        _rel(job["ranks"][r][name]["prefill"], want, 1e-5, f"rank {r}")


@pytest.mark.parametrize("name", ARCHS)
def test_split_decode_matches_one_rank(job, name):
    want = job["one"][name]["decode"]
    for r in range(4):
        _rel(job["ranks"][r][name]["decode"], want, 1e-5, f"rank {r}")


@pytest.mark.parametrize("name", ARCHS)
def test_split_prefill_and_decode_match_repro(job, name):
    want = job["repro"][name]
    got = job["ranks"][0][name]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-4)
    np.testing.assert_allclose(got["decode"], want["decode"], atol=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_split_generate_matches_repros_server(job, name):
    want = job["repro"][name]["generate"]
    assert want.shape == (B, GEN)
    np.testing.assert_array_equal(job["one"][name]["generate"], want)
    for r in range(4):
        got = job["ranks"][r][name]["generate"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", M4)
def test_model_axis_four_matches_one_rank(job, name):
    for r in range(4):
        got = job["ranks"][r][("m4", name)]
        for part in ("prefill", "decode"):
            _rel(got[part], job["one"][name][part], 1e-5, f"{part} {r}")


def test_split_vocabulary_forward_gives_every_logit(job):
    """``LM.forward`` at m = 2 on tinyllama-smoke (vocabulary 256, split
    128 / 128) returns (B, S, 256), one rank's logits."""
    want = job["one"]["forward"]
    assert want.shape == (B, P, 256)
    for r in range(4):
        _rel(job["ranks"][r]["forward"], want, 1e-5, f"rank {r}")


# ---------------------------------------------------------------------------
# The cache a rank holds
# ---------------------------------------------------------------------------

def test_a_cache_the_axis_does_not_divide_is_whole_on_each_rank(job):
    held = job["ranks"][0]["held"]
    assert held["k"] == [(B, 2, SEQ // 2, 16)] * 2
    for r in range(4):
        _rel(job["ranks"][r]["whole"]["decode"],
             job["one"]["whole"]["decode"], 1e-5, f"rank {r}")
    assert par.cache_slots(WHOLE, par.Axis(None, 2, 1)) == (0, WHOLE)
    assert par.cache_slots(SEQ, par.Axis(None, 2, 1)) == (SEQ // 2,
                                                          SEQ // 2)


def test_a_rank_with_no_live_slot_adds_nothing(job):
    """Positions 4-11 of 48: rank 1's slots 24-47 are all masked."""
    for r in range(4):
        _rel(job["ranks"][r]["early"]["decode"],
             job["one"]["early"]["decode"], 1e-5, f"rank {r}")
    case = job["ranks"][0]["merge"]
    _rel(case["got"], case["whole"], 1e-6, "merge")
    # the trap: rank 1's plain softmax over its masked row is the mean of
    # its v, which only the rescale by the group's max takes out
    one = job["ranks"][1]["merge"]
    torch.testing.assert_close(one["plain"], one["mean"])
    _rel(one["got"], case["whole"], 1e-6, "merge rank 1")


def test_whisper_cross_cache_splits_its_frames(job):
    """whisper-smoke's 30 frames: 15 a rank, filled from the frames by
    the rank's encoder, the decode logits as one rank's."""
    want = job["one"]["cross"]
    for r in range(4):
        got = job["ranks"][r]["cross"]
        first = 15 * (r % 2)
        for g, w in zip(got["cross_k"], want["cross_k"]):
            assert g.shape == (B, 4, 15, 16)
            _rel(g, w[:, :, first:first + 15], 1e-5, f"cross rank {r}")
        _rel(got["decode"], want["decode"], 1e-5, f"decode rank {r}")


@pytest.mark.parametrize("name", ARCHS)
def test_rank_cache_is_repros_decode_rule(name):
    """``init_cache(..., axis=, data=)`` and ``shard_cache`` give the
    shapes of ``repro``'s sanitized decode specs on (data 2, model 2) at
    the full config: the KV and cross caches' S / 2 slots, the recurrent
    states whole over 'model', the batch of 8 split over 'data'."""
    from repro_torch.launch.mesh import make_mesh
    arch = get_config(name)
    S = 4096
    whole = lm.init_cache(arch, 8, S, "meta")
    specs = sharding.batch_partition_specs(
        {"cache": whole}, make_mesh((2, 2), ("data", "model")))["cache"]
    ax, data = par.Axis(None, 2, 1), par.Axis(None, 2, 1)
    mine = lm.init_cache(arch, 8, S, "meta", ax, data)
    cut = lm.shard_cache(whole, ax, data)
    mesh = make_mesh((2, 2), ("data", "model"))
    assert sorted(mine) == sorted(whole) == sorted(cut)
    for e, layers in whole.items():
        for i, t in enumerate(layers):
            if t is None:
                assert mine[e][i] is None
                continue
            want = sharding.shard_shape(tuple(t.shape), specs[e][i], mesh)
            assert tuple(mine[e][i].shape) == want == tuple(cut[e][i].shape)
            assert want[0] == 4
            if e in ("k", "v", "cross_k", "cross_v"):
                assert want[2] == t.shape[2] // 2, (e, i)
            else:
                assert want[1:] == tuple(t.shape[1:]), (e, i)
    assert mine.seq_len == cut.seq_len == S


@pytest.mark.parametrize("name", ARCHS)
def test_dryrun_decode_bytes_at_1x2_are_a_ranks(name):
    """The dry run's 1x2 decode cell: a rank's parameters, its shares of
    the cache, its int32 tokens and the int32 ``pos``, exactly."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    arch = get_config(name)
    Bd, S = 8, 4096
    mesh = make_mesh((1, 2), ("data", "model"))
    fn, args, specs = dryrun.build_step(
        arch, ShapeConfig("x", "decode", S, Bd), mesh,
        dryrun.DryrunOptions())
    ax = par.Axis(None, 2, 0)
    model = lm.param_specs(arch, ax)
    cache = lm.init_cache(arch, Bd, S, "meta", ax)
    held = sum(p.numel() * p.element_size() for p in model.parameters()) \
        + sum(t.numel() * t.element_size() for ts in cache.values()
              for t in ts if t is not None) + Bd * 4 + 4
    assert dryrun.argument_bytes(args, specs, mesh) == held


# ---------------------------------------------------------------------------
# (data 2, model 2): an MoE routes the data group's tokens as one
# ---------------------------------------------------------------------------

def test_grid_decode_routes_the_global_batch(job):
    """granite-smoke at a decode batch of 64: the four ranks' rows within
    rel 1e-5 of one rank and atol 1e-4 of ``repro``'s global routing
    (capacity 40 an expert); a rank routing its 32 rows alone (capacity
    20) drops picks and misses ``repro``; the generated tokens gathered
    over the data axis are ``repro``'s server's."""
    want = job["repro"]["grid"]["decode"]
    np.testing.assert_allclose(job["one"]["grid"], want, atol=1e-4)
    for r in range(4):
        rows = slice(32 * (r // 2), 32 * (r // 2 + 1))
        got = job["ranks"][r]["grid"]
        _rel(got, job["one"]["grid"][rows], 1e-5, f"rank {r}")
        np.testing.assert_allclose(got, want[rows], atol=1e-4)
        np.testing.assert_array_equal(job["ranks"][r]["grid_generate"],
                                      job["repro"]["grid"]["generate"])
    alone, dropped = job["ranks"][0]["grid_alone"]
    assert sum(dropped) > 0
    assert np.max(np.abs(alone - want[:32])) > 1e-2
