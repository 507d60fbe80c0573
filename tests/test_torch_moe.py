"""The port's MoE layer, its ``moe`` and ``swa_mlp`` blocks and the MoE
LMs on the CPU, held against repro's on the same numpy inputs and weights
(JAX at f32 in-process, as the other LM files).

* ``moe_dispatch``'s places (``expert_places``, a sort by expert)
  against the cumsum of the one-hot that repro takes, exactly.
* ``layers.moe`` against ``repro.models.layers.moe``: top 2 of 8 and top
  8 of 32, capacity_factor 0.5 (tokens dropped) and 4.0 (none), the
  chunked path; at f32 the output within 1e-5 of max |repro|, aux rel
  1e-6 and the kept (expert, place) pairs equal to those repro's rule
  gives (``lax.top_k`` of repro's probabilities, places in token-major
  order); at bf16 within test_torch_lm.py's bar (atol 0.12, rtol 0.05).
* The LM on mixtral-smoke (window 32) and granite-smoke at f32 with
  repro's weights carried across by ``convert``: forward logits and aux,
  prefill, ``train_loss`` (rel 1e-5) and its gradients against
  ``jax.grad`` (within 1e-4 of each leaf's max), 48 decode steps through
  mixtral's ring of 32, which wraps, with the cache equal to repro's, and
  ``BatchedServer.generate``'s tokens equal. Each path is held to repro,
  not decode to forward: the MoE routes the B tokens of a decode step at
  another capacity than the B S of a forward, in repro too.
* The ``swa_mlp`` kind (tinyllama-smoke, window 16) alone and mixed with
  ``attn_mlp``, whose caches then have two lengths: forward and decode.
* ``init_params`` against repro's ``param_specs`` (the router f32 in a
  bf16 model; the expert weights at shape[1] ** -0.5), the ``convert``
  round trips of the params and of a ring cache, and the serving CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import BatchedServer as JServer
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import layers as L
from repro_torch.models import lm

MOE = ["mixtral-8x7b", "granite-moe-1b-a400m"]


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _moe_params(rng, D, Fd, E):
    return {"router": rng.standard_normal((D, E)) * D ** -0.5,
            "w_gate": rng.standard_normal((E, D, Fd)) * D ** -0.5,
            "w_up": rng.standard_normal((E, D, Fd)) * D ** -0.5,
            "w_down": rng.standard_normal((E, Fd, D)) * Fd ** -0.5}


def _kept_pairs_repro(p, x, E, K, C):
    """{(token pick, expert, place)} that repro keeps: lax.top_k of
    repro's f32 router probabilities, each pick placed in its expert in
    token-major order, kept while the place is under C."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ jnp.asarray(p["router"], jnp.float32), -1)
    _, tope = jax.lax.top_k(probs, K)
    count = np.zeros(E, np.int64)
    kept = set()
    for i, e in enumerate(np.asarray(tope).reshape(-1)):
        if count[e] < C:
            kept.add((i, int(e), int(count[e])))
        count[e] += 1
    return kept


def _kept_pairs_port(p, x, E, K, C):
    xf = x.reshape(-1, x.shape[-1])
    _, tope, _, _ = L.moe_route(p["router"], xf, K)
    _, row, keep = L.moe_dispatch(xf, tope, E, C)
    row, keep = row.numpy(), keep.numpy()
    return {(i, int(row[i]) // C, int(row[i]) % C)
            for i in range(len(row)) if keep[i]}


@pytest.mark.parametrize("picks,E", [(4096, 32), (512, 8), (33, 5)])
def test_dispatch_places_are_the_one_hot_cumsum(picks, E):
    """moe_dispatch's places (a sort by expert) equal repro's
    cumsum of the one-hot down the token-major picks, with experts left
    empty too; the kept rows carry their token's x."""
    rng = np.random.default_rng(picks)
    e = rng.integers(0, E - 1, picks)              # expert E - 1 unpicked
    oh = np.eye(E, dtype=np.int64)[e]
    want = np.cumsum(oh, 0)[np.arange(picks), e] - 1
    C = int(np.bincount(e).max()) // 2
    x = rng.standard_normal((picks, 3)).astype(np.float32)
    buf, row, keep = L.moe_dispatch(_t(x), torch.as_tensor(e)[:, None], E, C)
    np.testing.assert_array_equal(keep.numpy(), want < C)
    np.testing.assert_array_equal(row.numpy(),
                                  np.where(want < C, e * C + want, E * C))
    got = buf.reshape(E * C, 3).numpy()
    np.testing.assert_array_equal(got[row.numpy()[want < C]], x[want < C])


@pytest.mark.parametrize("E,K", [(8, 2), (32, 8)])
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_matches_repro(E, K, cf):
    rng = np.random.default_rng(10 + E)
    D, Fd, B, S = 32, 48, 2, 12
    p = {k: v.astype(np.float32) for k, v in _moe_params(rng, D, Fd,
                                                         E).items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf)
    want, waux = JL.moe({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), **kw)
    tp = {k: _t(v) for k, v in p.items()}
    got, gaux = L.moe(tp, _t(x), **kw)
    _close(got, want)
    assert float(gaux) == pytest.approx(float(waux), rel=1e-6)
    C = max(int(B * S * K / E * cf), 4)
    kept = _kept_pairs_repro(p, x, E, K, C)
    assert _kept_pairs_port(tp, _t(x), E, K, C) == kept
    # capacity 0.5 drops picks, 4.0 keeps every one
    assert (len(kept) < B * S * K) == (cf < 1)


def test_moe_chunked_matches_repro(monkeypatch):
    """T 64 in chunks of 16: capacity per chunk, aux the chunks' mean;
    both packages read their chunk size at call time."""
    rng = np.random.default_rng(11)
    D, Fd, E, K = 32, 48, 8, 2
    p = {k: v.astype(np.float32) for k, v in _moe_params(rng, D, Fd,
                                                         E).items()}
    x = rng.standard_normal((4, 16, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.0)
    monkeypatch.setattr(JL, "MOE_CHUNK_TOKENS", 16)
    monkeypatch.setattr(L, "MOE_CHUNK_TOKENS", 16)
    want, waux = JL.moe({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), **kw)
    tp = {k: _t(v) for k, v in p.items()}
    got, gaux = L.moe(tp, _t(x), **kw)
    _close(got, want)
    assert float(gaux) == pytest.approx(float(waux), rel=1e-6)
    whole, _ = L.moe(tp, _t(x), chunk_tokens=0, **kw)
    assert not torch.equal(whole, got)     # the chunks' capacity differs
    xf = x.reshape(4, 16, D)
    for c in range(4):      # each chunk keeps what repro's rule keeps
        kept = _kept_pairs_repro(p, xf[c], E, K, 4)
        assert _kept_pairs_port(tp, _t(xf[c]), E, K, 4) == kept


@pytest.mark.parametrize("E,K", [(8, 2), (32, 8)])
def test_moe_matches_repro_bf16(E, K):
    rng = np.random.default_rng(12)
    D, Fd = 32, 48
    p = _moe_params(rng, D, Fd, E)
    x = rng.standard_normal((2, 12, D))
    dt = {k: (jnp.float32 if k == "router" else jnp.bfloat16) for k in p}
    want, waux = JL.moe({k: jnp.asarray(v, dt[k]) for k, v in p.items()},
                        jnp.asarray(x, jnp.bfloat16), n_experts=E,
                        top_k=K)
    got, gaux = L.moe({k: _t(np.asarray(jnp.asarray(v, dt[k]), np.float32),
                          torch.float32 if k == "router" else torch.bfloat16)
                       for k, v in p.items()},
                      _t(np.asarray(jnp.asarray(x, jnp.bfloat16),
                                    np.float32), torch.bfloat16),
                      n_experts=E, top_k=K)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=0.12, rtol=0.05)
    assert float(gaux) == pytest.approx(float(waux), rel=1e-5)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

def _pair(ja, ta):
    tree = jax.tree.map(np.asarray, jlm.init_params(ja, jax.random.key(0)))
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_numpy(ta, tree, "cpu"))


def _archs(name, dtype="float32", **kw):
    return (dataclasses.replace(j_smoke(name), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(name), dtype=dtype, **kw))


def _tokens(V, B=2, S=40, seed=6):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _decode_both(ja, ta, params, model, toks, steps):
    """``steps`` decode steps of both packages from empty caches of
    length ``steps``, each step's logits compared; returns both caches."""
    B = toks.shape[0]
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, B, steps))
    cache = lm.init_cache(ta, B, steps, "cpu")
    for t in range(steps):
        jlog, jcache = jdec(params, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)
    return jcache, cache


def _same_cache(ta, jcache, cache):
    back = convert.cache_to_numpy(ta, cache)
    assert back.keys() == jcache.keys()
    for slot in back:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(back[slot][leaf],
                                       np.asarray(jcache[slot][leaf]),
                                       atol=1e-5)


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_forward_and_loss_match_repro(name):
    """Forward logits and aux, prefill, train_loss and its gradients at
    S 40 (past mixtral-smoke's window of 32)."""
    ja, ta = _archs(name)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size)
    targets = _tokens(ja.vocab_size, seed=7)
    want, waux, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got, gaux = model.forward_aux(torch.as_tensor(toks))
        last = model.prefill(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(gaux) == pytest.approx(float(waux), rel=1e-6)
    assert float(waux) > 0
    np.testing.assert_allclose(last.numpy(), np.asarray(
        jlm.prefill(params, ja, jnp.asarray(toks))), atol=1e-4)

    batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)}
    wloss, wgrad = jax.value_and_grad(
        lambda p: jlm.train_loss(p, ja, batch))(params)
    named = dict(model.named_parameters())
    for t in named.values():
        t.requires_grad_(True)
    loss = lm.train_loss(model, {"tokens": toks, "targets": targets})
    grads = torch.autograd.grad(loss, list(named.values()))
    assert float(loss.detach()) == pytest.approx(float(wloss), rel=1e-5)
    want_g = convert.lm_flat(ta, jax.tree.map(np.asarray, wgrad))
    assert want_g.keys() == named.keys()
    for k, g in zip(named, grads):
        _close(g, want_g[k], rel=1e-4)


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_decode_and_serve_match_repro(name):
    """48 decode steps (mixtral-smoke's ring of 32 wraps at step 32), the
    cache equal to repro's, then generate's tokens through a ring that
    wraps (prompt 20 + 20)."""
    ja, ta = _archs(name)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=48)
    jcache, cache = _decode_both(ja, ta, params, model, toks, 48)
    want_len = 32 if name == "mixtral-8x7b" else 48
    assert [c.shape[2] for c in cache["k"]] == [want_len] * ta.n_layers
    _same_cache(ta, jcache, cache)

    prompts = toks[:, :20]
    want_tokens = JServer(ja, params, 40).generate(prompts, 20)
    got_tokens = BatchedServer(ta, model, 40).generate(prompts, 20)
    assert got_tokens.dtype == np.int32
    np.testing.assert_array_equal(got_tokens, want_tokens)


def _picks(router, h, K):
    """Each token's top-K expert set and the gap between its K-th and
    (K+1)-th router probability, from f32 logits of h (T, D)."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(h, jnp.float32) @ jnp.asarray(router, jnp.float32), -1))
    order = np.argsort(-probs, -1)
    top = np.take_along_axis(probs, order, -1)
    return [frozenset(r) for r in order[:, :K]], top[:, K - 1] - top[:, K]


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_matches_repro_bf16(name, monkeypatch):
    """At bf16 the two packages' hidden states differ by rounding, so a
    token whose K-th and (K+1)-th router probabilities nearly tie may
    pick another expert in each. With capacity for every pick (so one
    flip moves no other token's place), every token whose picks agree
    in every layer has logits within test_torch_lm.py's bf16 bar, and a
    token whose picks differ sat within 1e-2 of a tie in the port."""
    ja, ta = _archs(name, "bfloat16", capacity_factor=4.0)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size)
    K = ta.top_k
    jin, tin = [], []
    j_moe, t_moe = JL.moe, L.moe
    monkeypatch.setattr(JL, "moe", lambda p, h, **kw: (
        jin.append((p["router"], h)), j_moe(p, h, **kw))[1])
    monkeypatch.setattr(L, "moe", lambda p, h, **kw: (
        tin.append((p["router"].numpy(), h.float().numpy())),
        t_moe(p, h, **kw))[1])
    want, waux, _ = jlm.forward(params, ja, jnp.asarray(toks),
                                unroll_layers=ja.n_layers)
    with torch.inference_mode():
        got, gaux = model.forward_aux(torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert model.layers[0].moe.router.dtype == torch.float32
    assert len(jin) == len(tin) == ta.n_layers
    agree = np.ones(toks.size, bool)
    for (jr, jh), (tr, th) in zip(jin, tin):
        jp, _ = _picks(jr, np.asarray(jh, np.float32).reshape(toks.size, -1),
                       K)
        tp, gap = _picks(tr, th.reshape(toks.size, -1), K)
        same = np.array([a == b for a, b in zip(jp, tp)])
        assert (gap[~same] < 1e-2).all(), gap[~same]
        agree &= same
    assert agree.sum() >= 0.9 * toks.size
    rows = agree.reshape(toks.shape)
    np.testing.assert_allclose(got.float().numpy()[rows],
                               np.asarray(want, np.float32)[rows],
                               atol=0.12, rtol=0.05)
    assert float(gaux) == pytest.approx(float(waux), rel=1e-2)


@pytest.mark.parametrize("pattern", [("swa_mlp",), ("attn_mlp", "swa_mlp")])
def test_swa_blocks_match_repro(pattern):
    """tinyllama-smoke with window 16: forward at S 24 and 24 decode
    steps, the window's ring (16) wrapping; the mixed pattern's caches
    are 24 and 16 long."""
    ja, ta = _archs("tinyllama-1.1b", block_pattern=pattern, window=16)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=24)
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    jcache, cache = _decode_both(ja, ta, params, model, toks, 24)
    assert [c.shape[2] for c in cache["k"]] == [
        16 if ta.block_at(i) == "swa_mlp" else 24
        for i in range(ta.n_layers)]
    _same_cache(ta, jcache, cache)


def test_ring_cache_round_trip_resumes_decode():
    """A mixed-length cache carried across from repro mid-sequence, after
    its ring has wrapped, continues there; the round trip is exact."""
    ja, ta = _archs("tinyllama-1.1b", block_pattern=("attn_mlp", "swa_mlp"),
                    window=8)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=16)
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 16))
    for t in range(11):
        _, jcache = jdec(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "cache": jcache, "pos": jnp.int32(t)})
    host = jax.tree.map(np.asarray, jcache)
    cache = convert.cache_from_numpy(ta, host, "cpu")
    back = convert.cache_to_numpy(ta, cache)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, host))
    for t in range(11, 16):
        jlog, jcache = jdec(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                     "cache": jcache, "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)
    _same_cache(ta, jcache, cache)


@pytest.mark.parametrize("name", MOE)
def test_moe_params_round_trip(name):
    """bf16 weights and the f32 router cross both ways exactly, each
    leaf keeping its dtype."""
    ja, ta = _archs(name, "bfloat16")
    params, model = _pair(ja, ta)
    sd = model.state_dict()
    assert sd["layers.0.moe.router"].dtype == torch.float32
    assert sd["layers.0.moe.w_gate"].dtype == torch.bfloat16
    back = convert.lm_params_to_numpy(model)
    same = jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a, np.float32), b),
        params, back)
    assert jax.tree.all(same)


@pytest.mark.parametrize("name", MOE)
def test_init_params_matches_param_specs(name):
    """Same names, shapes and dtypes as repro's param_specs (the router
    f32 in the bf16 model); the expert weights drawn at shape[1] ** -0.5
    (D for gate and up, F for down), the router at D ** -0.5."""
    ja, ta = j_smoke(name), get_smoke_config(name)
    specs = jlm.param_specs(ja)
    model = lm.init_params(ta, seed=3, device="cpu")
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for g in range(s.shape[0]):
                want[".".join(["layers", str(g)] + keys[2:])] = (
                    tuple(s.shape[1:]), str(s.dtype))
        else:
            want[".".join(keys)] = (tuple(s.shape), str(s.dtype))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    assert got == want
    assert got["layers.0.moe.router"][1] == "float32"
    sd = model.state_dict()
    D, Fd = ta.d_model, ta.d_ff
    for leaf, fan_in in (("w_gate", D), ("w_up", D), ("w_down", Fd),
                         ("router", D)):
        std = float(sd[f"layers.1.moe.{leaf}"].float().std())
        assert std == pytest.approx(fan_in ** -0.5, rel=0.1), leaf


def test_moe_archs_are_ported():
    for name in MOE:
        lm.check_ported(get_config(name))
        lm.check_ported(get_smoke_config(name))
    full = get_config("mixtral-8x7b")
    assert lm.cache_len(full, "moe", 8192) == 4096
    assert lm.cache_len(full, "moe", 160) == 160
    assert lm.cache_len(get_config("granite-moe-1b-a400m"), "moe",
                        8192) == 8192


def test_serve_cli_runs_moe_on_cpu(capsys):
    serve.main(["--arch", "mixtral-8x7b", "--smoke", "--batch", "2",
                "--prompt-len", "40", "--gen-len", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=mixtral-smoke generated (2, 4)" in out
