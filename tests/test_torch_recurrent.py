"""The port's recurrent layers (``models/recurrent.py``), the four block
kinds built on them and the two recurrent LMs on the CPU, held against
repro's on the same numpy inputs and weights (JAX at f32 in-process, as
the other LM files).

* ``chunked_gla`` (normalize off and on, chunk 1, 16 and T, from a given
  state) and ``gla_step`` against ``repro.models.recurrent``; the SSM
  heads, mLSTM and sLSTM, train and step. f32 within 1e-5 of max |repro|.
  ``chunked_gla``'s gradients against ``jax.grad``, and finite where
  ``repro``'s masked exponent overflows.
* The LM on xlstm-smoke and hymba-smoke (window 32, 4 meta tokens) with
  repro's weights carried across by ``convert``: forward logits, prefill,
  ``train_loss`` (rel 1e-5) and its gradients (within 1e-4 of each leaf's
  max, all finite) against ``jax.grad``; 40 decode steps with the state
  caches equal to repro's (hymba's ring of 32 wraps); the tokens of
  ``BatchedServer.generate`` equal. At bf16 within test_torch_lm.py's bar
  (atol 0.12, rtol 0.05). A ``mamba_mlp`` pattern on tinyllama-smoke.
* At meta_tokens = 0, decode against the forward's last position (repro's
  bar); ``init_params`` against repro's ``param_specs``; the ``convert``
  round trips of the params and the state caches, bit for bit; the serving
  CLI for both archs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import BatchedServer as JServer
from repro.models import lm as jlm
from repro.models import recurrent as JR
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import lm
from repro_torch.models import recurrent as R

RECURRENT = ["xlstm-350m", "hymba-1.5b"]


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _gla_inputs(rng, B=2, H=3, T=32, dk=4, dv=5):
    q = rng.standard_normal((B, H, T, dk)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, H, T, dk))).astype(np.float32)
    v = rng.standard_normal((B, H, T, dv)).astype(np.float32)
    la = -rng.uniform(0.01, 0.5, (B, H, T)).astype(np.float32)
    S0 = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    n0 = rng.uniform(0, 1, (B, H, dk)).astype(np.float32)
    return q, k, v, la, S0, n0


# ---------------------------------------------------------------------------
# The recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("chunk", [1, 16, 32])
def test_chunked_gla_matches_repro(normalize, chunk):
    """T 32 in chunks of 1, 16 and T, from a nonzero state (and norm)."""
    q, k, v, la, S0, n0 = _gla_inputs(np.random.default_rng(chunk))
    kw = dict(chunk=chunk, normalize=normalize)
    wo, wS, wn = JR.chunked_gla(*map(jnp.asarray, (q, k, v, la)),
                                state0=jnp.asarray(S0),
                                norm0=jnp.asarray(n0), **kw)
    go, gS, gn = R.chunked_gla(*map(_t, (q, k, v, la)), state0=_t(S0),
                               norm0=_t(n0), **kw)
    _close(go, wo)
    _close(gS, wS)
    _close(gn, wn)
    assert gS.dtype == gn.dtype == torch.float32


def test_chunked_gla_refuses_a_ragged_chunking():
    q, k, v, la, _, _ = _gla_inputs(np.random.default_rng(0), T=40)
    with pytest.raises(ValueError, match="not a multiple of chunk 16"):
        JR.chunked_gla(*map(jnp.asarray, (q, k, v, la)), chunk=16)
    with pytest.raises(ValueError, match="not a multiple of chunk 16"):
        R.chunked_gla(*map(_t, (q, k, v, la)), chunk=16)


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_gla_gradients_match_jax(normalize):
    q, k, v, la, S0, n0 = _gla_inputs(np.random.default_rng(5), T=32)
    w = np.random.default_rng(6).standard_normal((2, 3, 32, 5)).astype(
        np.float32)

    def jloss(q, k, v, la, S0):
        o, S, n = JR.chunked_gla(q, k, v, la, chunk=8, normalize=normalize,
                                 state0=S0, norm0=jnp.asarray(n0))
        return jnp.sum(o * w) + jnp.sum(S) + jnp.sum(n)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (q, k, v, la, S0)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, la, S0)]
    o, S, n = R.chunked_gla(*leaves[:4], chunk=8, normalize=normalize,
                            state0=leaves[4], norm0=_t(n0))
    loss = (o * _t(w)).sum() + S.sum() + n.sum()
    for g, wg in zip(torch.autograd.grad(loss, leaves), want):
        _close(g, wg, rel=1e-4)


def test_chunked_gla_gradients_finite_under_strong_decay():
    """Decays whose within-chunk differences overflow exp above the
    diagonal: the port masks the exponent first, so its gradients stay
    finite; its forward equals repro's."""
    q, k, v, _, _, _ = _gla_inputs(np.random.default_rng(7), T=64)
    la = np.full((2, 3, 64), -5.0, np.float32)           # 5 x 63 > 88
    want, _, _ = JR.chunked_gla(*map(jnp.asarray, (q, k, v, la)), chunk=64)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, la)]
    o, S, _ = R.chunked_gla(*leaves, chunk=64)
    _close(o, want)
    grads = torch.autograd.grad(o.sum() + S.sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_step_matches_repro(normalize):
    rng = np.random.default_rng(8)
    B, H, dk, dv = 2, 3, 4, 5
    q, k = (rng.standard_normal((B, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, dv)).astype(np.float32)
    la = -rng.uniform(0.01, 1, (B, H)).astype(np.float32)
    S = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    n = rng.uniform(0, 1, (B, H, dk)).astype(np.float32)
    wo, wS, wn = JR.gla_step(*map(jnp.asarray, (q, k, v, la, S, n)),
                             normalize=normalize)
    go, gS, gn = R.gla_step(*map(_t, (q, k, v, la, S, n)),
                            normalize=normalize)
    _close(go, wo)
    _close(gS, wS)
    _close(gn, wn)


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------

def _cell_params(kind, rng, D, H, dk=4):
    """Random f32 numpy params of a cell, with repro's leaf names."""
    dv = D // H
    n = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    if kind == "ssm":
        return {"wq": n(D, H * dk), "wk": n(D, H * dk), "wv": n(D, D),
                "w_decay": n(D, H), "b_decay": np.full(H, 2.0, np.float32),
                "w_gate": n(D, D), "wo": n(D, D)}
    if kind == "mlstm":
        return {"wq": n(D, D), "wk": n(D, D), "wv": n(D, D), "w_i": n(D, H),
                "w_f": n(D, H), "b_f": np.full(H, 3.0, np.float32),
                "w_gate": n(D, D), "wo": n(D, D)}
    p = {"wo": n(D, D)}
    for g in "zifo":
        p[f"w_{g}"] = n(D, D)
        p[f"r_{g}"] = (rng.standard_normal((H, dv, dv)) * dv ** -0.5
                       ).astype(np.float32)
    return p


def _run_cell(kind, p, x, state, step, pkg):
    """repro's (pkg "jax") or the port's cell on x from ``state``."""
    H = 4
    if pkg == "jax":
        mod, p, x = JR, {k: jnp.asarray(v) for k, v in p.items()}, \
            jnp.asarray(x)
        state = jax.tree.map(jnp.asarray, state)
    else:
        mod, p, x = R, {k: _t(v) for k, v in p.items()}, _t(x)
        state = jax.tree.map(_t, state)
    if kind == "ssm":
        if step:
            return mod.ssm_heads_step(p, x, state, n_heads=H, dk=4)
        return mod.ssm_heads_train(p, x, n_heads=H, dk=4)
    if kind == "mlstm":
        if step:
            return mod.mlstm_step(p, x, *state, n_heads=H)
        return mod.mlstm_train(p, x, n_heads=H)
    if step:
        return mod.slstm_step(p, x, tuple(state), n_heads=H)
    return mod.slstm_train(p, x, n_heads=H)


@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
def test_cells_match_repro(kind):
    """Train over S 24, then three steps from the train path's final
    state, each against repro's."""
    rng = np.random.default_rng({"ssm": 1, "mlstm": 2, "slstm": 3}[kind])
    D, B, S = 32, 2, 24
    p = _cell_params(kind, rng, D, 4)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    want, wstate = _run_cell(kind, p, x, None, False, "jax")
    got, gstate = _run_cell(kind, p, x, None, False, "torch")
    _close(got, want)
    jax.tree.map(lambda g, w: _close(g, w), list(jax.tree.leaves(gstate)),
                 list(jax.tree.leaves(wstate)))
    state = jax.tree.map(np.asarray, wstate)
    for _ in range(3):
        xs = rng.standard_normal((B, 1, D)).astype(np.float32)
        want, wnext = _run_cell(kind, p, xs, state, True, "jax")
        got, gnext = _run_cell(kind, p, xs, state, True, "torch")
        _close(got, want)
        for g, w in zip(jax.tree.leaves(gnext), jax.tree.leaves(wnext)):
            _close(g, w)
        state = jax.tree.map(np.asarray, wnext)


# ---------------------------------------------------------------------------
# The LMs
# ---------------------------------------------------------------------------

def _archs(name, dtype="float32", **kw):
    return (dataclasses.replace(j_smoke(name), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(name), dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _repro_tree(ja):
    """repro's params of ``ja`` as numpy leaves, drawn once a config
    (``init_params`` takes seconds on the CPU). repro draws every leaf in
    f32 and casts it to its dtype, so a bf16 config's tree is its f32
    tree cast leaf by leaf to ``param_specs``' dtypes."""
    if ja.dtype == "float32":
        return jax.tree.map(np.asarray,
                            jlm.init_params(ja, jax.random.key(0)))
    f32 = _repro_tree(dataclasses.replace(ja, dtype="float32"))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), f32,
                        jlm.param_specs(ja))


def _pair(ja, ta):
    tree = _repro_tree(ja)
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_numpy(ta, tree, "cpu"))


def _tokens(V, B=2, S=40, seed=6):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _same_cache(ta, jcache, cache):
    """Every entry of every slot within 1e-5 of repro's max."""
    back = convert.cache_to_numpy(ta, cache)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jcache))
    for slot in back:
        for leaf in back[slot]:
            _close(back[slot][leaf], jcache[slot][leaf])


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


@pytest.mark.parametrize("name", RECURRENT)
def test_lm_forward_and_loss_match_repro(name):
    """Forward logits (hymba's with its 4 meta positions), prefill,
    train_loss and its gradients at S 40 (past hymba-smoke's window)."""
    ja, ta = _archs(name)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size)
    targets = _tokens(ja.vocab_size, seed=7)
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks))
        last = model.prefill(torch.as_tensor(toks))
    assert got.shape == (2, 40 + ta.meta_tokens, ta.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # repro's prefill is its forward's last position
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               atol=1e-4)

    batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)}
    wloss, wgrad = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(p, ja, batch)))(params)
    named = dict(model.named_parameters())
    for t in named.values():
        t.requires_grad_(True)
    loss = lm.train_loss(model, {"tokens": toks, "targets": targets})
    grads = torch.autograd.grad(loss, list(named.values()))
    assert float(loss.detach()) == pytest.approx(float(wloss), rel=1e-5)
    want_g = convert.lm_flat(ta, jax.tree.map(np.asarray, wgrad))
    assert want_g.keys() == named.keys()
    for k, g in zip(named, grads):
        assert bool(torch.isfinite(g).all()), k
        _close(g, want_g[k], rel=1e-4)


@pytest.mark.parametrize("name", RECURRENT)
def test_lm_decode_and_serve_match_repro(name):
    """40 decode steps (hymba-smoke's ring of 32 wraps at step 32), every
    cache entry equal to repro's, then generate's tokens (prompt 20 +
    20)."""
    ja, ta = _archs(name)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size)
    jcache, cache = _decode_both(ja, ta, params, model, toks, 40)
    if name == "hymba-1.5b":
        assert [c.shape[2] for c in cache["k"]] == [32] * ta.n_layers
        assert cache["ssm_state"][0].dtype == torch.float32
    else:
        assert "k" not in cache
        assert cache["slstm_m"][1].dtype == torch.float32
    _same_cache(ta, jcache, cache)

    prompts = toks[:, :20]
    want_tokens = JServer(ja, params, 40).generate(prompts, 20)
    got_tokens = BatchedServer(ta, model, 40).generate(prompts, 20)
    assert got_tokens.dtype == np.int32
    np.testing.assert_array_equal(got_tokens, want_tokens)


@pytest.mark.parametrize("name", RECURRENT)
def test_lm_matches_repro_bf16(name):
    """bf16 forward and 8 decode steps within test_torch_lm.py's bar; the
    gate, decay and recurrent weights stay f32."""
    ja, ta = _archs(name, "bfloat16")
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=28)
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=0.12, rtol=0.05)
    sd = model.state_dict()
    f32 = [k for k, v in sd.items() if v.dtype == torch.float32]
    assert f32 and all(k.rsplit(".", 1)[-1] in (
        "w_decay", "b_decay", "w_i", "w_f", "b_f", "r_z", "r_i", "r_f",
        "r_o") for k in f32), f32
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 8))
    cache = lm.init_cache(ta, 2, 8, "cpu")
    for t in range(8):
        jlog, jcache = jdec(params, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.float().numpy(),
                                   np.asarray(jlog, np.float32),
                                   atol=0.12, rtol=0.05)


def test_mamba_mlp_blocks_match_repro():
    """tinyllama-smoke with the ``mamba_mlp`` pattern (SSM heads of key
    dim 8 in place of attention): forward and 12 decode steps."""
    ja, ta = _archs("tinyllama-1.1b", block_pattern=("mamba_mlp",),
                    ssm_state=8)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=12)
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    jcache, cache = _decode_both(ja, ta, params, model, toks, 12)
    assert set(cache) == {"ssm_state"}
    _same_cache(ta, jcache, cache)


@pytest.mark.parametrize("name", RECURRENT)
def test_decode_matches_forward_last_position(name):
    """At meta_tokens = 0 teacher-forced decode reproduces the forward's
    last position (repro's test_models invariant and bar); with hymba's
    meta tokens it does not, in repro as in the port."""
    arch = dataclasses.replace(get_smoke_config(name), meta_tokens=0)
    model = lm.init_params(arch, seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(arch.vocab_size, B=1, S=16))
    cache = lm.init_cache(arch, 1, 16, "cpu")
    with torch.inference_mode():
        full = model.forward(toks)
        for t in range(16):
            step, cache = model.decode_step(toks[:, t:t + 1], cache, t)
    np.testing.assert_allclose(step[:, 0].float().numpy(),
                               full[:, -1].float().numpy(),
                               atol=0.12, rtol=0.05)


@pytest.mark.parametrize("name", RECURRENT)
def test_init_params_matches_param_specs(name):
    """Same names, shapes and dtypes as repro's param_specs (the f32
    leaves in the bf16 model); b_decay 2 and b_f 3; the recurrent r_* at
    dh ** -0.5, meta at 0.02."""
    ja, ta = j_smoke(name), get_smoke_config(name)
    specs = jlm.param_specs(ja)
    model = lm.init_params(ta, seed=3, device="cpu")
    period = len(ta.block_pattern)
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            slot = int(keys[1][4:].split("_")[0])
            for g in range(s.shape[0]):
                want[".".join(["layers", str(g * period + slot)]
                              + keys[2:])] = (tuple(s.shape[1:]),
                                              str(s.dtype))
        else:
            want[".".join(keys)] = (tuple(s.shape), str(s.dtype))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    assert got == want
    sd = model.state_dict()
    D = ta.d_model
    if name == "hymba-1.5b":
        assert bool((sd["layers.0.ssm.b_decay"] == 2).all())
        assert float(sd["meta"].float().std()) == pytest.approx(0.02,
                                                                rel=0.2)
        assert float(sd["layers.1.ssm.w_decay"].std()) == pytest.approx(
            D ** -0.5, rel=0.2)
    else:
        dh = D // ta.n_heads
        assert bool((sd["layers.0.mlstm.b_f"] == 3).all())
        r = torch.stack([sd[f"layers.{i}.slstm.r_{g}"] for i in (1, 3)
                         for g in "zifo"])
        assert float(r.std()) == pytest.approx(dh ** -0.5, rel=0.1)
        assert float(sd["layers.2.mlstm.wq"].float().std()) == \
            pytest.approx(D ** -0.5, rel=0.1)


@pytest.mark.parametrize("name", RECURRENT)
def test_params_and_caches_round_trip(name):
    """bf16 weights, the f32 leaves and meta cross both ways bit for bit;
    a cache carried across from repro mid-sequence (hymba's ring wrapped)
    round-trips exactly and resumes decoding."""
    ja, ta = _archs(name, "bfloat16")
    params, model = _pair(ja, ta)
    back = convert.lm_params_to_numpy(model)
    same = jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a, np.float32), b),
        params, back)
    assert jax.tree.all(same)

    ja, ta = _archs(name)
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=40)
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 40))
    for t in range(34):
        _, jcache = jdec(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "cache": jcache, "pos": jnp.int32(t)})
    host = jax.tree.map(np.asarray, jcache)
    cache = convert.cache_from_numpy(ta, host, "cpu")
    assert jax.tree.all(jax.tree.map(np.array_equal,
                                     convert.cache_to_numpy(ta, cache),
                                     host))
    for t in range(34, 40):
        jlog, jcache = jdec(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                     "cache": jcache, "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)
    _same_cache(ta, jcache, cache)


def test_recurrent_archs_are_ported():
    for name in RECURRENT:
        lm.check_ported(get_config(name))
        lm.check_ported(get_smoke_config(name))
    hymba, xlstm = get_config("hymba-1.5b"), get_config("xlstm-350m")
    assert lm.has_attention(hymba) and not lm.has_attention(xlstm)
    assert lm.cache_len(hymba, "hybrid", 8192) == 1024
    for name in ("whisper-large-v3", "pixtral-12b"):    # ported since
        lm.check_ported(get_config(name))


@pytest.mark.parametrize("name", RECURRENT)
def test_serve_cli_runs_recurrent_on_cpu(name, capsys):
    serve.main(["--arch", name, "--smoke", "--batch", "2", "--prompt-len",
                "40", "--gen-len", "4", "--device", "cpu"])
    smoke = get_smoke_config(name).name
    assert f"arch={smoke} generated (2, 4)" in capsys.readouterr().out
