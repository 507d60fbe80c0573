"""The port's encoder-decoder (whisper) and vision-stub (pixtral) paths on
the CPU, held against repro's on the same numpy inputs and weights (JAX
at f32 in-process, as the other LM files; repro's weights carried across
by ``convert``), at test_torch_lm.py's bar: atol 1e-4 on logits.

* ``sinusoid`` against repro's ``_sinusoid``; ``attention_train`` with
  ``kv_override`` (cross-attention) against repro's.
* Forward logits and prefill: whisper-smoke (30 frames), whisper-smoke
  with ``encoder_seq`` 200 (the encoder's and the cross-attention's
  bidirectional calls at a ragged length), pixtral-smoke with 8 patch
  rows.
* ``fill_cross_cache`` against repro's ``_encoder_forward`` composed with
  ``_cross_kv``; every ``decode_step`` against repro's ``decode_step`` on
  the ``cache["cross"]`` so built, and the caches.
* ``train_loss`` (rel 1e-5) and its gradients (1e-4 of each leaf's max)
  against ``jax.grad``; pixtral's patch positions carry no loss.
* Three AdamW steps through the port's ``make_train_step`` against
  ``repro``'s (one device, 2 microbatches, the frames or patches in the
  batch): the losses (rel 1e-5) and step 1's gradients (1e-5 of each
  leaf's max).
* ``init_params`` against repro's ``param_specs``; params and caches
  through ``convert`` both ways, bit for bit.
* ``BatchedServer.generate``'s tokens equal repro's on both smoke archs
  (whisper with repro's zero cross cache, and with one filled from
  frames against repro's decode loop on the same cache); the CLI refuses
  whisper with repro's message and serves pixtral.
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
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as j_cosine
from repro.runtime.driver import TrainerConfig as JTrainerConfig
from repro.runtime.driver import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.driver import TrainerConfig, make_train_step

WHISPER, PIXTRAL = "whisper-large-v3", "pixtral-12b"
# (arch, config overrides): whisper-smoke's 30 frames, then 200 (a
# ragged bidirectional length: 200 is not a multiple of 128), pixtral.
CASES = {"whisper": (WHISPER, {}),
         "whisper-ragged": (WHISPER, {"encoder_seq": 200}),
         "pixtral": (PIXTRAL, {})}


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _archs(case, dtype="float32"):
    name, over = CASES[case]
    over = dict(over, dtype=dtype)
    return (dataclasses.replace(j_smoke(name), **over),
            dataclasses.replace(get_smoke_config(name), **over))


@functools.lru_cache(maxsize=None)
def _repro_tree(ja):
    """repro's params of ``ja`` as numpy leaves, drawn once a config."""
    return jax.tree.map(np.asarray, jlm.init_params(ja, jax.random.key(0)))


def _pair(ja, ta):
    tree = _repro_tree(ja)
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_numpy(ta, tree, "cpu"))


def _tokens(V, B=2, S=24, seed=6):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _extras(arch, B=2, seed=7):
    """{"frames": (B, encoder_seq, D)} or {"patches": (B, n_patches, D)},
    f32 numpy draws."""
    rng = np.random.default_rng(seed)
    if arch.is_encdec:
        return {"frames": rng.standard_normal(
            (B, arch.encoder_seq, arch.d_model)).astype(np.float32)}
    return {"patches": rng.standard_normal(
        (B, arch.n_patches, arch.d_model)).astype(np.float32)}


def _jcross(ja, params, frames):
    """repro's ``cache["cross"]`` for ``frames``: ``_encoder_forward``,
    then each group's ``_cross_kv`` (what its ``decode_step`` reads)."""
    enc_out = jlm._encoder_forward(params, ja, jnp.asarray(frames))
    xattn = params["layers"]["slot0_attn_mlp"]["xattn"]
    G = ja.n_layers // len(ja.block_pattern)
    ks, vs = zip(*(jlm._cross_kv(jax.tree.map(lambda a: a[g], xattn),
                                 enc_out, ja) for g in range(G)))
    return {"k": jnp.stack(ks), "v": jnp.stack(vs)}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_matches_repro(d):
    """The two packages' f32 ``exp`` may round a frequency f one ulp
    apart, which moves the angle at position p by up to p 2^-23 f <= p
    1.2e-7 (1.8e-4 at p 1499): that, plus 2e-6 for sin and cos, is the
    bar at each position."""
    pos = np.array([0, 1, 7, 447, 1499], np.int32)
    got = lm.sinusoid(torch.as_tensor(pos), d)
    assert got.dtype == torch.float32 and got.shape == (5, d)
    want = np.asarray(jlm._sinusoid(jnp.asarray(pos), d))
    assert (np.abs(got.numpy() - want)
            <= pos[:, None] * 1.2e-7 + 2e-6).all()


@pytest.mark.parametrize("Sq,Sk", [(12, 30), (40, 200)])
def test_cross_attention_train_matches_repro(Sq, Sk):
    """``kv_override`` (B, Hkv, Sk, Dh) of a bidirectional call: q alone
    is projected, no rope (rope_theta > 0 here, as repro also skips it)."""
    rng = np.random.default_rng(Sk)
    D, H, Hkv, Dh = 32, 4, 2, 8
    p = {"wq": rng.standard_normal((D, H * Dh)) * D ** -0.5,
         "wk": rng.standard_normal((D, Hkv * Dh)) * D ** -0.5,
         "wv": rng.standard_normal((D, Hkv * Dh)) * D ** -0.5,
         "wo": rng.standard_normal((H * Dh, D)) * (H * Dh) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, Sq, D)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, Sk, Dh)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, Sk, Dh)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, rope_theta=1e4,
              causal=False)
    want, (wk, _) = JL.attention_train(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        kv_override=(jnp.asarray(k), jnp.asarray(v)), **kw)
    got, (gk, _) = L.attention_train({n: _t(a) for n, a in p.items()},
                                     _t(x), kv_override=(_t(k), _t(v)),
                                     **kw)
    _close(got, want)
    assert np.array_equal(gk.numpy(), np.asarray(wk))


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_prefill_match_repro(case):
    """Logits at every position (pixtral's 8 patch positions first) and
    prefill's last position; whisper without frames refuses."""
    ja, ta = _archs(case)
    params, model = _pair(ja, ta)
    toks, extras = _tokens(ja.vocab_size), _extras(ta)
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks),
                             {k: jnp.asarray(v) for k, v in extras.items()})
    ext = {k: torch.as_tensor(v) for k, v in extras.items()}
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks), ext)
        last = model.prefill(torch.as_tensor(toks), ext)
    n_prefix = ta.n_patches if ta.frontend == "vision_stub" else 0
    assert got.shape == (2, 24 + n_prefix, ta.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               atol=1e-4)
    if ta.is_encdec:
        with pytest.raises(ValueError, match="frames"):
            model.forward(torch.as_tensor(toks))


@pytest.mark.parametrize("case", ["whisper", "whisper-ragged"])
def test_cross_cache_and_decode_match_repro(case):
    """``fill_cross_cache`` equals repro's ``_encoder_forward`` +
    ``_cross_kv``; 20 decode steps (the sinusoid at each position, the
    cross step against that cache) equal repro's ``decode_step`` step by
    step, and so do the caches after them."""
    ja, ta = _archs(case)
    params, model = _pair(ja, ta)
    toks, frames = _tokens(ja.vocab_size, S=20), _extras(ta)["frames"]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 20))
    jcache["cross"] = _jcross(ja, params, frames)
    cache = lm.init_cache(ta, 2, 20, "cpu")
    assert all(not t.any() for t in cache["cross_k"] + cache["cross_v"])
    with torch.inference_mode():
        model.fill_cross_cache(cache, torch.as_tensor(frames))
    assert cache["cross_k"][0].shape == (2, ta.n_kv_heads, ta.encoder_seq,
                                         ta.head_dim_)
    for name in ("k", "v"):
        for i in range(ta.n_layers):
            _close(cache[f"cross_{name}"][i], jcache["cross"][name][i])
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    for t in range(20):
        jlog, jcache = jdec(params, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)
    back = convert.cache_to_numpy(ta, cache)
    host = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    jax.tree.map(_close, back, host)


@pytest.mark.parametrize("case", ["whisper-ragged", "pixtral"])
def test_train_loss_and_gradients_match_repro(case):
    """Every batch key but tokens and targets is an extra, in both
    packages; pixtral's patch positions carry no loss."""
    ja, ta = _archs(case)
    params, model = _pair(ja, ta)
    batch = {"tokens": _tokens(ja.vocab_size),
             "targets": _tokens(ja.vocab_size, seed=8), **_extras(ta)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    wloss, wgrad = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(p, ja, jbatch)))(params)
    named = dict(model.named_parameters())
    for t in named.values():
        t.requires_grad_(True)
    loss = lm.train_loss(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    assert float(loss.detach()) == pytest.approx(float(wloss), rel=1e-5)
    want_g = convert.lm_flat(ta, jax.tree.map(np.asarray, wgrad))
    assert want_g.keys() == named.keys()
    for k, g in zip(named, grads):
        assert bool(torch.isfinite(g).all()), k
        _close(g, want_g[k], rel=1e-4)


@dataclasses.dataclass(frozen=True)
class _JRecording(JAdamW):
    """repro's AdamW that hands its first update's gradients to the host
    (``jax.debug.callback`` from inside the jitted step)."""

    def update(self, grads, state, params):
        jax.debug.callback(
            lambda g: _KEPT.setdefault("repro", jax.tree.map(np.asarray, g)),
            grads)
        return super().update(grads, state, params)


_KEPT = {}
TRAIN_STEPS, TRAIN_B, TRAIN_K = 3, 4, 2


@pytest.mark.parametrize("case", ["whisper", "pixtral"])
def test_train_step_matches_repro(case):
    """TRAIN_STEPS AdamW steps through the port's ``make_train_step`` and
    ``repro``'s (one device, f32), a batch of TRAIN_B rows in TRAIN_K
    microbatches with the frames or patch rows in it (the same each step,
    the tokens drawn anew): every step's loss within rel 1e-5 and step
    1's gradients within 1e-5 of each leaf's max."""
    from jax.sharding import Mesh
    ja, ta = _archs(case)
    params, model = _pair(ja, ta)
    extras = _extras(ta, B=TRAIN_B)
    batches = [{"tokens": _tokens(ja.vocab_size, B=TRAIN_B, seed=20 + i),
                "targets": _tokens(ja.vocab_size, B=TRAIN_B, seed=40 + i),
                **extras} for i in range(TRAIN_STEPS)]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    _KEPT.clear()
    jstep = j_make_train_step(
        ja, _JRecording(learning_rate=j_cosine(1e-3, 1, TRAIN_STEPS)), mesh,
        JTrainerConfig(microbatches=TRAIN_K))
    jstate = _JRecording().init(params)
    want = []
    for b in batches:
        params, jstate, loss = jstep(params, jstate,
                                     {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(loss))
    kept = {}

    class Recording(AdamW):
        def update(self, grads, state, params_, **kw):
            kept.setdefault("port", {n: g.detach().numpy().copy()
                                     for n, g in grads.items()})
            return super().update(grads, state, params_, **kw)

    opt = Recording(learning_rate=cosine_schedule(1e-3, 1, TRAIN_STEPS))
    model.requires_grad_(True)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(ta, opt, TrainerConfig(microbatches=TRAIN_K))
    got = [float(step(model, state, b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_g = convert.lm_flat(ta, _KEPT["repro"])
    assert want_g.keys() == kept["port"].keys()
    for k, g in kept["port"].items():
        _close(g, want_g[k], rel=1e-5)


@pytest.mark.parametrize("name", [WHISPER, PIXTRAL])
def test_init_params_matches_param_specs(name):
    """Same names, shapes and dtypes as repro's param_specs (the encoder's
    stacked layers split into ``encoder.layers.{j}``); pos_embed at 0.02,
    the cross-attention's matrices at fan_in ** -0.5, norms 1."""
    specs = jlm.param_specs(j_smoke(name))
    ta = get_smoke_config(name)
    model = lm.init_params(ta, seed=3, device="cpu")
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), specs)
    want = {k: (tuple(a.shape), str(a.dtype))
            for k, a in convert.lm_flat(ta, zeros).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    assert got == want
    sd = model.state_dict()
    D = ta.d_model
    if name == WHISPER:
        assert float(sd["encoder.pos_embed"].float().std()) == \
            pytest.approx(0.02, rel=0.2)
        assert bool((sd["layers.1.norm_x.scale"] == 1).all())
        assert float(sd["layers.0.xattn.wk"].float().std()) == \
            pytest.approx(D ** -0.5, rel=0.2)
        assert "xattn" not in " ".join(k for k in sd if "encoder" in k)
    else:
        assert not any(k.startswith("encoder") for k in sd)


@pytest.mark.parametrize("name", [WHISPER, PIXTRAL])
def test_params_and_caches_round_trip(name):
    """bf16 weights cross both ways bit for bit; a cache carried across
    from repro mid-sequence (whisper's with its cross k and v) round-trips
    exactly and resumes decoding."""
    ja = dataclasses.replace(j_smoke(name), dtype="bfloat16")
    ta = dataclasses.replace(get_smoke_config(name), dtype="bfloat16")
    tree = jax.tree.map(lambda a, s: a.astype(s.dtype),
                        _repro_tree(dataclasses.replace(ja, dtype="float32")),
                        jlm.param_specs(ja))
    model = convert.lm_params_from_numpy(ta, tree, "cpu")
    back = convert.lm_params_to_numpy(model)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a, np.float32), b), tree,
        back))

    ja, ta = _archs("whisper" if name == WHISPER else "pixtral")
    params, model = _pair(ja, ta)
    toks = _tokens(ja.vocab_size, S=16)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 16))
    if ja.is_encdec:
        jcache["cross"] = _jcross(ja, params, _extras(ta)["frames"])
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    for t in range(10):
        _, jcache = jdec(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "cache": jcache, "pos": jnp.int32(t)})
    host = jax.tree.map(np.asarray, jcache)
    cache = convert.cache_from_numpy(ta, host, "cpu")
    assert ("cross_k" in cache) == ja.is_encdec
    assert jax.tree.all(jax.tree.map(np.array_equal,
                                     convert.cache_to_numpy(ta, cache),
                                     host))
    for t in range(10, 16):
        jlog, jcache = jdec(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                     "cache": jcache, "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)


@pytest.mark.parametrize("name", [WHISPER, PIXTRAL])
def test_generate_matches_repro(name):
    """``BatchedServer.generate``'s tokens (prompt 12 + 12) equal repro's:
    whisper's against repro's zero cross cache; pixtral decodes no
    patches, in repro too."""
    ja, ta = _archs("whisper" if name == WHISPER else "pixtral")
    params, model = _pair(ja, ta)
    prompts = _tokens(ja.vocab_size, S=12)
    want = JServer(ja, params, 24).generate(prompts, 12)
    got = BatchedServer(ta, model, 24).generate(prompts, 12)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_with_frames_matches_repro():
    """With frames, generate fills the cross cache first: its tokens equal
    repro's greedy decode loop (its server's) on a ``cache["cross"]``
    built from the same frames."""
    ja, ta = _archs("whisper")
    params, model = _pair(ja, ta)
    prompts, frames = _tokens(ja.vocab_size, S=12), _extras(ta)["frames"]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 24))
    jcache["cross"] = _jcross(ja, params, frames)
    jdec = jax.jit(lambda p, b: jlm.decode_step(p, ja, b))
    for t in range(12):
        logits, jcache = jdec(params, {
            "tokens": jnp.asarray(prompts[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
    want, tok = [], jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    for t in range(12):
        want.append(np.asarray(tok))
        logits, jcache = jdec(params, {"tokens": tok[:, None],
                                       "cache": jcache,
                                       "pos": jnp.int32(12 + t)})
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    got = BatchedServer(ta, model, 24).generate(prompts, 12,
                                                {"frames": frames})
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    zeros = BatchedServer(ta, model, 24).generate(prompts, 12)
    assert not np.array_equal(got, zeros)


def test_serve_cli_refuses_encdec_and_serves_pixtral(capsys):
    with pytest.raises(SystemExit,
                       match="use the audio pipeline for enc-dec archs"):
        serve.main(["--arch", WHISPER, "--smoke", "--device", "cpu"])
    serve.main(["--arch", PIXTRAL, "--smoke", "--batch", "2",
                "--prompt-len", "8", "--gen-len", "4", "--device", "cpu"])
    assert "arch=pixtral-smoke generated (2, 4)" in capsys.readouterr().out


def test_full_configs_are_ported():
    """Both archs pass ``check_ported`` at full size, their heads are K5
    head dimensions of its wgmma body (whisper 64, pixtral 128), and the
    whisper-large-v3 cache holds a (B, 20, 1500, 64) cross k and v a
    layer."""
    for name in (WHISPER, PIXTRAL):
        lm.check_ported(get_config(name))
        assert lm.has_attention(get_config(name))
    assert get_config(WHISPER).head_dim_ == 64
    assert get_config(PIXTRAL).head_dim_ == 128
    smoke = dataclasses.replace(get_smoke_config(WHISPER), encoder_seq=6)
    cache = lm.init_cache(smoke, 3, 5, "cpu")
    assert sorted(cache) == ["cross_k", "cross_v", "k", "v"]
    assert cache["cross_k"][1].shape == (3, 4, 6, 16)
