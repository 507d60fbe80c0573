"""The port's dense LM serving path on the CPU, held against repro's on
the same numpy inputs and weights.

* Layers at f32, max |port - repro| <= 1e-5 max |repro|: rmsnorm,
  apply_rope (1-D and 2-D positions), attention_train (full, sliding
  window, QKV bias), attention_decode (a linear and a ring cache, several
  steps with the cache carried), the SwiGLU and 2-matrix MLPs.
* The LM on tinyllama-smoke, llama3-smoke, qwen-smoke and stablelm-smoke
  (heads of 20, GQA 2:1) with repro's
  weights carried across by convert.lm_params_from_numpy: at f32 the
  forward logits, prefill and every decode_step's logits (atol 1e-4 on
  logits of size ~4) and cache, and BatchedServer.generate's tokens
  equal to repro's; at bf16 the logits within repro's own train/serve
  bar (atol 0.12, rtol 0.05).
* The port's own decode-vs-forward consistency, init_params' names,
  shapes and dtypes against repro's param_specs, the refusal without a
  card, the recurrent kinds, the encoder-decoder and the vision stub
  building, the kernel's head dimensions against every ported arch with
  attention, and the serving CLI. The MoE and sliding-window blocks are
  held to repro in test_torch_moe.py, the recurrent ones in
  test_torch_recurrent.py, the encoder-decoder and the vision stub in
  test_torch_encdec.py.
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
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import layers as L
from repro_torch.models import lm

DENSE = ["tinyllama-1.1b", "llama3-8b", "qwen1.5-4b", "stablelm-12b"]


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _attn_params(rng, D, H, Hkv, Dh, bias):
    p = {"wq": rng.standard_normal((D, H * Dh)) * D ** -0.5,
         "wk": rng.standard_normal((D, Hkv * Dh)) * D ** -0.5,
         "wv": rng.standard_normal((D, Hkv * Dh)) * D ** -0.5,
         "wo": rng.standard_normal((H * Dh, D)) * (H * Dh) ** -0.5}
    if bias:
        p.update(bq=0.1 * rng.standard_normal(H * Dh),
                 bk=0.1 * rng.standard_normal(Hkv * Dh),
                 bv=0.1 * rng.standard_normal(Hkv * Dh))
    return {k: v.astype(np.float32) for k, v in p.items()}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 32), (1, 7, 64)])
def test_rmsnorm_matches_repro(shape):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(L.rmsnorm(_t(scale), _t(x)), want)


@pytest.mark.parametrize("pos_dims", [1, 2])
def test_apply_rope_matches_repro(pos_dims):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    pos = np.arange(9) + 5 if pos_dims == 1 else \
        rng.integers(0, 5000, (2, 9))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    _close(L.apply_rope(_t(x), torch.as_tensor(pos), 500000.0), want)


@pytest.mark.parametrize("window,bias", [(0, False), (5, False), (0, True)])
def test_attention_train_matches_repro(window, bias):
    rng = np.random.default_rng(2)
    D, H, Hkv, Dh, S = 32, 4, 2, 8, 12
    p = _attn_params(rng, D, H, Hkv, Dh, bias)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, rope_theta=1e4,
              window=window)
    want, (wk, wv) = JL.attention_train(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), **kw)
    got, (gk, gv) = L.attention_train({k: _t(v) for k, v in p.items()},
                                      _t(x), **kw)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("window,S,steps", [(0, 10, 10), (6, 6, 11)])
def test_attention_decode_matches_repro(window, S, steps):
    """Linear cache (slot min(pos, S - 1)) and a ring cache (slot
    pos % S, every slot live once pos >= S), the cache carried across
    ``steps`` steps."""
    rng = np.random.default_rng(3)
    D, H, Hkv, Dh, B = 32, 4, 2, 8, 2
    p = _attn_params(rng, D, H, Hkv, Dh, False)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, rope_theta=1e4,
              window=window)
    jk = jv = jnp.zeros((B, Hkv, S, Dh), jnp.float32)
    tk, tv = torch.zeros((B, Hkv, S, Dh)), torch.zeros((B, Hkv, S, Dh))
    for pos in range(steps):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        want, jk, jv = JL.attention_decode(jp, jnp.asarray(x), jk, jv,
                                           jnp.int32(pos), **kw)
        got, tk, tv = L.attention_decode(tp, _t(x), tk, tv, pos, **kw)
        _close(got, want)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("mlp_type,act", [("swiglu", "silu"),
                                          ("mlp2", "gelu")])
def test_mlp_matches_repro(mlp_type, act):
    rng = np.random.default_rng(4)
    D, Fd = 32, 48
    p = {"w_up": rng.standard_normal((D, Fd)) * D ** -0.5,
         "w_down": rng.standard_normal((Fd, D)) * Fd ** -0.5}
    if mlp_type == "swiglu":
        p["w_gate"] = rng.standard_normal((D, Fd)) * D ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), act=act)
    _close(L.mlp({k: _t(v) for k, v in p.items()}, _t(x), act=act), want)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

def _pair(name, dtype):
    """repro's params at ``dtype`` (biases made nonzero), the port's
    model with the same weights, and both configs."""
    ja = dataclasses.replace(j_smoke(name), dtype=dtype)
    ta = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(ja, jax.random.key(0)))
    if ja.qkv_bias:
        rng = np.random.default_rng(5)
        for b in ("bq", "bk", "bv"):
            leaf = tree["layers"]["slot0_attn_mlp"]["attn"][b]
            tree["layers"]["slot0_attn_mlp"]["attn"][b] = (
                0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    params = jax.tree.map(jnp.asarray, tree)
    return ja, ta, params, convert.lm_params_from_numpy(ta, tree, "cpu")


def _tokens(V, B=2, S=12, seed=6):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_lm_matches_repro_f32(name):
    ja, ta, params, model = _pair(name, "float32")
    toks = _tokens(ja.vocab_size)
    B, S = toks.shape
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks))
        last = model.prefill(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(
        jlm.prefill(params, ja, jnp.asarray(toks))), atol=1e-4)

    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, B, S))
    cache = lm.init_cache(ta, B, S, "cpu")
    for t in range(S):
        jlog, jcache = jlm.decode_step(params, ja, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)
    back = convert.cache_to_numpy(ta, cache)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(back["slot0_attn_mlp"][leaf],
                                   np.asarray(jcache["slot0_attn_mlp"][leaf]),
                                   atol=1e-5)

    prompts = toks[:, :6]
    want_tokens = JServer(ja, params, 14).generate(prompts, 8)
    got_tokens = BatchedServer(ta, model, 14).generate(prompts, 8)
    assert got_tokens.dtype == np.int32
    np.testing.assert_array_equal(got_tokens, want_tokens)


@pytest.mark.parametrize("name", DENSE)
def test_lm_matches_repro_bf16(name):
    ja, ta, params, model = _pair(name, "bfloat16")
    toks = _tokens(ja.vocab_size)
    want, _, _ = jlm.forward(params, ja, jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=0.12, rtol=0.05)


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_forward_last_position(name):
    """Teacher-forced decode through the cache reproduces the forward
    logits at the last position (the port's counterpart of
    test_models.test_decode_matches_forward_last_position, same bar)."""
    arch = get_smoke_config(name)
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


@pytest.mark.parametrize("name", DENSE)
def test_init_params_matches_param_specs(name):
    """Same names (the group axis unstacked into layers), shapes and
    dtypes as repro's param_specs; the draws at repro's scales."""
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
    sd = model.state_dict()
    assert float(sd["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    D = ta.d_model
    assert float(sd["layers.0.attn.wq"].float().std()) \
        == pytest.approx(D ** -0.5, rel=0.1)
    assert bool((sd["final_norm.scale"] == 1).all())
    again = lm.init_params(ta, seed=3, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(get_smoke_config("llama3-8b"), seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(get_smoke_config("llama3-8b"), 1, 4)


@pytest.mark.parametrize("name,pattern,kind", [
    ("xlstm-350m", ("slstm",), "slstm"),
    ("tinyllama-1.1b", ("mamba_mlp",), "mamba_mlp"),
    ("hymba-1.5b", None, "hybrid"), ("xlstm-350m", None, "mlstm")])
def test_recurrent_kinds_build_and_run(name, pattern, kind):
    """The four recurrent kinds, once refused, build and run a forward
    on the CPU (they are held to repro in test_torch_recurrent.py)."""
    arch = get_smoke_config(name)
    if pattern is not None:
        arch = dataclasses.replace(arch, block_pattern=pattern)
    assert kind in arch.block_pattern
    model = lm.init_params(arch, seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(arch.vocab_size, S=8))
    with torch.inference_mode():
        logits = model.forward(toks)
    assert logits.shape == (2, 8 + arch.meta_tokens, arch.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("name,kind", [
    ("whisper-large-v3", "encoder-decoder"), ("pixtral-12b", "vision_stub")])
def test_unported_archs_raise(name, kind):
    """The two archs once refused (the encoder-decoder, the vision stub)
    now build and run a forward on the CPU with their extras (they are
    held to repro in test_torch_encdec.py); none is refused any more."""
    arch = get_smoke_config(name)
    assert kind == ("encoder-decoder" if arch.is_encdec else arch.frontend)
    model = lm.init_params(arch, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    extras = {"frames": rng.standard_normal(
        (2, arch.encoder_seq, arch.d_model))} if arch.is_encdec else \
        {"patches": rng.standard_normal((2, arch.n_patches, arch.d_model))}
    toks = torch.as_tensor(_tokens(arch.vocab_size, S=8))
    extras = {k: torch.as_tensor(v, dtype=torch.float32)
              for k, v in extras.items()}
    with torch.inference_mode():
        logits = model.forward(toks, extras)
    n_prefix = 0 if arch.is_encdec else arch.n_patches
    assert logits.shape == (2, 8 + n_prefix, arch.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_flash_kernel_takes_every_ported_head_dim():
    """The port runs all ten archs: the four dense archs, the two MoE
    archs, hymba, xlstm, whisper and pixtral; each with an attention
    block has a head dimension the card's flash_attention kernel is built
    for, so its prefill launches there (xlstm-350m has none, and
    launches no kernel)."""
    def runs(arch):
        try:
            lm.check_ported(arch)
        except NotImplementedError:
            return False
        return True

    ported = [get_config(n) for n in list_archs() if runs(get_config(n))]
    assert sorted(a.name for a in ported) == sorted(
        ["llama3-8b", "tinyllama-1.1b", "qwen1.5-4b", "stablelm-12b",
         "mixtral-8x7b", "granite-moe-1b-a400m", "hymba-1.5b",
         "xlstm-350m", "whisper-large-v3", "pixtral-12b"])
    with_attention = [a for a in ported if lm.has_attention(a)]
    assert [a.name for a in ported if a not in with_attention] == \
        ["xlstm-350m"]
    for arch in with_attention:
        assert arch.head_dim_ in dispatch.FLASH_HEAD_DIMS, arch.name


def test_params_round_trip():
    ja, ta, params, model = _pair("qwen1.5-4b", "float32")
    back = convert.lm_params_to_numpy(model)
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                        params, back)
    assert jax.tree.all(same)
    with pytest.raises(RuntimeError):      # a leaf missing
        tree = jax.tree.map(np.asarray, params)
        del tree["final_norm"]
        convert.lm_params_from_numpy(ta, tree, "cpu")


def test_cache_from_numpy_resumes_decode():
    """A cache carried across from repro mid-sequence continues there."""
    ja, ta, params, model = _pair("llama3-8b", "float32")
    toks = _tokens(ja.vocab_size, S=8)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.cache_specs(ja, 2, 8))
    for t in range(5):
        _, jcache = jlm.decode_step(params, ja, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
    cache = convert.cache_from_numpy(ta, jax.tree.map(np.asarray, jcache),
                                     "cpu")
    for t in range(5, 8):
        jlog, jcache = jlm.decode_step(params, ja, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "cache": jcache,
            "pos": jnp.int32(t)})
        with torch.inference_mode():
            glog, cache = model.decode_step(
                torch.as_tensor(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(glog.numpy(), np.asarray(jlog), atol=1e-4)


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", "llama3-8b", "--smoke", "--batch", "2",
                "--prompt-len", "6", "--gen-len", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=llama3-smoke generated (2, 4)" in out
