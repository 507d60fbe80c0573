"""The tile logic of the flash attention kernel's wgmma body (K5), held
on the CPU before the card runs it.

* ``dispatch.flash_tile_plan`` (the Python mirror of the live key tiles
  the producer loads and the tiles the consumers mask) against the skip
  test of repro's kernel.py:56-64 and a brute-force search for hidden
  (query, key) pairs, at small tiles and at the kernel's 128 x 128.
* A blocked f32 evaluator that follows the plan as the kernel does
  (running max of the raw scores, -inf only on the flagged tiles, the
  scale folded into log2(e), optionally P rounded to bf16 before P V)
  against repro's ``attention_ref`` on numpy inputs from a seed: every
  ATTN_CASES shape of tests/test_torch_attention.py plus ragged, window,
  Sq < Sk and 4:1 GQA cases, at repro's bars (atol 2e-3 f32, 2e-2 with
  bf16 P and bf16 inputs). Where Sq > Sk leaves rows with no visible
  key, those rows are 0 and the others match the oracle.
* ``dispatch.flash_attention_route`` and ``dispatch.tma_strides_ok``,
  the pure functions the wrapper reads; the kernel constants the C
  source states against ``dispatch``; ``_build`` hashing every header.
"""
import math
import pathlib
import re
import shutil

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.flash_attention import flash_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BQ, BK = dispatch.FLASH_WGMMA_BLOCK_Q, dispatch.FLASH_WGMMA_BLOCK_K

CASES = [
    # B, Hq, Hkv, Sq, Sk, D, causal, window: test_torch_attention.ATTN_CASES
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 2, 256, 256, 64, True, 64),
    (1, 4, 4, 100, 100, 32, True, 0),
    (1, 2, 1, 1, 384, 64, True, 0),
    (1, 2, 1, 1, 384, 64, True, 128),
    (2, 2, 2, 64, 64, 128, False, 0),
    (1, 4, 2, 100, 100, 160, True, 0),
    # ragged over several tiles, a window inside one tile and across
    # tiles, Sq < Sk, 4:1 GQA over a partial last tile, bidirectional
    # Sq < Sk
    (1, 4, 2, 300, 300, 64, True, 0),
    (1, 8, 2, 300, 300, 128, True, 100),
    (1, 2, 1, 260, 260, 64, True, 200),
    (2, 2, 1, 130, 400, 64, True, 0),
    (1, 2, 2, 70, 333, 128, True, 150),
    (1, 8, 2, 1000, 1000, 128, True, 0),
    (1, 4, 1, 128, 256, 64, False, 0),
]


def _qkv(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.3 * rng.standard_normal((B, Hq, Sq, D))).astype(np.float32)
    k = (0.3 * rng.standard_normal((B, Hkv, Sk, D))).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _pad_rows(x, mult):
    pad = -x.shape[2] % mult
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def blocked_attention(q, k, v, causal, window, block_q=BQ, block_k=BK,
                      bf16_p=False):
    """The wgmma body's arithmetic in f32 on numpy (B, H, S, D) inputs:
    per query tile of ``flash_tile_plan``, the live key tiles in order
    (q, k and v zero past their lengths, as TMA fills them), -inf where a
    flagged tile hides a pair, the running max m of the raw scores (a row
    whose m is still -inf scales against 0), P = 2^(s c - m c) with c =
    scale log2(e), the running sum, P (rounded to bf16 if ``bf16_p``)
    times v, and o = acc / max(l, 1e-30)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qt = _pad_rows(torch.from_numpy(q), block_q)
    kt = _pad_rows(torch.from_numpy(k), block_k).repeat_interleave(g, 1)
    vt = _pad_rows(torch.from_numpy(v), block_k).repeat_interleave(g, 1)
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    out = torch.empty_like(qt)
    for iq, (lo, hi, masked) in enumerate(
            dispatch.flash_tile_plan(Sq, Sk, causal, window, block_q,
                                     block_k)):
        rows = slice(iq * block_q, (iq + 1) * block_q)
        qpos = iq * block_q + Sk - Sq + torch.arange(block_q)[:, None]
        m = torch.full((B, Hq, block_q, 1), -math.inf)
        l = torch.zeros((B, Hq, block_q, 1))
        acc = torch.zeros((B, Hq, block_q, D))
        for kt_i, flag in zip(range(lo, hi), masked):
            cols = slice(kt_i * block_k, (kt_i + 1) * block_k)
            s = qt[:, :, rows] @ kt[:, :, cols].transpose(-1, -2)
            if flag:
                kpos = kt_i * block_k + torch.arange(block_k)[None, :]
                live = kpos < Sk
                if causal:
                    live = live & (kpos <= qpos)
                if window > 0:
                    live = live & (kpos > qpos - window)
                s = torch.where(live, s, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            ms = torch.where(m_new == -math.inf, 0.0, m_new) * scale_log2
            alpha = torch.exp2(m * scale_log2 - ms)
            p = torch.exp2(s * scale_log2 - ms)
            l = alpha * l + p.sum(-1, keepdim=True)
            if bf16_p:
                p = p.bfloat16().float()
            acc = alpha * acc + p @ vt[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)
    return out[:, :, :Sq].numpy()


def _hidden(qpos, kpos, Sk, causal, window):
    hidden = (kpos >= Sk) & (qpos == qpos)
    if causal:
        hidden = hidden | (kpos > qpos)
    if window > 0:
        hidden = hidden | (kpos <= qpos - window)
    return hidden


PLAN_SHAPES = [(Sq, Sk, causal, window)
               for Sq, Sk in ((1, 40), (37, 37), (64, 64), (40, 19),
                              (19, 57), (100, 100))
               for causal in (True, False)
               for window in (0, 1, 7, 16, 30)
               if causal or window or Sq <= Sk]


@pytest.mark.parametrize("Sq,Sk,causal,window", PLAN_SHAPES)
@pytest.mark.parametrize("block_q,block_k", [(16, 8), (8, 16), (BQ, BK)])
def test_tile_plan_matches_skip_test_and_hidden_pairs(Sq, Sk, causal, window,
                                                      block_q, block_k):
    plan = dispatch.flash_tile_plan(Sq, Sk, causal, window, block_q, block_k)
    assert len(plan) == -(-Sq // block_q)
    n_k = -(-Sk // block_k)
    for iq, (lo, hi, masked) in enumerate(plan):
        q_lo = iq * block_q + Sk - Sq
        q_hi = q_lo + block_q - 1
        live = [kt for kt in range(n_k)
                if (not causal or kt * block_k <= q_hi)
                and (window == 0 or (kt + 1) * block_k - 1 > q_lo - window)]
        assert list(range(lo, hi)) == live, (iq, lo, hi, live)
        assert len(masked) == hi - lo
        qpos = np.arange(q_lo, q_hi + 1)[:, None]
        for kt, flag in zip(range(lo, hi), masked):
            kpos = np.arange(kt * block_k, (kt + 1) * block_k)[None, :]
            assert flag == bool(_hidden(qpos, kpos, Sk, causal,
                                        window).any()), (iq, kt)


def test_tile_plan_at_the_prefill_shape():
    """llama3-8b at S 8192, causal: query tile iq loads key tiles 0..iq
    and masks only the diagonal one; 2,080 of the 4,096 tile pairs live."""
    plan = dispatch.flash_tile_plan(8192, 8192, True, 0, BQ, BK)
    assert len(plan) == 64
    for iq, (lo, hi, masked) in enumerate(plan):
        assert (lo, hi) == (0, iq + 1)
        assert masked == (False,) * iq + (True,)
    assert sum(hi - lo for lo, hi, _ in plan) == 2080
    # Bidirectional: only a tile that reaches past Sk is masked.
    plan = dispatch.flash_tile_plan(512, 512, False, 0, BQ, BK)
    assert all(m == (False,) * 4 for _, _, m in plan)
    plan = dispatch.flash_tile_plan(300, 300, False, 0, BQ, BK)
    assert all(m == (False, False, True) for _, _, m in plan)


@pytest.mark.parametrize("case", CASES)
def test_blocked_evaluator_matches_repro_f32(case):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D)
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window))
    got = blocked_attention(q, k, v, causal, window)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_blocked_evaluator_with_bf16_p_matches_repro(case):
    """bf16 inputs (as the kernel reads them) and P rounded to bf16 before
    P V, as the wgmma body's register A operand; repro's bf16 bar."""
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in _qkv(B, Hq, Hkv, Sq, Sk, D, seed=1))
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window))
    got = blocked_attention(q, k, v, causal, window, bf16_p=True)
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_unmasked_plan_would_fail(monkeypatch):
    """The evaluator sees the masks: skipping the flagged tiles' mask
    breaks the match, so the tests above hold the flags."""
    q, k, v = _qkv(1, 2, 1, 300, 300, 64, seed=2)
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True))
    orig = dispatch.flash_tile_plan
    monkeypatch.setattr(dispatch, "flash_tile_plan", lambda *a: [
        (lo, hi, (False,) * (hi - lo)) for lo, hi, _ in orig(*a)])
    got = blocked_attention(q, k, v, True, 0)
    assert np.abs(got - want).max() > 0.1


@pytest.mark.parametrize("Sq,Sk", [(300, 200), (200, 130), (70, 10)])
def test_rows_without_keys_are_zero(Sq, Sk):
    """Sq > Sk under a causal mask leaves rows with no visible key: the
    wgmma body gives them 0 (their max stays -inf, so every probability
    is 0), whatever the tiles; every other row matches the oracle."""
    q, k, v = _qkv(1, 2, 1, Sq, Sk, 64, seed=3)
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True))
    got = blocked_attention(q, k, v, True, 0)
    dead = np.arange(Sq) + Sk - Sq < 0
    assert dead.any() and not np.abs(got[:, :, dead]).any()
    np.testing.assert_allclose(got[:, :, ~dead], want[:, :, ~dead],
                               atol=2e-3)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 160, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 32, "simt"), (torch.float32, 160, "simt"),
    ("bfloat16", 128, "wgmma"), ("float32", 128, "simt")])
def test_route_by_type_and_head_dim(dtype, D, route):
    assert dispatch.flash_attention_route(dtype, D) == route


def test_every_serving_config_routes_bf16_to_a_built_body():
    from repro_torch.configs import get_config, list_archs
    for name in list_archs():
        arch = get_config(name)
        D = arch.head_dim_
        if D not in dispatch.FLASH_HEAD_DIMS:
            continue
        route = dispatch.flash_attention_route(arch.torch_dtype, D)
        assert route == ("wgmma" if D in (64, 128) else "simt"), name


def test_tma_stride_rule():
    ok = dispatch.tma_strides_ok
    q = torch.empty(1, 32, 8192, 128, dtype=torch.bfloat16)
    assert ok(q.stride(), 0, 2)
    # project_qkv's v: a transposed view, sequence stride Hkv * D.
    v = torch.empty(2, 200, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert v.stride() == (204800, 128, 1024, 1) and ok(v.stride(), 256, 2)
    assert ok((4096, 512, 64, 1), 16, 2)            # D = 64
    assert not ok((4096, 512, 36, 1), 16, 2)        # 72-byte rows
    assert not ok((4096, 512, 64, 1), 8, 2)         # 8-byte aligned start
    assert not ok((4096, 512, 1, 64), 16, 2)        # D not contiguous
    assert not ok((4096, 0, 64, 1), 16, 2)          # broadcast head
    assert not ok((2 ** 40, 512, 64, 1), 16, 2)     # beyond TMA's range
    assert ok((4096, 512, 4, 1), 16, 4)             # f32: 16-byte rows
    assert not ok((4096, 512, 4, 1), 16, 2)         # bf16: 8-byte rows


def test_wgmma_route_refuses_before_the_card(monkeypatch):
    """A forced body that does not exist for (dtype, D) raises in the
    wrapper; an operand TMA cannot describe is copied into fresh storage
    and goes on to the launch (here: to the build, stopped before nvcc)."""
    from repro_torch.kernels.flash_attention import ops
    q = torch.zeros(1, 2, 8, 64)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="no 'wgmma' body"):
        ops._launch(q, q, q, True, 0, 0.125, route="wgmma")
    qb = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no 'wgmma' body"):
        ops._launch(qb, qb, qb, True, 0, 0.125, route="wgmma")
    x = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., 4:]
    seen = []

    def build_stop(name, declare):
        raise LookupError(name)
    monkeypatch.setattr(ops._build, "load", build_stop)
    real = ops._readable
    monkeypatch.setattr(ops, "_readable",
                        lambda t, route: seen.append(real(t, route))
                        or seen[-1])
    with pytest.raises(LookupError, match="flash_attention"):
        ops._launch(x, x, x, True, 0, 0.125)
    assert len(seen) == 3 and all(
        t.is_contiguous() and t.data_ptr() != x.data_ptr()
        and torch.equal(t, x) for t in seen)
    assert flash_attention.route_launches == {"wgmma": 0, "simt": 0}


def test_kernel_constants_match_dispatch():
    """Each ``constexpr`` that csrc/flash_attention.cu ties to a
    ``dispatch`` name (``// dispatch.NAME``) has its value."""
    src = (CSRC / "flash_attention.cu").read_text()
    found = re.findall(
        r"constexpr int (\w+) = (\d+);\s*// dispatch\.(\w+)", src)
    names = {n for _, _, n in found}
    assert {"FLASH_BLOCK_Q", "FLASH_BLOCK_K", "FLASH_PAD",
            "FLASH_WGMMA_BLOCK_Q", "FLASH_WGMMA_BLOCK_K",
            "FLASH_WGMMA_STAGES"} <= names
    for _, value, name in found:
        assert int(value) == getattr(dispatch, name), name


def test_build_hashes_every_header(tmp_path, monkeypatch):
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    assert headers and set(headers) <= set(_build._HEADERS)
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build.library_path("flash_attention")
    for name in headers:
        with open(copy / name, "a") as f:
            f.write("\n// edited\n")
        after = _build.library_path("flash_attention")
        assert after != before, name
        before = after
