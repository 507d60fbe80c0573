"""The port's flash attention (K5) on the CPU: its plain path against
repro's Pallas kernel in interpret mode and repro's oracle, the chunked
path, the dispatch, the backward, and the wrapper's refusals.

* flash_attention (a CPU tensor -> the plain version) against repro's
  flash_attention(..., interpret=True) and attention_ref over every
  test_kernels.ATTN_CASES entry and a D = 160 case (stablelm-12b's head
  dimension), at f32 (atol 2e-3) and bf16 (atol 2e-2): the JAX sweep's own
  bars. Inputs are numpy draws from a seed.
* attention_chunked against repro's at test_attention_chunked_matches_ref's
  four cases (q_chunk 64, atol 2e-3).
* Gradients of the port's flash_attention against jax.grad of repro's
  (interpret mode) at atol 2e-3, test_flash_attention_backward_matches_ref's
  bar.
* A bidirectional call at ragged lengths runs (repro refuses it only on
  its Pallas path) and equals repro's non-Pallas flash_attention.
* The CUDA kernel runs only on a card: chip_smoke.py holds it against the
  plain version there. Here the wrapper must refuse what it cannot launch.
"""
import pathlib

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    attention_chunked as j_attention_chunked
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels import KERNEL_PACKAGES, dispatch
from repro_torch.kernels.flash_attention import (attention_chunked,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATTN_CASES = [
    # B, Hq, Hkv, Sq, Sk, D, causal, window  (test_kernels.ATTN_CASES)
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 2, 256, 256, 64, True, 64),
    (1, 4, 4, 100, 100, 32, True, 0),       # ragged
    (1, 2, 1, 1, 384, 64, True, 0),         # decode
    (1, 2, 1, 1, 384, 64, True, 128),       # decode + window
    (2, 2, 2, 64, 64, 128, False, 0),       # bidirectional (encoder)
    # not in test_kernels: stablelm-12b's head_dim, ragged
    (1, 4, 2, 100, 100, 160, True, 0),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.3 * rng.standard_normal((B, Hq, Sq, D))).astype(np.float32)
    k = (0.3 * rng.standard_normal((B, Hkv, Sk, D))).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_repro(case, dtype):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, Hq, Hkv, Sq, Sk, D), jdt, tdt)
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tdt and out.shape == (B, Hq, Sq, D)
    got = out.float().numpy()
    kernel = j_flash(jq, jk, jv, causal=causal, window=window,
                     interpret=True)
    oracle = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32), atol=tol)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), atol=tol)
    mine = attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(oracle, np.float32), atol=tol)


@pytest.mark.parametrize("Sq,Sk,window", [(256, 256, 0), (256, 256, 64),
                                          (100, 228, 0), (512, 512, 100)])
def test_attention_chunked_matches_repro(Sq, Sk, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 4, 2, Sq, Sk, 32, seed=1),
                                       jnp.float32, torch.float32)
    got = attention_chunked(tq, tk, tv, causal=True, window=window,
                            q_chunk=64).numpy()
    want = j_attention_chunked(jq, jk, jv, causal=True, window=window,
                               q_chunk=64)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)
    ref = attention_ref(tq, tk, tv, causal=True, window=window).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_cpu_dispatch_takes_chunked_path_from_threshold(monkeypatch):
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape[2])
        return attention_chunked(*a, **kw)

    monkeypatch.setattr(fa_ops, "attention_chunked", counted)
    for Sq in (fa_ops.CHUNKED_THRESHOLD - 1, fa_ops.CHUNKED_THRESHOLD):
        q, k, v = (torch.from_numpy(a)
                   for a in _qkv(1, 2, 1, Sq, Sq, 32, seed=2))
        out = flash_attention(q, k, v, causal=True, window=256)
        ref = attention_ref(q, k, v, causal=True, window=256)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-3)
    assert calls == [fa_ops.CHUNKED_THRESHOLD]
    assert flash_attention.launches == 0


def test_bidirectional_ragged_lengths_raise():
    """repro's Pallas path (interpret mode) refuses a bidirectional call
    at 200 x 200, since its padding would unmask keys; its non-Pallas path
    runs it, and so does the port (whose kernel pads nothing): the port's
    plain path equals repro's there (f32, atol 2e-3)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 200, 200, 32))
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    with pytest.raises(ValueError, match="bidirectional"):
        j_flash(jq, jk, jv, causal=False, interpret=True)
    got = flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_flash(jq, jk, jv, causal=False)),
                               atol=2e-3)
    flash_attention(q, k, v, causal=True)           # causal: fine
    flash_attention(q, k, v, causal=False, window=16)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_attention_gradient_matches_repro(window):
    arrays = _qkv(1, 2, 1, 64, 64, 32, seed=3)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]

    def f_repro(q, k, v):
        return j_flash(q, k, v, causal=True, window=window,
                       interpret=True).sum()

    want = jax.grad(f_repro, (0, 1, 2))(*jargs)
    flash_attention(*targs, causal=True, window=window).sum().backward()
    for t, w in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-3)


def test_wrapper_refuses_what_it_cannot_launch():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 32))
    # meta tensors (the dry run) take a shape-only path; the kernel itself
    # takes only cuda tensors
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="runs on cuda tensors"):
        fa_ops._launch(q, k, v, True, 0, 1.0)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v[..., :16])
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="empty"):
        flash_attention(q, k[:, :, :0], v[:, :, :0])


def test_flash_attention_smem_budget():
    """Each body's tiles fit a block's shared memory at every head
    dimension it serves. simt (f32 tiles): 115 KB at the model's D = 128,
    139 KB at stablelm-12b's D = 160. wgmma (bf16 Q and two stages of K
    and V, 1 KB of alignment slack, the barriers): 161 KB at D = 128,
    81 KB at D = 64, 201 KB at stablelm-12b's D = 160 (its 64-byte tail
    panel adds no padding; D padded to 192 would need 246,856 bytes)."""
    assert dispatch.flash_attention_smem_bytes(128) == 117_760
    assert dispatch.flash_attention_smem_bytes(160) == 142_336
    assert dispatch.flash_attention_smem_bytes(128, "wgmma") == 164_936
    assert dispatch.flash_attention_smem_bytes(64, "wgmma") == 83_016
    assert dispatch.flash_attention_smem_bytes(160, "wgmma") == 205_896
    assert dispatch.flash_attention_smem_bytes(192, "wgmma") == 246_856 \
        > dispatch.SMEM_PER_BLOCK
    for D in dispatch.FLASH_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            route = dispatch.flash_attention_route(dtype, D)
            assert dispatch.flash_attention_smem_bytes(D, route) \
                <= dispatch.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="route"):
        dispatch.flash_attention_smem_bytes(128, "tf32")


def test_every_kernel_package_has_a_source_and_a_counter():
    assert KERNEL_PACKAGES == ("gram", "sa_inner", "spmm", "svm_inner",
                               "flash_attention")
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for name in KERNEL_PACKAGES:
        assert (csrc / f"{name}.cu").is_file(), name
    assert flash_attention.launches == 0
    assert flash_attention.route_launches == {"wgmma": 0, "simt": 0}
