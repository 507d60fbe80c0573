"""The port's kernel modules on the CPU: their plain versions against
repro's, the Hopper budget table, and the no-fallback build contract.

* gram_t_ref against repro's gram_t(..., interpret=True) over the
  test_gram_kernel_sweep shapes at f32 (rtol 2e-4, atol 2e-4 sqrt(m): the
  JAX sweep's own bar).
* sa_inner_ref against repro's sa_inner_ref (the Pallas sa_inner kernel
  does not run in interpret mode on jax 0.9) over the
  test_sa_inner_kernel_sweep cases plus a forced-collision case: rtol 1e-4
  / atol 1e-5 at f32 in-process, 1e-12 at f64 from one x64 subprocess.
* svm_inner_ref against repro's svm_inner_ref (its Pallas kernel does not
  run in interpret mode on jax 0.9 either) over the
  test_svm_inner_kernel_sweep cases at nu = 1 and nu = inf, ids drawn
  from 0..11 so blocks collide: theta rtol 1e-4 / atol 1e-5 and the dual
  increments rtol 1e-4 / atol 1e-4 at f32, 1e-12 at f64.
* ell_spmm_ref against repro's ell_spmm_ref over the
  test_spmm_kernel_sweep shapes plus R = 1, Q = 2 and rows with no
  nonzeros: rtol 1e-5 / atol 1e-6 at f32, 1e-12 at f64 (the same
  summation order, so in practice equal).
* The CUDA kernels themselves run only on a card (chip_smoke.py holds
  them against these plain versions there); here the wrappers must raise
  for anything they cannot launch rather than return a plain result.
"""
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import SparseOperand as JSparseOperand
from repro.kernels.gram import gram_t as j_gram_t
from repro.kernels.sa_inner.ref import sa_inner_ref as j_sa_inner_ref
from repro.kernels.spmm.ref import ell_spmm_ref as j_ell_spmm_ref
from repro.kernels.svm_inner.ref import svm_inner_ref as j_svm_inner_ref
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.gram import gram_t
from repro_torch.kernels.gram.ref import gram_t_ref
from repro_torch.kernels.sa_inner import sa_inner_loop
from repro_torch.kernels.spmm import ell_spmm
from repro_torch.kernels.svm_inner import svm_inner_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRAM_SHAPES = [(300, 65, 33), (1024, 128, 130), (64, 8, 8), (513, 257, 3),
               (129, 16, 16)]
# (s, mu, n): n is the id range, so n = 4 forces collisions.
INNER_CASES = [(4, 1, 64), (8, 4, 64), (16, 2, 64), (3, 5, 64), (6, 3, 4)]
# (s, mu, nu): the test_svm_inner_kernel_sweep cases; ids from 0..11.
SVM_CASES = [(s, mu, nu) for s, mu in ((4, 1), (8, 4), (16, 2), (3, 5))
             for nu in (1.0, float("inf"))]
# (R, C, Q, density): the test_spmm_kernel_sweep shapes, plus R = 1 and
# Q = 2 (the classical SVM at mu = 1) and a sparse one with empty rows.
SPMM_CASES = [(12, 40, 5, 0.3), (33, 128, 17, 0.05), (64, 200, 1, 0.5),
              (7, 16, 130, 0.4), (1, 50, 2, 0.2), (40, 300, 9, 0.004)]


def _svm_inputs(s, mu, nu, dtype=np.float32):
    rng = np.random.default_rng(s * 10 + mu)
    G0 = rng.standard_normal((64, s * mu))
    G = (G0.T @ G0 + 0.5 * np.eye(s * mu)).astype(dtype)
    proj = rng.standard_normal((s, mu)).astype(dtype)
    b = np.where(rng.standard_normal((s, mu)) < 0, -1.0, 1.0).astype(dtype)
    a_vals = (0.2 * rng.random((s, mu))).astype(dtype)
    idx = rng.integers(0, 12, (s, mu))
    return G, proj, b, a_vals, idx


def _spmm_inputs(R, C, Q, density, dtype=np.float32):
    """The ELL arrays of repro's SparseOperand for a random (R, C) S and
    a dense (C, Q) D."""
    rng = np.random.default_rng(R + C + Q)
    S = rng.standard_normal((R, C)).astype(np.float32)
    S[rng.random((R, C)) >= density] = 0.0
    op = JSparseOperand.from_dense(S)
    D = rng.standard_normal((C, Q)).astype(dtype)
    return (np.asarray(op.row_vals).astype(dtype), np.asarray(op.row_cols),
            np.asarray(op.row_blocks), D)


def _inner_inputs(s, mu, n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    G0 = rng.standard_normal((128, s * mu))
    G = (G0.T @ G0).astype(dtype)
    yp = rng.standard_normal((s, mu)).astype(dtype)
    zp = rng.standard_normal((s, mu)).astype(dtype)
    zv = (0.1 * rng.standard_normal((s, mu))).astype(dtype)
    idx = rng.integers(0, n, (s, mu))
    th = np.linspace(0.5, 0.1, s).astype(dtype)
    coefU = ((1.0 - 16 * th) / (th * th)).astype(dtype)
    return G, yp, zp, zv, idx, th, coefU


@pytest.mark.parametrize("m,p,q", GRAM_SHAPES)
def test_gram_ref_matches_repro_interpret(m, p, q):
    rng = np.random.default_rng(m + p + q)
    x = rng.standard_normal((m, p)).astype(np.float32)
    y = rng.standard_normal((m, q)).astype(np.float32)
    want = np.asarray(j_gram_t(jnp.asarray(x), jnp.asarray(y),
                               interpret=True))
    got = gram_t(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (p, q)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * m ** 0.5)
    np.testing.assert_array_equal(
        got.numpy(), gram_t_ref(torch.from_numpy(x),
                                torch.from_numpy(y)).numpy())


@pytest.mark.parametrize("s,mu,n", INNER_CASES)
def test_sa_inner_ref_matches_repro_f32(s, mu, n):
    G, yp, zp, zv, idx, th, coefU = _inner_inputs(s, mu, n)
    dz_j, eta_j = j_sa_inner_ref(*(jnp.asarray(a) for a in
                                   (G, yp, zp, zv, idx, th, coefU)),
                                 16.0, 0.3, 0.05)
    dz, eta = sa_inner_loop(*(torch.from_numpy(a) for a in
                              (G, yp, zp, zv, idx, th, coefU)),
                            q=16.0, lam1=0.3, lam2=0.05)
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(eta.numpy(), np.asarray(eta_j), rtol=1e-4)


@pytest.mark.parametrize("s,mu,nu", SVM_CASES)
def test_svm_inner_ref_matches_repro_f32(s, mu, nu):
    ins = _svm_inputs(s, mu, nu)
    th_j, d_j = j_svm_inner_ref(*(jnp.asarray(a) for a in ins), 0.3, nu)
    th, d = svm_inner_loop(*(torch.from_numpy(a) for a in ins), gamma=0.3,
                           nu=nu)
    assert th.dtype == torch.float32 and th.shape == (s, mu)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-4,
                               atol=1e-4)
    if nu == 1.0:
        assert float(th.max()) <= 1.0 and (th.numpy() != 0).any()


@pytest.mark.parametrize("R,C,Q,density", SPMM_CASES)
def test_spmm_ref_matches_repro_f32(R, C, Q, density):
    vals, idx, blocks, D = _spmm_inputs(R, C, Q, density)
    want = np.asarray(j_ell_spmm_ref(jnp.asarray(vals), jnp.asarray(idx),
                                     jnp.asarray(D)))
    got = ell_spmm(*(torch.from_numpy(a) for a in (vals, idx, blocks, D)))
    assert got.dtype == torch.float32 and got.shape == (R, Q)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    dense = np.zeros((R, C), np.float32)
    np.add.at(dense, (np.arange(R)[:, None], idx), vals)
    np.testing.assert_allclose(got.numpy(), dense @ D, rtol=1e-4, atol=1e-4)


_REF_CODE = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro.kernels.sa_inner.ref import sa_inner_ref
from repro.kernels.spmm.ref import ell_spmm_ref
from repro.kernels.svm_inner.ref import svm_inner_ref
d = np.load(sys.argv[1])
out = {}
for name in d.files:
    c = name.rsplit("/", 1)[0]
    if name.startswith("sa/") and name.endswith("/G"):
        args = [jnp.asarray(d[c + "/" + k]) for k in
                ("G", "yp", "zp", "zv", "idx", "th", "coefU")]
        dz, eta = sa_inner_ref(*args, 16.0, 0.3, 0.05)
        out[c + "/dz"], out[c + "/eta"] = np.asarray(dz), np.asarray(eta)
    elif name.startswith("svm/") and name.endswith("/G"):
        args = [jnp.asarray(d[c + "/" + k]) for k in
                ("G", "proj", "b", "a_vals", "idx")]
        th, dl = svm_inner_ref(*args, 0.3, float(d[c + "/nu"]))
        out[c + "/theta"], out[c + "/deltas"] = np.asarray(th), np.asarray(dl)
    elif name.startswith("spmm/") and name.endswith("/D"):
        args = [jnp.asarray(d[c + "/" + k]) for k in ("vals", "idx", "D")]
        out[c + "/out"] = np.asarray(ell_spmm_ref(*args))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inner_ref_f64(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_kernels")
    data = {}
    for s, mu, n in INNER_CASES:
        for k, a in zip(("G", "yp", "zp", "zv", "idx", "th", "coefU"),
                        _inner_inputs(s, mu, n, np.float64)):
            data[f"sa/{s}-{mu}-{n}/{k}"] = a
    for s, mu, nu in SVM_CASES:
        c = f"svm/{s}-{mu}-{nu}"
        for k, a in zip(("G", "proj", "b", "a_vals", "idx"),
                        _svm_inputs(s, mu, nu, np.float64)):
            data[f"{c}/{k}"] = a
        data[c + "/nu"] = np.asarray(nu)
    for case in SPMM_CASES:
        c = "spmm/" + "-".join(map(str, case))
        vals, idx, _, D = _spmm_inputs(*case, dtype=np.float64)
        data.update({c + "/vals": vals, c + "/idx": idx, c + "/D": D})
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_CODE,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("s,mu,n", INNER_CASES)
def test_sa_inner_ref_matches_repro_f64(s, mu, n, inner_ref_f64):
    ins = _inner_inputs(s, mu, n, np.float64)
    dz, eta = sa_inner_loop(*(torch.from_numpy(a) for a in ins),
                            q=16.0, lam1=0.3, lam2=0.05)
    assert dz.dtype == torch.float64
    np.testing.assert_allclose(dz.numpy(),
                               inner_ref_f64[f"sa/{s}-{mu}-{n}/dz"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(eta.numpy(),
                               inner_ref_f64[f"sa/{s}-{mu}-{n}/eta"],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s,mu,nu", SVM_CASES)
def test_svm_inner_ref_matches_repro_f64(s, mu, nu, inner_ref_f64):
    th, d = svm_inner_loop(*(torch.from_numpy(a) for a in
                             _svm_inputs(s, mu, nu, np.float64)),
                           gamma=0.3, nu=nu)
    assert th.dtype == torch.float64
    c = f"svm/{s}-{mu}-{nu}"
    np.testing.assert_allclose(th.numpy(), inner_ref_f64[c + "/theta"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(d.numpy(), inner_ref_f64[c + "/deltas"],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_ref_matches_repro_f64(case, inner_ref_f64):
    ins = _spmm_inputs(*case, dtype=np.float64)
    got = ell_spmm(*(torch.from_numpy(a) for a in ins))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(), inner_ref_f64["spmm/" + "-".join(map(str, case))
                                   + "/out"], rtol=1e-12, atol=1e-12)


def test_zero_block_sa_inner_finite():
    """A fully-zero diagonal Gram block (and zero projections) gives a
    finite eta and a zero step, as repro's reference does."""
    s, mu = 4, 2
    G, yp, zp, _, _, th, coefU = _inner_inputs(s, mu, 64, seed=5)
    G[2 * mu:3 * mu, :] = 0.0
    G[:, 2 * mu:3 * mu] = 0.0
    yp[2] = 0.0
    zp[2] = 0.0
    zv = np.zeros((s, mu), np.float32)
    idx = np.arange(s * mu).reshape(s, mu)
    coefU = ((1.0 - 8 * th) / (th * th)).astype(np.float32)
    ins = (G, yp, zp, zv, idx, th, coefU)
    dz, eta = sa_inner_loop(*(torch.from_numpy(a) for a in ins),
                            q=8.0, lam1=0.3)
    dz_j, _ = j_sa_inner_ref(*(jnp.asarray(a) for a in ins), 8.0, 0.3)
    assert torch.isfinite(dz).all() and torch.isfinite(eta).all()
    assert (dz[2] == 0).all()
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), rtol=1e-4,
                               atol=1e-5)


def test_build_without_nvcc_raises(monkeypatch):
    """A build request with no CUDA compiler is an error naming nvcc, not
    a quiet switch to the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("gram", lambda lib: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["sa_inner"])


def test_nvcc_lookup_reports_missing_compiler(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_wrappers_refuse_devices_and_dtypes_they_cannot_run():
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gram_t(x, x)
    with pytest.raises(TypeError):
        gram_t(torch.zeros(8, 4, dtype=torch.float16),
               torch.zeros(8, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        gram_t(torch.zeros(8, 4), torch.zeros(7, 4))
    ins = [torch.from_numpy(a) for a in _inner_inputs(4, 2, 64)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        sa_inner_loop(*(t.to("meta") for t in ins), q=8.0, lam1=0.3)
    with pytest.raises(TypeError):
        sa_inner_loop(*ins[:4], ins[4].to(torch.int32), *ins[5:],
                      q=8.0, lam1=0.3)
    with pytest.raises(ValueError, match="shape"):
        sa_inner_loop(ins[0][:4, :4], *ins[1:], q=8.0, lam1=0.3)
    sv = [torch.from_numpy(a) for a in _svm_inputs(4, 2, 1.0)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        svm_inner_loop(*(t.to("meta") for t in sv), gamma=0.3, nu=1.0)
    with pytest.raises(TypeError):
        svm_inner_loop(*sv[:4], sv[4].to(torch.int32), gamma=0.3, nu=1.0)
    with pytest.raises(TypeError):
        svm_inner_loop(sv[0].to(torch.float16), *sv[1:], gamma=0.3, nu=1.0)
    with pytest.raises(ValueError, match="shape"):
        svm_inner_loop(sv[0][:4, :4], *sv[1:], gamma=0.3, nu=1.0)
    sp = [torch.from_numpy(a) for a in _spmm_inputs(12, 40, 5, 0.3)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ell_spmm(*(t.to("meta") for t in sp))
    with pytest.raises(TypeError):
        ell_spmm(sp[0], sp[1].to(torch.int64), *sp[2:])
    with pytest.raises(TypeError):
        ell_spmm(sp[0].to(torch.float16), *sp[1:3], sp[3].to(torch.float16))
    with pytest.raises(ValueError, match="ell_block"):
        ell_spmm(*sp, ell_block=7)
    with pytest.raises(ValueError):
        ell_spmm(sp[0], sp[1], sp[2][:5], sp[3])


def test_sa_inner_smem_budget():
    """G stays in shared memory on the main path (s=16, mu=8) at f32 and
    f64, and moves to global memory at (64, 8); the chosen footprint
    always fits a block's 227 KB."""
    assert dispatch.sa_inner_g_in_smem(16, 8, 4)
    assert dispatch.sa_inner_g_in_smem(16, 8, 8)
    assert not dispatch.sa_inner_g_in_smem(64, 8, 4)
    assert dispatch.sa_inner_smem_bytes(16, 8, 4) == 128 * 8 + (
        128 * 128 + 128 + 48 + 16 * 2 * 8) * 4
    for itemsize, limit in ((4, 238), (8, 167)):
        assert dispatch.sa_inner_g_in_smem(limit, 1, itemsize)
        assert not dispatch.sa_inner_g_in_smem(limit + 1, 1, itemsize)
    for s, mu in ((16, 8), (64, 8), (4, 1), (240, 1)):
        for itemsize in (4, 8):
            g = dispatch.sa_inner_g_in_smem(s, mu, itemsize)
            assert dispatch.sa_inner_smem_bytes(s, mu, itemsize, g) \
                <= dispatch.SMEM_PER_BLOCK


def test_svm_inner_smem_budget():
    """K3's G stays in shared memory at the SVM path's (64, 1) and at
    (16, 8), and moves to global memory at (64, 8); the chosen footprint
    always fits a block's 227 KB."""
    assert dispatch.svm_inner_g_in_smem(64, 1, 4)
    assert dispatch.svm_inner_g_in_smem(16, 8, 8)
    assert not dispatch.svm_inner_g_in_smem(64, 8, 4)
    assert dispatch.svm_inner_smem_bytes(64, 1, 4) == 64 * 8 + (
        64 * 64 + 3 * 64 + 64 + 16 * 2) * 4
    for itemsize, limit in ((4, 238), (8, 167)):
        assert dispatch.svm_inner_g_in_smem(limit, 1, itemsize)
        assert not dispatch.svm_inner_g_in_smem(limit + 1, 1, itemsize)
    for s, mu in ((64, 1), (16, 8), (64, 8), (3, 5), (300, 1)):
        for itemsize in (4, 8):
            g = dispatch.svm_inner_g_in_smem(s, mu, itemsize)
            assert dispatch.svm_inner_smem_bytes(s, mu, itemsize, g) \
                <= dispatch.SMEM_PER_BLOCK


@pytest.mark.parametrize("Q,tiles", [(1, 1), (65, 1), (256, 1), (257, 2),
                                     (130, 1), (1000, 4)])
def test_spmm_q_tiles_cover_q(Q, tiles):
    assert dispatch.spmm_q_tiles(Q) == tiles
    assert (tiles - 1) * dispatch.SPMM_Q_TILE < Q <= \
        tiles * dispatch.SPMM_Q_TILE


@pytest.mark.parametrize("m,p,q", [(400_000, 128, 130), (513, 257, 3),
                                   (31, 8, 10), (1, 1, 1)])
def test_gram_splits_cover_m(m, p, q):
    splits, rows = dispatch.gram_splits(m, p, q, 132)
    assert rows % dispatch.GRAM_BLOCK_K == 0
    assert (splits - 1) * rows < m <= splits * rows
    if m == 400_000:
        assert splits == 88
