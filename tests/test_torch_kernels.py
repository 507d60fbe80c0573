"""The port's kernel modules on the CPU: their plain versions against
repro's, the Hopper budget table, and the no-fallback build contract.

* gram_t_ref against repro's gram_t(..., interpret=True) over the
  test_gram_kernel_sweep shapes at f32 (rtol 2e-4, atol 2e-4 sqrt(m): the
  JAX sweep's own bar).
* sa_inner_ref against repro's sa_inner_ref (the Pallas sa_inner kernel
  does not run in interpret mode on jax 0.9) over the
  test_sa_inner_kernel_sweep cases plus a forced-collision case: rtol 1e-4
  / atol 1e-5 at f32 in-process, 1e-12 at f64 from one x64 subprocess.
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

from repro.kernels.gram import gram_t as j_gram_t
from repro.kernels.sa_inner.ref import sa_inner_ref as j_sa_inner_ref
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.gram import gram_t
from repro_torch.kernels.gram.ref import gram_t_ref
from repro_torch.kernels.sa_inner import sa_inner_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRAM_SHAPES = [(300, 65, 33), (1024, 128, 130), (64, 8, 8), (513, 257, 3),
               (129, 16, 16)]
# (s, mu, n): n is the id range, so n = 4 forces collisions.
INNER_CASES = [(4, 1, 64), (8, 4, 64), (16, 2, 64), (3, 5, 64), (6, 3, 4)]


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


_REF_CODE = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro.kernels.sa_inner.ref import sa_inner_ref
d = np.load(sys.argv[1])
out = {}
for name in d.files:
    if name.endswith("/G"):
        c = name[:-2]
        args = [jnp.asarray(d[c + "/" + k]) for k in
                ("G", "yp", "zp", "zv", "idx", "th", "coefU")]
        dz, eta = sa_inner_ref(*args, 16.0, 0.3, 0.05)
        out[c + "/dz"], out[c + "/eta"] = np.asarray(dz), np.asarray(eta)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inner_ref_f64(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_kernels")
    data = {}
    for s, mu, n in INNER_CASES:
        for k, a in zip(("G", "yp", "zp", "zv", "idx", "th", "coefU"),
                        _inner_inputs(s, mu, n, np.float64)):
            data[f"{s}-{mu}-{n}/{k}"] = a
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
    np.testing.assert_allclose(dz.numpy(), inner_ref_f64[f"{s}-{mu}-{n}/dz"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(eta.numpy(),
                               inner_ref_f64[f"{s}-{mu}-{n}/eta"],
                               rtol=1e-12, atol=1e-12)


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


@pytest.mark.parametrize("m,p,q", [(400_000, 128, 130), (513, 257, 3),
                                   (31, 8, 10), (1, 1, 1)])
def test_gram_splits_cover_m(m, p, q):
    splits, rows = dispatch.gram_splits(m, p, q, 132)
    assert rows % dispatch.GRAM_BLOCK_K == 0
    assert (splits - 1) * rows < m <= splits * rows
    if m == 400_000:
        assert splits == 88
