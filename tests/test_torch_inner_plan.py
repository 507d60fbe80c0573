"""K2's Hopper design on the CPU: its route, layouts and arithmetic.

* ``dispatch.sa_inner_route``: ``warp`` exactly where mu <= 32, s mu <=
  256 and the warp body's layout fits a block's shared memory (s <= 238
  at f32, 168 at f64 for mu = 1), on a grid that straddles each cap;
  both bodies' layouts laid out array by array as ``csrc/sa_inner.cu``
  carves them; the power-iteration warps (a group of P lanes, the least
  power of two >= mu, per block) leave at least two warps to stage G;
  the ``// dispatch.NAME`` constants of ``sa_inner.cu``.
* An evaluator of the warp body's arithmetic: lambda_max by the
  register power iteration (sum over r = 0..mu-1, the P-lane butterfly,
  a division by the norm; the same bits as the block body's 32-lane
  butterfly), the chain right-looking (r carried per row from th^2
  y_proj + z_proj, each step's dz subtracted as G[row, col] ((th_row^2
  coefU_j - 1) dz) in step order; z from z_vals plus the dz of the
  earlier rows with the same id, in row order, as the kernel's walk
  adds them) and
  the prox's division by 1 + 2 eta lam2 as a product with its
  reciprocal. Held against repro's ``sa_inner_ref`` at the f32 bar
  ``chip_smoke.py`` uses (dz rtol 1e-4 / atol 1e-5, eta rtol 1e-4), and
  at f64 against the port's plain version (1e-12) and repro's with
  jax_enable_x64 (1e-12, one subprocess for this file); the cases force
  collisions, take mu = 1, s mu not a multiple of 32, an all-zero
  diagonal block (the tiny floor) and lam2 > 0.
* The wrapper: a forced route the body cannot take raises; the path's
  (16, 8) takes the warp body and reaches the build.
The kernel itself runs only on a card: chip_smoke.py holds both bodies
against the plain version there.
"""
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sa_inner.ref import sa_inner_ref as j_sa_inner_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.sa_inner import ops as sa_ops
from repro_torch.kernels.sa_inner import sa_inner_loop
from repro_torch.kernels.sa_inner.ref import sa_inner_ref

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels" / "csrc"
SMEM = dispatch.SMEM_PER_BLOCK
Q, LAM1 = 16.0, 0.3
# (s, mu, n_ids, lam2, zero diagonal block): the paths' (16, 8), with
# collisions and lam2 > 0; forced collisions at s mu = 18; s mu = 15;
# mu = 1 with collisions and at the f32 cap (238, eight rows a lane); an
# all-zero diagonal block, small and at (16, 8); a block of a full warp;
# mu = 20 (groups of 32 lanes, s mu = 140); s mu = 132.
CASES = [(16, 8, 2000, 0.0, None), (16, 8, 12, 0.01, None),
         (6, 3, 4, 0.0, None), (3, 5, 64, 0.05, None),
         (64, 1, 12, 0.0, None), (238, 1, 4000, 0.01, None),
         (4, 2, 64, 0.0, 2), (16, 8, 2000, 0.05, 5),
         (2, 32, 12, 0.0, None), (7, 20, 50, 0.01, None),
         (33, 4, 40, 0.0, None)]


def _case_id(case):
    return "-".join(str(c) for c in case)


# --------------------------------------------------------------------------
# Route and layouts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("s,mu", [(16, 8), (64, 8), (32, 8), (33, 8),
                                  (2, 32), (8, 32), (1, 33), (4, 33),
                                  (256, 1), (257, 1), (128, 2), (129, 2),
                                  (238, 1), (239, 1), (168, 1), (169, 1),
                                  (3, 5), (51, 5), (52, 5), (7, 20),
                                  (85, 3), (86, 3), (1, 1)])
def test_sa_inner_route(s, mu, itemsize):
    smu = s * mu
    warp_bytes = (smu * (smu + 2) + 2 * s) * itemsize + smu * 4
    want = "warp" if mu <= 32 and smu <= 256 and warp_bytes <= SMEM \
        else "block"
    assert dispatch.sa_inner_route(s, mu, itemsize) == want
    assert dispatch.sa_inner_warp_smem_bytes(s, mu, itemsize) == warp_bytes


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sa_inner_warp_cap_straddles(itemsize):
    """At mu = 1 the warp body ends where its layout leaves shared memory,
    before a lane would own a ninth row: s = 238 at f32, 168 at f64; the
    paths' (16, 8) is well inside at both."""
    cap = max(s for s in range(1, 400)
              if dispatch.sa_inner_route(s, 1, itemsize) == "warp")
    assert dispatch.sa_inner_route(cap + 1, 1, itemsize) == "block"
    assert all(dispatch.sa_inner_route(s, 1, itemsize) == "warp"
               for s in range(1, cap + 1))
    assert cap == (238 if itemsize == 4 else 168)
    assert dispatch.sa_inner_route(16, 8, itemsize) == "warp"
    assert dispatch.sa_inner_route(64, 8, itemsize) == "block"


def _layout(arrays):
    """End offset of arrays laid one after another from byte 0, each
    (count, itemsize), checking each starts on its own alignment."""
    off = 0
    for count, size in arrays:
        assert off % size == 0
        off += count * size
    return off


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("s,mu", [(16, 8), (64, 8), (3, 5), (2, 32),
                                  (238, 1), (7, 20)])
def test_sa_inner_layouts_mirror_the_kernel(s, mu, itemsize):
    """Both bodies' shared memory, array by array as the kernel carves it:
    int64 ids, then (block) G if resident, the dz history, theta, coefU,
    eta and the power-iteration vectors; (warp) G's columns transposed at
    pitch s mu + 1, coefU, eta and the dz history, then each row's next
    row with its id (int32)."""
    smu = s * mu
    pw = dispatch.SA_INNER_WARPS * 2 * mu
    for g in (True, False):
        assert dispatch.sa_inner_smem_bytes(s, mu, itemsize, g) == _layout(
            [(smu, 8), (smu * smu if g else 0, itemsize), (smu, itemsize),
             (s, itemsize), (s, itemsize), (s, itemsize), (pw, itemsize)])
    assert dispatch.sa_inner_warp_smem_bytes(s, mu, itemsize) == _layout(
        [(smu * (smu + 1), itemsize), (s, itemsize), (s, itemsize),
         (smu, itemsize), (smu, 4)])
    route = dispatch.sa_inner_route(s, mu, itemsize)
    used = dispatch.sa_inner_warp_smem_bytes(s, mu, itemsize) \
        if route == "warp" else dispatch.sa_inner_smem_bytes(
            s, mu, itemsize, dispatch.sa_inner_g_in_smem(s, mu, itemsize))
    assert used <= SMEM


@pytest.mark.parametrize("mu", range(1, 33))
def test_sa_inner_power_warps_cover_every_block(mu):
    """Wherever the warp body serves, a group of P lanes (P the least
    power of two >= mu) runs each block's power iteration, 32 / P groups
    a warp, and at least two of the 16 warps are left to stage G; at mu =
    1 no warp runs one (lambda_max is G_jj)."""
    P = dispatch.sa_inner_group_width(mu)
    assert P >= mu and P & (P - 1) == 0 and (P == 1 or P < 2 * mu)
    for s in range(1, 257):
        if dispatch.sa_inner_route(s, mu, 4) != "warp":
            continue
        W = dispatch.sa_inner_power_warps(s, mu)
        if mu == 1:
            assert W == 0
        else:
            assert W * (32 // P) >= s > (W - 1) * (32 // P)
        assert W <= dispatch.SA_INNER_WARPS - 2


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sa_inner_warp_reads_stay_in_the_layout(itemsize):
    """Wherever the warp body serves with more than one row a lane (RPL,
    the least power of two covering s mu rows in 32 lanes), a lane's rows
    past s mu read past their column of the transposed G, up to row
    32 RPL - 1 of the last column, and that read ends inside the block's
    shared memory. (At one row a lane the kernel clamps the row: s mu < 8
    would read past the layout.)"""
    for mu in range(1, 33):
        for s in range(1, 257):
            if dispatch.sa_inner_route(s, mu, itemsize) != "warp":
                continue
            smu = s * mu
            rpl = 1 << (-(-smu // 32) - 1).bit_length()
            assert 32 * rpl >= smu and (rpl == 1 or 16 * rpl < smu)
            if rpl > 1:
                assert ((smu - 1) * (smu + 1) + 32 * rpl) * itemsize \
                    <= dispatch.sa_inner_warp_smem_bytes(s, mu, itemsize)


def test_kernel_constants_match_dispatch():
    """Each ``constexpr`` of sa_inner.cu tied to a ``dispatch`` name has
    its value; the multi-line tag of the rows-per-lane cap too."""
    src = (CSRC / "sa_inner.cu").read_text()
    found = re.findall(
        r"constexpr int (\w+) = (\d+);\s*// dispatch\.(\w+)", src)
    assert {"SA_INNER_WARPS", "SA_INNER_WARP_MAX_MU", "SMEM_PER_BLOCK"} \
        <= {n for _, _, n in found}
    for _, value, name in found:
        assert int(value) == getattr(dispatch, name), name
    m = re.search(r"dispatch\.SA_INNER_WARP_MAX_ROWS_PER_LANE\s*\n"
                  r"constexpr int \w+ = (\d+);", src)
    assert int(m.group(1)) == dispatch.SA_INNER_WARP_MAX_ROWS_PER_LANE


# --------------------------------------------------------------------------
# The warp body's arithmetic
# --------------------------------------------------------------------------

def butterfly(x, width):
    """Every lane's value after a xor butterfly sum over ``width`` lanes
    (offsets width/2 .. 1), in x's dtype: lane l adds lane l ^ off."""
    lanes = torch.arange(width)
    off = width // 2
    while off:
        x = x + x[lanes ^ off]
        off //= 2
    return x


def power_group(Gjj, iters=32, width=None):
    """power_iter_max_eig_group: lane c of ``width`` lanes (default the
    least power of two >= mu; 32 gives the block body's warp helper)
    holds column c; (vG)_c summed over r = 0..mu-1, the norm by the
    butterfly, v divided by it; then the Rayleigh quotient."""
    mu = Gjj.shape[0]
    dt = Gjj.dtype
    P = width or dispatch.sa_inner_group_width(mu)
    g = torch.zeros((P, P), dtype=dt)
    g[:mu, :mu] = Gjj
    v = torch.zeros(P, dtype=dt)
    v[:mu] = 1.0 / torch.sqrt(torch.tensor(float(mu), dtype=dt))
    tiny = torch.tensor(1e-30, dtype=dt)

    def vg(v):
        acc = torch.zeros(P, dtype=dt)
        for r in range(mu):
            acc = acc + v[r] * g[r]
        return acc
    for _ in range(iters):
        acc = vg(v)
        v = acc / torch.maximum(torch.sqrt(butterfly(acc * acc, P)[0]), tiny)
    acc = vg(v)
    return butterfly(acc * v, P)[0] / torch.maximum(butterfly(v * v, P)[0],
                                                    tiny)


def sa_warp_chain(G, y_proj, z_proj, z_vals, idx, th_prev, coefU, q, lam1,
                  lam2=0.0, power_iters=32):
    """The warp body's arithmetic -> (dz, eta): eta from the register
    power iteration (G_jj itself at mu = 1), floored; then each step's mu
    dz from the rows' running r and z (the prox times 1 / (1 + 2 eta
    lam2)), subtracted from every row's r as G[row, col] ((th_row^2
    coefU_j - 1) dz) and added to every colliding row's z, in step order
    (the order in which the kernel's walk adds a row's earlier
    collisions)."""
    s, mu = y_proj.shape
    smu = s * mu
    dt = G.dtype
    tiny = torch.finfo(dt).tiny
    th_row = th_prev.repeat_interleave(mu)
    th2 = th_row * th_row
    r = th2 * y_proj.reshape(smu) + z_proj.reshape(smu)
    z = z_vals.reshape(smu).clone()
    ids = idx.reshape(smu)
    etas = []
    for j in range(s):
        rows = slice(j * mu, (j + 1) * mu)
        Gjj = G[rows, rows]
        lam = Gjj[0, 0] if mu == 1 else power_group(Gjj, power_iters)
        etas.append(1.0 / torch.clamp(q * th_prev[j] * lam, min=tiny))
    eta = torch.stack(etas)
    dz = torch.zeros(smu, dtype=dt)
    for j in range(s):
        rows = slice(j * mu, (j + 1) * mu)
        rden = 1.0 / (1.0 + 2.0 * eta[j] * lam2)
        g = z[rows] - eta[j] * r[rows]
        mag = torch.clamp(torch.abs(g) - lam1 * eta[j], min=0.0)
        d = torch.sign(g) * mag * rden - z[rows]
        dz[rows] = d
        coef = th2 * coefU[j] - 1.0
        for p in range(mu):
            col = j * mu + p
            r = r - G[:, col] * (coef * d[p])
            z = z + torch.where(ids == ids[col], d[p], torch.zeros_like(d[p]))
    return dz.reshape(s, mu), eta


def _inputs(s, mu, n_ids, zero_block, dtype, seed=0):
    rng = np.random.default_rng(seed + 1000 * s + mu)
    G0 = rng.standard_normal((128, s * mu))
    if zero_block is not None:
        G0[:, zero_block * mu:(zero_block + 1) * mu] = 0.0
    G = (G0.T @ G0).astype(dtype)
    yp = rng.standard_normal((s, mu)).astype(dtype)
    zp = rng.standard_normal((s, mu)).astype(dtype)
    if zero_block is not None:
        yp[zero_block] = 0.0
        zp[zero_block] = 0.0
    zv = (0.1 * rng.standard_normal((s, mu))).astype(dtype)
    idx = rng.integers(0, n_ids, (s, mu))
    th = np.linspace(0.5, 0.1, s).astype(dtype)
    coefU = ((1.0 - Q * th) / (th * th)).astype(dtype)
    return G, yp, zp, zv, idx, th, coefU


@pytest.mark.parametrize("mu", [2, 3, 5, 8, 13, 20, 32])
def test_group_power_iteration_gives_the_warp_helpers_bits(mu):
    """The P-lane butterfly adds the same terms as the block body's
    32-lane one (its other lanes hold zeros), so at f32 the register
    power iteration returns the warp helper's value bit for bit."""
    rng = np.random.default_rng(mu)
    A = rng.standard_normal((40, mu)).astype(np.float32)
    Gjj = torch.from_numpy(A.T @ A)
    assert torch.equal(power_group(Gjj), power_group(Gjj, width=32))
    ev = float(np.linalg.eigvalsh(Gjj.double().numpy())[-1])
    assert abs(float(power_group(Gjj)) - ev) <= 1e-2 * ev


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sa_warp_chain_matches_repro_f32(case):
    s, mu, n_ids, lam2, zero = case
    ins = _inputs(s, mu, n_ids, zero, np.float32)
    dz, eta = sa_warp_chain(*(torch.from_numpy(a) for a in ins), Q, LAM1,
                            lam2)
    dz_j, eta_j = j_sa_inner_ref(*(jnp.asarray(a) for a in ins), Q, LAM1,
                                 lam2)
    assert torch.isfinite(dz).all() and torch.isfinite(eta).all()
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(eta.numpy(), np.asarray(eta_j), rtol=1e-4)
    if zero is not None:
        # the all-zero block's eta is 1 / tiny (the floor), finite
        tiny = np.finfo(np.float32).tiny
        assert float(eta[zero]) == float(np.float32(1.0) / tiny)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sa_warp_chain_matches_plain_f64(case):
    s, mu, n_ids, lam2, zero = case
    ins = [torch.from_numpy(a) for a in _inputs(s, mu, n_ids, zero,
                                                np.float64)]
    dz, eta = sa_warp_chain(*ins, Q, LAM1, lam2)
    dz_r, eta_r = sa_inner_ref(*ins, Q, LAM1, lam2)
    torch.testing.assert_close(dz, dz_r, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(eta, eta_r, rtol=1e-12, atol=0.0)


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
        c = name.rsplit("/", 1)[0]
        args = [jnp.asarray(d[c + "/" + k]) for k in
                ("G", "yp", "zp", "zv", "idx", "th", "coefU")]
        dz, eta = sa_inner_ref(*args, float(d[c + "/q"]),
                               float(d[c + "/lam1"]), float(d[c + "/lam2"]))
        out[c + "/dz"], out[c + "/eta"] = np.asarray(dz), np.asarray(eta)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def repro_f64(tmp_path_factory):
    """repro's sa_inner_ref with jax_enable_x64 on every case, in one
    subprocess."""
    tmp = tmp_path_factory.mktemp("torch_inner_plan")
    data = {}
    for case in CASES:
        s, mu, n_ids, lam2, zero = case
        c = _case_id(case)
        for k, a in zip(("G", "yp", "zp", "zv", "idx", "th", "coefU"),
                        _inputs(s, mu, n_ids, zero, np.float64)):
            data[f"{c}/{k}"] = a
        data.update({f"{c}/q": np.asarray(Q), f"{c}/lam1": np.asarray(LAM1),
                     f"{c}/lam2": np.asarray(lam2)})
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    out = subprocess.run([sys.executable, "-c", _REF_CODE,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sa_warp_chain_matches_repro_f64(case, repro_f64):
    s, mu, n_ids, lam2, zero = case
    ins = [torch.from_numpy(a) for a in _inputs(s, mu, n_ids, zero,
                                                np.float64)]
    dz, eta = sa_warp_chain(*ins, Q, LAM1, lam2)
    c = _case_id(case)
    np.testing.assert_allclose(dz.numpy(), repro_f64[c + "/dz"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(eta.numpy(), repro_f64[c + "/eta"],
                               rtol=1e-12)


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------

def test_sa_inner_forced_route_refuses_before_the_card(monkeypatch):
    """Forcing the warp body where it cannot run raises in the wrapper;
    the paths' (16, 8) takes the warp body and reaches the build."""
    ins = [torch.from_numpy(a) for a in _inputs(64, 8, 12, None,
                                                np.float32)]
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="no 'warp' body"):
        sa_ops._launch(*ins, Q, LAM1, 0.0, 32, route="warp")

    def build_stop(name, declare):
        raise LookupError(name)
    monkeypatch.setattr(sa_ops._build, "load", build_stop)
    assert sa_ops._route(16, 8, 4, None) == ("warp", 2)
    assert sa_ops._route(16, 8, 8, None) == ("warp", 2)
    assert sa_ops._route(64, 8, 4, None) == ("block", 0)
    assert sa_ops._route(16, 8, 4, "block") == ("block", 1)
    assert sa_ops._route(238, 1, 4, None) == ("warp", 2)
    assert sa_ops._route(239, 1, 4, None) == ("block", 0)
    ins = [torch.from_numpy(a) for a in _inputs(16, 8, 12, None,
                                                np.float32)]
    with pytest.raises(LookupError, match="sa_inner"):
        sa_inner_loop(*ins, q=Q, lam1=LAM1)
    with pytest.raises(ValueError, match="contiguous"):
        sa_ops._launch(ins[0].T.contiguous().T, *ins[1:], Q, LAM1,
                       0.0, 32)
    assert sa_inner_loop.route_launches == {"warp": 0, "block": 0}
    assert sa_inner_loop.launches == 0
