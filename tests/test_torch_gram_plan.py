"""K1's wgmma body on the CPU: its arithmetic, its route and its grid.

* ``ref.gram_t_tf32`` emulates the body's 3xTF32 products (tf32 rounding
  by integer bit operations, three products accumulated in f32); at a
  tall shape it meets K1's bar (rtol 2e-4, atol 2e-4 sqrt(m), the JAX
  sweep's) against the f64 product, and a single TF32 product does not.
* ``dispatch.gram_route`` and ``dispatch.gram_plan``: which body serves
  a shape, every row of m covered exactly once, tiles of q of a wgmma
  width (a multiple of 8), shared memory within the H100's 232,448 bytes,
  and a blocked evaluator of the grid (tiles, splits, the fixed-order
  sum of the partials) against the plain product.
* ``engine.gram_local`` (through ``gram_fused``, the solvers' call)
  against repro's ``gram_and_proj`` in interpret mode.
The kernel itself runs only on a card: chip_smoke.py holds both bodies
against the plain version there.
"""
import math

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import gram_and_proj as j_gram_and_proj
from repro_torch.core import engine
from repro_torch.kernels import dispatch
from repro_torch.kernels.gram import gram_and_proj, gram_fused, gram_t
from repro_torch.kernels.gram.ref import (gram_fused_ref, gram_t_ref,
                                          gram_t_tf32, round_tf32,
                                          split_tf32, truncate_tf32)

SMEM = dispatch.SMEM_PER_BLOCK
# (m, p, q, same, route): the epsilon path's fused call, the fused call at
# s 64, mu 8, the dense SVM's Y^T [Y | x] over n = 2,000 features, a
# general x^T y that TMA cannot describe (p = 257), m smaller than one
# 32-row stage, p = 1, and x^T y at the epsilon shape (q = 130 is not a
# whole number of 16-byte units).
PLAN_CASES = [(400_000, 128, 130, True, "wgmma"),
              (400_000, 512, 514, True, "wgmma"),
              (2_000, 64, 65, True, "wgmma"),
              (513, 257, 3, False, "simt"),
              (20, 128, 130, True, "wgmma"),
              (1_000, 1, 2, True, "simt"),
              (400_000, 128, 130, False, "simt"),
              (513, 256, 4, False, "wgmma")]


def _bar(m):
    return dict(rtol=2e-4, atol=2e-4 * math.sqrt(m))


def test_round_tf32_is_nearest_ties_away():
    one = 1.0
    a = torch.tensor([one, one + 2**-11, one + 2**-10 + 2**-11,
                      -(one + 2**-11), one + 2**-12, 3.0 * 2**-100, 0.0])
    want = [one, one + 2**-10, one + 2**-9, -(one + 2**-10), one,
            3.0 * 2**-100, 0.0]
    assert round_tf32(a).tolist() == want


def test_truncate_tf32_drops_low_bits_toward_zero():
    one = 1.0
    a = torch.tensor([one + 2**-10 + 2**-11, -(one + 2**-10 + 2**-11),
                      one - 2**-24, 0.0])
    assert truncate_tf32(a).tolist() == [one + 2**-10, -(one + 2**-10),
                                         one - 2**-11, 0.0]


def test_split_tf32_is_exact_to_2_pow_minus_22():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    hi, lo = split_tf32(a)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - a).abs() / a.abs()).max()) <= 2.0**-11
    resid = (hi.double() + lo.double() - a.double()).abs()
    assert float((resid / a.double().abs()).max()) <= 2.0**-21


@pytest.fixture(scope="module")
def tall():
    rng = np.random.default_rng(1)
    m, p, q = 100_000, 128, 130
    x = rng.standard_normal((m, p)).astype(np.float32)
    y = np.concatenate([x, rng.standard_normal((m, q - p))
                        .astype(np.float32)], axis=1)
    want = torch.from_numpy(x.astype(np.float64).T @ y.astype(np.float64))
    return torch.from_numpy(x), torch.from_numpy(y), want


def test_3xtf32_meets_k1_bar_at_tall_shape(tall):
    x, y, want = tall
    got = gram_t_tf32(x, y, passes=3).double()
    torch.testing.assert_close(got, want, **_bar(x.shape[0]))


def test_1xtf32_misses_k1_bar_at_tall_shape(tall):
    x, y, want = tall
    got = gram_t_tf32(x, y, passes=1).double()
    assert not torch.allclose(got, want, **_bar(x.shape[0]))
    # ... by a wide margin, while 3xTF32 sits well inside it.
    tol = _bar(x.shape[0])
    lim = tol["atol"] + tol["rtol"] * want.abs()
    assert float(((got - want).abs() / lim).max()) > 2.0
    got3 = gram_t_tf32(x, y, passes=3).double()
    assert float(((got3 - want).abs() / lim).max()) < 0.1


def test_gram_t_tf32_rejects_other_pass_counts():
    with pytest.raises(ValueError):
        gram_t_tf32(torch.zeros(4, 4), torch.zeros(4, 4), passes=2)


@pytest.mark.parametrize("m,p,q,same,route", PLAN_CASES)
def test_gram_route(m, p, q, same, route):
    y_cols = p if same else q
    assert dispatch.gram_route(torch.float32, m, p, q, y_cols=y_cols) \
        == route
    assert dispatch.gram_route("float32", m, p, q, y_cols=y_cols) == route
    assert dispatch.gram_route(torch.float64, m, p, q,
                               y_cols=y_cols) == "simt"


@pytest.mark.parametrize("m,p,q,same,route", PLAN_CASES)
@pytest.mark.parametrize("body", ["wgmma", "simt"])
def test_gram_plan_covers_rows_and_fits(m, p, q, same, route, body):
    plan = dispatch.gram_plan(m, p, q, body, same=same, num_sms=132)
    assert plan.route == body
    assert plan.rows % (dispatch.GRAM_WGMMA_BLOCK_K if body == "wgmma"
                        else dispatch.GRAM_BLOCK_K) == 0
    # every row of m in exactly one split: the last split is the only
    # ragged one and none is empty
    assert (plan.splits - 1) * plan.rows < m <= plan.splits * plan.rows
    assert plan.p_tiles * plan.tile_p >= p > (plan.p_tiles - 1) * plan.tile_p
    assert plan.q_tiles * plan.tile_n >= q > (plan.q_tiles - 1) * plan.tile_n
    assert plan.splits <= 65535 and plan.smem_bytes <= SMEM
    if body == "wgmma":
        assert plan.tile_n % 8 == 0 and 8 <= plan.tile_n <= 256
        assert plan.tile_n in dispatch.GRAM_WGMMA_TILE_NS
        blocks = plan.p_tiles * plan.q_tiles * plan.splits
        k_steps = -(-m // dispatch.GRAM_WGMMA_BLOCK_K)
        assert blocks >= 132 or plan.splits == k_steps
        if plan.shared:
            # A is B's first rows: every consumer warpgroup's 64 rows lie
            # inside B's buffer
            assert same and plan.p_tiles == plan.q_tiles == 1
            assert 64 * -(-p // 64) <= plan.tile_n


def test_gram_plan_at_the_epsilon_path():
    plan = dispatch.gram_plan(400_000, 128, 130, "wgmma", same=True,
                              num_sms=132)
    assert (plan.tile_n, plan.splits, plan.rows, plan.shared) == \
        (136, 132, 3040, True)
    # rings of 3 hi/lo stages and 4 raw stages of 136 rows (+ 8 vectors)
    assert plan.smem_bytes == 179_312
    # without sharing, A's own 128 rows and 2-stage rings: still within
    # one block's budget
    assert dispatch.gram_wgmma_smem_bytes(136, False) == 205_888 <= SMEM
    assert dispatch.gram_plan(400_000, 512, 514, "wgmma", same=True) \
        .shared is False


@pytest.mark.parametrize("k,route", [(0, "wgmma"), (2, "wgmma"),
                                     (8, "wgmma"), (9, "simt")])
def test_gram_route_vector_count(k, route):
    """The wgmma body reads at most 8 vectors in place beside Y."""
    assert dispatch.gram_route(torch.float32, 3000, 64, 64 + k,
                               y_cols=64) == route


def test_gram_tile_n_menu():
    assert [dispatch.gram_tile_n(q) for q in (1, 24, 25, 65, 72, 73, 130,
                                              136, 137, 514)] == \
        [24, 24, 72, 72, 72, 136, 136, 136, 136, 136]


def _blocked_gram(x, y, plan):
    """The grid of ``plan`` evaluated block by block: each (p tile, q
    tile, split) block's partial from the 3xTF32 emulation over its rows
    (zero beyond the operands, as TMA fills them), then the partials
    summed split by split in order, as the second pass does."""
    m, p = x.shape
    q = y.shape[1]
    partial = torch.zeros((plan.splits, p, q), dtype=torch.float32)
    for z in range(plan.splits):
        rows = slice(z * plan.rows, min(m, (z + 1) * plan.rows))
        for pt in range(plan.p_tiles):
            ps = slice(pt * plan.tile_p, min(p, (pt + 1) * plan.tile_p))
            for qt in range(plan.q_tiles):
                qs = slice(qt * plan.tile_n, min(q, (qt + 1) * plan.tile_n))
                partial[z, ps, qs] = gram_t_tf32(x[rows, ps], y[rows, qs])
    out = torch.zeros((p, q), dtype=torch.float32)
    for z in range(plan.splits):
        out += partial[z]
    return out


@pytest.mark.parametrize("m,p,k", [(3_000, 128, 2), (700, 64, 1),
                                   (2_000, 200, 2), (20, 8, 2)])
def test_blocked_wgmma_grid_matches_plain(m, p, k):
    rng = np.random.default_rng(m + p)
    Y = torch.from_numpy(rng.standard_normal((m, p)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((k, m)).astype(np.float32))
    plan = dispatch.gram_plan(m, p, p + k, "wgmma", same=True, num_sms=8)
    W = torch.cat([Y, V.T], dim=1)
    torch.testing.assert_close(_blocked_gram(Y, W, plan),
                               gram_fused_ref(Y, V), **_bar(m))


@pytest.mark.parametrize("m,c,k", [(300, 16, 1), (1_024, 128, 2),
                                   (129, 8, 2)])
def test_gram_local_matches_repro_interpret(m, c, k):
    rng = np.random.default_rng(c)
    Y = rng.standard_normal((m, c)).astype(np.float32)
    V = rng.standard_normal((m, k)).astype(np.float32)
    G, P = j_gram_and_proj(jnp.asarray(Y), jnp.asarray(V), interpret=True)
    want = np.concatenate([np.asarray(G), np.asarray(P)], axis=1)
    # the solvers' layout: the vectors as the rows of a (k, m) stack
    Vt = torch.from_numpy(np.ascontiguousarray(V.T))
    got = engine.gram_local(torch.from_numpy(Y), Vt)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * math.sqrt(m))
    # and (m, k) as it comes, through gram_and_proj
    G2, P2 = gram_and_proj(torch.from_numpy(Y), torch.from_numpy(V))
    np.testing.assert_allclose(torch.cat([G2, P2], 1).numpy(), want,
                               rtol=2e-4, atol=2e-4 * math.sqrt(m))


def test_gram_fused_on_cpu_is_the_plain_product():
    rng = np.random.default_rng(3)
    Y = torch.from_numpy(rng.standard_normal((257, 12)))
    V = torch.from_numpy(rng.standard_normal((3, 257)))
    want = gram_t_ref(Y, torch.cat([Y, V.T], dim=1))
    assert torch.equal(gram_fused(Y, V), want)
    assert torch.equal(gram_fused(Y, V.T.contiguous().T), want)
    assert gram_fused(Y, V).shape == (12, 15)


def test_gram_fused_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        gram_fused(torch.zeros(8, 4), torch.zeros(2, 7))
    with pytest.raises(TypeError):
        gram_fused(torch.zeros(8, 4), torch.zeros(2, 8, dtype=torch.float64))
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gram_fused(x, torch.empty((2, 8), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        gram_t(x, x)
