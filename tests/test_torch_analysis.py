"""The port's static contracts (repro_torch.analysis) against repro's
(repro.analysis) on the same shapes, and the port's own seeded faults.

* Collectives: the port's ``budget_rows()`` equals repro's for every
  (family, s) exactly: per-outer-iteration and amortized counts by kind
  and per-iteration payload bytes (the port's end-of-solve gathers are
  kept apart, as ``CollectiveBudget.end_gathers``).
* Costs: every family x variant x s of ``CERT_S_GRID``, dense and
  sparse: the same words and messages as repro's, exactly, and flops
  within rel 0.25 of repro's counted flops, but for two causes named in
  ``test_cost_counts_match_repro``; ``check_costs`` green on all five.
* Seeded faults, each firing its own pass alone (mirroring
  tests/test_analysis.py): a second all-reduce (collectives), a
  rank-dependent replicated output (replication), an f64 -> f32 cast
  (dtypes, at its source line), hooks off by 10x in F, with a wrong s
  exponent, ignoring s in L, a dense count on a sparse operand (costs),
  a dispatch constant changed in a copy of a .cu source and a plan that
  covers slots twice (kernels), lint snippets, and the certified tuner's
  refusal.
* The kernels pass green over KERNEL_PACKAGES, check_all's selection
  checks, the CLI; the seams' flop formulas against the plain versions'
  dispatch counts; a sharded solve of an operand with a stored 0.0
  bit-identical to the local solve at one rank (ROADMAP Queue 3, item
  1); every name of api_surface.txt in scope resolving in the port
  (Queue 3, item 2).

repro's rows are computed once per module in this process (f32, no
x64); the replication pass spawns its two gloo ranks once, for every
registered family and the stubs together.
"""
import dataclasses
import importlib
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest
import torch

import _torch_analysis_stubs as stubs
from repro_torch import analysis as tan
from repro_torch.analysis import costs as tcosts
from repro_torch.analysis.common import one_rank_group, variant_config
from repro_torch.analysis.record import Recorder
from repro_torch.core.api import FAMILIES as TFAMILIES
from repro_torch.core.api import solve, solve_sharded
from repro_torch.core.types import SparseOperand, SVMProblem, LassoProblem
from repro_torch.kernels import KERNEL_PACKAGES, dispatch
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.sa_inner import ops as sa_inner_ops
from repro_torch.kernels.sa_inner import ref as sa_inner_ref
from repro_torch.kernels.svm_inner import ops as svm_inner_ops
from repro_torch.kernels.svm_inner import ref as svm_inner_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_NAMES = ("ksvm", "lasso", "logreg", "sfista", "svm")
REPRO_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _errors(diags):
    return [d for d in diags if d.severity == "error"]


# ---------------------------------------------------------------------------
# Module fixtures: repro's rows, the port's rows, one replication job.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_rows():
    """repro's budget rows and cost counts (dense and sparse) for every
    family x variant x s of the certification grid."""
    from repro.analysis import budget_rows
    from repro.analysis import costs as jcosts
    from repro.analysis.common import family_variants
    from repro.analysis.common import variant_config as jvariant
    from repro.core.types import FAMILIES
    budgets = budget_rows()
    counts = {}
    for name in FAMILY_NAMES:
        fam = FAMILIES[name]
        mu = jcosts.cost_tolerance(name).mu or fam.bench_block_size
        m, n = jcosts.CERT_SHAPES[fam.partition]
        op = jcosts.certification_operand(fam)
        for v in family_variants(fam):
            grid = jcosts.CERT_S_GRID if v.startswith(("sa", "ca")) \
                else (1,)
            for s in grid:
                cfg = jvariant(fam, v, iterations=jcosts.CERT_ITERATIONS,
                               s=s, block_size=mu)
                counts[name, v, s] = (
                    jcosts.solver_cost_count(fam, cfg, m=m, n=n),
                    jcosts.solver_cost_count(fam, cfg, operand=op))
    return budgets, counts


@pytest.fixture(scope="module")
def port_cost_rows():
    return {name: tcosts.cost_ratio_rows(TFAMILIES[name], device="cpu")
            for name in FAMILY_NAMES}


@pytest.fixture(scope="module")
def replication():
    """One two-rank gloo job: every registered family, then the stubs;
    the diagnostics grouped by family name."""
    subjects = [(TFAMILIES[name], None) for name in FAMILY_NAMES] + [
        (fam, None) for fam in (stubs.GOOD, stubs.TWO_PREDUCE,
                                stubs.DIVERGENT, stubs.DOWNCAST)]
    diags, checked = tan.check_replication_families(subjects, device="cpu")
    by = {}
    for d in diags:
        by.setdefault(d.where.split(":")[0], []).append(d)
    return by, checked


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def test_budget_rows_match_repro(repro_rows):
    budgets, _ = repro_rows
    rows = tan.budget_rows(device="cpu")
    assert set(rows) == set(budgets)
    for key, row in rows.items():
        ref = budgets[key].budget
        got = row.budget
        for kind in REPRO_KINDS:
            assert got.per_iteration[kind] == ref.per_iteration[kind], key
            assert got.amortized[kind] == ref.amortized[kind], key
        assert all(got.per_iteration[k] == 0 == got.amortized[k]
                   for k in got.per_iteration if k not in REPRO_KINDS)
        assert got.per_iteration_bytes == ref.per_iteration_bytes, key
        assert got.amortized_bytes == ref.amortized_bytes == 0.0
        assert row.runtime_messages == row.trips == budgets[key].trips
        # every outer iteration holds the one all-reduce, nothing else
        assert all(it["all-reduce"] == 1 and sum(it.values()) == 1
                   for it in got.outer), key


def test_check_collectives_green_with_payload_info():
    diags, checked = tan.check_collectives(TFAMILIES["lasso"], device="cpu")
    assert checked == ["lasso:accelerated", "lasso:classical", "lasso:sa",
                       "lasso:sa_accelerated"]
    assert not _errors(diags), [d.format() for d in diags]
    info = {d.where: d.message for d in diags if d.severity == "info"}
    # accelerated SA Lasso at s 8, mu 4: (s mu)(s mu + 2) f32 words
    assert info["lasso:sa_accelerated"].startswith(
        f"all-reduce payload {32 * 34 * 4} B per outer iteration x 2")


def test_seeded_second_preduce_flags_collectives_only(replication):
    errs = _errors(tan.check_collectives(stubs.TWO_PREDUCE,
                                         device="cpu")[0])
    assert len(errs) == 1 and errs[0].check == "collectives"
    assert "ONE all-reduce per outer iteration" in errs[0].message
    assert "#0: 2" in errs[0].message
    assert not _errors(tan.check_dtypes(stubs.TWO_PREDUCE,
                                        device="cpu")[0])
    assert "stub_two_preduce" not in replication[0]


def test_stub_good_is_clean(replication):
    for check in (tan.check_collectives, tan.check_dtypes):
        diags, checked = check(stubs.GOOD, device="cpu")
        assert checked == ["stub_good:classical"]
        assert not _errors(diags), [d.format() for d in diags]
    assert "stub_good" not in replication[0]
    assert "stub_good:classical" in replication[1]


# ---------------------------------------------------------------------------
# Replication
# ---------------------------------------------------------------------------

def test_replication_green_on_every_family(replication):
    by, checked = replication
    for name in FAMILY_NAMES:
        assert name not in by, [d.format() for d in by[name]]
        assert any(c.startswith(f"{name}:") for c in checked)
    assert len([c for c in checked if c.split(":")[0] in FAMILY_NAMES]) \
        == sum(len(TFAMILIES[n].variants) for n in FAMILY_NAMES)


def test_seeded_rank_dependent_output_flags_replication_only(replication):
    errs = replication[0].get("stub_divergent", [])
    assert errs and all(d.check == "replication" for d in errs)
    assert any("'x'" in d.message and "declared replicated" in d.message
               for d in errs)
    # it keeps its one all-reduce per outer iteration and its dtypes
    assert not _errors(tan.check_collectives(stubs.DIVERGENT,
                                             device="cpu")[0])
    assert not _errors(tan.check_dtypes(stubs.DIVERGENT, device="cpu")[0])


# ---------------------------------------------------------------------------
# Dtypes
# ---------------------------------------------------------------------------

def test_check_dtypes_green_on_every_family():
    for name in FAMILY_NAMES:
        diags, checked = tan.check_dtypes(TFAMILIES[name], device="cpu")
        assert len(checked) == len(TFAMILIES[name].variants)
        assert not diags, [d.format() for d in diags]


def test_seeded_f64_downcast_flags_dtypes_only_at_its_line(replication):
    src = pathlib.Path(stubs.__file__).read_text().splitlines()
    line = next(i + 1 for i, text in enumerate(src) if "# NARROW" in text)
    errs = _errors(tan.check_dtypes(stubs.DOWNCAST, device="cpu")[0])
    assert errs and all(d.check == "dtypes" for d in errs)
    assert "float64 -> float32" in errs[0].message
    assert all(f"_torch_analysis_stubs.py:{line}" in d.message
               for d in errs), [d.message for d in errs]
    assert not _errors(tan.check_collectives(stubs.DOWNCAST,
                                             device="cpu")[0])
    assert "stub_downcast" not in replication[0]


def test_kernel_event_on_f32_body_flags_dtypes():
    """A float64 call whose seam reports a body that computes in f32 (K1's
    3xTF32 wgmma) is a narrowing, at the caller's line."""
    from repro_torch import seams
    event = seams.KernelEvent("gram", "gram_fused", ((8, 4),),
                              torch.float64, torch.float64, "wgmma", 0.0)

    def run():
        for rec in list(seams.OPEN):
            rec.enter_seam(event)
            rec.exit_seam(event)

    found = tan.find_float_narrowing(run)
    assert len(found) == 1
    assert found[0][:2] == ("float64", "float32")
    assert "'wgmma' body" in found[0][2]
    assert "test_torch_analysis.py:" in found[0][2]


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

# The port's deferred update of the column layout (engine.deferred_steps,
# dense) multiplies the sampled columns Y (m, s mu) by a block-diagonal
# (s mu, s) matrix: 2 m (s mu) s flops per call, s times what repro's
# einsum over the s blocks counts (2 m s mu). Lasso calls it once per
# outer iteration, CA-SFISTA twice. The surplus is the zeros' products.
DEFERRED_CALLS = {"lasso": 1, "sfista": 2}


def _deferred_surplus(name, s, mu, m, outer):
    return DEFERRED_CALLS.get(name, 0) * outer * 2.0 * m * s * mu * (s - 1)


def test_cost_counts_match_repro(repro_rows, port_cost_rows):
    """Words and messages equal repro's exactly; flops within rel 0.25,
    after two causes, each named here:

    * dense Lasso and CA-SFISTA at s > 1: the port ADDS the block-diagonal
      surplus of its dense deferred update (``_deferred_surplus``), up to
      1.44x repro's count at s = 16; without it they agree within 0.25;
    * sparse: the port ADDS K4's products, 2 R K Q per ``ell_spmm`` call
      over the padded ELL slots (``CostRow.sparse_spmm_flops``), which
      repro's jaxpr walk does not count (its ``ell_spmm_ref`` is a scan
      of elementwise multiply-adds); without them they agree within 0.25.

    The port's counts, surplus and K4 included, pass the unchanged bands
    (``test_check_costs_green_on_every_family``)."""
    _, counts = repro_rows
    for name, rows in port_cost_rows.items():
        fam = TFAMILIES[name]
        m, _ = tcosts.CERT_SHAPES[fam.partition]
        for row in rows:
            dense, sparse = counts[name, row.variant, row.s]
            key = (name, row.variant, row.s)
            assert row.words == dense.words, key
            assert row.messages == dense.messages == row.outer, key
            surplus = _deferred_surplus(name, row.s, row.mu, m, row.outer)
            assert math.isclose(row.flops - surplus, dense.flops,
                                rel_tol=0.25), (key, row.flops, surplus,
                                                dense.flops)
            assert math.isclose(row.sparse_flops - row.sparse_spmm_flops,
                                sparse.flops, rel_tol=0.25), key
            if not surplus:
                assert math.isclose(row.flops, dense.flops,
                                    rel_tol=0.25), key


def test_check_costs_green_on_every_family(port_cost_rows):
    for name, rows in port_cost_rows.items():
        diags, checked = tan.check_costs(TFAMILIES[name], rows=rows)
        assert checked == [f"{name}:{v}"
                           for v in sorted(TFAMILIES[name].variants)]
        assert not _errors(diags), [d.format() for d in diags]
        for row in rows:
            assert row.sparse_ratio <= 4.0 and row.messages == row.outer


def _counted(fam, variant="sa"):
    m, n = tcosts.CERT_SHAPES[fam.partition]
    cfg = variant_config(fam, variant, iterations=48, s=1, device="cpu")
    return tcosts.solver_cost_count(fam, cfg, m=m, n=n)


def _outer_hook(base, f_scale=1.0, s_power=1):
    """F and W of ``base`` (counted at s = 1) per outer iteration, times
    ``f_scale``; ``s_power`` 0 drops the 1/s of F (a wrong exponent)."""
    def costs(dims, H, mu, s, P, kernel="linear"):
        outer = -(-H // s)
        f = base.flops * f_scale * (outer if s_power else H) / 48.0
        return {"F": f, "W": base.words * outer / 48.0, "L": outer,
                "M": dims.n}
    return costs


WIDE = tcosts.CostTolerance(f_band=(1e-3, 1e3), w_band=(1e-3, 1e3))


def test_cost_certifier_green_on_matching_hook():
    fam = stubs.with_costs(stubs.SA_GOOD, _outer_hook(_counted(
        stubs.SA_GOOD)))
    diags, checked = tan.check_costs(fam, sparse=False, device="cpu",
                                     tolerance=tcosts.CostTolerance())
    assert checked == ["stub_sa:sa"]
    assert not _errors(diags), [d.format() for d in diags]


def test_cost_f_off_by_10x_fires_f_band_alone():
    fam = stubs.with_costs(stubs.SA_GOOD, _outer_hook(
        _counted(stubs.SA_GOOD), f_scale=10.0))
    errs = _errors(tan.check_costs(fam, sparse=False, device="cpu",
                                   tolerance=tcosts.CostTolerance(
                                       f_band=(0.4, 8.0)))[0])
    assert len(errs) == 1, [d.format() for d in errs]
    assert errs[0].check == "costs"
    assert "term F" in errs[0].message and "band" in errs[0].message


def test_wrong_s_exponent_fires_drift_alone():
    fam = stubs.with_costs(stubs.SA_GOOD, _outer_hook(
        _counted(stubs.SA_GOOD), s_power=0))
    errs = _errors(tan.check_costs(fam, sparse=False, device="cpu",
                                   tolerance=WIDE)[0])
    assert len(errs) == 1, [d.format() for d in errs]
    assert "term F s-scaling" in errs[0].message
    assert "wrong s exponent" in errs[0].message


def test_ignored_s_fires_latency_alone():
    base = _counted(stubs.SA_PER_INNER)

    def costs(dims, H, mu, s, P, kernel="linear"):
        return {"F": base.flops, "W": base.words, "L": H, "M": dims.n}

    fam = stubs.with_costs(stubs.SA_PER_INNER, costs)
    errs = _errors(tan.check_costs(fam, sparse=False, device="cpu",
                                   tolerance=WIDE)[0])
    assert len(errs) == 1, [d.format() for d in errs]
    assert "term L" in errs[0].message
    assert "ceil(H/s)" in errs[0].message


def test_dense_count_on_sparse_operand_fails_nnz_alone():
    """The stubs densify a SparseOperand (``todense``) and count dense
    products on it: 1 / density = 12.5x the O(nnz) certificate's
    density x dense count, over its 4x."""
    fam = stubs.with_costs(stubs.SA_GOOD, _outer_hook(
        _counted(stubs.SA_GOOD)))
    errs = _errors(tan.check_costs(fam, sparse=True, device="cpu",
                                   s_grid=(1, 4),
                                   tolerance=WIDE)[0])
    assert len(errs) == 1, [d.format() for d in errs]
    assert "term O(nnz)" in errs[0].message


def test_select_config_certified_refuses_uncertified_hook():
    from repro_torch import tune as ttune
    from repro_torch.core.cost_model import Machine
    from repro_torch.core.types import SolverConfig
    A = (np.arange(64 * 32, dtype=np.float32).reshape(64, 32) % 7) - 3.0
    prob = LassoProblem(A=torch.as_tensor(A), b=torch.ones(64), lam=0.1)
    cfg = SolverConfig(block_size=4, iterations=16, device="cpu")
    bad = dataclasses.replace(
        TFAMILIES["lasso"],
        costs=lambda dims, H, mu, s, P, kernel="linear":
        {"F": 1.0, "W": 1.0, "L": 1.0, "M": 1.0})
    with pytest.raises(ValueError, match="uncertified cost model"):
        ttune.select_config(prob, Machine.cray_xc30(), cfg, family=bad,
                            certified=True)


# ---------------------------------------------------------------------------
# The seams count what the plain versions compute
# ---------------------------------------------------------------------------

def _dispatch_flops(fn, *args):
    """Flops a Recorder counts at dispatch for ``fn(*args)`` (no seam)."""
    rec = Recorder()
    with rec:
        fn(*args)
    return sum(t.flops for t in rec.spans())


@pytest.mark.parametrize("s,mu", [(2, 2), (4, 2), (8, 4), (3, 8)])
def test_inner_seam_flops_match_plain_version(s, mu):
    """The inner seams' flops (``inner_flops``) are the products of the
    plain versions, counted at dispatch. At s = 1 or mu = 1 torch's
    einsum turns the unit contractions into elementwise multiplies, which no dispatch
    count sees; the formula keeps 2 x output x contraction there too, as
    repro's jaxpr walk counts the same einsums (dot_general at any
    size)."""
    gen = torch.Generator().manual_seed(0)
    Y = torch.randn((40, s * mu), generator=gen, dtype=torch.float64)
    G = Y.T @ Y + torch.eye(s * mu, dtype=torch.float64)
    sm = torch.randn((s, mu), generator=gen, dtype=torch.float64)
    idx = torch.arange(s * mu).reshape(s, mu)
    th = torch.full((s,), 0.5, dtype=torch.float64)
    got = _dispatch_flops(sa_inner_ref.sa_inner_ref, G, sm, sm, sm, idx,
                          th, th, 1.5, 0.1, 0.0, 32)
    assert got == sa_inner_ops.inner_flops(s, mu, 32)
    got = _dispatch_flops(svm_inner_ref.svm_inner_ref, G, sm, sm.sign(),
                          sm.abs(), idx, 0.0, 1.0, 32)
    assert got == svm_inner_ops.inner_flops(s, mu, 32)
    x = torch.randn((40, 6), generator=gen)
    assert _dispatch_flops(gram_ref.gram_t_ref, x, x) == 2.0 * 6 * 6 * 40


def test_seam_counts_once_and_ignores_plain_ops():
    """gram_and_proj (a seam) calls gram_fused (a seam): one event, its
    2 p (p + k) m flops, and nothing of the plain version's products."""
    from repro_torch.kernels.gram import gram_and_proj
    Y = torch.ones((16, 4))
    V = torch.ones((16, 2))
    rec = Recorder()
    with rec:
        gram_and_proj(Y, V)
    assert [e.entry for e, _ in rec.events] == ["gram_and_proj"]
    assert rec.events[0][0].route == "plain"
    assert rec.setup.flops == 2.0 * 4 * 6 * 16


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def test_check_kernels_green_over_every_package():
    diags, checked = tan.check_kernels()
    assert checked == list(KERNEL_PACKAGES)
    assert not _errors(diags), [d.format() for d in diags]
    assert {d.where for d in diags if d.severity == "info"} \
        == set(KERNEL_PACKAGES)


@pytest.mark.parametrize("arch,want", [("xlstm-350m", []),
                                       ("hymba-1.5b", [64])])
def test_head_dims_count_only_archs_with_attention(arch, want, monkeypatch):
    """K5's head dimensions come from dispatch and the ported archs with
    an attention block: xlstm-350m (no attention, d_model / heads 256)
    adds none, hymba-1.5b adds its 64."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.analysis import kernels as tkernels
    monkeypatch.setattr(configs, "list_archs", lambda: [arch])
    assert tkernels._head_dims(SimpleNamespace(FLASH_HEAD_DIMS=())) == want
    assert tkernels._head_dims(dispatch) == sorted(dispatch.FLASH_HEAD_DIMS)


def test_package_without_describer_and_stray_describer():
    errs = _errors(tan.check_kernels(
        packages=KERNEL_PACKAGES + ("new_kernel",))[0])
    assert len(errs) == 1 and "no safety-pass describer" in errs[0].message
    errs = _errors(tan.check_kernels(packages=KERNEL_PACKAGES[:-1])[0])
    assert len(errs) == 1 and "stale registration" in errs[0].message


def test_changed_dispatch_constant_fires_guard_drift(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(ROOT / "src" / "repro_torch" / "kernels" / "csrc", csrc)
    src = (csrc / "spmm.cu").read_text()
    tag = "constexpr int kWarps = 4;"
    assert tag in src
    (csrc / "spmm.cu").write_text(src.replace(
        tag, "constexpr int kWarps = 8;"))
    errs = _errors(tan.check_kernels(csrc=csrc)[0])
    assert len(errs) == 1, [d.format() for d in errs]
    assert errs[0].check == "kernels"
    assert errs[0].where.startswith("spmm.cu:")
    assert "dispatch.SPMM_WARPS = 4" in errs[0].message


def test_plan_covering_slots_twice_fires_write_race(monkeypatch):
    real = dispatch.spmm_worker_range

    def overlapping(K, active, workers, worker):
        lo, hi = real(K, active, workers, worker)
        return max(0, lo - 1), hi        # each warp rereads its left slot

    monkeypatch.setattr(dispatch, "spmm_worker_range", overlapping)
    errs = _errors(tan.check_kernels()[0])
    assert errs and all(d.check == "kernels" and d.where.startswith("spmm[")
                        for d in errs)
    assert all("write race" in d.message for d in errs)


def test_output_injectivity_and_bounds_helpers():
    assert not tan.output_injectivity_diags("k", "x", [(0, 4), (4, 9)], 9)
    race = tan.output_injectivity_diags("k", "x", [(0, 5), (4, 9)], 9)
    assert len(race) == 1 and "write race" in race[0].message
    gap = tan.output_injectivity_diags("k", "x", [(0, 4), (5, 9)], 9)
    assert len(gap) == 1 and "covered by no part" in gap[0].message
    oob = tan.index_map_bounds_diags("k", "x", [(0, 4), (4, 10)], 9)
    assert len(oob) == 1 and "out of bounds" in oob[0].message


# ---------------------------------------------------------------------------
# Lint and registry
# ---------------------------------------------------------------------------

LINT_CASES = [
    ("import torch.distributed as dist\ndist.all_reduce(x)\n",
     "core/sa_lasso.py", "raw-collective"),
    ("from torch.distributed import all_gather\n", "core/svm.py",
     "raw-collective"),
    ("import torch.distributed as dist\ndist.barrier()\n", "tune/x.py",
     "raw-collective"),
    ("import random\n", "core/x.py", "ambient-rng"),
    ("import numpy as np\nnp.random.seed(0)\n", "data/x.py",
     "ambient-rng"),
    ("import numpy as np\nnp.random.default_rng(0)\n", "core/x.py",
     "ambient-rng"),
    ("import torch\ntorch.manual_seed(0)\n", "models/x.py", "ambient-rng"),
    ("import torch\ntorch.randn(3)\n", "core/x.py", "ambient-rng"),
    ("import torch\ntorch.randperm(5, device='cpu')\n", "core/x.py",
     "ambient-rng"),
    ("assert x > 0\n", "core/x.py", "bare-assert"),
]


@pytest.mark.parametrize("source,rel,rule", LINT_CASES)
def test_lint_rule_fires_on_snippet(source, rel, rule):
    diags = tan.lint_source(source, rel)
    assert len(diags) == 1 and f"[{rule}]" in diags[0].message, \
        [d.format() for d in diags]


@pytest.mark.parametrize("source,rel", [
    ("import torch.distributed as dist\ndist.all_reduce(x)\n",
     "core/linalg.py"),
    ("import torch.distributed as dist\ndist.barrier()\n",
     "core/distributed.py"),
    ("import numpy as np\nnp.random.default_rng(0)\n", "data/sparse.py"),
    ("import numpy as np\nnp.random.default_rng(0)\n",
     "tune/microbench.py"),
    ("import torch\ng = torch.Generator()\ng.manual_seed(0)\n"
     "torch.randn(3, generator=g)\n", "models/lm.py"),
])
def test_lint_allows_blessed_sites(source, rel):
    assert not tan.lint_source(source, rel)


def test_lint_and_registry_green_on_the_port():
    diags, checked = tan.lint_paths()
    assert not diags, [d.format() for d in diags]
    assert "core/linalg.py" in checked and "analysis/lint.py" in checked
    diags, checked = tan.check_registry()
    assert not diags, [d.format() for d in diags]
    assert len(checked) == 6


def test_registry_fires_on_uncovered_carry():
    fam = dataclasses.replace(TFAMILIES["svm"],
                              state_layout=lambda cfg: (("alpha", "r"),))
    errs = tan.check_registry([fam])[0]
    assert errs and all(d.check == "registry" for d in errs)
    assert "not covered" in errs[0].message


# ---------------------------------------------------------------------------
# check_all and the CLI
# ---------------------------------------------------------------------------

def test_check_all_validates_selection():
    with pytest.raises(ValueError, match="unknown checks"):
        tan.check_all(checks=["nope"], device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        tan.check_all(families=["nope"], device="cpu")
    with pytest.raises(ValueError, match="registered by no"):
        tan.check_all(families=["svm"], variants=["accelerated"],
                      device="cpu")
    assert tan.CHECKS == ("collectives", "replication", "dtypes", "costs",
                          "kernels", "lint", "registry")


def test_check_all_solver_passes_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tan.check_all(checks=["collectives"], families=["svm"])


def test_check_all_filters_variants():
    report = tan.check_all(checks=["collectives", "lint"],
                           families=["lasso", "svm"], variants=["sa"],
                           device="cpu")
    assert report.ok, report.format()
    assert [c for c in report.checked if c.startswith("collectives")] \
        == ["collectives:lasso:sa", "collectives:svm:sa"]


def test_cli_json_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--json", "--checks", "collectives", "kernels", "registry",
         "--family", "svm"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert report["ok"] and report["errors"] == 0
    assert "collectives:svm:sa" in report["checked"]


# ---------------------------------------------------------------------------
# ROADMAP Queue 3, item 1: stored zeros survive the one-rank shard
# ---------------------------------------------------------------------------

def _with_stored_zero(m, n, seed):
    """A sparse operand that stores two explicit zeros (one in the first
    slot of row 0, at column 0; one mid-row) and labels b."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, n)).astype(np.float32)
    dense[rng.random((m, n)) > 0.3] = 0.0
    dense[0, 0] = dense[m // 2, n // 2] = 0.0
    rows, cols = np.nonzero(dense)
    rows = np.concatenate([rows, [0, m // 2]])
    cols = np.concatenate([cols, [0, n // 2]])
    vals = np.concatenate([dense[rows[:-2], cols[:-2]], [0.0, 0.0]])
    A = SparseOperand.from_coo(rows, cols, vals.astype(np.float32), (m, n))
    b = np.sign(rng.standard_normal(m)).astype(np.float32)
    return A, torch.as_tensor(b), len(vals)


def test_shard_keeps_stored_zeros():
    A, _, stored = _with_stored_zero(30, 20, 0)
    assert A.nnz == stored - 2
    for axis, size in ((0, 30), (1, 20)):
        one = A.shard(axis, 0, size)
        for k in ("row_cols", "row_vals", "row_blocks", "col_rows",
                  "col_vals", "col_blocks"):
            assert torch.equal(getattr(one, k), getattr(A, k)), (axis, k)


def test_sharded_solve_with_stored_zero_bit_identical_at_one_rank():
    from repro_torch.core.types import SolverConfig
    A, b, _ = _with_stored_zero(40, 24, 1)
    cases = [
        (LassoProblem(A=A, b=b, lam=0.05), "lasso",
         SolverConfig(block_size=2, s=4, iterations=16, device="cpu")),
        (SVMProblem(A=A, b=b, lam=1.0, kernel="rbf",
                    kernel_params={"gamma": 0.1}), "ksvm",
         SolverConfig(block_size=2, s=4, iterations=16, device="cpu")),
    ]
    with one_rank_group("cpu") as group:
        for problem, family, cfg in cases:
            local = solve(problem, cfg, family=family)
            shard = solve_sharded(problem, cfg, group, family=family)
            assert torch.equal(local.x, shard.x), family
            assert torch.equal(local.objective, shard.objective), family
            for k, v in local.aux.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, shard.aux[k]), (family, k)


# ---------------------------------------------------------------------------
# ROADMAP Queue 3, item 2: the API surface
# ---------------------------------------------------------------------------

IN_SCOPE = ("repro.core", "repro.core.engine", "repro.api",
            "repro.kernels.spmm", "repro.tune", "repro.analysis",
            "repro.runtime.elastic")
OUT_OF_SCOPE = {
    # the TPU VMEM guards: the port's kernels have no fallback to guard
    "vmem_ok", "spmm_vmem_ok", "kernel_vmem_model", "KernelVmemEntry",
    "choose_inner_impl", "choose_spmm_impl", "reset_fallback_warnings",
    "grouped_spmm_label", "pallas_guards_ok",
    # the JAX lowering entry (ROADMAP Queue 1, item 7)
    "lower_solve",
    # a JAX mesh over the survivors: the port's elastic runtime forms a
    # process group over them instead (core.distributed.survivor_group)
    "build_1d_mesh",
    # jaxpr and Pallas machinery of repro.analysis
    "taint_jaxpr", "shard_map_out_taints", "KernelCapture", "SpecView",
    "capture_pallas_calls", "capture_footprint",
}


def test_api_surface_resolves_in_the_port():
    missing, checked = [], 0
    for line in (ROOT / "api_surface.txt").read_text().split():
        module, name = line.split(":")
        if module not in IN_SCOPE or name in OUT_OF_SCOPE:
            continue
        checked += 1
        port = importlib.import_module("repro_torch" + module[len("repro"):])
        if not hasattr(port, name):
            missing.append(line)
    assert not missing, missing
    assert checked > 120
