"""The port's cost model (repro_torch.core.cost_model) against repro's on
the same inputs: every cost function, speedup, best_s, the per-term
vectors and time_breakdown, PAPER_DATASETS and the families' registered
cost hooks must be EXACTLY equal (the formulas are copied, so the floats
are the same), and the unknown-kind / unknown-kernel errors the same.
"""
import itertools

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest

from repro.api import FAMILIES as J_FAMILIES
from repro.core import cost_model as jcm
from repro_torch.api import FAMILIES as T_FAMILIES
from repro_torch.core import cost_model as tcm

DATASETS = sorted(jcm.PAPER_DATASETS)
KERNELS = ("linear", "poly", "rbf")
# H, mu, s, P: the sweep each dataset's costs are compared over.
SWEEP = list(itertools.product((1, 48, 512), (1, 4, 16), (1, 8, 64),
                               (1, 2, 64)))


def _machines(seed: int = 0):
    """A random machine in each package (same floats), and the paper's."""
    alpha, beta, gamma, kappa = np.random.default_rng(seed).uniform(
        1e-12, 1e-4, 4)
    args = dict(name="m", alpha=float(alpha), beta=float(beta),
                gamma=float(gamma), kappa=float(kappa))
    return [(jcm.Machine(**args), tcm.Machine(**args)),
            (jcm.Machine.cray_xc30(), tcm.Machine.cray_xc30())]


def _dims(name):
    d = jcm.PAPER_DATASETS[name]
    return d, tcm.ProblemDims(m=d.m, n=d.n, f=d.f)


def test_paper_datasets_equal_repro():
    assert {k: (v.m, v.n, v.f) for k, v in tcm.PAPER_DATASETS.items()} == \
        {k: (v.m, v.n, v.f) for k, v in jcm.PAPER_DATASETS.items()}
    assert tcm.KERNEL_EVAL_FLOPS == jcm.KERNEL_EVAL_FLOPS
    assert tcm.COST_TERMS == jcm.COST_TERMS


def test_paper_machine_kept_tpu_machine_left_out():
    """The port keeps the paper's machine and states no TPU rates."""
    assert tcm.machine_vector(tcm.Machine.cray_xc30()) == \
        jcm.machine_vector(jcm.Machine.cray_xc30())
    assert not hasattr(tcm.Machine, "tpu_v5e_pod")


@pytest.mark.parametrize("name", DATASETS)
def test_costs_equal_repro(name):
    jd, td = _dims(name)
    for H, mu, s, P in SWEEP:
        assert tcm.lasso_costs(td, H, mu, s, P) == \
            jcm.lasso_costs(jd, H, mu, s, P)
        assert tcm.logreg_costs(td, H, mu, s, P) == \
            jcm.logreg_costs(jd, H, mu, s, P)
        for k in KERNELS:
            assert tcm.svm_costs(td, H, s, P, mu, k) == \
                jcm.svm_costs(jd, H, s, P, mu, k)


@pytest.mark.parametrize("name", DATASETS)
def test_speedups_and_breakdown_equal_repro(name):
    jd, td = _dims(name)
    for (jm, tm), (H, mu, s, P) in itertools.product(_machines(), SWEEP):
        assert tcm.lasso_speedup(td, H, mu, s, P, tm) == \
            jcm.lasso_speedup(jd, H, mu, s, P, jm)
        assert tcm.logreg_speedup(td, H, s, P, tm, mu) == \
            jcm.logreg_speedup(jd, H, s, P, jm, mu)
        for k in KERNELS:
            assert tcm.svm_speedup(td, H, s, P, tm, mu, k) == \
                jcm.svm_speedup(jd, H, s, P, jm, mu, k)
        costs = jcm.svm_costs(jd, H, s, P, mu, "rbf")
        assert tcm.time_breakdown(costs, tm) == \
            jcm.time_breakdown(costs, jm)
        assert tcm.predicted_time(costs, tm) == \
            jcm.predicted_time(costs, jm)
        assert tcm.cost_vector(costs) == jcm.cost_vector(costs)


@pytest.mark.parametrize("kind,kernel", [("lasso", "linear"),
                                         ("logreg", "linear"),
                                         ("svm", "linear"), ("svm", "poly"),
                                         ("svm", "rbf")])
def test_best_s_equal_repro(kind, kernel):
    for name in DATASETS:
        jd, td = _dims(name)
        for (jm, tm), (H, mu, P) in itertools.product(
                _machines(1), itertools.product((48, 4096), (1, 8),
                                                (1, 64, 4096))):
            assert tcm.best_s(td, H, mu, P, tm, kind=kind, kernel=kernel) \
                == jcm.best_s(jd, H, mu, P, jm, kind=kind, kernel=kernel)


def test_machine_vector_roundtrip_equals_repro():
    (jm, tm), _ = _machines(2)
    vec = tcm.machine_vector(tm)
    assert vec == jcm.machine_vector(jm)
    back = tcm.machine_from_vector(vec, name="m")
    assert back == tm
    assert tcm.machine_vector(back) == \
        jcm.machine_vector(jcm.machine_from_vector(vec, name="m"))


def _error(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def test_errors_equal_repro():
    jd, td = _dims("epsilon")
    jm, tm = _machines()[1]
    assert _error(tcm.best_s, td, 64, 1, 4, tm, kind="ridge") == \
        _error(jcm.best_s, jd, 64, 1, 4, jm, kind="ridge")
    assert _error(tcm.svm_costs, td, 64, 4, 1, kernel="sigmoid") == \
        _error(jcm.svm_costs, jd, 64, 4, 1, kernel="sigmoid")
    assert _error(tcm.best_s, td, 64, 1, 4, tm, kind="svm",
                  kernel="sigmoid")[0] is ValueError
    # a malformed costs hook fails loudly (no F/W/L), as in repro
    assert _error(tcm.cost_vector, {"F": 1.0, "L": 1.0}) == \
        _error(jcm.cost_vector, {"F": 1.0, "L": 1.0})
    assert tcm.cost_vector({"F": 1.0, "W": 2.0, "L": 3.0}) == \
        jcm.cost_vector({"F": 1.0, "W": 2.0, "L": 3.0})


@pytest.mark.parametrize("family", sorted(J_FAMILIES))
def test_family_cost_hooks_equal_repro(family):
    """Each registration's costs= hook and tune_space are repro's."""
    jf, tf = J_FAMILIES[family], T_FAMILIES[family]
    assert dict(tf.tune_space) == dict(jf.tune_space)
    assert tf.supports_symmetric_gram == jf.supports_symmetric_gram
    for name in ("epsilon", "news20.binary", "w1a"):
        jd, td = _dims(name)
        for H, mu, s, P in SWEEP:
            assert tf.costs(td, H, mu, s, P) == jf.costs(jd, H, mu, s, P)
            for k in KERNELS:
                assert tf.costs(td, H, mu, s, P, kernel=k) == \
                    jf.costs(jd, H, mu, s, P, kernel=k)
