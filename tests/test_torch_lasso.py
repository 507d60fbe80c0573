"""The port's Lasso solvers (repro_torch.core.lasso / sa_lasso) against
repro's on the same numpy-made inputs, on the CPU.

f64: every case runs through repro with jax_enable_x64 in ONE subprocess
per module (DESIGN.md "Test-process device convention"), which writes the
results to an .npz; the port is held to x, the objective trace and every
aux["state"] leaf within 1e-10 (the repo's SA tier: objective relative,
vectors absolute against max(1, |ref|_inf)). f32: in-process JAX, the
objective trace within rel 1e-4. SA == classical inside the port at f64
within 1e-10.
"""
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore

H = 37                      # H mod s != 0 for every s > 1 below
L2 = 0.5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# The reference subprocess compiles many small programs; XLA's cheapest
# backend optimisation level keeps that fast (the f64 bar is 1e-10, far
# above any reordering it could cause).
XLA_FAST_COMPILE = "--xla_backend_optimization_level=0"

# name -> (solver, s, mu, prox, symmetric_gram, warm start)
CASES = {
    "sa_acc-s1-mu1-lasso": ("sa_acc_bcd_lasso", 1, 1, "lasso", False, False),
    "sa_acc-s3-mu4-lasso": ("sa_acc_bcd_lasso", 3, 4, "lasso", False, False),
    "sa_acc-s8-mu1-enet": ("sa_acc_bcd_lasso", 8, 1, "enet", False, False),
    "sa_acc-s16-mu4-group": ("sa_acc_bcd_lasso", 16, 4, "group", False,
                             False),
    "sa_acc-s8-mu4-sym-x0": ("sa_acc_bcd_lasso", 8, 4, "lasso", True, True),
    "sa-s1-mu4-enet": ("sa_bcd_lasso", 1, 4, "enet", False, False),
    "sa-s3-mu1-lasso": ("sa_bcd_lasso", 3, 1, "lasso", False, False),
    "sa-s8-mu4-group-sym": ("sa_bcd_lasso", 8, 4, "group", True, False),
    "sa-s16-mu1-x0": ("sa_bcd_lasso", 16, 1, "lasso", False, True),
    "acc-mu1-enet-x0": ("acc_bcd_lasso", 1, 1, "enet", False, True),
    "acc-mu4-group": ("acc_bcd_lasso", 1, 4, "group", False, False),
    "bcd-mu1-lasso": ("bcd_lasso", 1, 1, "lasso", False, False),
    "bcd-mu4-enet-x0": ("bcd_lasso", 1, 4, "enet", False, True),
}


# The case helpers run here and, with x64 on, in the reference subprocess
# (which then needs neither torch nor this module).
_HELPERS = r"""
import numpy as np


def problem_kwargs(n, mu, prox):
    groups = np.repeat(np.arange(n // mu), mu) if prox == "group" else None
    return {"l2": L2 if prox == "enet" else 0.0, "groups": groups}


def warm_start(n):
    return 0.1 * np.random.default_rng(3).standard_normal(n)
"""
exec(_HELPERS)

_REF_CODE = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro import core
CASES, H, L2 = json.loads(sys.argv[2])
""" + _HELPERS + r"""
d = np.load(sys.argv[1])
A, b, lam = d["A"], d["b"], float(d["lam"])
out = {}
for name, (solver, s, mu, prox, sym, warm) in CASES.items():
    prob = core.LassoProblem(A=A, b=b, lam=lam,
                             **problem_kwargs(A.shape[1], mu, prox))
    cfg = core.SolverConfig(block_size=mu, s=s, iterations=H,
                            symmetric_gram=sym, dtype=jnp.float64)
    res = getattr(core, solver)(prob, cfg,
                                x0=warm_start(A.shape[1]) if warm else None)
    out[name + "/x"] = np.asarray(res.x)
    out[name + "/objective"] = np.asarray(res.objective)
    for k, v in res.aux["state"].carry.items():
        out[name + "/state/" + k] = np.asarray(v)
    out[name + "/iteration"] = np.asarray(res.aux["state"].iteration)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def ref_f64(lasso_data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_lasso")
    A, b, lam = lasso_data
    np.savez(tmp / "data.npz", A=A, b=b, lam=lam)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FAST_COMPILE)
    out = subprocess.run(
        [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
         json.dumps([CASES, H, L2]), str(tmp / "ref.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "ref.npz"))


def _run_port(name, lasso_data, dtype):
    solver, s, mu, prox, sym, warm = CASES[name]
    A, b, lam = lasso_data
    prob = tcore.LassoProblem(A=A, b=b, lam=lam,
                              **problem_kwargs(A.shape[1], mu, prox))
    cfg = tcore.SolverConfig(block_size=mu, s=s, iterations=H,
                             symmetric_gram=sym, dtype=dtype, device="cpu")
    return getattr(tcore, solver)(prob, cfg,
                                  x0=warm_start(A.shape[1]) if warm else None)


def _close(got, want, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= 1e-10, f"{what}: {err:.3e} > 1e-10"


def _rel_close(got, want, tol, what):
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    assert err <= tol, f"{what}: rel {err:.3e} > {tol}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_repro_f64(name, ref_f64, lasso_data):
    res = _run_port(name, lasso_data, torch.float64)
    _close(res.x, ref_f64[name + "/x"], "x")
    _rel_close(res.objective.numpy(), ref_f64[name + "/objective"], 1e-10,
               "objective")
    assert res.aux["state"].iteration == int(ref_f64[name + "/iteration"])
    leaves = [k for k in ref_f64 if k.startswith(name + "/state/")]
    assert sorted(k.rsplit("/", 1)[1] for k in leaves) \
        == sorted(res.aux["state"].carry)
    for k in leaves:
        _close(res.aux["state"].carry[k.rsplit("/", 1)[1]], ref_f64[k], k)


@pytest.mark.parametrize("name", ["sa_acc-s8-mu1-enet", "acc-mu4-group"])
def test_port_matches_repro_f32_objective(name, lasso_data):
    solver, s, mu, prox, sym, warm = CASES[name]
    A, b, lam = lasso_data
    prob = jcore.LassoProblem(A=A, b=b, lam=lam,
                              **problem_kwargs(A.shape[1], mu, prox))
    cfg = jcore.SolverConfig(block_size=mu, s=s, iterations=H,
                             symmetric_gram=sym, dtype=jnp.float32)
    want = np.asarray(getattr(jcore, solver)(
        prob, cfg, x0=warm_start(A.shape[1]) if warm else None).objective)
    got = _run_port(name, lasso_data, torch.float32).objective.numpy()
    assert got.dtype == np.float32
    _rel_close(got, want, 1e-4, "objective")


@pytest.mark.parametrize("accelerated", [True, False])
@pytest.mark.parametrize("s,mu", [(3, 1), (16, 4)])
def test_sa_equals_classical_in_port_f64(lasso_data, accelerated, s, mu):
    A, b, lam = lasso_data
    prob = tcore.LassoProblem(A=A, b=b, lam=lam)
    base = tcore.solve_lasso(prob, tcore.SolverConfig(
        block_size=mu, iterations=H, accelerated=accelerated,
        dtype=torch.float64, device="cpu"))
    sa = tcore.solve_lasso(prob, tcore.SolverConfig(
        block_size=mu, s=s, iterations=H, accelerated=accelerated,
        dtype=torch.float64, device="cpu"))
    _rel_close(sa.objective.numpy(), base.objective.numpy(), 1e-10,
               "objective")
    _close(sa.x, base.x.numpy(), "x")
    assert base.objective[-1] < 0.9 * base.objective[0]


def test_inner_impl_label_on_cpu(lasso_data):
    A, b, lam = lasso_data
    res = tcore.sa_acc_bcd_lasso(
        tcore.LassoProblem(A=A, b=b, lam=lam),
        tcore.SolverConfig(block_size=4, s=8, iterations=12, device="cpu"))
    assert res.aux["inner_impl"] == "torch"


def test_cuda_device_without_card_raises(lasso_data):
    """Asking for the card on a machine without one raises; nothing runs
    on the CPU quietly."""
    A, b, lam = lasso_data
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="cuda"):
        tcore.sa_acc_bcd_lasso(tcore.LassoProblem(A=A, b=b, lam=lam),
                               tcore.SolverConfig(block_size=4, s=8))
