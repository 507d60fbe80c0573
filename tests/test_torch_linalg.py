"""The port's linalg and prox modules (repro_torch.core.linalg / prox)
against repro's at f64, within 1e-12: power iteration, the theta
schedule, the three proxes, reg_value and the Lasso objective. The JAX
side runs with jax_enable_x64 in one subprocess per module."""
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest
import torch

from repro_torch.core import linalg, prox

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MUS = [1, 2, 4, 8, 16]
THETA0 = [8 / 60, 1 / 512, 4 / 2000]
N, MU_G, LAM, L2, ETA = 24, 4, 0.3, 0.2, 0.7


def _psd(mu, seed):
    G0 = np.random.default_rng(seed).standard_normal((3 * mu, mu))
    return G0.T @ G0


def _vecs():
    rng = np.random.default_rng(11)
    return rng.standard_normal(N), rng.standard_normal((5, N))


_REF_CODE = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro.core import linalg, prox
d = np.load(sys.argv[1])
lam, l2, eta, mu_g = json.loads(sys.argv[3])
out = {}
for k in d.files:
    if k.startswith("G"):
        out["eig/" + k] = np.asarray(linalg.power_iteration_max_eig(
            jnp.asarray(d[k]), 32))
    if k.startswith("theta0"):
        out["theta/" + k] = np.asarray(linalg.theta_schedule(
            jnp.asarray(d[k]), 100, 1))
v, X, res = d["v"], d["X"], d["res"]
groups = np.repeat(np.arange(v.size // mu_g), mu_g)
out["soft"] = np.asarray(prox.soft_threshold(v, eta * lam))
out["enet"] = np.asarray(prox.elastic_net_prox(v, eta, lam, l2))
out["group"] = np.asarray(prox.group_soft_threshold(v[:mu_g], eta * lam))
for name, kw in (("lasso", {}), ("enet", {"l2": l2}),
                 ("group", {"groups": groups})):
    out["prox_" + name] = np.asarray(prox.make_prox(lam, **kw)(
        v[:mu_g], eta))
    out["reg_" + name] = np.stack([np.asarray(prox.reg_value(x, lam, **kw))
                                   for x in X])
    out["obj_" + name] = np.stack([np.asarray(prox.lasso_objective(
        r, x, lam, **kw)) for r, x in zip(res, X)])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_linalg")
    v, X = _vecs()
    data = {f"G{mu}": _psd(mu, mu) for mu in MUS}
    data["Gzero"] = np.zeros((4, 4))
    data.update({f"theta0_{i}": np.float64(t) for i, t in enumerate(THETA0)})
    data.update(v=v, X=X, res=np.random.default_rng(12).standard_normal(
        (5, 7)))
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_CODE,
                          str(tmp / "in.npz"), str(tmp / "out.npz"),
                          json.dumps([LAM, L2, ETA, MU_G])],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), data


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("key", [f"G{mu}" for mu in MUS] + ["Gzero"])
def test_power_iteration_matches_repro(ref, key):
    want, data = ref
    got = linalg.power_iteration_max_eig(torch.from_numpy(data[key]), 32)
    _close(got, want["eig/" + key])
    if key != "Gzero":
        np.testing.assert_allclose(float(got),
                                   np.linalg.eigvalsh(data[key]).max(),
                                   rtol=1e-6)


@pytest.mark.parametrize("i", range(len(THETA0)))
def test_theta_schedule_matches_repro(ref, i):
    want, _ = ref
    got = linalg.theta_schedule(THETA0[i], 100, torch.float64)
    assert got.dtype == torch.float64 and got.shape == (101,)
    _close(got, want[f"theta/theta0_{i}"])


def test_proxes_match_repro(ref):
    want, _ = ref
    v = torch.from_numpy(_vecs()[0])
    _close(prox.soft_threshold(v, ETA * LAM), want["soft"])
    _close(prox.elastic_net_prox(v, ETA, LAM, L2), want["enet"])
    _close(prox.group_soft_threshold(v[:MU_G], ETA * LAM), want["group"])


@pytest.mark.parametrize("name", ["lasso", "enet", "group"])
def test_make_prox_reg_value_and_objective_match_repro(ref, name):
    want, data = ref
    kw = {"lasso": {}, "enet": {"l2": L2},
          "group": {"groups": np.repeat(np.arange(N // MU_G), MU_G)}}[name]
    v = torch.from_numpy(data["v"])
    X, res = torch.from_numpy(data["X"]), torch.from_numpy(data["res"])
    _close(prox.make_prox(LAM, **kw)(v[:MU_G], ETA), want["prox_" + name])
    _close(prox.reg_value(X, LAM, **kw), want["reg_" + name])   # batched
    _close(prox.lasso_objective(res, X, LAM, **kw), want["obj_" + name])
