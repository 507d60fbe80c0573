"""The port's slice as a whole, on the CPU: the public entry points
(repro_torch.api.solve, convert, the launcher) against repro's at f64
within 1e-10, and the import rule that keeps JAX out of the port.

* State across: repro runs H1 iterations, convert.state_from_numpy loads
  its aux["state"], the port runs H - H1 more; that matches repro's
  uninterrupted H-iteration run.
* repro_torch.api.solve on the conftest lasso_data shape and on
  make_lasso_dataset("epsilon-like") (whose arrays are first checked
  bitwise equal to repro's) matches repro.api.solve (s=16, mu=8, H=100).
"""
import ast
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest
import torch

from repro.data.sparse import make_lasso_dataset as j_make_lasso_dataset
from repro_torch import api, convert
from repro_torch.data.sparse import make_lasso_dataset
from repro_torch.launch import solve as launch_solve

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
S, MU, H = 16, 8, 100
H1 = 48                     # s-aligned; the resumed leg ends in a tail

_REF_CODE = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from repro import api
from repro.data.sparse import make_lasso_dataset
d = np.load(sys.argv[1])
s, mu, h, h1 = json.loads(sys.argv[3])
A, b, lam = d["A"], d["b"], float(d["lam"])
out = {}


def keep(tag, res):
    out[tag + "/x"] = np.asarray(res.x)
    out[tag + "/objective"] = np.asarray(res.objective)
    for k, v in res.aux["state"].carry.items():
        out[tag + "/state/" + k] = np.asarray(v)


prob = api.LassoProblem(A=A, b=b, lam=lam)
cfg = lambda iters: api.SolverConfig(block_size=mu, s=s, iterations=iters,
                                     dtype=jnp.float64)
keep("first", api.solve(prob, cfg(h1)))
keep("whole", api.solve(prob, cfg(h)))
Ae, be, lam_max = make_lasso_dataset("epsilon-like", 0)
keep("epsilon", api.solve(api.LassoProblem(A=Ae, b=be, lam=0.1 * lam_max),
                          cfg(h)))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(lasso_data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_slice")
    A, b, lam = lasso_data
    np.savez(tmp / "data.npz", A=A, b=b, lam=lam)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    out = subprocess.run(
        [sys.executable, "-c", _REF_CODE, str(tmp / "data.npz"),
         str(tmp / "ref.npz"),
         json.dumps([S, MU, H, H1])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "ref.npz"))


def _cfg(iterations, s=S, mu=MU):
    return api.SolverConfig(block_size=mu, s=s, iterations=iterations,
                            dtype=torch.float64, device="cpu")


def _assert_matches(res, ref, tag, objective=None):
    scale = lambda a: max(1.0, float(np.max(np.abs(a))))
    want_obj = ref[tag + "/objective"] if objective is None else objective
    obj = res.objective.numpy()
    assert obj.shape == want_obj.shape
    assert np.max(np.abs(obj - want_obj) / np.abs(want_obj)) <= 1e-10
    for key in [k for k in ref if k.startswith(tag + "/")]:
        leaf = key[len(tag) + 1:]
        if leaf == "objective":
            continue
        got = res.x if leaf == "x" else \
            res.aux["state"].carry[leaf.split("/", 1)[1]]
        want = ref[key]
        assert np.max(np.abs(got.numpy() - want)) / scale(want) <= 1e-10, \
            key


def test_jax_state_resumes_in_port(ref, lasso_data):
    A, b, lam = lasso_data
    carry = {k.split("/")[-1]: ref[k] for k in ref
             if k.startswith("first/state/")}
    state = convert.state_from_numpy(H1, carry, torch.float64, "cpu")
    prob = convert.problem_from_numpy(A, b, lam, device="cpu",
                                      dtype=torch.float64)
    res = api.solve(prob, _cfg(H - H1), state=state)
    assert res.aux["state"].iteration == H
    _assert_matches(res, ref, "whole",
                    objective=ref["whole/objective"][H1:])


def test_port_resume_is_the_uninterrupted_run(lasso_data):
    A, b, lam = lasso_data
    prob = api.LassoProblem(A=A, b=b, lam=lam)
    first = api.solve(prob, _cfg(H1))
    it, carry = convert.state_to_numpy(first.aux["state"])
    assert it == H1 and set(carry) == {"z", "y", "ztil", "ytil"}
    rest = api.solve(prob, _cfg(H - H1),
                     state=convert.state_from_numpy(it, carry,
                                                    torch.float64, "cpu"))
    whole = api.solve(prob, _cfg(H))
    assert torch.equal(torch.cat([first.objective, rest.objective]),
                       whole.objective)
    assert torch.equal(rest.x, whole.x)


def test_api_solve_matches_repro_small(ref, lasso_data):
    A, b, lam = lasso_data
    prob = api.LassoProblem(A=A, b=b, lam=lam)
    res = api.solve(prob, _cfg(H))
    assert res.aux["inner_impl"] == "torch"
    _assert_matches(res, ref, "whole")
    direct = api.resolve_family(prob).objective(     # evaluates in A's dtype
        api.LassoProblem(A=A.astype(np.float64), b=b, lam=lam), res.x)
    assert abs(float(direct) / float(res.objective[-1]) - 1) <= 1e-10


def test_api_solve_matches_repro_epsilon_like(ref):
    A, b, lam_max = make_lasso_dataset("epsilon-like", 0, device="cpu")
    Aj, bj, lam_j = j_make_lasso_dataset("epsilon-like", 0)
    assert A.dtype == torch.float32 and np.array_equal(A.numpy(), Aj)
    assert np.array_equal(b.numpy(), bj) and lam_max == lam_j
    res = api.solve(api.LassoProblem(A=A, b=b, lam=0.1 * lam_max), _cfg(H))
    _assert_matches(res, ref, "epsilon")


def test_facade_refuses_unported_paths(lasso_data, tmp_path, monkeypatch):
    A, b, lam = lasso_data
    prob = api.LassoProblem(A=A, b=b, lam=lam)
    cfg = _cfg(8, s=4, mu=4)
    # the sharded backend needs a torch.distributed process group
    with pytest.raises(ValueError, match="process group"):
        api.solve(prob, cfg, backend="sharded")
    # tune="auto" is ported: it calibrates on the CPU, solves with the
    # tuned config and reports it; the sharded backend refuses it
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    res = api.solve(prob, cfg, tune="auto")
    used = res.aux["tuned_config"]
    assert (used.iterations, used.dtype, used.device) == \
        (8, torch.float64, "cpu")
    assert res.x.shape == (A.shape[1],) and torch.isfinite(res.x).all()
    assert [p.name for p in tmp_path.iterdir()][0].startswith("torch-")
    with pytest.raises(ValueError, match="backend='local'"):
        api.solve(prob, cfg, backend="sharded", tune="auto")
    # a kernel SVM is no longer refused: it resolves to the ksvm family
    assert api.resolve_family(api.SVMProblem(
        A=A, b=np.sign(b), kernel="poly")).name == "ksvm"
    with pytest.raises(ValueError, match="x0= .* or state="):
        api.solve(prob, cfg, x0=np.zeros(A.shape[1]),
                  state=api.SolveState(0, {}))
    assert api.families() == ("ksvm", "lasso", "logreg", "sfista", "svm")
    assert api.resolve_family(prob).name == "lasso"
    assert api.resolve_family(api.SVMProblem(A=A, b=b)).name == "svm"


def test_launcher_runs_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_solve.main(["--dataset", "epsilon-like", "--mu", "8",
                           "--s", "16", "--iterations", "64",
                           "--accelerated", "--device", "cpu"])
    first, last = map(float, re.search(r"obj (\S+) -> (\S+),",
                                       buf.getvalue()).groups())
    assert last < first


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (repro); the machine with the card has no JAX."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    training = ["repro_torch.optim", "repro_torch.optim.adamw",
                "repro_torch.optim.compress", "repro_torch.data.tokens",
                "repro_torch.runtime.driver", "repro_torch.launch.train"]
    scanned = {str(f.relative_to(ROOT)) for f in files}
    for mod in training:
        path = "src/" + mod.replace(".", "/")
        assert path + ".py" in scanned or path + "/__init__.py" in scanned
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    # The training modules, imported: nothing of JAX comes with them.
    code = ("import importlib, sys\n"
            f"for m in {training!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ,
                                             PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
