"""The port's threefry RNG (repro_torch.core.rng) and block samplers
(repro_torch.core.linalg) against jax.random and repro's samplers: the
bar is equality, bit for bit.

JAX draws 32-bit values normally and 64-bit values under jax_enable_x64;
the port draws at the solve dtype's width. 32-bit draws are compared
in-process, 64-bit draws against one x64 subprocess per module.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import linalg, rng

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# (n, mu): mu = n, mu = 1, n >= 2000 (ties among 23-bit uniforms occur).
SHAPES = [(60, 4), (60, 60), (100, 99), (513, 1), (2000, 8), (4096, 64)]
SEEDS = [0, 1, 42, 2 ** 31 - 1]
HS = list(range(1, 10))


# repro's sample_block / sample_group and jax.random.uniform at
# fold_in(key(seed), h) for every (seed, h); run in-process and, with x64
# on, in the subprocess (which then needs neither torch nor this module).
_JAX_DRAWS = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.core import linalg as jlinalg


def jax_draws(n, mu, seeds, hs):
    sd = jnp.asarray(np.repeat(seeds, len(hs)))
    hh = jnp.asarray(np.tile(hs, len(seeds)))

    def one(seed, h):
        k = jax.random.fold_in(jax.random.key(seed), h)
        return (jlinalg.sample_block(k, n, mu),
                jlinalg.sample_group(k, n // mu, mu),
                jax.random.uniform(k, (n,)), jax.random.key_data(k))

    return [np.asarray(a) for a in jax.jit(jax.vmap(one))(sd, hh)]
"""
exec(_JAX_DRAWS)


def _port_draws(n, mu, seeds, bits):
    blocks, groups, unif, keys = [], [], [], []
    for seed in seeds:
        k = rng.fold_in(rng.key(seed, bits), torch.tensor(HS))
        blocks.append(linalg.sample_block(k, n, mu, bits))
        groups.append(linalg.sample_group(k, n // mu, mu, bits))
        unif.append(rng.uniform(k, n, bits))
        keys.append(k)
    return [torch.cat(t).numpy() for t in (blocks, groups, unif, keys)]


def test_fold_in_key_data():
    k = rng.fold_in(rng.key(0), 1)
    assert k.tolist() == [928981903, 3453687069]
    want = jax.random.key_data(jax.random.fold_in(jax.random.key(0), 1))
    assert k.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("n,mu", SHAPES)
def test_draws_match_jax_32bit(n, mu):
    """len(SEEDS) x len(HS) = 36 (seed, h) cases per shape, 216 in all."""
    want = jax_draws(n, mu, SEEDS, HS)
    got = _port_draws(n, mu, SEEDS, 32)
    for name, w, g in zip(("sample_block", "sample_group", "uniform",
                           "fold_in"), want, got):
        assert g.dtype == w.dtype or name != "uniform"
        np.testing.assert_array_equal(g, w, err_msg=name)


_X64_CODE = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
""" + _JAX_DRAWS + r"""
import numpy as np
shapes, seeds, hs = json.loads(sys.argv[2])
out = {}
for n, mu in shapes:
    for name, a in zip(("block", "group", "uniform", "key"),
                       jax_draws(n, mu, seeds, hs)):
        out[f"{n}-{mu}/{name}"] = a
np.savez(sys.argv[1], **out)
"""
SEEDS_X64 = [0, 1, 42, 2 ** 33 + 5]


@pytest.fixture(scope="module")
def x64_draws(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_rng") / "x64.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    out = subprocess.run([sys.executable, "-c", _X64_CODE, str(path),
                          json.dumps([SHAPES, SEEDS_X64, HS])],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("n,mu", SHAPES)
def test_draws_match_jax_64bit(n, mu, x64_draws):
    got = _port_draws(n, mu, SEEDS_X64, 64)
    for name, g in zip(("block", "group", "uniform", "key"), got):
        np.testing.assert_array_equal(g, x64_draws[f"{n}-{mu}/{name}"],
                                      err_msg=name)


def test_sampler_width_follows_dtype():
    assert rng.bits_for(torch.float64) == 64
    assert rng.bits_for(torch.float32) == 32


@pytest.mark.parametrize("budget", [1, 130, 1 << 24])
def test_batched_draws_are_the_per_group_draws(monkeypatch, budget):
    """block_draws batches whole groups under a size budget; the blocks
    (and so a solve) do not depend on how they are batched."""
    from repro_torch import api
    from repro_torch.core import engine

    n, mu, s, H = 40, 4, 3, 23
    key = rng.key(7)
    sampler = lambda k: linalg.sample_block(k, n, mu)   # noqa: E731
    want = engine.sample_all(key, sampler, 5, H)
    monkeypatch.setattr(engine, "DRAW_BUDGET", budget)
    batches = list(engine.block_draws(key, sampler, 5, H, n, s))
    assert all(len(b) % s == 0 for b in batches[:-1])
    assert torch.equal(torch.cat(batches), want)
    rs = np.random.default_rng(0)
    prob = api.LassoProblem(A=rs.standard_normal((30, n)),
                            b=rs.standard_normal(30), lam=0.5)
    res = {}
    for b in (budget, 1 << 24):
        monkeypatch.setattr(engine, "DRAW_BUDGET", b)
        res[b] = api.solve(prob, api.SolverConfig(
            block_size=mu, s=s, iterations=H, device="cpu"))
    assert torch.equal(res[budget].objective, res[1 << 24].objective)
