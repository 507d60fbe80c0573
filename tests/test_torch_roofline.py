"""The port's roofline, mesh and sharding rules on the CPU, held against
repro's.

* ``roofline_terms``, ``two_point_fit`` and ``model_flops`` equal repro's
  on a grid (repro given a ``Hardware`` built from ``HW_H100``'s fields),
  and chip_smoke.py's bf16 and HBM peaks are ``HW_H100``'s.
* ``make_production_mesh`` keeps repro's contract: held against repro's
  mesh built in one subprocess with 512 forced host devices.
* ``param_partition_specs`` equals repro's ``param_partition_specs(
  lm.param_specs(arch), mesh)`` for all 10 archs at full config on the
  meshes (16,16), (2,16,16), (2,2), (4,1) and (1,1), leaf for leaf
  through ``convert.lm_flat`` (a stacked leaf's spec less its group
  entry); repro's rules take the port's mesh description, which has the
  ``.shape`` and ``.axis_names`` they read.
* ``input_specs`` and ``batch_partition_specs`` equal repro's shapes,
  dtypes and specs for all 40 arch x shape cells on both production
  meshes (a stacked cache leaf against each of its layers).
* The DTensor placements of the specs on a (2, 2) mesh of four gloo
  ranks: each rank's local block is the spec's slice.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import input_specs as j_input_specs
from repro.models import lm as jlm
from repro.parallel import sharding as jsh
from repro.roofline import analysis as ja
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import input_specs
from repro_torch.core import distributed
from repro_torch.launch.mesh import (EMPTY, Mesh, make_mesh,
                                     make_production_mesh, set_mesh)
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.parallel import sharding
from repro_torch.roofline import (HW_H100, Hardware, model_flops,
                                  roofline_terms, two_point_fit)

from _torch_sharding_ranks import placement_rank

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
J_HW = ja.Hardware(**{f: getattr(HW_H100, f)
                      for f in ("name", "peak_flops", "hbm_bw", "ici_bw",
                                "hbm_bytes")})

# ---------------------------------------------------------------------------
# Roofline arithmetic
# ---------------------------------------------------------------------------

GRID = [(f, b, c) for f in (0.0, 7.3e11, 4.1e15)
        for b in (0.0, 2.2e9, 9.9e12) for c in (0.0, 3.1e8)]


@pytest.mark.parametrize("flops,nbytes,coll", GRID)
def test_roofline_terms_equal_repro(flops, nbytes, coll):
    for mac in (1.0, 2.0):
        got = roofline_terms(flops, nbytes, coll, mac_correction=mac)
        want = ja.roofline_terms(flops, nbytes, coll, hw=J_HW,
                                 mac_correction=mac)
        assert got == want


@pytest.mark.parametrize("c1,c2,n1,n2,n", [
    (10.0, 17.0, 1, 2, 32), (5e12, 9e12, 1, 2, 40), (3.0, 3.0, 1, 2, 7),
    (1e9, 3e9, 2, 4, 24), (8.0, 2.0, 1, 1, 5), (0.5, 1.5, 256, 512, 4096)])
def test_two_point_fit_equals_repro(c1, c2, n1, n2, n):
    assert two_point_fit(c1, c2, n1, n2, n) \
        == ja.two_point_fit(c1, c2, n1, n2, n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equals_repro(kind):
    for n, tokens, batch in ((8_030_261_248, 1_048_576, 256),
                             (1_100_048_384, 32_768, 8), (7, 3, 1)):
        assert model_flops(n, kind, tokens, batch) \
            == ja.model_flops(n, kind, tokens, batch)


def test_h100_is_the_default_and_the_smoke_scripts_peaks():
    assert isinstance(HW_H100, Hardware)
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.ici_bw) \
        == (989e12, 3.35e12, 900e9)
    assert 80e9 < HW_H100.hbm_bytes < 86e9
    t = roofline_terms(989e12, 0.0, 0.0)
    assert t["compute_s"] == 1.0 and t["dominant"] == "compute"
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.BF16_FLOPS == HW_H100.peak_flops
    assert chip_smoke.HBM_BYTES_PER_S == HW_H100.hbm_bw


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_production_mesh_contract_against_repro():
    code = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch.mesh import make_mesh, make_production_mesh
out = []
for m in (make_production_mesh(), make_production_mesh(multi_pod=True),
          make_mesh((2, 2), ("data", "model"))):
    out.append([dict(m.shape), list(m.axis_names), int(m.devices.size)])
print("MESHES", json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("MESHES")][0]
    want = json.loads(line.split(" ", 1)[1])
    for m, (shape, axes, size) in zip(
            (make_production_mesh(), make_production_mesh(multi_pod=True),
             make_mesh((2, 2), ("data", "model"))), want):
        assert m.shape == shape and list(m.shape) == list(shape)
        assert list(m.axis_names) == axes and m.size == size
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape \
        == {"pod": 2, "data": 16, "model": 16}


def test_set_mesh_and_abstract_mesh():
    assert sharding.get_abstract_mesh() is EMPTY
    assert EMPTY.empty and EMPTY.axis_names == ()
    a, b = make_mesh((2, 2), ("data", "model")), make_mesh((1, 1),
                                                           ("data", "model"))
    with set_mesh(a):
        assert sharding.get_abstract_mesh() is a
        with set_mesh(b):
            assert sharding.get_abstract_mesh() is b
        assert sharding.get_abstract_mesh() is a
    assert sharding.get_abstract_mesh() is EMPTY


def test_mesh_refuses_bad_shapes_and_no_group():
    with pytest.raises(ValueError):
        Mesh(("data", "data"), (2, 2))
    with pytest.raises(ValueError):
        Mesh(("data",), (0,))
    with pytest.raises(RuntimeError, match="process group of 4"):
        make_mesh((2, 2), ("data", "model")).device_mesh("cpu")


# ---------------------------------------------------------------------------
# Parameter specs: 10 archs x 5 meshes, leaf for leaf
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _j_param_specs(name):
    return jlm.param_specs(j_get_config(name))


def _per_layer(tree, spec_tree):
    """repro's spec tree with each stacked leaf's spec as an object array
    of one spec a layer, less the group entry, so that ``lm_flat`` splits
    it as it splits the leaves."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        arr = np.empty(t.shape[0], dtype=object)
        for g in range(t.shape[0]):
            arr[g] = tuple(s)[1:]
        return arr
    out = {k: v for k, v in spec_tree.items()
           if k not in ("layers", "encoder")}
    out["layers"] = walk(tree["layers"], spec_tree["layers"])
    if "encoder" in tree:
        enc = dict(spec_tree["encoder"])
        enc["layers"] = walk(tree["encoder"]["layers"],
                             spec_tree["encoder"]["layers"])
        out["encoder"] = enc
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list_archs())
def test_param_partition_specs_equal_repro(name, mesh_name):
    mesh = make_mesh(*MESHES[mesh_name])
    jtree = _j_param_specs(name)
    want = convert.lm_flat(get_config(name),
                           _per_layer(jtree, jsh.param_partition_specs(
                               jtree, mesh)), leaf=tuple)
    model = lm.param_specs(get_config(name))
    got = sharding.param_partition_specs(model, mesh)
    assert set(got) == set(want)
    bad = {k: (tuple(got[k]), want[k]) for k in got
           if tuple(got[k]) != want[k]}
    assert not bad, bad
    # a mapping of shapes gives the same specs; so does AdamW's state
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert sharding.param_partition_specs(shapes, mesh) == got
    st = AdamW().state_specs(got)
    assert st.step == () and st.mu == got and st.nu == got


def test_group_axis_of_a_one_dim_w_leaf_is_dropped():
    """repro stacks a 1-D ``w_*`` leaf to 2-D and gives it (fsdp, tp); the
    port's per-layer leaf keeps the tp entry."""
    mesh = make_mesh((2, 2), ("data", "model"))
    got = sharding.param_partition_specs(
        {"layers.3.cell.w_x": (8,), "w_top": (8,)}, mesh)
    assert tuple(got["layers.3.cell.w_x"]) == ("model",)
    assert tuple(got["w_top"]) == (None,)
    assert tuple(jsh._rule_for("w_x", (4, 8), False, "data", "model")) \
        == ("data", "model")


# ---------------------------------------------------------------------------
# Inputs and their specs: 40 cells
# ---------------------------------------------------------------------------

def _dt(d):
    return str(d).rsplit(".", 1)[-1]


def _port_leaves(arch, batch):
    """{repro path: (shape, dtype, spec getter)} of the port's batch, a
    cache entry's layer under its stacked slot path with g."""
    period = len(arch.block_pattern)
    out = {}
    for k, v in batch.items():
        if k != "cache":
            out[(k,)] = v
            continue
        for entry, layers in v.items():
            for i, t in enumerate(layers):
                if t is None:
                    continue
                if entry in ("cross_k", "cross_v"):
                    path = ("cache", "cross", entry[-1], i // period)
                else:
                    kind = arch.block_pattern[i % period]
                    path = ("cache", f"slot{i % period}_{kind}", entry,
                            i // period)
                out[path] = t
    return out


def _j_leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_j_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("name", list_archs())
def test_input_and_batch_specs_equal_repro(name, shape_name):
    arch, shape = get_config(name), SHAPES[shape_name]
    jspec = j_input_specs(j_get_config(name), J_SHAPES[shape_name])
    batch = input_specs(arch, shape)
    assert all(t.device.type == "meta" for t in _port_leaves(
        arch, batch).values())
    jl = _j_leaves(jspec)
    mine = _port_leaves(arch, batch)
    # every stacked leaf of repro's, layer by layer
    want_paths = set()
    for path, sds in jl.items():
        if path[0] == "cache":
            want_paths.update(path + (g,) for g in range(sds.shape[0]))
        else:
            want_paths.add(path)
    assert set(mine) == want_paths
    for path, t in mine.items():
        sds = jl[path[:-1]] if path[0] == "cache" else jl[path]
        want_shape = sds.shape[1:] if path[0] == "cache" else sds.shape
        assert tuple(t.shape) == tuple(want_shape), path
        assert _dt(t.dtype) == _dt(sds.dtype), path
    for mesh in (make_production_mesh(), make_production_mesh(
            multi_pod=True)):
        want = _j_leaves(jsh.batch_partition_specs(jspec, mesh,
                                                   kind=shape.kind))
        got = sharding.batch_partition_specs(batch, mesh, kind=shape.kind)
        for path, t in mine.items():
            if path[0] == "cache":
                entry = path[2] if path[1] != "cross" else f"cross_{path[2]}"
                layer = path[-1] * len(arch.block_pattern) + (
                    0 if path[1] == "cross" else int(path[1][4]))
                spec = got["cache"][entry][layer]
                assert tuple(spec) == tuple(want[path[:-1]])[1:], path
            else:
                assert tuple(got[path[0]]) == tuple(want[path]), path


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    P = sharding.P
    assert sharding.placements(P(("pod", "data"), "model", None),
                               ("pod", "data", "model")) \
        == (Shard(0), Shard(0), Shard(1))
    assert sharding.placements(P(None, "data"), ("data", "model")) \
        == (Shard(1), Replicate())
    assert sharding.shard_shape((64, 32, 5), P(("pod", "data"), "model"),
                                make_production_mesh(multi_pod=True)) \
        == (2, 2, 5)
    assert repr(P("data", None)) == "P('data', None)"


def test_named_shardings_place_each_rank_block():
    got = distributed.run_ranks(placement_rank, 4, "gloo", device="cpu")
    assert got["ok"], got
    assert got["specs"] == {"layers.0.attn.wq": ("data", "model"),
                            "embed": ("model", "data"),
                            "layers.0.norm1.scale": (None,)}
