"""The port's dry run (``repro_torch.launch.dryrun``) and its helpers on
the CPU, held against repro's.

* ``ArchConfig.param_count`` / ``active_param_count`` and
  ``lm.param_count`` equal repro's for all 10 archs.
* ``run_cell("tinyllama-1.1b", "train_4k")`` on a (2, 2) mesh gives
  ``status: ok`` with repro's own checks of it
  (tests/test_dryrun_unit.py).
* FLOPs: the port's count of a tinyllama-width, 2-layer prefill at B 1,
  S 256 lies within 3 % of repro's ``cost_analysis()`` flops, lowered
  under ``cost_exact_mode`` (this file's one JAX lowering) from repro's
  own blocks composed as the port's ``LM.prefill`` runs them (only the
  last position unembedded; repro's prefill step unembeds all S).
  XLA counts the elementwise work too, the port only products and seams.
* The depth fit equals the full-depth count for a dense arch; the fit
  over S equals the direct count for an arch without attention.
* Argument bytes on one card are the bytes of the model, the AdamW state
  and the batch; the dry run's step takes extras (whisper's frames)
  through ``make_train_step``, which splits them by rows.
* The meta K5 seam's event equals the CPU plain path's (the route aside:
  the meta call stands for the card's), and its backward runs.
* Every public name of repro.roofline, repro.parallel, repro.launch.mesh
  and repro.launch.dryrun resolves in the port or stands in the
  scope-out list below with its reason.
* The CLI prints one ``[ OK ]`` line with the H100 bound.
"""
import ast
import dataclasses
import functools
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import input_specs as j_input_specs
from repro.kernels.flash_attention.ops import cost_exact_mode
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.roofline.analysis import cost_analysis_dict
from repro_torch.analysis.record import Recorder
from repro_torch.configs import SHAPES, get_config, get_smoke_config, \
    list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.runtime import driver

ROOT = os.path.join(os.path.dirname(__file__), "..")
ONE = make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("name", list_archs())
def test_param_counts_equal_repro(name, monkeypatch):
    # one trace of repro's init for both of its counts
    monkeypatch.setattr(jlm, "param_specs",
                        functools.lru_cache(jlm.param_specs))
    arch, jarch = get_config(name), j_get_config(name)
    assert arch.param_count() == jarch.param_count()
    assert arch.active_param_count() == jarch.active_param_count()
    for embed in (True, False):
        assert lm.param_count(arch, include_embed=embed) \
            == jlm.param_count(jarch, include_embed=embed)


def test_run_cell_small_mesh():
    mesh = make_mesh((2, 2), ("data", "model"))
    r = dryrun.run_cell("tinyllama-1.1b", "train_4k", mesh=mesh,
                        opts=dryrun.DryrunOptions(include_optimizer=False),
                        verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["memory"]["total_bytes"] > 0
    assert r["per_device"]["flops_macs"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert 0 < r["useful_ratio"] < 10
    assert r["flops_split"] == "rank" and r["n_chips"] == 4
    assert r["roofline"]["collective_s"] > 0
    assert r["opts"]["microbatches"] == 2
    # the fit over depth equals the direct count, per device
    assert r["cost_fit"]["flops"] == r["per_device"]["flops_macs"]
    assert r["cost_fit"]["bytes"] == r["per_device"]["hbm_bytes"]
    # the optimizer's state is an argument even when it does not update:
    # bf16 params and two f32 moments, over 4 devices at least
    assert r["memory"]["argument_bytes"] > (2 + 8) * 1.1e9 / 4


def _repro_prefill_flops(arch_j, B, S):
    """repro's cost_analysis flops of its own blocks composed as the
    port's LM.prefill: every layer over S, then the final norm and the
    unembed of the last position only."""
    def prefill(p, b):
        x = jlm._embed(p, arch_j, b["tokens"], {})

        def fn(slot_params, x, kind):
            return jlm._block_forward(slot_params, x, arch_j, kind)
        x, _ = jlm._scan_layers(p, x, arch_j, fn, unroll_layers=2)
        x = JL.rmsnorm(p["final_norm"], x[:, -1:])
        return x @ p["unembed"]
    specs = j_input_specs(arch_j, JShape("p", "prefill", S, B))
    with cost_exact_mode():
        compiled = jax.jit(prefill).lower(jlm.param_specs(arch_j),
                                          specs).compile()
    return float(cost_analysis_dict(compiled)["flops"])


def test_prefill_flops_within_3pct_of_repro(capsys):
    B, S = 1, 256
    arch = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    jarch = dataclasses.replace(j_get_config("tinyllama-1.1b"), n_layers=2)
    r = dryrun.run_cell("tinyllama-1.1b", "prefill_32k", mesh=ONE,
                        arch=arch, shape=ShapeConfig("prefill_32k",
                                                     "prefill", S, B),
                        verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    got = r["per_device"]["flops_macs"]
    want = _repro_prefill_flops(jarch, B, S)
    with capsys.disabled():
        print(f"\n  tinyllama width, 2 layers, prefill B {B} S {S}: port "
              f"{got:.6e}, repro cost_analysis {want:.6e}, port / repro "
              f"{got / want:.6f}")
    assert abs(got / want - 1) <= 0.03
    # the same count on the CPU, where K5's plain version runs
    model = lm.init_params(arch, 0, "cpu")
    with torch.no_grad(), Recorder() as rec:
        model.prefill(torch.zeros((B, S), dtype=torch.int32))
    assert sum(t.flops for t in rec.spans()) == got


def test_depth_fit_equals_full_depth_dense():
    arch = get_smoke_config("llama3-8b")
    for kind in ("prefill", "train", "decode"):
        r = dryrun.run_cell("llama3-8b", "x", mesh=ONE, arch=arch,
                            shape=ShapeConfig("x", kind, 128, 2),
                            verbose=False)
        assert r["status"] == "ok", r.get("traceback")
        assert r["count"] == "direct"
        assert r["cost_fit"]["flops"] == r["per_device"]["flops_macs"]
        assert r["cost_fit"]["bytes"] == r["per_device"]["hbm_bytes"]


def test_seq_fit_equals_direct_count_without_attention(monkeypatch):
    """The quadratic fit over S is exact for each xLSTM block alone (the
    fit is linear in the counts, and a step's count is the sum of its
    layers'): the mLSTM's from two chunks of 128 on, the sLSTM's (no
    chunks) once its peak is in its steady phase, at short lengths."""
    smoke = get_smoke_config("xlstm-350m")
    opts = dryrun.DryrunOptions(cost_fit=False)
    mlstm = dataclasses.replace(smoke, block_pattern=("mlstm",), n_layers=1)
    slstm = dataclasses.replace(smoke, block_pattern=("slstm",), n_layers=1)
    for kind, arch, lengths, S in (
            ("train", mlstm, (256, 384, 512), 640),
            ("prefill", mlstm, (256, 384, 512), 640),
            ("train", slstm, (48, 64, 80), 96),
            ("prefill", slstm, (48, 64, 80), 96)):
        shape = ShapeConfig("x", kind, S, 1)
        direct = dryrun.count_step(arch, shape, ONE, opts)
        assert dryrun.fit_over_seq(arch, shape, ONE, opts, lengths) \
            == direct, (kind, arch.block_pattern)
    assert dryrun.seq_fitted(smoke, ShapeConfig("x", "train", 1024, 2))
    assert not dryrun.seq_fitted(smoke, ShapeConfig("x", "train", 768, 2))
    assert not dryrun.seq_fitted(get_smoke_config("hymba-1.5b"),
                                 ShapeConfig("x", "prefill", 1024, 2))
    monkeypatch.setattr(dryrun, "SEQ_FIT", (256, 384, 512))
    shape = ShapeConfig("x", "prefill", 640, 1)
    r = dryrun.run_cell("xlstm-350m", "x", mesh=ONE, arch=mlstm,
                        shape=shape, opts=opts, verbose=False)
    assert r["status"] == "ok" and r["count"] == "fit over S at 256, 384, 512"
    assert r["per_device"]["flops_macs"] \
        == dryrun.count_step(mlstm, shape, ONE, opts)["flops"]


def test_argument_bytes_one_card_and_the_train_step_takes_frames():
    arch = get_smoke_config("whisper-large-v3")
    shape = ShapeConfig("x", "train", 16, 4)
    opts = dryrun.DryrunOptions(microbatches=2, cost_fit=False)
    fn, args, specs = dryrun.build_step(arch, shape, ONE, opts)
    model, ostate, batch = args
    want = sum(p.numel() * p.element_size() for p in model.parameters()) \
        + 2 * sum(p.numel() * 4 for p in model.parameters()) + 4 \
        + sum(t.numel() * t.element_size() for t in batch.values())
    assert "frames" in batch
    assert dryrun.argument_bytes(args, specs, ONE) == want
    r = dryrun.run_cell("whisper-large-v3", "x", mesh=ONE, arch=arch,
                        shape=shape, opts=opts, verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["memory"]["argument_bytes"] == want
    # on the CPU: make_train_step's loss is the mean of the microbatches'
    model = lm.init_params(dataclasses.replace(arch, dtype="float32"), 0,
                           "cpu")
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, arch.vocab_size, (4, 8)).astype(np.int32),
         "targets": rng.integers(0, arch.vocab_size, (4, 8)).astype(
             np.int32),
         "frames": rng.standard_normal((4, arch.encoder_seq,
                                        arch.d_model)).astype(np.float32)}
    with torch.no_grad():
        want = np.mean([float(lm.train_loss(model, {
            k: v[i:i + 2] for k, v in b.items()})) for i in (0, 2)])
    model.requires_grad_(True)
    opt = AdamW(1e-3)
    step = driver.make_train_step(arch, opt, driver.TrainerConfig(
        microbatches=2))
    got = float(step(model, opt.init(dict(model.named_parameters())), b))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("dtype,D,causal,window", [
    (torch.float32, 32, True, 0), (torch.bfloat16, 64, True, 16),
    (torch.bfloat16, 128, False, 0)])
def test_meta_k5_seam_event_equals_cpu(dtype, D, causal, window):
    rng = np.random.default_rng(0)
    shapes = ((2, 4, 48, D), (2, 2, 64, D), (2, 2, 64, D))
    cpu = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype) for s in shapes]
    meta = [t.to("meta").requires_grad_() for t in cpu]
    events = {}
    for where, ts in (("cpu", cpu), ("meta", meta)):
        with Recorder() as rec:
            out = flash_attention(*ts, causal=causal, window=window)
        (events[where], _), = rec.events
        assert out.shape == ts[0].shape and out.dtype == dtype
        assert out.device == ts[0].device
        assert rec.setup.flops == events[where].flops
    assert events["meta"]._replace(route="plain") == events["cpu"]
    assert events["cpu"].route == "plain"
    assert events["meta"].route == dispatch.flash_attention_route(dtype, D)
    assert events["cpu"].flops == 4.0 * 2 * 4 * D * 48 * 64
    grads = torch.autograd.grad(out.float().sum(), meta)
    assert [g.shape for g in grads] == [t.shape for t in meta]


# The public names of repro's modules that the port scopes out, and why.
SCOPED_OUT = {
    # a TPU v5e: the port's machine is HW_H100
    "HW_V5E": "describes a TPU",
    # readers of compiled XLA: an eager program has no HLO or
    # cost_analysis (the port builds CollectiveStats from a Recorder)
    "collective_stats_from_hlo": "reads compiled XLA",
    "collective_bytes_from_hlo": "reads compiled XLA",
    "cost_analysis_dict": "reads compiled XLA",
}
REPRO_MODULES = {"roofline/__init__.py": "roofline",
                 "roofline/analysis.py": "roofline.analysis",
                 "parallel/__init__.py": "parallel",
                 "parallel/sharding.py": "parallel.sharding",
                 "launch/mesh.py": "launch.mesh",
                 "launch/dryrun.py": "launch.dryrun"}


def _public(path):
    """The public names a module defines at top level (a package's
    ``__init__`` also those it re-exports)."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and node.module \
                and path.endswith("__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", list(REPRO_MODULES))
def test_public_names_resolve_in_the_port(rel):
    names = _public(os.path.join(ROOT, "src", "repro", rel))
    assert names
    port = importlib.import_module("repro_torch." + REPRO_MODULES[rel])
    missing = sorted(n for n in names
                     if n not in SCOPED_OUT and not hasattr(port, n))
    assert not missing, missing


def test_cli_prints_one_ok_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3-8b", "--shape", "prefill_32k",
                     "--mesh", "1x1"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    ok = [ln for ln in out.splitlines() if ln.startswith("[ OK ]")]
    assert len(ok) == 1 and "h100" in ok[0] and "fits=False" in ok[0]
    assert os.path.exists(os.path.join(tmp_path,
                                       "llama3-8b__prefill_32k__pod1x1.json"))
    with pytest.raises(SystemExit):                  # the cached cell
        dryrun.main(["--arch", "llama3-8b", "--shape", "prefill_32k",
                     "--mesh", "1x1"])
    assert capsys.readouterr().out.count("[ OK ]") == 1
    assert SHAPES["prefill_32k"].global_batch == 32
