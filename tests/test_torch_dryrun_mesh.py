"""The dry run's count of a rank's own step on a mesh
(``repro_torch.launch.dryrun`` on n > 1 cards), held to real ranks.

* Exactness: for the smoke configs at f32, each rank of a gloo job
  records its step with a ``Recorder`` (``analysis.record``) on the CPU,
  and the dry run's cell of the same rank's step on the meta device,
  inside a process group of the ``fake`` backend, counts the same: its
  FLOPs, and its collectives by axis ('model', 'data') and kind, count
  and result bytes, each exactly. hymba's rank 1 computes more than its
  rank 0 (under ``shard_acts`` its 4 meta rows sit on rank 0 and carry no
  loss, and its vocabulary of 256 is whole), and each is held to its own
  cell. The cells: tinyllama train at 1x2 with and without
  ``shard_acts``, granite (EP) train at 2x2 (the data group's MoE
  routing), hymba train at 1x2 (its 5 heads by flat columns), tinyllama
  FSDP train at 2x1, xlstm and whisper (the cross cache) decode at 1x2,
  the decodes recorded in ``inference_mode`` (the dry run's run under
  ``no_grad``), whisper train at 1x2 with ``shard_acts`` (its frames
  whole on each rank, the encoder without SP) and pixtral train at 1x2
  with ``shard_acts`` (its 8 patch rows first, on rank 0), ranks 0 and 1.
  One four-rank gloo job runs them all: 2x2 over its four ranks, 1x2 and
  2x1 over ranks 0 and 1 (``parallel.tensor.build_grid(..., ranks)``).
* The leaves a rank holds on meta sum to the argument bytes of the specs
  on 1x2, 2x1 and 2x2, for every arch at full width.
* The fit over depth equals the direct count for the collective bytes
  (dense, 2x2); the fit over S does for xlstm's collectives at 1x2.
* A cell on the production mesh (16 x 16) and on the multi-pod mesh
  (its data axis pod x data: 32 ranks) counts rank 0's step at full
  width and a cut depth, with a collective term.
* ``run_cell`` leaves no process group behind, and refuses to count a
  mesh cell in a process that runs one.

The module imports no JAX: the reference is the port's own ranks.
"""
import dataclasses
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis.record import Recorder
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import distributed, linalg
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor as par
from repro_torch.roofline import collective_stats
from repro_torch.runtime.driver import TrainerConfig, make_train_step

B, S = 4, 32
# name -> (arch, kind, (data, model), shard_acts, microbatches)
CELLS = {
    "tinyllama_1x2_sp": ("tinyllama-1.1b", "train", (1, 2), True, 2),
    "tinyllama_1x2": ("tinyllama-1.1b", "train", (1, 2), False, 1),
    "granite_2x2": ("granite-moe-1b-a400m", "train", (2, 2), False, 2),
    "hymba_1x2": ("hymba-1.5b", "train", (1, 2), True, 1),
    "tinyllama_fsdp_2x1": ("tinyllama-1.1b", "train", (2, 1), False, 1),
    "xlstm_decode_1x2": ("xlstm-350m", "decode", (1, 2), False, 1),
    "whisper_decode_1x2": ("whisper-large-v3", "decode", (1, 2), False, 1),
    "whisper_1x2_sp": ("whisper-large-v3", "train", (1, 2), True, 2),
    "pixtral_1x2_sp": ("pixtral-12b", "train", (1, 2), True, 2),
}
# hymba-smoke with a vocabulary the model axis does not split, as
# hymba-1.5b's 32,001 at m = 2: its ranks' steps differ
FIELDS = {"hymba_1x2": {"vocab_size": 255}}
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}


def _arch(key):
    return dataclasses.replace(get_smoke_config(CELLS[key][0]),
                               dtype="float32", **FIELDS.get(key, {}))


def _shape(kind):
    return ShapeConfig("cell", kind, S, B)


def _cell_on_rank(key, group):
    """One cell's step on this rank of ``group``'s grid, recorded: (its
    FLOPs, its collectives by axis)."""
    name, kind, (D, M), sp, k = CELLS[key]
    arch = _arch(key)
    grid = par.build_grid(group, M, list(range(D * M)))
    axis = grid.model if M > 1 else None
    gen = torch.Generator().manual_seed(1)
    model = lm.init_params(arch, 0, "cpu", axis)
    rec = Recorder()
    if kind == "train":
        fsdp.shard_params(model, fsdp.grid_data_layout(arch, D, M),
                          grid.data)
        model.requires_grad_(True)
        opt = AdamW(learning_rate=1e-4)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(arch, opt, TrainerConfig(
            microbatches=k, remat="none", shard_acts=sp, model_axis=M),
            grid=grid)
        # the batch of ``input_specs``: a vision stub's patch rows count
        # in S; an encoder-decoder arch's frames come beside the tokens
        n = min(arch.n_patches, S // 4) \
            if arch.frontend == "vision_stub" else 0
        toks = torch.randint(arch.vocab_size, (2, B // D, S - n),
                             generator=gen, dtype=torch.int32)
        batch = {"tokens": toks[0], "targets": toks[1]}
        if n:
            batch["patches"] = torch.randn(B // D, n, arch.d_model,
                                           generator=gen)
        if arch.is_encdec:
            batch["frames"] = torch.randn(B // D, arch.encoder_seq,
                                          arch.d_model, generator=gen)
        with rec:
            step(model, state, batch)
    else:
        cache = lm.init_cache(arch, B, S, "cpu", axis, grid.data)
        toks = torch.randint(arch.vocab_size, (B // D, 1), generator=gen,
                             dtype=torch.int32)
        # as a server decodes (and phase 21 (g) records): in inference
        # mode, where composite products reach the recorder whole
        with torch.inference_mode(), rec:
            model.decode_step(toks, cache, S - 1, data=grid.data)
    out = (sum(t.flops for t in rec.spans()),
           dryrun.axes_traffic(rec, grid))
    for g in grid.made:
        dist.destroy_process_group(g)
    return out


def _rank(rank, world, tmp):
    torch.set_num_threads(1)        # four ranks share the host's cores
    out = {}
    for key, (_, _, (D, M), _, _) in CELLS.items():
        if rank < D * M:
            out[key] = _cell_on_rank(key, dist.group.WORLD)
        dist.barrier()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{rank: {cell: (its FLOPs, its collectives by axis)}}."""
    tmp = str(tmp_path_factory.mktemp("dryrun_mesh"))
    distributed.run_ranks(_rank, 4, "gloo", device="cpu", args=(tmp,))
    return {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(4)}


def _cell(key, **kw):
    name, kind, (D, M), sp, k = CELLS[key]
    opts = dryrun.DryrunOptions(remat="none", cost_fit=False,
                                shard_acts=sp, microbatches=k)
    r = dryrun.run_cell(name, "cell", mesh=make_mesh((D, M),
                                                     ("data", "model")),
                        arch=_arch(key), shape=_shape(kind), opts=opts,
                        verbose=False, **kw)
    assert r["status"] == "ok", r.get("traceback")
    return r


@pytest.mark.parametrize("key,rank", [
    (key, r) for key, (_, _, (D, M), _, _) in CELLS.items()
    for r in range(D * M)])
def test_rank_count_equals_a_gloo_rank(ranks, key, rank):
    """The dry run's FLOPs and collectives (count and result bytes, by
    axis and kind) of a rank equal what that rank records of the same
    step."""
    flops, axes = ranks[rank][key]
    r = _cell(key, rank=rank)
    assert r["flops_split"] == "rank" and r["rank"] == rank
    assert r["per_device"]["flops_macs"] == flops
    assert r["collectives_by_axis"] == axes
    D, M = CELLS[key][2]
    moved = [a for a, n in (("model", M), ("data", D)) if n > 1]
    total = sum(v["bytes"] for a in moved for v in axes[a].values())
    assert r["collectives_static"]["total"] == total > 0
    assert r["collective_counts"]["all-gather"] == sum(
        axes[a].get("all-gather", {}).get("count", 0) for a in moved)
    assert r["roofline"]["collective_s"] > 0


def test_the_cells_run_what_they_name(ranks):
    """The cells exercise their feature: SP gathers the sequence, FSDP
    reduce-scatters once, the MoE routes over the data group, hymba's
    flat columns gather, the decodes gather over the model group."""
    model = {k: ranks[0][k][1].get("model", {}) for k in ranks[0]}
    data = {k: ranks[0][k][1]["data"] for k in ranks[0]}
    assert model["tinyllama_1x2_sp"]["reduce-scatter"]["count"] > 0
    assert "reduce-scatter" not in model["tinyllama_1x2"]
    assert data["tinyllama_1x2"] == {"all-reduce": {
        "count": 1, "bytes": data["tinyllama_1x2"]["all-reduce"]["bytes"]}}
    assert data["tinyllama_fsdp_2x1"]["reduce-scatter"]["count"] == 1
    assert data["granite_2x2"]["all-gather"]["count"] \
        > data["tinyllama_fsdp_2x1"]["all-gather"]["count"]
    assert model["hymba_1x2"]["all-gather"]["count"] \
        > model["tinyllama_1x2_sp"]["all-gather"]["count"]
    for key in ("xlstm_decode_1x2", "whisper_decode_1x2"):
        assert model[key]["all-gather"]["count"] > 0 and not data[key]
    # the archs with extras gather and scatter the decoder's sequence
    for key in ("whisper_1x2_sp", "pixtral_1x2_sp"):
        assert model[key]["reduce-scatter"]["count"] > 0
    # the one step whose ranks differ: hymba's rank 1 computes the
    # logits of the positions rank 0's meta rows take
    assert ranks[1]["hymba_1x2"][0] > ranks[0]["hymba_1x2"][0]
    assert ranks[1]["tinyllama_1x2_sp"][0] == ranks[0]["tinyllama_1x2_sp"][0]


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list_archs())
def test_rank_holds_the_argument_bytes(name, mesh, kind):
    """The leaves rank 0 holds on meta (parameters, AdamW state and batch
    rows, or the cache's shares) sum to the specs' argument bytes."""
    arch = get_config(name)
    shape = ShapeConfig("cell", kind, 4096, 16)
    grid_mesh = make_mesh(MESHES[mesh], ("data", "model"))
    opts = dryrun.DryrunOptions()
    _, whole, specs = dryrun.build_step(arch, shape, grid_mesh, opts)
    want = dryrun.argument_bytes(whole, specs, grid_mesh)
    with dryrun.rank_grid(grid_mesh) as grid:
        _, args = dryrun.build_rank_step(arch, shape, grid_mesh, grid, opts)
        assert dryrun.held_bytes(args) == want
    assert not dist.is_initialized()


def test_depth_fit_equals_the_direct_count_of_collectives():
    arch = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"))
    for kind in ("train", "decode"):
        r = dryrun.run_cell("llama3-8b", "cell", mesh=mesh, arch=arch,
                            shape=_shape(kind), verbose=False)
        assert r["status"] == "ok", r.get("traceback")
        assert r["cost_fit"]["coll"] == r["per_device"]["collective_bytes"] \
            > 0
        assert r["cost_fit"]["flops"] == r["per_device"]["flops_macs"]
        assert r["cost_fit"]["bytes"] == r["per_device"]["hbm_bytes"]


def test_seq_fit_equals_the_direct_count_of_collectives():
    smoke = get_smoke_config("xlstm-350m")
    mlstm = dataclasses.replace(smoke, block_pattern=("mlstm",), n_layers=1)
    mesh = make_mesh((1, 2), ("data", "model"))
    opts = dryrun.DryrunOptions(cost_fit=False)
    shape = ShapeConfig("x", "train", 640, 2)
    direct = dryrun.count_step(mlstm, shape, mesh, opts)
    assert direct["collectives"]["model"]
    assert dryrun.fit_over_seq(mlstm, shape, mesh, opts,
                               (256, 384, 512)) == direct


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_cell_counts_a_rank(multi_pod):
    """tinyllama-1.1b at full width, one layer, on the 16 x 16 mesh (and
    2 x 16 x 16): rank 0's step, with a positive collective term and the
    one gradient reduce-scatter of FSDP over the data group (16 ranks, or
    the multi-pod mesh's 32)."""
    arch = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=1)
    opts = dryrun.DryrunOptions(cost_fit=False)
    r = dryrun.run_cell("tinyllama-1.1b", "train_4k", multi_pod=multi_pod,
                        arch=arch, opts=opts, verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    assert r["flops_split"] == "rank" and r["n_chips"] == 256 * (
        2 if multi_pod else 1)
    assert r["roofline"]["collective_s"] > 0
    assert set(r["collectives_by_axis"]) == {"model", "data"}
    assert r["collectives_by_axis"]["data"]["reduce-scatter"]["count"] == 1
    assert not dist.is_initialized()


def test_result_bytes_are_repros_convention():
    """A collective's result bytes: an all-gather's gathered output, a
    reduce-scatter's block of the rank, an all-reduce's tensor; the
    ``CollectiveStats`` of a Recorder's traffic over chosen groups."""
    mesh = make_mesh((4, 2), ("data", "model"))
    with dryrun.rank_grid(mesh) as grid, Recorder() as rec:
        meta = torch.device("meta")
        linalg.pall_gather(torch.empty(4, 3, device=meta), grid.model.group)
        linalg.preduce_scatter(torch.empty(8, 3, device=meta),
                               grid.data.group)
        linalg.preduce(torch.empty(5, device=meta), grid.data.group)
        linalg.pmax(torch.empty(5, device=meta), grid.model.group)
        axes = dryrun.axes_traffic(rec, grid)
    assert axes == {
        "model": {"all-gather": {"count": 1, "bytes": 8 * 3 * 4.0},
                  "all-reduce": {"count": 1, "bytes": 5 * 4.0}},
        "data": {"all-reduce": {"count": 1, "bytes": 5 * 4.0},
                 "reduce-scatter": {"count": 1, "bytes": 2 * 3 * 4.0}}}
    stats = collective_stats(axes, ["data"])
    assert stats.counts == {"all-reduce": 1, "all-gather": 0,
                            "reduce-scatter": 1, "all-to-all": 0,
                            "collective-permute": 0}
    assert stats.total_bytes == 44.0 and stats.total_count == 2
    assert collective_stats(axes).total_bytes == 160.0


def test_run_cell_leaves_no_group_and_refuses_inside_one(tmp_path):
    assert not dist.is_initialized()
    r = _cell("tinyllama_1x2")
    assert r["status"] == "ok" and not dist.is_initialized()
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        name, kind, (D, M), sp, k = CELLS["tinyllama_1x2"]
        r = dryrun.run_cell(name, "cell", mesh=make_mesh((D, M),
                                                         ("data", "model")),
                            arch=_arch("tinyllama_1x2"), shape=_shape(kind),
                            verbose=False)
        assert r["status"] == "error"
        assert "already runs a process group" in r["error"]
        # one card needs no group
        one = dryrun.run_cell(name, "cell", mesh=make_mesh(
            (1, 1), ("data", "model")), arch=_arch("tinyllama_1x2"),
            shape=_shape(kind), verbose=False)
        assert one["status"] == "ok" and one["flops_split"] == "exact"
        assert one["per_device"]["collective_bytes"] == 0.0
        assert one["roofline"]["collective_s"] == 0.0
    finally:
        dist.destroy_process_group()
