"""Dry run of the port (the port of ``repro/launch/dryrun.py``): every
(architecture x input shape x mesh) cell's step, run on the meta device at
full width and depth (nothing is allocated), with the roofline inputs
counted as it runs:

  * FLOPs: ``analysis.record.Recorder``'s count, ``repro.analysis``'s
    convention: 2 x output x contraction of each matrix product, plus each
    kernel seam's event (K5: 4 B Hq D Sq Sk, ``repro``'s cost-exact
    count). One card: the count itself. A mesh of n > 1 cards: the count
    / n (``flops_split: "even"``);
  * argument bytes per device, exact: what each leaf's sanitized partition
    spec (``repro_torch.parallel``) leaves on a device, over the
    parameters, the AdamW state (train) and the batch or decode cache.
    The parameters' specs are the port's own layout
    (``parallel.tensor.partition_specs``: ``repro``'s sanitized rules on
    the 'model' axis, its ``fsdp`` rule on 'data'), what each rank of the
    trainer's grid holds, on every mesh;
  * temp bytes: the peak of the meta storage that the step made and that
    was alive at once, tracked by storage identity with weak references,
    so the step's own frees (autograd's saved tensors included) count as
    they do on the card. ``fits_hbm``: argument + temp below
    ``HW_H100.hbm_bytes``;
  * HBM bytes: each operation's tensor inputs and outputs summed, views
    excluded (a kernel seam: its operands and output). This is eager's
    unfused traffic, what the card runs, not XLA's fused "bytes
    accessed".

On a mesh of n > 1 cards, temp and HBM bytes are the count / n too
(``even``), and collectives are not counted (``collective_s`` None; the
HLO parser they need is scoped out, ROADMAP Queue 1, item 7); on one card
there are none. With ``cost_fit`` the cell is also counted at 1 and 2
layer groups (``_reduced``) and fit to full depth (``two_point_fit``), as
``repro`` does; for an arch without attention (xlstm), whose sLSTM scan
is S host-launched steps, a train or prefill cell is counted at three
short lengths and fit over S instead (``fit_over_seq``). The step it
runs is one process's whole step, without ``shard_acts`` (the trainer's
sequence parallelism); ``unroll_layers`` is not ported (a layer is a
module, counted as it runs). Results
cache as JSON under ``results/dryrun_torch/``. The numbers are
predictions on ``HW_H100``'s data-sheet peaks.

The steps are the port's own: train is ``runtime.driver.make_train_step``
(microbatches into one f32 buffer, AdamW), prefill is ``LM.prefill``
(only the last position is unembedded, where ``repro``'s prefill step
makes every position's logits), decode is ``LM.decode_step`` at the last
position of a full cache, its arguments the tokens, the cache and ``pos``
(not the frames, which ``repro``'s decode batch carries and does not
read: their cross k and v are in the cache). On a mesh with a model axis
the decode cell's argument bytes are what a rank of the port's split
decode holds (``lm.init_cache(..., axis=)``: the KV and cross caches'
sequence split, the recurrent states whole).

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 1x1  # all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from fractions import Fraction
from typing import Dict, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.record import Recorder
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, \
    input_specs
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh, \
    set_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.sharding import (batch_partition_specs,
                                           shard_shape)
from repro_torch.parallel.tensor import partition_specs
from repro_torch.roofline.analysis import (HW_H100, model_flops,
                                           roofline_terms, two_point_fit)
from repro_torch.runtime import driver

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "..", "..", "..", "results", "dryrun_torch")
META = torch.device("meta")


@dataclasses.dataclass
class DryrunOptions:
    remat: str = "full"
    include_optimizer: bool = True
    microbatches: int = 1        # grad-accumulation splits (memory knob;
    #                              ONE gradient reduction per step)
    cost_fit: bool = True        # also count at 1 and 2 layer groups


# per-(arch, shape) microbatch defaults (``repro``'s; a run of 1 takes
# them, the FLOPs are invariant to the split).
MICROBATCH_DEFAULTS = {
    ("mixtral-8x7b", "train_4k"): 8,
    ("llama3-8b", "train_4k"): 4,
    ("stablelm-12b", "train_4k"): 4,
    ("pixtral-12b", "train_4k"): 4,
    ("qwen1.5-4b", "train_4k"): 4,
    ("whisper-large-v3", "train_4k"): 8,
    ("granite-moe-1b-a400m", "train_4k"): 4,
    ("hymba-1.5b", "train_4k"): 8,
    ("tinyllama-1.1b", "train_4k"): 2,
    ("xlstm-350m", "train_4k"): 2,
}
# The lengths of the fit over S: multiples of ``chunked_gla``'s chunk of 128
# from two chunks on, where a count is linear in S (FLOPs, temp bytes) or,
# the HBM bytes of a training step, quadratic (each of the sLSTM's S
# steps reads a (B, S, D) slice, whose backward writes a full-length
# gradient), so a quadratic through three lengths is exact.
SEQ_FIT = (256, 512, 768)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class Meter(Recorder):
    """A :class:`Recorder` (FLOPs) that also keeps the HBM bytes of each
    operation and the peak of the live storage the step made.
    ``hold(tensors)`` marks the arguments' storage, which is not the
    step's own."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._known = WeakIdKeyDictionary()

    def hold(self, tensors) -> None:
        for t in _tensors(tensors):
            self._known[t.untyped_storage()] = True

    def _free(self, n: int) -> None:
        self.live -= n

    def _made(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._known:
                continue
            self._known[st] = True
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def enter_seam(self, event) -> None:
        if self._seam == 0:
            # the operands read and an output of the first operand's shape
            # written: K5's, the one seam an LM step reaches.
            self.hbm_bytes += sum(math.prod(s) for s in event.shapes) \
                * event.dtype_in.itemsize \
                + math.prod(event.shapes[0]) * event.dtype_out.itemsize
        super().enter_seam(event)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self._made(out)
        name = func._schema.name
        if self._seam == 0 and not func.is_view \
                and not name.startswith(("aten::empty", "aten::new_empty")):
            for t in list(_tensors(args)) + list(_tensors(kwargs)) \
                    + list(_tensors(out)):
                self.hbm_bytes += min(_nbytes(t), t.untyped_storage().nbytes())
        return out

    def flops(self) -> float:
        return sum(t.flops for t in self.spans())


class _Frozen:
    """An optimizer whose update changes nothing (``include_optimizer``
    off: the state is still an argument, as in ``repro``)."""

    @staticmethod
    def update(grads, state, params, **_):
        return params, state


def build_step(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
               opts: DryrunOptions):
    """(fn, args, specs): ``fn(*args)`` runs one step eagerly on the meta
    device; ``specs`` are the partition specs of ``args``, leaf for leaf."""
    batch = input_specs(arch, shape, META)
    if shape.kind == "decode":
        # decode reads the tokens, the cache and pos: an encoder-decoder
        # arch's frames are in the cache's cross k and v, which a rank
        # holds instead (``repro``'s decode batch carries them unread)
        batch.pop("frames", None)
    model = lm.param_specs(arch)
    # the port's own layout, what a rank of its trainer holds: repro's
    # sanitized rules on the model axis, its fsdp rule on the data axis
    ppart = partition_specs(arch, mesh)
    bpart = batch_partition_specs(batch, mesh, kind=shape.kind)

    if shape.kind == "train":
        model.requires_grad_(True)
        opt = AdamW(learning_rate=1e-4)
        ostate = opt.init(dict(model.named_parameters()))
        opart = opt.state_specs(ppart)
        step = driver.make_train_step(
            arch, opt if opts.include_optimizer else _Frozen(),
            driver.TrainerConfig(microbatches=opts.microbatches,
                                 remat=opts.remat))
        return step, (model, ostate, batch), (ppart, opart, bpart)

    if shape.kind == "prefill":
        def prefill_step(model, batch):
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            with torch.no_grad():
                return model.prefill(batch["tokens"], extras)
        return prefill_step, (model, batch), (ppart, bpart)

    def serve_step(model, batch):
        # ``pos`` stands in for the position, which a meta tensor cannot
        # hold: the last slot of the cache.
        with torch.no_grad():
            return model.decode_step(batch["tokens"], batch["cache"],
                                     shape.seq_len - 1)[0]
    return serve_step, (model, batch), (ppart, bpart)


def _leaves(arg):
    """An argument (or its specs) as nested dicts and lists: an LM as its
    named parameters, an AdamW state as its step, mu and nu, a batch as
    it is."""
    if isinstance(arg, torch.nn.Module):
        return dict(arg.named_parameters())
    if hasattr(arg, "_fields"):                          # AdamWState
        return {"step": arg.step, "mu": arg.mu, "nu": arg.nu}
    return arg


def argument_bytes(args, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``args`` laid out by ``specs``."""
    total = 0

    def walk(x, s):
        nonlocal total
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            total += math.prod(shard_shape(tuple(x.shape), s, mesh)) \
                * x.element_size()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, s[k])
        elif isinstance(x, (list, tuple)):
            for v, sv in zip(x, s):
                walk(v, sv)
    for a, s in zip(args, specs):
        walk(_leaves(a), _leaves(s))
    return total


def count_step(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
               opts: DryrunOptions) -> Dict:
    """One step of the cell on the meta device: its FLOPs, HBM bytes,
    argument, temp and output bytes, all for the whole step (one card's
    worth when the mesh is one card)."""
    fn, args, specs = build_step(arch, shape, mesh, opts)
    meter = Meter()
    meter.hold(list(_leaves(a) for a in args))
    with set_mesh(mesh), meter:
        out = fn(*args)
    output = sum(min(_nbytes(t), t.untyped_storage().nbytes())
                 for t in _tensors(out))
    return {"flops": meter.flops(), "hbm_bytes": meter.hbm_bytes,
            "argument_bytes": argument_bytes(args, specs, mesh),
            "temp_bytes": meter.peak, "output_bytes": output}


def _attention_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic attention FLOPs per step: 4*B*Hq*Dh*sum_attended per layer
    forward (QK^T + PV), x3 for train (bwd). Causal full attention sums
    ~S^2/2 pairs; sliding window ~S*window."""
    B, S = shape.global_batch, shape.seq_len
    Hq, Dh = arch.n_heads, arch.head_dim_
    n_attn_layers = sum(
        1 for i in range(arch.n_layers)
        if arch.block_at(i) in ("attn_mlp", "swa_mlp", "moe", "hybrid"))
    if shape.kind == "decode":
        attended = min(S, arch.window) if arch.window else S
        per_layer = 4.0 * B * Hq * Dh * attended
        return per_layer * n_attn_layers
    if arch.window:
        pairs = S * min(arch.window, S)
    else:
        pairs = S * S / 2.0
    per_layer = 4.0 * B * Hq * Dh * pairs
    mult = 3.0 if shape.kind == "train" else 1.0
    total = per_layer * n_attn_layers * mult
    if arch.is_encdec:
        enc_pairs = arch.encoder_seq ** 2
        total += 4.0 * B * Hq * Dh * enc_pairs * arch.encoder_layers * mult
        total += 4.0 * B * Hq * Dh * S * arch.encoder_seq \
            * arch.n_layers * mult        # cross-attention
    return total


def _reduced(arch: ArchConfig, groups: int) -> ArchConfig:
    period = len(arch.block_pattern)
    kw = {"n_layers": period * groups}
    if arch.encoder_layers:
        kw["encoder_layers"] = max(1, groups)
    return dataclasses.replace(arch, **kw)


def seq_fitted(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """Whether the cell is counted by the fit over S: a train or prefill
    step of an arch without attention layers, longer than the fit's
    lengths."""
    return shape.kind != "decode" and not lm.has_attention(arch) \
        and shape.seq_len > SEQ_FIT[-1]


def quadratic_fit(xs, ys, x: float) -> float:
    """The quadratic through the three points (xs[i], ys[i]) at x
    (Lagrange's form in exact rational arithmetic, so integer counts on a
    line or a parabola come back exactly)."""
    out = Fraction(0)
    for i in range(3):
        term = Fraction(ys[i])
        for j in range(3):
            if j != i:
                term *= Fraction(x - xs[j], xs[i] - xs[j])
        out += term
    return float(out)


def fit_over_seq(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                 opts: DryrunOptions, lengths=None) -> Dict:
    """``count_step`` at the three ``lengths`` and each count but the
    argument bytes fit to ``shape.seq_len`` by ``quadratic_fit`` (exact
    for an arch without attention, at multiples of its chunk from two
    chunks on); the argument bytes are counted at the full length."""
    lengths = lengths or SEQ_FIT
    pts = [count_step(arch, dataclasses.replace(shape, seq_len=s), mesh,
                      opts) for s in lengths]
    out = {k: quadratic_fit(lengths, [p[k] for p in pts], shape.seq_len)
           for k in pts[0]}
    _, args, specs = build_step(arch, shape, mesh, opts)
    out["argument_bytes"] = argument_bytes(args, specs, mesh)
    for k in ("temp_bytes", "output_bytes"):
        out[k] = int(round(out[k]))
    return out


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def mesh_label(mesh: Mesh) -> str:
    return "pod" + "x".join(str(d) for d in mesh.dims)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
             opts: Optional[DryrunOptions] = None, mesh: Optional[Mesh] = None,
             verbose: bool = True, *, arch: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict:
    """One cell's result (``repro``'s keys). ``arch`` / ``shape`` replace
    the named configs (a cut depth, a path's own batch and length)."""
    opts = opts or DryrunOptions()
    if opts.microbatches == 1:
        mb = MICROBATCH_DEFAULTS.get((arch_name, shape_name), 1)
        if mb != 1:
            opts = dataclasses.replace(opts, microbatches=mb)
    arch = arch or get_config(arch_name)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    result: Dict = {"arch": arch_name, "shape": shape_name,
                    "mesh": mesh_label(mesh), "status": "ok",
                    "opts": dataclasses.asdict(opts)}
    if shape_name in arch.skip_shapes:
        result["status"] = "skip"
        result["reason"] = ("pure full-attention arch: long_500k needs "
                            "sub-quadratic attention (DESIGN.md)")
        return result
    n_chips = mesh.size
    t0 = time.time()
    try:
        fitted = seq_fitted(arch, shape)
        c = fit_over_seq(arch, shape, mesh, opts) if fitted \
            else count_step(arch, shape, mesh, opts)
        result["count"] = "fit over S at %d, %d, %d" % SEQ_FIT if fitted \
            else "direct"
        split = 1 if n_chips == 1 else n_chips
        temp = c["temp_bytes"] // split
        result["memory"] = {
            "argument_bytes": int(c["argument_bytes"]),
            "output_bytes": int(c["output_bytes"] // split),
            "temp_bytes": int(temp),
            "total_bytes": int(c["argument_bytes"] + temp),
            "fits_hbm": bool(c["argument_bytes"] + temp
                             < HW_H100.hbm_bytes),
        }
        flops_dev = c["flops"] / split
        bytes_dev = c["hbm_bytes"] / split
        coll_dev = 0.0 if n_chips == 1 else None
        result["flops_split"] = "exact" if n_chips == 1 else "even"
        if opts.cost_fit:
            n_groups = arch.n_layers // len(arch.block_pattern)
            pts = {}
            for g in (1, 2):
                red = _reduced(arch, g)
                cg = fit_over_seq(red, shape, mesh, opts) if fitted \
                    else count_step(red, shape, mesh, opts)
                pts[g] = {"flops": cg["flops"] / split,
                          "bytes": cg["hbm_bytes"] / split}
            result["cost_fit_points"] = pts
            result["cost_fit"] = {
                key: two_point_fit(pts[1][key], pts[2][key], 1, 2, n_groups)
                for key in ("flops", "bytes")}
        result["per_device"] = {"flops_macs": flops_dev,
                                "hbm_bytes": bytes_dev,
                                "collective_bytes": coll_dev}

        # ---- roofline terms on the H100 --------------------------------
        terms = roofline_terms(flops_dev, bytes_dev, coll_dev or 0.0)
        if coll_dev is None:
            terms["collective_s"] = None          # not counted
        result["roofline"] = terms
        n_active = lm.param_count(arch)
        if arch.n_experts:
            # the analytic active count rescaled by the leaves / analytic
            # ratio (repro's).
            n_active = int(arch.active_param_count() * n_active
                           / max(arch.param_count(), 1))
        tokens = shape.global_batch * shape.seq_len
        mf = model_flops(n_active, shape.kind, tokens, shape.global_batch)
        flops_global = flops_dev * n_chips
        result["model_flops"] = mf
        result["useful_ratio"] = mf / flops_global if flops_global else 0.0
        af = _attention_flops(arch, shape)
        result["attention_flops"] = af
        result["useful_ratio_attn"] = (mf + af) / flops_global \
            if flops_global else 0.0
        result["n_chips"] = n_chips
        result["wall_s"] = round(time.time() - t0, 1)
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-3000:]
    if verbose:
        _print_cell(result)
    return result


def _print_cell(r: Dict):
    if r["status"] == "skip":
        print(f"[SKIP] {r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
              f"({r['reason'][:60]})")
        return
    if r["status"] == "error":
        print(f"[FAIL] {r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
              f"{r['error'][:120]}")
        return
    m, t = r["memory"], r["roofline"]
    coll = "   n/c  " if t["collective_s"] is None \
        else f"{t['collective_s'] * 1e3:8.2f}"
    print(f"[ OK ] {r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
          f"mem/dev={m['total_bytes'] / 1e9:7.2f}GB "
          f"fits={m['fits_hbm']} "
          f"C={t['compute_s'] * 1e3:9.2f}ms M={t['memory_s'] * 1e3:9.2f}ms "
          f"N={coll}ms -> {t['dominant']:8s} bound "
          f"{t['bound_s'] * 1e3:.2f}ms on {HW_H100.name} "
          f"useful={r['useful_ratio']:.2f}/{r['useful_ratio_attn']:.2f} "
          f"({r['wall_s']}s)")


def cell_path(arch: str, shape: str, mesh: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="data x model, e.g. 1x1 (one card) or 4x1; "
                         "default: the production mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-optimizer", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.mesh:
        meshes = [make_mesh([int(d) for d in args.mesh.split("x")],
                            ("data", "model"))]
    else:
        meshes = [make_production_mesh(multi_pod=mp) for mp in
                  ([False, True] if args.both_meshes else [args.multi_pod])]
    base_opts = DryrunOptions(remat=args.remat,
                              include_optimizer=not args.no_optimizer)

    n_fail = 0
    for mesh in meshes:
        # the fit points on the production mesh only, as repro's
        # single-pod roofline pass.
        opts = dataclasses.replace(base_opts,
                                   cost_fit="pod" not in mesh.axis_names)
        for a in archs:
            for s in shapes:
                path = cell_path(a, s, mesh_label(mesh))
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        r = json.load(f)
                    _print_cell(r)
                    n_fail += r["status"] == "error"
                    continue
                r = run_cell(a, s, opts=opts, mesh=mesh)
                if r["status"] == "ok":
                    r.pop("traceback", None)
                with open(path, "w") as f:
                    json.dump(r, f, indent=1)
                n_fail += r["status"] == "error"
    print(f"\ndone; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
