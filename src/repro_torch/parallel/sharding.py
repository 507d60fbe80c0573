"""Sharding rules for the model zoo over the production mesh (the port of
``repro/parallel/sharding.py``).

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model')
multi-pod. ``repro``'s strategy, rule for rule:

* TP  — attention heads / FFN hidden / vocab over 'model' (column-parallel
  in-projections, row-parallel out-projections).
* FSDP — the remaining weight dim over 'data'.
* EP  — MoE expert dim over 'model' (detected by the 'moe' path segment).
* DP  — batch over ('pod', 'data').
* decode — KV cache sequence dim over 'model' (split-KV).

A spec is a :class:`PartitionSpec`, a tuple whose entries are None, an
axis name or a tuple of names, so ``tuple(spec)`` equals ``tuple()`` of
``repro``'s ``jax.sharding.PartitionSpec``. Every spec is sanitized
against the mesh: a named axis that does not evenly divide its dim falls
back to replication for that dim.

``repro`` stacks each pattern slot's layers along a leading group axis,
and its rules read the rank of the stacked leaf. The port holds one
tensor a layer (``layers.{i}.*``, ``encoder.layers.{j}.*``, a cache
entry's list), so for such a leaf the rule sees the layer's rank plus
one, as ``repro``'s does, and the entry for the group axis is dropped.
That entry is None for every leaf but a 1-D ``w_*`` one, whose (fsdp,
tp) keeps tp alone here: the port has no group axis to split over
'data'.

``named_shardings`` gives ``torch.distributed.tensor`` placements
(``Shard(d)`` / ``Replicate()`` per mesh dimension) on a built
``DeviceMesh``. The trainer's tensor, expert and sequence parallelism
(``repro_torch.parallel.tensor``) runs these rules' 'model' axis on every
leaf, and its FSDP (``repro_torch.parallel.fsdp``) their 'data' axis.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.launch import mesh as _mesh


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry per tensor
    dim, None (replicated), an axis name, or a tuple of axis names."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return f"P({', '.join(map(repr, self))})"


P = PartitionSpec


def get_abstract_mesh() -> _mesh.Mesh:
    """The mesh installed by ``repro_torch.launch.mesh.set_mesh``, or an
    empty one (``.empty`` True, no axes)."""
    return _mesh.current_mesh() or _mesh.EMPTY


_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_z", "w_i", "w_f", "w_o")
_ROW = ("wo", "w_down")
_REPL = ("scale", "b_decay", "b_f", "router", "w_decay",
         "r_z", "r_i", "r_f", "r_o", "meta", "pos_embed")


def _rule_for(name: str, shape: Tuple[int, ...], in_moe: bool,
              fsdp: str, tp: str, tp_size: int = 0) -> P:
    nd = len(shape)

    def pad(spec_tail):
        return P(*([None] * (nd - len(spec_tail))), *spec_tail)

    if name == "embed":
        return P(tp, fsdp)                     # (V, D): vocab-parallel
    if name == "unembed":
        return P(fsdp, tp)                     # (D, V)
    if name in _REPL:
        return P(*([None] * nd))
    if name in ("bq", "bk", "bv"):
        return pad((tp,))
    if in_moe and nd >= 3:
        n_experts = shape[nd - 3]
        ep_ok = tp_size > 0 and n_experts % tp_size == 0
        if name in ("w_gate", "w_up"):
            # EP when the expert count divides the TP axis (granite 32e);
            # otherwise expert-TP: split each expert's FFN over 'model'
            # (mixtral 8e on a 16-wide axis).
            return pad((tp, fsdp, None)) if ep_ok else pad((None, fsdp, tp))
        if name == "w_down":
            return pad((tp, None, fsdp)) if ep_ok else pad((None, tp, fsdp))
    if name in _COL and nd >= 2:
        return pad((fsdp, tp))                 # (D_in, D_out) column-par
    if name in _ROW and nd >= 2:
        return pad((tp, fsdp))                 # row-parallel
    if name.startswith("w_") and nd >= 2:      # misc projections
        return pad((fsdp, tp))
    return P(*([None] * nd))


def sanitize_spec(spec, shape: Tuple[int, ...], mesh) -> P:
    """Drop named axes that don't exist on the mesh or don't divide the
    dim."""
    parts = []
    for dim, part in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if part is None:
            parts.append(None)
            continue
        names = (part,) if isinstance(part, str) else tuple(part)
        names = tuple(n for n in names if n in mesh.axis_names)
        size = math.prod(mesh.shape[n] for n in names) if names else 1
        if not names or size == 0 or dim % size != 0:
            parts.append(None)
        else:
            parts.append(names if len(names) > 1 else names[0])
    return P(*parts)


def _stacked(name: str) -> bool:
    """Whether ``repro`` stacks the parameter ``name`` along a group axis
    (a decoder or encoder layer's leaf)."""
    return name.startswith(("layers.", "encoder.layers."))


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    items = params.named_parameters() \
        if isinstance(params, torch.nn.Module) else params.items()
    return {n: tuple(getattr(v, "shape", v)) for n, v in items}


def param_partition_specs(params, mesh=None, fsdp: str = "data",
                          tp: str = "model") -> Dict[str, P]:
    """{parameter name: spec} of ``params``: an ``LM`` (on any device, the
    meta device included) or a mapping of names to tensors or shapes."""
    tp_size = int(mesh.shape[tp]) if mesh is not None \
        and tp in mesh.axis_names else 0
    specs = {}
    for name, shape in _shapes(params).items():
        parts = name.split(".")
        layered = _stacked(name)
        seen = (1,) + shape if layered else shape
        spec = _rule_for(parts[-1], seen, "moe" in parts[:-1], fsdp, tp,
                         tp_size)
        if layered:
            spec = P(*spec[1:])
        if mesh is not None:
            spec = sanitize_spec(spec, shape, mesh)
        specs[name] = spec
    return specs


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present on this mesh ('pod' first)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_rule(name: str, shape: Tuple[int, ...], dp_spec) -> P:
    """``repro``'s input rule for a leaf of rank len(shape)."""
    nd = len(shape)
    if nd == 0:
        return P()
    if name in ("k", "v") and nd == 5:
        # stacked KV cache (G, B, Hkv, S, D): batch over DP, cache
        # sequence over 'model' (split-KV decode).
        return P(None, dp_spec, None, "model", None)
    if name.startswith(("ssm_", "mlstm_", "slstm_")):
        return P(None, dp_spec, *([None] * (nd - 2)))
    # tokens/targets/frames/patches: batch first.
    return P(dp_spec, *([None] * (nd - 1)))


# The port's cache entries under the names ``repro``'s cache gives them
# (its cross-attention k and v sit under cache["cross"]).
_CACHE_NAMES = {"cross_k": "k", "cross_v": "v"}


def batch_partition_specs(batch: Mapping, mesh, kind: str = "train"):
    """Input sharding, the structure of ``batch`` with a spec for each
    tensor (a 0-dim tensor or a Python number: ``P()``; a None layer of a
    cache entry stays None): batch dim over the DP axes; decode caches
    shard the KV sequence dim over 'model' (split-KV). ``batch["cache"]``
    is ``init_cache``'s {entry: one tensor a layer}, whose leaves
    ``repro`` stacks."""
    dp = dp_axes(mesh)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)

    def spec_for(name, leaf, layered):
        shape = tuple(getattr(leaf, "shape", ()))
        if layered:
            spec = P(*_batch_rule(_CACHE_NAMES.get(name, name),
                                  (1,) + shape, dp_spec)[1:])
        else:
            spec = _batch_rule(name, shape, dp_spec)
        return sanitize_spec(spec, shape, mesh)

    out = {}
    for name, leaf in batch.items():
        if name == "cache":
            out[name] = {e: [None if t is None else spec_for(e, t, True)
                             for t in layers]
                         for e, layers in leaf.items()}
        else:
            out[name] = spec_for(name, leaf, False)
    return out


def activation_spec(mesh_axis_names) -> P:
    """Layer-boundary residual sharding: batch over DP, sequence over
    'model' (sequence parallelism)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh_axis_names)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    return P(dp_spec, "model", None)


def shard_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    """The shape one device holds of a ``shape`` tensor laid out by the
    (sanitized) ``spec`` on ``mesh``."""
    out = []
    for dim, part in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        names = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        out.append(dim // math.prod(mesh.shape[n] for n in names))
    return tuple(out)


def placements(spec, axis_names) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on a mesh
    with ``axis_names``: ``Shard(d)`` on each mesh dimension that splits
    tensor dim d, ``Replicate()`` on the rest. A dim split over several
    axes (('pod', 'data')) is split over them in that order, as jax
    does."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, part in enumerate(spec):
        for n in () if part is None else (
                (part,) if isinstance(part, str) else part):
            where[n] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names)


def named_shardings(tree, specs, device_mesh):
    """``specs`` (a spec, or a dict / list of them, None kept) as
    ``placements`` on the built ``device_mesh`` (``Mesh.device_mesh()``),
    in ``specs``' structure."""
    names = device_mesh.mesh_dim_names

    def walk(s):
        if s is None:
            return None
        if isinstance(s, PartitionSpec):
            return placements(s, names)
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return [walk(v) for v in s]
    return walk(specs)
