"""State carried across from the JAX package to the port.

Solvers have no weights: what a solve carries is its problem and its
:class:`~repro_torch.core.types.SolveState` (the global iteration count
plus the named recurrence leaves: z/y/ztil/ytil or x/residual for Lasso,
alpha/x/dual for SVM, alpha/x/f/dual for the kernel SVM, w/margins/sq
for logistic regression, x/y/rx/ry for SFISTA). These helpers take and return numpy arrays, so a
state saved by ``repro`` (``np.asarray`` of each leaf of its
``aux["state"]``) resumes here. The RNG offset and the theta schedule are
recomputed from ``iteration``, so the resumed solve continues the
uninterrupted trajectory. A sparse operand crosses as its six ELL arrays
(``operand_from_numpy``).

Language models: ``repro`` keeps an LM's weights as a tree whose
``layers["slot{i}_{kind}"]`` leaves stack the layers of pattern slot i
along a leading group axis (layer g * period + i), and its decode cache
the same way; the port keeps one module per layer and, per cache leaf,
one tensor a layer (a sliding-window layer's ring is shorter than a
full-attention layer's; a layer without an entry holds None there). The
MoE router, the recurrent blocks' decay, gate and recurrent weights and
the recurrent state entries of the cache are f32 in a bf16 model on both
sides, and cross as such. ``lm_params_from_numpy`` /
``lm_params_to_numpy`` and ``cache_from_numpy`` / ``cache_to_numpy`` move
them across as numpy arrays (``np.asarray`` of each ``repro`` leaf; bf16
leaves travel as float32, which holds them exactly), and
``adamw_state_from_numpy`` / ``adamw_state_to_numpy`` the optimizer state
(its moments are shaped like the params). ``lm_flat`` / ``lm_tree`` are
the layout change itself, for numpy arrays or tensors: the trainer's
checkpoints hold ``repro``'s tree. An encoder-decoder arch's ``encoder``
subtree stacks its layers along a leading axis too (``layers``, beside
``pos_embed`` and ``final_norm``), and its cache's ``cross`` k and v
stack the decoder's groups: the port holds ``encoder.layers.{j}`` and
one ``cross_k`` / ``cross_v`` tensor a layer. Given a model ``axis``
(``parallel.tensor.Axis``), ``lm_params_from_numpy`` and
``adamw_state_from_numpy`` cut each leaf to that model rank's shard
(``parallel.tensor.cut`` by the port's layout).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sfista import SFISTAProblem
from repro_torch.core.types import (LassoProblem, LogRegProblem, SolveState,
                                    SparseOperand, SVMProblem,
                                    resolve_device)
from repro_torch.models import lm as _lm
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import tensor as _par

_ELL_FIELDS = ("row_cols", "row_vals", "row_blocks",
               "col_rows", "col_vals", "col_blocks")


def operand_from_numpy(arrays, ell_block: int = 8, device="cuda",
                       dtype=torch.float32) -> SparseOperand:
    """A :class:`SparseOperand` from the six ELL arrays of a ``repro``
    operand (``np.asarray`` of each of ``row_cols, row_vals, row_blocks,
    col_rows, col_vals, col_blocks``), as a mapping or an object with
    those attributes; values become ``dtype``, indices stay int32."""
    dev = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, dict) \
        else lambda k: getattr(arrays, k)
    leaves = {}
    for k in _ELL_FIELDS:
        t = torch.as_tensor(np.array(get(k)), device=dev)
        leaves[k] = t.to(dtype) if k.endswith("vals") else t.to(torch.int32)
    return SparseOperand(ell_block=int(ell_block), **leaves)


def _matrix(A, dev, dtype):
    if isinstance(A, SparseOperand):
        return A.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(A)).to(device=dev, dtype=dtype)


def problem_from_numpy(A, b, lam: float, l2: float = 0.0, groups=None,
                       device="cuda", dtype=torch.float32) -> LassoProblem:
    """A :class:`LassoProblem` with A (a numpy matrix, or a SparseOperand
    from ``operand_from_numpy``) and b as ``dtype`` tensors on ``device``;
    ``groups`` stays a host array."""
    dev = resolve_device(device)
    return LassoProblem(
        A=_matrix(A, dev, dtype),
        b=torch.as_tensor(np.asarray(b)).to(device=dev, dtype=dtype),
        lam=float(lam), l2=float(l2),
        groups=None if groups is None else np.asarray(groups))


def _vector(v, dev, dtype):
    return torch.as_tensor(np.asarray(v)).to(device=dev, dtype=dtype)


def svm_problem_from_numpy(A, b, lam: float = 1.0, loss: str = "l1",
                           kernel: str = "linear", kernel_params=None,
                           device="cuda", dtype=torch.float32) -> SVMProblem:
    """An :class:`SVMProblem` with A (a numpy matrix, or a SparseOperand)
    and the {-1, +1} labels b as ``dtype`` tensors on ``device``; a
    ``kernel`` other than "linear" (with its ``kernel_params`` dict) makes
    it a kernel-SVM problem."""
    dev = resolve_device(device)
    return SVMProblem(
        A=_matrix(A, dev, dtype), b=_vector(b, dev, dtype),
        lam=float(lam), loss=loss, kernel=kernel,
        kernel_params=None if kernel_params is None else {
            k: v.item() if isinstance(v, np.generic) else v
            for k, v in dict(kernel_params).items()})


def logreg_problem_from_numpy(A, b, lam: float = 0.0, device="cuda",
                              dtype=torch.float32) -> LogRegProblem:
    """A :class:`LogRegProblem` with A (a numpy matrix, or a
    SparseOperand) and the {-1, +1} labels b as ``dtype`` tensors on
    ``device``."""
    dev = resolve_device(device)
    return LogRegProblem(A=_matrix(A, dev, dtype), b=_vector(b, dev, dtype),
                         lam=float(lam))


def sfista_problem_from_numpy(A, b, lam: float, l2: float = 0.0,
                              device="cuda",
                              dtype=torch.float32) -> SFISTAProblem:
    """An :class:`~repro_torch.core.sfista.SFISTAProblem` with A (a numpy
    matrix, or a SparseOperand) and b as ``dtype`` tensors on
    ``device``."""
    dev = resolve_device(device)
    return SFISTAProblem(A=_matrix(A, dev, dtype), b=_vector(b, dev, dtype),
                         lam=float(lam), l2=float(l2))


def state_from_numpy(iteration: int, carry: Dict[str, np.ndarray],
                     dtype=torch.float32, device="cuda") -> SolveState:
    """A :class:`SolveState` from numpy leaves (e.g. a JAX solve's
    ``aux["state"]`` after ``np.asarray``)."""
    dev = resolve_device(device)
    return SolveState(int(iteration), {
        name: torch.as_tensor(np.asarray(leaf)).to(device=dev, dtype=dtype)
        for name, leaf in carry.items()})


def state_to_numpy(state: SolveState) -> Tuple[int, Dict[str, np.ndarray]]:
    """(iteration, {leaf name: numpy array}) of a port state."""
    return int(state.iteration), {
        name: leaf.detach().cpu().numpy() for name, leaf in
        state.carry.items()}


# ---------------------------------------------------------------------------
# Language models
# ---------------------------------------------------------------------------

def _slots(arch: ArchConfig):
    period = len(arch.block_pattern)
    return [(i, f"slot{i}_{kind}", period)
            for i, kind in enumerate(arch.block_pattern)]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _nest(flat, sep="."):
    tree = {}
    for path, v in flat.items():
        *dirs, leaf = path.split(sep)
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _unstack(flat, stacked_tree, name, leaf):
    """Each leaf of ``stacked_tree`` (layer g along its leading axis) into
    ``flat`` as ``name(g).path``."""
    for path, stacked in _flatten(stacked_tree):
        if not isinstance(stacked, torch.Tensor):
            stacked = np.asarray(stacked)
        for g in range(stacked.shape[0]):
            flat[f"{name(g)}.{path}"] = leaf(stacked[g])


def _stacked(flat, names, stack):
    """The inverse of :func:`_unstack` for the layers ``names`` (in stack
    order): their leaves' paths nested, each joined by ``stack``."""
    prefix = f"{names[0]}."
    return _nest({
        path[len(prefix):]: stack([flat[f"{n}.{path[len(prefix):]}"]
                                   for n in names])
        for path in flat if path.startswith(prefix)})


def lm_flat(arch: ArchConfig, tree, leaf=lambda a: a) -> Dict:
    """``repro``'s param-shaped tree (the params, or a moment of their
    optimizer state) as {port parameter name: ``leaf(layer's slice)``}:
    the stacked leaves of ``layers["slot{i}_{kind}"]`` split into layers
    g * period + i, and those of ``encoder["layers"]`` into encoder
    layers j. Leaves are numpy arrays or tensors."""
    enc = tree.get("encoder", {})
    flat = {k: leaf(v) for k, v in _flatten(
        {k: v for k, v in tree.items() if k not in ("layers", "encoder")})}
    flat.update({f"encoder.{k}": leaf(v) for k, v in _flatten(
        {k: v for k, v in enc.items() if k != "layers"})})
    for i, slot, period in _slots(arch):
        _unstack(flat, tree["layers"][slot],
                 lambda g: f"layers.{g * period + i}", leaf)
    if "layers" in enc:
        _unstack(flat, enc["layers"], lambda j: f"encoder.layers.{j}", leaf)
    return flat


def lm_tree(arch: ArchConfig, flat, stack=np.stack):
    """The inverse of :func:`lm_flat`: {port parameter name: leaf} as
    ``repro``'s tree, each slot's layers (and the encoder's) joined by
    ``stack`` (``np.stack`` or ``torch.stack``)."""
    tree = _nest({k: v for k, v in flat.items()
                  if not k.startswith(("layers.", "encoder.layers."))})
    tree["layers"] = {}
    for i, slot, period in _slots(arch):
        tree["layers"][slot] = _stacked(
            flat, [f"layers.{g}" for g in range(i, arch.n_layers, period)],
            stack)
    if arch.is_encdec:
        tree["encoder"]["layers"] = _stacked(
            flat, [f"encoder.layers.{j}"
                   for j in range(arch.encoder_layers)], stack)
    return tree


def _cut(arch: ArchConfig, axis):
    """numpy leaf -> f32 tensor of rank ``axis.index``'s shard of it, by
    name (``parallel.tensor``'s layout; the leaf itself without a model
    axis)."""
    if axis is None or axis.size == 1:
        return lambda name, a: _f32(a)
    lay = _par.layout(arch, axis.size)
    return lambda name, a: _f32(_par.cut(np.asarray(a), lay[name], axis))


def lm_params_from_numpy(arch: ArchConfig, tree, device="cuda",
                         axis=None) -> _lm.LM:
    """An :class:`~repro_torch.models.lm.LM` holding ``repro``'s weights:
    ``tree`` is ``repro``'s param tree (``lm.init_params``) with every leaf
    as a numpy array. Raises on a missing, extra or misshapen leaf. With a
    model ``axis`` (``parallel.tensor.Axis``), the LM built for it,
    holding rank ``axis.index``'s shards (``parallel.tensor.cut``)."""
    model = _lm.LM(arch, resolve_device(device), axis)
    cut = _cut(arch, axis)
    model.load_state_dict({k: cut(k, v) for k, v in
                           lm_flat(arch, tree).items()}, strict=True)
    return model


def lm_params_to_numpy(model: _lm.LM):
    """``repro``'s param tree of ``model``'s weights, float32 numpy
    leaves (cast them to the config dtype on the JAX side)."""
    return lm_tree(model.arch, {k: v.detach().float().cpu().numpy()
                                for k, v in model.state_dict().items()})


def adamw_state_from_numpy(arch: ArchConfig, state, device="cuda",
                           axis=None) -> AdamWState:
    """The port's :class:`~repro_torch.optim.AdamWState` (moments keyed
    by parameter name, as the trainer's ``named_parameters``) from
    ``repro``'s ``AdamWState`` (``step``, ``mu``, ``nu``; numpy leaves in
    the stacked per-slot layout); with a model ``axis``, the rank's
    shards of the moments."""
    dev = resolve_device(device)
    cut = _cut(arch, axis)
    moments = lambda tree: {k: cut(k, v).to(dev)
                            for k, v in lm_flat(arch, tree).items()}
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=moments(state.mu), nu=moments(state.nu))


def adamw_state_to_numpy(arch: ArchConfig, state: AdamWState) -> AdamWState:
    """``repro``'s optimizer state of the port's: an ``AdamWState`` of
    an int32 numpy step and float32 numpy moment trees in ``repro``'s
    stacked layout (``repro.optim.adamw.AdamWState(*it)`` on the JAX
    side)."""
    host = lambda t: t.detach().float().cpu().numpy()
    return AdamWState(
        step=np.asarray(int(state.step), dtype=np.int32),
        mu=lm_tree(arch, {k: host(v) for k, v in state.mu.items()}),
        nu=lm_tree(arch, {k: host(v) for k, v in state.nu.items()}))


def cache_from_numpy(arch: ArchConfig, tree, device="cuda"):
    """The port's decode cache (``lm.init_cache``'s layout: {entry: one
    tensor a layer, None where a layer lacks the entry}) from ``repro``'s
    (``{"slot{i}_{kind}": {entry: (G, ...)}}``, numpy leaves: "k" and "v"
    (G, B, Hkv, S_i, Dh) with S_i slot i's cache length, and the f32
    recurrent states; for an encoder-decoder arch, ``"cross": {"k", "v"}``
    (G, B, Hkv, Se, Dh), which group g's layers share). k, v and the
    cross k and v take the config dtype, the states stay f32."""
    dev = resolve_device(device)
    out = {}
    for i, slot, period in _slots(arch):
        for name, stacked in tree[slot].items():
            dtype = arch.torch_dtype if name in ("k", "v") \
                else torch.float32
            per_layer = out.setdefault(name, [None] * arch.n_layers)
            for g, leaf in enumerate(np.asarray(stacked, dtype=np.float32)):
                per_layer[g * period + i] = _f32(leaf).to(device=dev,
                                                          dtype=dtype)
    period = len(arch.block_pattern)
    for name, stacked in tree.get("cross", {}).items():
        groups = [_f32(leaf).to(device=dev, dtype=arch.torch_dtype)
                  for leaf in np.asarray(stacked, dtype=np.float32)]
        out[f"cross_{name}"] = [groups[l // period]
                                for l in range(arch.n_layers)]
    return out


def cache_to_numpy(arch: ArchConfig, cache):
    """``repro``'s decode cache tree from the port's, float32 leaves (the
    cross k and v from the first layer of each group)."""
    host = lambda ts: np.stack([t.float().cpu().numpy() for t in ts])
    out = {slot: {name: host(per_layer[i::period])
                  for name, per_layer in cache.items()
                  if name not in _lm.CROSS and per_layer[i] is not None}
           for i, slot, period in _slots(arch)}
    if "cross_k" in cache:
        period = len(arch.block_pattern)
        out["cross"] = {name[len("cross_"):]: host(cache[name][::period])
                        for name in _lm.CROSS}
    return out
