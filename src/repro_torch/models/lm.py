"""Decoder LM of the port (the port of ``repro/models/lm.py``): layer i
is a block of kind ``arch.block_at(i)``, one of

    attn_mlp  GQA attention + SwiGLU MLP   (llama3-8b, tinyllama-1.1b,
                                            qwen1.5-4b, stablelm-12b)
    swa_mlp   sliding-window attention + MLP
    moe       GQA attention (sliding-window where ``arch.window`` > 0) +
              the capacity-based top-k MoE   (mixtral-8x7b, granite-moe-1b)

    model = init_params(arch, seed=0)             # an LM on the card
    logits = model.forward(tokens)                # (B, S, V)
    logits, aux = model.forward_aux(tokens)       # + the summed MoE aux
    loss = train_loss(model, {"tokens": tokens, "targets": targets},
                      remat="none")               # K5 runs here
    last = model.prefill(tokens)                  # (B, 1, V); K5 runs here
    cache = init_cache(arch, B, max_seq)
    logits, cache = model.decode_step(tok, cache, pos)

``repro`` scans stacked per-slot params over layer groups (for the TPU
dry-run); here each layer is a module of a ``ModuleList``, and
``repro_torch.convert`` moves weights, optimizer state and caches between
the two layouts. Parameters are made with ``requires_grad=False`` for
serving; the trainer (``runtime.driver``) turns gradients on for its own
model. ``forward``'s ``remat`` checkpoints each block: "full" recomputes
the whole block in the backward pass, "dots" keeps the outputs of the
matrix products (``aten.mm`` / ``addmm`` / ``bmm``) and recomputes the
rest, the counterparts of ``jax.checkpoint`` and
``checkpoint_policies.checkpoint_dots``; either way K5's forward runs
again in the backward pass. As in ``repro``, ``prefill`` returns the last
position's logits and seeds no cache (serving re-runs ``decode_step``
from an empty one), and decode attention is plain PyTorch, so no kernel
launches there. The decode cache holds one k and one v tensor a layer,
``repro``'s ``_cache_len`` long: ``seq_len``, or a ring of
min(seq_len, window) for a sliding-window layer, so a pattern that mixes
the two has caches of two lengths. The MoE routes the tokens of each call
together: all B S of a prefill, the B of a decode step (at batch 8 a
capacity of 4 a expert, so decode drops tokens a prefill would keep, as
in ``repro``). Unported block kinds (``mamba_mlp``, ``hybrid``,
``mlstm``, ``slstm``), encoder-decoder archs and the modality frontends
raise ``NotImplementedError``; so do ``repro``'s ``shard_acts`` (no
device mesh, ROADMAP Queue 1, item 7) and ``unroll_layers`` (only the
roofline's cost extraction needs it), which are not ported.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L

REMAT = ("none", "full", "dots")
# The operations whose outputs "dots" keeps (jax's checkpoint_dots saves
# every dot_general's output).
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, x, remat: str):
    """``fn(x)`` under the activation-checkpointing policy ``remat``."""
    if remat == "none":
        return fn(x)
    if remat == "full":
        return _ckpt.checkpoint(fn, x, use_reentrant=False)
    if remat == "dots":
        return _ckpt.checkpoint(fn, x, use_reentrant=False, context_fn=(
            functools.partial(_ckpt.create_selective_checkpoint_contexts,
                              _dots_policy)))
    raise ValueError(f"remat must be one of {REMAT}, not {remat!r}")


# The block kinds the port runs, and those whose attention takes
# ``arch.window`` (repro's lm.py picks the window by the same test).
PORTED_KINDS = ("attn_mlp", "swa_mlp", "moe")
WINDOWED_KINDS = ("swa_mlp", "moe")


def check_ported(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    for kind in arch.block_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{arch.name}: block kind {kind!r} is not ported to "
                f"repro_torch yet (only {', '.join(PORTED_KINDS)}; see "
                f"ROADMAP Queue 1)")
    if arch.is_encdec:
        raise NotImplementedError(
            f"{arch.name}: encoder-decoder archs are not ported yet")
    if arch.frontend != "none" or arch.meta_tokens:
        raise NotImplementedError(
            f"{arch.name}: frontend {arch.frontend!r} / meta tokens are not "
            f"ported yet")


def block_window(arch: ArchConfig, kind: str) -> int:
    """The attention window of a ``kind`` block (0: full attention)."""
    return arch.window if kind in WINDOWED_KINDS else 0


def cache_len(arch: ArchConfig, kind: str, seq_len: int) -> int:
    """A ``kind`` layer's decode cache length (``repro``'s
    ``_cache_len``): a ring of min(seq_len, window) where the block's
    attention has a window, else seq_len."""
    window = block_window(arch, kind)
    return min(seq_len, window) if window > 0 else seq_len


class Block(nn.Module):
    """One block of ``kind``: x + attn(norm1 x), then + ffn(norm2 x), the
    FFN an ``MLP`` (``mlp``) or, for ``moe``, an ``MoE`` (``moe``)."""

    def __init__(self, arch: ArchConfig, kind: str, device=None):
        super().__init__()
        dt, D = arch.torch_dtype, arch.d_model
        self.norm1 = L.RMSNorm(D, dt, device)
        self.attn = L.Attention(D, arch.n_heads, arch.n_kv_heads,
                                arch.head_dim_, arch.qkv_bias,
                                arch.rope_theta, dt, device,
                                window=block_window(arch, kind))
        self.norm2 = L.RMSNorm(D, dt, device)
        if kind == "moe":
            self.moe = L.MoE(D, arch.d_ff, arch.n_experts, arch.top_k,
                             arch.capacity_factor, dt, device, arch.act)
        else:
            self.mlp = L.MLP(D, arch.d_ff, dt, device, arch.mlp_type,
                             arch.act)

    def _ffn(self, x):
        """(ffn(norm2 x), the MoE's aux or None)."""
        h = self.norm2(x)
        if hasattr(self, "moe"):
            return self.moe(h)
        return self.mlp(h), None

    def forward(self, x):
        """(x after the block, the MoE's aux or None)."""
        a, _ = self.attn(self.norm1(x))
        x = x + a
        f, aux = self._ffn(x)
        return x + f, aux

    def decode(self, x, cache_k, cache_v, pos: int):
        a, _, _ = self.attn.decode(self.norm1(x), cache_k, cache_v, pos)
        x = x + a
        return x + self._ffn(x)[0]


class LM(nn.Module):
    """Parameters under ``repro``'s names: ``embed`` (V, D),
    ``layers.{i}.{norm1,attn,norm2}.*`` and ``layers.{i}.mlp.*`` or
    ``layers.{i}.moe.*``, ``final_norm.scale`` and ``unembed`` (D, V)
    (absent with tied embeddings)."""

    def __init__(self, arch: ArchConfig, device=None):
        super().__init__()
        check_ported(arch)
        self.arch = arch
        dt, D, V = arch.torch_dtype, arch.d_model, arch.vocab_size
        self.embed = L.empty_param((V, D), dt, device)
        self.layers = nn.ModuleList(Block(arch, arch.block_at(i), device)
                                    for i in range(arch.n_layers))
        self.final_norm = L.RMSNorm(D, dt, device)
        if not arch.tie_embeddings:
            self.unembed = L.empty_param((D, V), dt, device)

    def _embed(self, tokens):
        return self.embed[tokens.long()]

    def _logits(self, x):
        x = self.final_norm(x)
        unembed = self.embed.T if self.arch.tie_embeddings else self.unembed
        return x @ unembed

    def _hidden(self, tokens, remat: str = "none"):
        """(last hidden state, the MoE layers' aux summed in f32)."""
        x = self._embed(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            x, a = _checkpointed(blk, x, remat)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward_aux(self, tokens, remat: str = "none"):
        """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), aux),
        each block under the checkpointing policy ``remat`` (one of
        :data:`REMAT`); aux is the sum of the MoE layers' load-balancing
        losses (0 without MoE layers), as ``repro``'s ``forward``
        returns it."""
        x, aux = self._hidden(tokens, remat)
        return self._logits(x), aux

    def forward(self, tokens, remat: str = "none"):
        """``forward_aux``'s logits alone."""
        return self.forward_aux(tokens, remat)[0]

    def prefill(self, tokens):
        """Forward over the prompt -> the last position's logits (B, 1, V).
        Only that position is normed and unembedded: the values are
        ``forward``'s, without the (B, S, V) logits."""
        return self._logits(self._hidden(tokens)[0][:, -1:])

    def decode_step(self, tokens, cache: Dict[str, List[torch.Tensor]],
                    pos: int):
        """One decode step: tokens (B, 1) at position ``pos`` against
        ``cache`` (from ``init_cache``), which is updated IN PLACE; an
        MoE layer routes the B tokens together. Returns (logits (B, 1,
        V), cache)."""
        x = self._embed(tokens)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][i], cache["v"][i], pos)
        return self._logits(x), cache


def train_loss(model: LM, batch: Dict, aux_weight: float = 0.01,
               remat: str = "none", shard_acts: bool = False):
    """The mean next-token cross-entropy of ``batch`` (``{"tokens": (B,
    S), "targets": (B, S)}``, tensors or numpy arrays, moved to the
    model's device), as ``repro``'s ``train_loss`` computes it: f32
    logits, logsumexp minus the gold logit, the mean. The gold logit is a
    ``torch.gather``, the same function as ``repro``'s masked reduction
    over the vocabulary (which exists for a sharded vocabulary, which the
    port does not have). Plus ``aux_weight`` times the MoE layers' summed
    load-balancing loss (0 without MoE layers), as in ``repro``."""
    if shard_acts:
        raise NotImplementedError(
            "shard_acts needs a device mesh, which the port does not have "
            "(ROADMAP Queue 1, item 7)")
    dev = model.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    logits, aux = model.forward_aux(tokens, remat=remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold) + aux_weight * aux


def init_params(arch: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """An :class:`LM` with random weights from ``seed``, drawn on
    ``device`` by a ``torch.Generator`` at ``repro``'s scales: N(0, 1) in
    f32 times fan_in ** -0.5 for the dense matrices (shape[0]; the MoE
    router, which stays f32), shape[1] ** -0.5 for the (E, ., .) expert
    weights, 0.02 for ``embed`` and d_model ** -0.5 for ``unembed``, then
    cast to each parameter's dtype; norm scales 1, biases 0. (Not
    ``jax.random``'s numbers: weights cross from ``repro`` through
    ``convert.lm_params_from_numpy``.)"""
    dev = resolve_device(device)
    model = LM(arch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            else:
                fan_in = p.shape[1] if p.dim() == 3 else p.shape[0]
                std = {"embed": 0.02, "unembed": arch.d_model ** -0.5}.get(
                    name, fan_in ** -0.5)
                p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                    dtype=torch.float32).mul_(std))
    return model


def init_cache(arch: ArchConfig, batch: int, seq_len: int,
               device="cuda") -> Dict[str, List[torch.Tensor]]:
    """The decode cache (``repro``'s ``cache_specs``, allocated): for "k"
    and "v" a list of one (B, Hkv, cache_len, head_dim) tensor of zeros a
    layer, in the config dtype on ``device``, where ``cache_len`` is
    ``seq_len`` or, for a sliding-window layer, its ring's
    min(seq_len, window)."""
    check_ported(arch)
    dev = resolve_device(device)
    shapes = [(batch, arch.n_kv_heads,
               cache_len(arch, arch.block_at(i), seq_len), arch.head_dim_)
              for i in range(arch.n_layers)]
    return {name: [torch.zeros(s, dtype=arch.torch_dtype, device=dev)
                   for s in shapes] for name in ("k", "v")}
