"""Decoder LM of the port, the dense path (the port of
``repro/models/lm.py``): every layer an ``attn_mlp`` block (GQA attention
+ SwiGLU MLP), as in llama3-8b, tinyllama-1.1b, qwen1.5-4b (QKV bias) and
stablelm-12b.

    model = init_params(arch, seed=0)             # an LM on the card
    logits = model.forward(tokens)                # (B, S, V)
    last = model.prefill(tokens)                  # (B, 1, V); K5 runs here
    cache = init_cache(arch, B, max_seq)
    logits, cache = model.decode_step(tok, cache, pos)

``repro`` scans stacked per-slot params over layer groups (for the TPU
dry-run); here each layer is a module of a ``ModuleList``, and
``repro_torch.convert`` moves weights and caches between the two layouts.
As in ``repro``, ``prefill`` returns the last position's logits and seeds
no cache (serving re-runs ``decode_step`` from an empty one), and decode
attention is plain PyTorch, so no kernel launches there. Unported block
kinds, encoder-decoder archs and the modality frontends raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L

def check_ported(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    for kind in arch.block_pattern:
        if kind != "attn_mlp":
            raise NotImplementedError(
                f"{arch.name}: block kind {kind!r} is not ported to "
                f"repro_torch yet (only 'attn_mlp'; see ROADMAP Queue 1)")
    if arch.is_encdec:
        raise NotImplementedError(
            f"{arch.name}: encoder-decoder archs are not ported yet")
    if arch.frontend != "none" or arch.meta_tokens:
        raise NotImplementedError(
            f"{arch.name}: frontend {arch.frontend!r} / meta tokens are not "
            f"ported yet")


class Block(nn.Module):
    """One ``attn_mlp`` block: x + attn(norm1 x), then + mlp(norm2 x)."""

    def __init__(self, arch: ArchConfig, device=None):
        super().__init__()
        dt, D = arch.torch_dtype, arch.d_model
        self.norm1 = L.RMSNorm(D, dt, device)
        self.attn = L.Attention(D, arch.n_heads, arch.n_kv_heads,
                                arch.head_dim_, arch.qkv_bias,
                                arch.rope_theta, dt, device)
        self.norm2 = L.RMSNorm(D, dt, device)
        self.mlp = L.MLP(D, arch.d_ff, dt, device, arch.mlp_type, arch.act)

    def forward(self, x):
        a, _ = self.attn(self.norm1(x))
        x = x + a
        return x + self.mlp(self.norm2(x))

    def decode(self, x, cache_k, cache_v, pos: int):
        a, _, _ = self.attn.decode(self.norm1(x), cache_k, cache_v, pos)
        x = x + a
        return x + self.mlp(self.norm2(x))


class LM(nn.Module):
    """Parameters under ``repro``'s names: ``embed`` (V, D),
    ``layers.{i}.{norm1,attn,norm2,mlp}.*``, ``final_norm.scale`` and
    ``unembed`` (D, V) (absent with tied embeddings)."""

    def __init__(self, arch: ArchConfig, device=None):
        super().__init__()
        check_ported(arch)
        self.arch = arch
        dt, D, V = arch.torch_dtype, arch.d_model, arch.vocab_size
        self.embed = L.empty_param((V, D), dt, device)
        self.layers = nn.ModuleList(Block(arch, device)
                                    for _ in range(arch.n_layers))
        self.final_norm = L.RMSNorm(D, dt, device)
        if not arch.tie_embeddings:
            self.unembed = L.empty_param((D, V), dt, device)

    def _embed(self, tokens):
        return self.embed[tokens.long()]

    def _logits(self, x):
        x = self.final_norm(x)
        unembed = self.embed.T if self.arch.tie_embeddings else self.unembed
        return x @ unembed

    def _hidden(self, tokens):
        x = self._embed(tokens)
        for blk in self.layers:
            x = blk(x)
        return x

    def forward(self, tokens):
        """Full-sequence forward: tokens (B, S) -> logits (B, S, V)."""
        return self._logits(self._hidden(tokens))

    def prefill(self, tokens):
        """Forward over the prompt -> the last position's logits (B, 1, V).
        Only that position is normed and unembedded: the values are
        ``forward``'s, without the (B, S, V) logits."""
        return self._logits(self._hidden(tokens)[:, -1:])

    def decode_step(self, tokens, cache: Dict[str, torch.Tensor], pos: int):
        """One decode step: tokens (B, 1) at position ``pos`` against
        ``cache`` (from ``init_cache``), which is updated IN PLACE.
        Returns (logits (B, 1, V), cache)."""
        x = self._embed(tokens)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][i], cache["v"][i], pos)
        return self._logits(x), cache


def init_params(arch: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """An :class:`LM` with random weights from ``seed``, drawn on
    ``device`` by a ``torch.Generator`` at ``repro``'s scales: N(0, 1) in
    f32 times fan_in ** -0.5 for the dense matrices, 0.02 for ``embed``
    and d_model ** -0.5 for ``unembed``, then cast to the config dtype;
    norm scales 1, biases 0. (Not ``jax.random``'s numbers: weights cross
    from ``repro`` through ``convert.lm_params_from_numpy``.)"""
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
                std = {"embed": 0.02, "unembed": arch.d_model ** -0.5}.get(
                    name, p.shape[0] ** -0.5)
                p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                    dtype=torch.float32).mul_(std))
    return model


def init_cache(arch: ArchConfig, batch: int, seq_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The decode cache (``repro``'s ``cache_specs``, allocated): k and v
    of every layer, (n_layers, B, Hkv, seq_len, head_dim) zeros in the
    config dtype on ``device``."""
    check_ported(arch)
    shape = (arch.n_layers, batch, arch.n_kv_heads, seq_len, arch.head_dim_)
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=arch.torch_dtype, device=dev)
            for name in ("k", "v")}
