"""Decoder LM of the port (the port of ``repro/models/lm.py``): layer i
is a block of kind ``arch.block_at(i)``, one of

    attn_mlp   GQA attention + SwiGLU MLP  (llama3-8b, tinyllama-1.1b,
                                            qwen1.5-4b, stablelm-12b)
    swa_mlp    sliding-window attention + MLP
    moe        GQA attention (sliding-window where ``arch.window`` > 0) +
               the capacity-based top-k MoE  (mixtral-8x7b, granite-moe-1b)
    mamba_mlp  SSM heads + MLP
    hybrid     sliding-window attention beside SSM heads, x + 0.5 (attn +
               ssm), then the MLP            (hymba-1.5b)
    mlstm      the xLSTM matrix-memory cell, no MLP
    slstm      the xLSTM scalar-memory cell, no MLP  (xlstm-350m: both)

An encoder-decoder arch (whisper-large-v3) adds an :class:`Encoder` of
bidirectional ``attn_mlp`` blocks without rope over the frames plus a
learned ``pos_embed``, and a cross-attention step (``norm_x``, ``xattn``)
in each decoder block after its self-attention; its tokens take
sinusoidal positions. A vision-stub arch (pixtral-12b) prepends the
patch rows it is given to the embedded tokens.

    model = init_params(arch, seed=0)             # an LM on the card
    logits = model.forward(tokens)                # (B, M + S, V)
    logits = model.forward(tokens, {"frames": f}) # whisper: f (B, Se, D)
    logits = model.forward(tokens, {"patches": p})  # pixtral: (B, N + S, V)
    logits, aux = model.forward_aux(tokens)       # + the summed MoE aux
    loss = train_loss(model, {"tokens": tokens, "targets": targets},
                      remat="none")               # K5 runs here
    last = model.prefill(tokens)                  # (B, 1, V); K5 runs here
    cache = init_cache(arch, B, max_seq)
    model.fill_cross_cache(cache, frames)         # whisper; K5 runs here
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
again in the backward pass. An arch with ``meta_tokens`` (hymba) prepends
M learned rows to the embedded tokens of a full-sequence forward, so its
logits have M + S positions; ``train_loss`` drops the first M. As in
``repro``, ``decode_step`` embeds its tokens without them, so hymba's
decode is not its prefill's last position unless M = 0. Also as in
``repro``, ``prefill`` returns the last position's logits and seeds no
cache (serving re-runs ``decode_step`` from an empty one), and decode is
plain PyTorch, so no kernel launches there. The decode cache
(``init_cache``) holds, a layer, what its kind carries: k and v
(``repro``'s ``_cache_len`` long: ``seq_len``, or a ring of min(seq_len,
window) for a sliding-window layer), the SSM state, the mLSTM state and
normaliser, the sLSTM's c, n, h, m; the recurrent states in f32. The MoE
routes the tokens of each call together: all B S of a prefill, the B of a
decode step (at batch 8 a capacity of 4 a expert, so decode drops tokens
a prefill would keep, as in ``repro``). An encoder-decoder arch's cache
also holds each decoder layer's cross-attention k and v of the encoder
output, ``repro``'s ``cache["cross"]``: zeros from ``init_cache`` (what
``repro``'s server decodes against) until ``fill_cross_cache`` writes
them; decode's cross-attention is plain PyTorch with an f32 softmax, as
in ``repro``. As in ``repro`` too, decode carries no patches.
``param_specs`` gives the parameters on the meta device and
``param_count`` counts the leaves, for the dry run
(``repro_torch.launch.dryrun``; ``init_cache(..., device="meta")`` is
``repro``'s ``cache_specs``). ``unroll_layers`` is not ported: a layer
here is a module, and the dry run counts each one as it runs.

Tensor, expert and sequence parallelism (``parallel.tensor``): an LM
built for a model axis (``LM(arch, device, axis)``, ``init_params(...,
axis=)``) holds its rank's shards, as ``repro``'s rules cut them: heads
or flat columns of attention and of the recurrent mixers, hidden
columns, experts (see ``models.layers`` and ``models.recurrent``) and,
where the axis divides it, its block of the vocabulary. A block takes
its split mixers' input through ``copy_to`` and sums their partial
outputs with ``reduce_from``. ``train_loss(..., shard_acts=True)``
keeps the residual stream (B, L / m, D) per rank between blocks
(``repro``'s ``activation_spec``), Megatron's sequence
parallelism: the norms run on the rank's positions, ``gather_seq`` feeds
each mixer the whole sequence and ``scatter_seq`` sums and splits its
output; a whole mixer (one whose dims the axis does not divide, as
hymba-smoke's at m = 8) runs on the gathered sequence and keeps its
rank's positions. A
split vocabulary embeds the rank's rows (zero elsewhere) and sums, and
the loss is a vocab-parallel cross entropy (the max and the sums over
the model group; the gold logit ``repro``'s masked reduction), while
``forward`` and ``prefill`` gather the vocabulary's column blocks to all
V logits on every rank. A split model serves too: ``init_cache(...,
axis=, data=)`` allocates a rank's shares of the cache under ``repro``'s
decode rule (:func:`shard_cache`: the KV and cross caches' sequence
split over the model axis where it divides, the recurrent states whole,
the batch over the data axis where it divides), and
``decode_step`` runs split-KV attention over the rank's slots, the
recurrent mixers on their heads or flat columns, each split mixer's
partial output summed over the model group, and with ``data=`` an MoE
routing the data group's tokens as one.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor as par

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


# The block kinds the port runs, those with an attention block, those
# with SSM heads, and those whose attention takes ``arch.window`` (repro's lm.py picks the window by
# the same test).
PORTED_KINDS = ("attn_mlp", "swa_mlp", "moe", "mamba_mlp", "hybrid",
                "mlstm", "slstm")
ATTENTION_KINDS = ("attn_mlp", "swa_mlp", "moe", "hybrid")
SSM_KINDS = ("mamba_mlp", "hybrid")
WINDOWED_KINDS = ("swa_mlp", "moe", "hybrid")
# An sLSTM layer's decode-cache entries, its state (c, n, h, m).
SLSTM_STATE = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")
# An encoder-decoder arch's decode-cache entries: each decoder layer's
# cross-attention k and v of the encoder output.
CROSS = ("cross_k", "cross_v")


def check_ported(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind the port cannot
    run."""
    for kind in arch.block_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{arch.name}: block kind {kind!r} is not ported to "
                f"repro_torch yet (only {', '.join(PORTED_KINDS)}; see "
                f"ROADMAP Queue 1)")


def sinusoid(positions, d: int):
    """``repro``'s ``_sinusoid``: for positions (S,), the f32 (S, d) rows
    [sin(p f) | cos(p f)], concatenated (not interleaved), with f_i =
    10000 ** (-i / (d / 2)), i < d / 2."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def cross_kv(xattn: L.Attention, enc_out, every_head: bool = False):
    """``repro``'s ``_cross_kv``: the encoder output (B, Se, D) projected
    by ``xattn``'s wk and wv to k and v (B, Hkv, Se, Dh), no rope (of a
    flat column split, gathered to the whole heads; ``every_head``: of a
    split by heads too, the decode cache's layout); both are transposed
    views of the projections."""
    B, Se, _ = enc_out.shape
    Hd = xattn.shape["head_dim"]
    Hkv, tp = (xattn.decode_shape["n_kv_heads"], xattn.tp) if every_head \
        else (xattn.shape["n_kv_heads"], xattn.flat())
    k, v = (L.project(enc_out, w, Hkv * Hd, tp)
            .reshape(B, Se, Hkv, Hd).transpose(1, 2)
            for w in (xattn.wk, xattn.wv))
    return k, v


def has_attention(arch: ArchConfig) -> bool:
    """Whether any layer of ``arch`` has an attention block (so K5 runs
    in its prefill)."""
    return any(kind in ATTENTION_KINDS for kind in arch.block_pattern)


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
    """One block of ``kind``, with ``repro``'s ``_init_block`` leaves:
    ``norm1``, then ``attn`` (attention kinds) and / or ``ssm``
    (``mamba_mlp``, ``hybrid``), then ``norm2`` and the FFN, an ``MLP``
    (``mlp``) or, for ``moe``, an ``MoE`` (``moe``); an ``mlstm`` or
    ``slstm`` block is ``norm1`` and its cell alone. A decoder block of an
    encoder-decoder arch adds ``norm_x`` and ``xattn`` (bidirectional,
    no rope, no QKV bias); an ``encoder`` block's attention is
    bidirectional and takes no rope, as ``_encoder_forward``'s. ``tp``:
    the model axis its mixers, MLP and MoE are split over."""

    def __init__(self, arch: ArchConfig, kind: str, device=None,
                 encoder: bool = False, tp=None):
        super().__init__()
        dt, D = arch.torch_dtype, arch.d_model
        self.kind = kind
        self.tp = tp
        self.norm1 = L.RMSNorm(D, dt, device)
        if kind in ATTENTION_KINDS:
            self.attn = L.Attention(D, arch.n_heads, arch.n_kv_heads,
                                    arch.head_dim_, arch.qkv_bias,
                                    0.0 if encoder else arch.rope_theta, dt,
                                    device, window=block_window(arch, kind),
                                    causal=not encoder, tp=tp)
        if kind in SSM_KINDS:
            self.ssm = R.SSMHeads(D, arch.ssm_heads or arch.n_heads,
                                  arch.ssm_state, dt, device, tp=tp)
        if kind == "mlstm":
            self.mlstm = R.MLSTM(D, arch.n_heads, dt, device, tp=tp)
        elif kind == "slstm":
            self.slstm = R.SLSTM(D, arch.n_heads, dt, device, tp=tp)
        else:
            self.norm2 = L.RMSNorm(D, dt, device)
            if kind == "moe":
                self.moe = L.MoE(D, arch.d_ff, arch.n_experts, arch.top_k,
                                 arch.capacity_factor, dt, device, arch.act,
                                 tp=tp)
            else:
                self.mlp = L.MLP(D, arch.d_ff, dt, device, arch.mlp_type,
                                 arch.act, tp=tp)
        if arch.is_encdec and not encoder:
            self.cross_len = arch.encoder_seq
            self.norm_x = L.RMSNorm(D, dt, device)
            self.xattn = L.Attention(D, arch.n_heads, arch.n_kv_heads,
                                     arch.head_dim_, False, 0.0, dt, device,
                                     causal=False, tp=tp)

    def _leave(self, y, mod, sp: bool):
        """A mixer's output y as the block's stream holds it: a split
        mixer's partial sums summed over the model group (and, under SP,
        split over the sequence); a whole mixer's, under SP, this rank's
        positions."""
        if getattr(mod, "tp", None) is not None:
            return par.scatter_seq(y, self.tp) if sp \
                else par.reduce_from(y, self.tp)
        return par.local_chunk(y, self.tp) if sp else y

    def _mix(self, mod, h, sp: bool, **kw):
        """``mod``'s output (its first, for a tuple) on h, the block's
        normed input (gathered over the sequence under SP), as the stream
        holds it (:meth:`_leave`)."""
        if getattr(mod, "tp", None) is not None and not sp:
            h = par.copy_to(h, self.tp)
        y = mod(h, **kw)
        return self._leave(y[0] if isinstance(y, tuple) else y, mod, sp)

    def _cross(self, x, enc_out, sp: bool = False):
        """x plus the cross-attention of norm_x(x) over ``enc_out``. The
        encoder's stream is whole on every rank: it enters through
        ``copy_to`` where the ranks' shares of its gradient differ."""
        h = self.norm_x(x)
        if self.tp is None:
            return x + self.xattn(h, kv=cross_kv(self.xattn, enc_out))[0]
        if self.xattn.tp is not None or sp:
            enc_out = par.copy_to(enc_out, self.tp)
        if sp:
            h = par.gather_seq(h, self.tp)
        return x + self._mix(self.xattn, h, sp,
                             kv=cross_kv(self.xattn, enc_out))

    def _ffn(self, x, sp: bool = False, dp=None):
        """(ffn(norm2 x), the MoE's aux or None); ``dp``: the data axis
        whose ranks' tokens the MoE routes together."""
        h = self.norm2(x)
        if hasattr(self, "moe"):
            if not sp:
                y, aux = self.moe(h, dp=dp)
                return self._leave(y, self.moe, False), aux
            y, aux = self.moe(par.gather_seq(h, self.tp), sp=self.tp, dp=dp)
            return self._leave(y, self.moe, True), aux
        if self.mlp.tp is None:             # per position: the rank's own
            return self.mlp(h), None
        return self._mix(self.mlp, par.gather_seq(h, self.tp) if sp else h,
                         sp), None

    def forward(self, x, enc_out=None, sp: bool = False, dp=None):
        """(x after the block, the MoE's aux or None); with ``enc_out``,
        a decoder block's cross step runs after its self-attention (or
        SSM) residual, before ``norm2``. ``sp``: x is this rank's
        positions (SP on the block's model axis); ``dp``: see
        :meth:`_ffn`."""
        h = self.norm1(x)
        if sp:
            h = par.gather_seq(h, self.tp)
        if self.kind in ("mlstm", "slstm"):
            return x + self._mix(getattr(self, self.kind), h, sp), None
        if self.kind == "hybrid":
            x = x + 0.5 * (self._mix(self.attn, h, sp)
                           + self._mix(self.ssm, h, sp))
        elif self.kind == "mamba_mlp":
            x = x + self._mix(self.ssm, h, sp)
        else:
            x = x + self._mix(self.attn, h, sp)
        if enc_out is not None and hasattr(self, "xattn"):
            x = self._cross(x, enc_out, sp)
        f, aux = self._ffn(x, sp, dp)
        return x + f, aux

    def _step(self, mod, method: str, h, *args, **kw):
        """(the output of ``mod.<method>`` on one token as the stream
        holds it, the new state or None): a split mixer enters through
        ``copy_to`` and its partial output is summed (:meth:`_leave`, no
        SP at decode)."""
        if getattr(mod, "tp", None) is not None:
            h = par.copy_to(h, self.tp)
        y = getattr(mod, method)(h, *args, **kw)
        y, state = (y, None) if torch.is_tensor(y) else y
        return self._leave(y, mod, False), state

    def decode(self, x, cache: Dict[str, List], i: int, pos: int,
               seq: int = None, dp=None):
        """One token through the block against layer ``i``'s entries of
        ``cache``, which are updated in place. On a split model ``seq``
        is the whole length of the layer's KV cache (the rank holds its
        slots, ``parallel.tensor.cache_slots``); ``dp``: the data axis
        whose ranks' tokens the MoE routes together."""
        h = self.norm1(x)
        if self.kind == "mlstm":
            a, (state, norm) = self._step(self.mlstm, "step", h,
                                          cache["mlstm_state"][i],
                                          cache["mlstm_norm"][i])
            cache["mlstm_state"][i].copy_(state)
            cache["mlstm_norm"][i].copy_(norm)
            return x + a
        if self.kind == "slstm":
            a, state = self._step(self.slstm, "step", h,
                                  tuple(cache[n][i] for n in SLSTM_STATE))
            for n, s in zip(SLSTM_STATE, state):
                cache[n][i].copy_(s)
            return x + a
        if self.kind in ATTENTION_KINDS:
            a, _ = self._step(self.attn, "decode", h, cache["k"][i],
                              cache["v"][i], pos, seq=seq)
        if self.kind in SSM_KINDS:
            s, state = self._step(self.ssm, "step", h,
                                  cache["ssm_state"][i])
            cache["ssm_state"][i].copy_(state)
            a = 0.5 * (a + s) if self.kind == "hybrid" else s
        x = x + a
        if hasattr(self, "xattn"):
            x = x + self._step(self.xattn, "cross_decode", self.norm_x(x),
                               cache["cross_k"][i], cache["cross_v"][i],
                               seq=self.cross_len)[0]
        return x + self._ffn(x, dp=dp)[0]


class Encoder(nn.Module):
    """The encoder of an encoder-decoder arch, ``repro``'s ``encoder``
    leaves and ``_encoder_forward``: ``layers.{j}`` (``attn_mlp``
    blocks, bidirectional, no rope, no cross step), ``pos_embed``
    (encoder_seq, D), added to the frames, and ``final_norm``. It runs
    without SP: its stream is whole on every rank of ``tp``."""

    def __init__(self, arch: ArchConfig, device=None, tp=None):
        super().__init__()
        dt, D = arch.torch_dtype, arch.d_model
        self.layers = nn.ModuleList(
            Block(arch, "attn_mlp", device, encoder=True, tp=tp)
            for _ in range(arch.encoder_layers))
        self.final_norm = L.RMSNorm(D, dt, device)
        self.pos_embed = L.empty_param((arch.encoder_seq, D), dt, device)

    def forward(self, frames, remat: str = "none"):
        """frames (B, encoder_seq, D), cast to the model dtype -> the
        encoder output (B, encoder_seq, D); each block under ``remat``."""
        x = frames.to(self.pos_embed.dtype) + self.pos_embed[None]
        for blk in self.layers:
            x = _checkpointed(blk, x, remat)[0]
        return self.final_norm(x)


class LM(nn.Module):
    """Parameters under ``repro``'s names: ``embed`` (V, D),
    ``layers.{i}.*`` (see :class:`Block`), ``final_norm.scale``,
    ``unembed`` (D, V) (absent with tied embeddings), ``meta`` (M, D)
    with M = ``arch.meta_tokens`` > 0 and, for an encoder-decoder arch,
    ``encoder.*`` (see :class:`Encoder`). Built for a model axis ``axis``
    of size m > 1 (``parallel.tensor.Axis``), each module holds its
    rank's shards, and ``embed`` / ``unembed`` their block of V / m rows /
    columns where m divides V (``vocab_split``)."""

    def __init__(self, arch: ArchConfig, device=None, axis=None):
        super().__init__()
        check_ported(arch)
        self.arch = arch
        self.axis = axis if axis is not None and axis.size > 1 else None
        m = axis.size if self.axis is not None else 1
        dt, D, V = arch.torch_dtype, arch.d_model, arch.vocab_size
        self.vocab_split = m > 1 and V % m == 0
        if self.vocab_split:
            V //= m
        self.embed = L.empty_param((V, D), dt, device)
        self.layers = nn.ModuleList(
            Block(arch, arch.block_at(i), device, tp=self.axis)
            for i in range(arch.n_layers))
        self.final_norm = L.RMSNorm(D, dt, device)
        if not arch.tie_embeddings:
            self.unembed = L.empty_param((D, V), dt, device)
        if arch.meta_tokens:
            self.meta = L.empty_param((arch.meta_tokens, D), dt, device)
        if arch.is_encdec:
            self.encoder = Encoder(arch, device, tp=self.axis)

    def _rows(self, tokens):
        """The tokens' embedding rows; of a split vocabulary, this rank's
        rows, zero for a token outside its block."""
        if not self.vocab_split:
            return self.embed[tokens.long()]
        n = self.embed.shape[0]
        t = tokens.long() - self.axis.index * n
        inside = (t >= 0) & (t < n)
        return torch.where(inside[..., None],
                           self.embed[t.clamp(0, n - 1)], 0)

    def _embed(self, tokens, extras=None, pos0: int = 0,
               prefix: bool = True, sp: bool = False):
        """The tokens' embedding rows plus the sinusoid at positions pos0
        + [0, S) where the arch takes sinusoidal positions; then, where
        ``prefix`` is set, ``extras["patches"]`` prepended for a
        vision-stub arch, then the ``meta`` rows broadcast over the batch
        where the arch has them (``repro``'s ``_embed``, in its order).
        A split vocabulary's rows are summed over the model group; under
        ``sp`` the sum is a reduce-scatter over the sequence, so only the
        model group's first rank adds the rest, and the result is this
        rank's positions."""
        x = self._rows(tokens)
        split = self.vocab_split
        own = not (split and sp) or self.axis.index == 0
        if split and not sp:
            x = par.reduce_from(x, self.axis)
        if self.arch.pos_embed == "sinusoidal" and own:
            pos = pos0 + torch.arange(tokens.shape[1], device=x.device)
            x = x + sinusoid(pos, self.arch.d_model)[None].to(x.dtype)
        rows = []
        if prefix and self.arch.frontend == "vision_stub" and extras \
                and "patches" in extras:
            rows.append(extras["patches"].to(x.dtype))
        if prefix and self.arch.meta_tokens:
            rows.insert(0, self.meta[None].expand(x.shape[0], -1, -1)
                        .to(x.dtype))
        for r in reversed(rows):
            x = torch.cat([r if own else torch.zeros_like(r), x], dim=1)
        if sp:
            par.seq_split(x.shape[1], self.axis)
            x = par.scatter_seq(x, self.axis) if split \
                else par.local_chunk(x, self.axis)
        return x

    def _logits(self, x):
        """All V logits of x: of a split vocabulary, the ranks' column
        blocks gathered over the model group (``gather_cols``)."""
        x = self.final_norm(x)
        unembed = self.embed.T if self.arch.tie_embeddings else self.unembed
        y = x @ unembed
        return par.gather_cols(y, self.axis) if self.vocab_split else y

    def _hidden(self, tokens, extras=None, remat: str = "none",
                sp: bool = False, dp=None):
        """(last hidden state, the MoE layers' aux summed in f32); under
        ``sp`` (a model axis of m > 1) the state is this rank's
        positions; ``dp``: the data axis whose ranks' tokens the MoE
        layers route together."""
        extras = {k: torch.as_tensor(v, device=self.embed.device)
                  for k, v in (extras or {}).items()}
        enc_out = None
        if self.arch.is_encdec:
            if "frames" not in extras:
                raise ValueError(
                    f"{self.arch.name} is an encoder-decoder arch: its "
                    f"forward needs extras['frames'] (B, "
                    f"{self.arch.encoder_seq}, {self.arch.d_model})")
            enc_out = self.encoder(extras["frames"], remat)
        sp = sp and self.axis is not None
        x = self._embed(tokens, extras, sp=sp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            fn = blk if enc_out is None and not sp and dp is None \
                else functools.partial(blk, enc_out=enc_out, sp=sp, dp=dp)
            x, a = _checkpointed(fn, x, remat)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward_aux(self, tokens, extras=None, remat: str = "none"):
        """Full-sequence forward: tokens (B, S) and ``extras``
        (``{"frames": (B, encoder_seq, D)}`` for an encoder-decoder arch,
        ``{"patches": (B, N, D)}`` for a vision-stub arch, else none) ->
        (logits (B, N + M + S, V), aux), N the patch rows and M the arch's
        meta tokens (0 but for hymba), each block under the checkpointing
        policy ``remat`` (one of :data:`REMAT`); aux is the sum of the MoE
        layers' load-balancing losses (0 without MoE layers), as
        ``repro``'s ``forward`` returns it."""
        x, aux = self._hidden(tokens, extras, remat)
        return self._logits(x), aux

    def forward(self, tokens, extras=None, remat: str = "none"):
        """``forward_aux``'s logits alone."""
        return self.forward_aux(tokens, extras, remat)[0]

    def prefill(self, tokens, extras=None):
        """Forward over the prompt (and ``extras``) -> the last position's
        logits (B, 1, V). Only that position is normed and unembedded: the
        values are ``forward``'s, without the (B, S, V) logits."""
        return self._logits(self._hidden(tokens, extras)[0][:, -1:])

    def fill_cross_cache(self, cache: Dict[str, List], frames):
        """Runs the encoder over ``frames`` (B, encoder_seq, D) and writes
        each decoder layer's cross-attention k and v of its output
        (``cross_kv``) into ``cache["cross_k"]`` / ``["cross_v"]`` IN
        PLACE: what ``repro``'s ``decode_step`` reads from
        ``cache["cross"]``. On a split model the encoder runs whole on
        every rank, as in training, and the rank writes every head of its
        frame slots (``parallel.tensor.cache_slots``); ``frames`` are the
        cache's batch rows. Returns ``cache``."""
        enc_out = self.encoder(torch.as_tensor(frames,
                                               device=self.embed.device))
        first, n = par.cache_slots(enc_out.shape[1], self.axis)
        for i, blk in enumerate(self.layers):
            k, v = cross_kv(blk.xattn, enc_out, every_head=True)
            cache["cross_k"][i].copy_(k[:, :, first:first + n])
            cache["cross_v"][i].copy_(v[:, :, first:first + n])
        return cache

    def decode_step(self, tokens, cache: Dict[str, List[torch.Tensor]],
                    pos: int, data=None):
        """One decode step: tokens (B, 1) at position ``pos`` against
        ``cache`` (from ``init_cache``), which is updated IN PLACE; an
        MoE layer routes the B tokens together; an encoder-decoder arch's
        layers attend to their ``cross_k`` / ``cross_v``. Returns (logits
        (B, 1, V), cache). On a model axis of m > 1 ``cache`` is the
        rank's (``init_cache(..., axis=)`` or :func:`shard_cache`), the
        logits all V on every rank. ``data``: the data
        axis (``parallel.tensor.Axis``) over whose ranks the batch is
        split, whose tokens an MoE layer routes as one, as ``repro``'s
        jitted step routes its global batch."""
        seq = None
        if self.axis is not None:
            seq = getattr(cache, "seq_len", None)
            if seq is None:
                raise ValueError(
                    "a model split over a model axis decodes against a "
                    "rank's cache from init_cache(..., axis=) or "
                    "shard_cache")
        dp = data if data is not None and data.size > 1 else None
        x = self._embed(tokens, pos0=pos, prefix=False)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache, i, pos, seq and cache_len(
                self.arch, blk.kind, seq), dp)
        return self._logits(x), cache


def train_loss(model: LM, batch: Dict, aux_weight: float = 0.01,
               remat: str = "none", shard_acts: bool = False, data=None):
    """The mean next-token cross-entropy of ``batch`` (``{"tokens": (B,
    S), "targets": (B, S)}``, tensors or numpy arrays, moved to the
    model's device; every other key, ``frames`` or ``patches``, goes to
    the forward as an extra), as ``repro``'s ``train_loss`` computes it:
    f32 logits, logsumexp minus the gold logit, the mean. The gold logit
    is a ``torch.gather`` on one rank, the same function as ``repro``'s
    masked reduction over the vocabulary, which a split vocabulary runs
    (:func:`_vocab_parallel_ce`). Plus ``aux_weight`` times the MoE
    layers' summed load-balancing loss (0 without MoE layers), as in
    ``repro``. The positions that ``forward`` prepends (patches, meta
    tokens) carry no loss. ``shard_acts``: sequence parallelism over the
    model's model axis (see the module docstring); on one rank it changes
    nothing. The loss is the same on every rank of the model axis.
    ``data``: the data axis (``parallel.tensor.Axis``) of a trainer's
    ranks, whose batches an MoE layer routes as one, as ``repro``'s
    jitted step routes its global batch (``layers.moe_route``)."""
    dev = model.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    extras = {k: v for k, v in batch.items()
              if k not in ("tokens", "targets")}
    data = data if data is not None and data.size > 1 else None
    x, aux = model._hidden(tokens, extras, remat, shard_acts, data)
    if model.vocab_split or (shard_acts and model.axis is not None):
        return _split_loss(model, x, targets, shard_acts) + aux_weight * aux
    logits = model._logits(x)
    logits = logits[:, logits.shape[1] - targets.shape[1]:].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold) + aux_weight * aux


def _vocab_parallel_ce(logits, targets, axis, first: int):
    """The mean over positions of logsumexp minus the gold logit, of f32
    logits (B, S, V / m) that hold the vocabulary's columns [first, first
    + V / m) on each rank of ``axis``: the max over the model group
    (no gradient: the shift cancels), the sums of exp and of ``repro``'s
    masked gold reduction in one ``reduce_from``."""
    mx = par.max_over(logits.detach().amax(-1), axis)
    iota = torch.arange(first, first + logits.shape[-1],
                        device=logits.device)
    gold = torch.where(iota == targets[..., None], logits, 0.0).sum(-1)
    sums = par.reduce_from(torch.stack(
        [torch.exp(logits - mx[..., None]).sum(-1), gold]), axis)
    return torch.mean(mx + torch.log(sums[0]) - sums[1])


def _split_loss(model: LM, x, targets, sp: bool):
    """``train_loss``'s cross entropy of the last hidden state x of a
    model on a model axis whose vocabulary is split, or (``sp``) whose
    x is this rank's positions."""
    ax = model.axis
    S = targets.shape[1]
    x = model.final_norm(x)
    unembed = model.embed.T if model.arch.tie_embeddings else model.unembed
    if model.vocab_split:
        x = par.gather_seq(x, ax) if sp else par.copy_to(x, ax)
        logits = (x[:, x.shape[1] - S:] @ unembed).float()
        return _vocab_parallel_ce(logits, targets, ax,
                                  ax.index * unembed.shape[1])
    # a whole vocabulary under SP: this rank's positions past the prefix
    n = x.shape[1]
    start, prefix = ax.index * n, n * ax.size - S
    skip = min(max(prefix - start, 0), n)
    t = targets[:, start + skip - prefix:max(start + n - prefix, 0)]
    logits = (x[:, skip:] @ unembed).float()
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    per = torch.logsumexp(logits, dim=-1) - gold
    return par.reduce_from(per.sum(), ax) / targets.numel()


# The recurrent blocks' biases, filled with constants, not drawn.
_BIAS_FILL = {"b_decay": 2.0, "b_f": 3.0}


def init_params(arch: ArchConfig, seed: int = 0, device="cuda",
                axis=None) -> LM:
    """An :class:`LM` with random weights from ``seed``, drawn on
    ``device`` by a ``torch.Generator`` at ``repro``'s scales: N(0, 1) in
    f32 times fan_in ** -0.5 for the dense matrices (shape[0]; the MoE
    router and the recurrent gates' f32 matrices), shape[1] ** -0.5 for the
    (E, ., .) expert weights, dh ** -0.5 for the sLSTM's (H, dh, dh)
    recurrent ``r_*``, 0.02 for ``embed``, ``meta`` and
    ``encoder.pos_embed``, d_model ** -0.5 for ``unembed``, then cast to
    each parameter's dtype; norm scales 1,
    QKV biases 0, the SSM decay bias ``b_decay`` 2 and the mLSTM forget
    bias ``b_f`` 3, as ``repro``'s inits fill them. (Not
    ``jax.random``'s numbers: weights cross from ``repro`` through
    ``convert.lm_params_from_numpy``.) On a model ``axis`` each leaf is
    drawn whole, in the same order, and the rank keeps its shard, so the
    ranks of every model axis start from the one-rank model."""
    dev = resolve_device(device)
    model = LM(arch, dev, axis)
    m = model.axis.size if model.axis is not None else 1
    lay = par.layout(arch, m) if m > 1 else {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            elif leaf in _BIAS_FILL:
                p.fill_(_BIAS_FILL[leaf])
            else:
                dim = lay.get(name)
                shape = par.full_shape(p.shape, dim, m)
                if leaf.startswith("r_"):          # (H, dh, dh)
                    fan_in = shape[-1]
                elif p.dim() == 3:                 # (E, fan_in, out)
                    fan_in = shape[1]
                else:
                    fan_in = shape[0]
                std = {"embed": 0.02, "meta": 0.02,
                       "encoder.pos_embed": 0.02,
                       "unembed": arch.d_model ** -0.5}.get(
                    name, fan_in ** -0.5)
                p.copy_(par.cut(torch.randn(
                    shape, generator=gen, device=dev,
                    dtype=torch.float32).mul_(std), dim, model.axis))
    return model


class Cache(dict):
    """A decode cache, {entry: one tensor a layer or None}, that knows the
    ``seq_len`` it was made for (a split model's rank reads its slots'
    place in the whole sequence from it)."""
    seq_len = None


def init_cache(arch: ArchConfig, batch: int, seq_len: int,
               device="cuda", axis=None, data=None) -> Cache:
    """The decode cache (``repro``'s ``cache_specs``, allocated, zeros on
    ``device``): {entry: a list with one tensor a layer, None for a layer
    without the entry}, over the entries the arch's kinds carry: "k" and
    "v" (B, Hkv, cache_len, head_dim) in the config dtype, where
    ``cache_len`` is ``seq_len`` or, for a sliding-window layer, its
    ring's min(seq_len, window); and, in f32, "ssm_state" (B, Hs,
    ssm_state, d_model / Hs), "mlstm_state" (B, H, head_dim, dh),
    "mlstm_norm" (B, H, head_dim) and "slstm_c" / "_n" / "_h" / "_m" (B,
    H, dh), dh = d_model / H; for an encoder-decoder arch, "cross_k" and
    "cross_v" (B, Hkv, encoder_seq, head_dim) in the config dtype on every
    layer (``repro``'s ``cache["cross"]``; ``LM.fill_cross_cache`` fills
    them). With a model ``axis`` or a ``data`` axis
    (``parallel.tensor.Axis``), a rank's shares of that cache under
    ``repro``'s decode rule (:func:`shard_cache`)."""
    check_ported(arch)
    dev = resolve_device(device)
    if any(a is not None and a.size > 1 for a in (axis, data)):
        whole = init_cache(arch, batch, seq_len, "meta")
        out = shard_cache(whole, axis, data)
        for layers in out.values():
            layers[:] = [None if t is None else torch.zeros(
                t.shape, dtype=t.dtype, device=dev) for t in layers]
        return out
    H, Hd = arch.n_heads, arch.head_dim_
    Hs = arch.ssm_heads or H
    dh = arch.d_model // H
    f32 = torch.float32
    cache = Cache()
    cache.seq_len = seq_len
    for i in range(arch.n_layers):
        kind = arch.block_at(i)
        shapes = {}
        if kind in ATTENTION_KINDS:
            kv = (batch, arch.n_kv_heads, cache_len(arch, kind, seq_len), Hd)
            shapes["k"] = shapes["v"] = (kv, arch.torch_dtype)
        if kind in SSM_KINDS:
            shapes["ssm_state"] = ((batch, Hs, arch.ssm_state,
                                    arch.d_model // Hs), f32)
        elif kind == "mlstm":
            shapes["mlstm_state"] = ((batch, H, Hd, dh), f32)
            shapes["mlstm_norm"] = ((batch, H, Hd), f32)
        elif kind == "slstm":
            for name in SLSTM_STATE:
                shapes[name] = ((batch, H, dh), f32)
        if arch.is_encdec:
            shapes["cross_k"] = shapes["cross_v"] = (
                (batch, arch.n_kv_heads, arch.encoder_seq, Hd),
                arch.torch_dtype)
        for name, (shape, dtype) in shapes.items():
            cache.setdefault(name, [None] * arch.n_layers)[i] = torch.zeros(
                shape, dtype=dtype, device=dev)
    return cache


def shard_cache(cache: Cache, axis=None, data=None) -> Cache:
    """A rank's decode cache cut from a whole ``cache`` (``init_cache``'s,
    of its ``seq_len``): each tensor's block under ``repro``'s decode
    specs (``sharding.batch_partition_specs``) sanitized on the (data,
    model) grid of ``data`` and the model ``axis``
    (``parallel.tensor.Axis``): the batch over 'data', the KV and cross
    caches' sequence over 'model', the recurrent states' other dims
    whole; a contiguous copy. The cache's counterpart of
    ``parallel.tensor.shard_model``, equal in layout to
    ``init_cache(..., axis, data)``."""
    mesh = make_mesh(tuple(a.size if a is not None else 1
                           for a in (data, axis)), ("data", "model"))
    specs = sharding.batch_partition_specs({"cache": cache}, mesh,
                                           "decode")["cache"]
    parts = {"model": axis, "data": data}
    out = Cache()
    out.seq_len = cache.seq_len
    for name, layers in cache.items():
        held = []
        for t, spec in zip(layers, specs[name]):
            for d, part in enumerate(spec if t is not None else ()):
                if part in parts:
                    t = par.cut(t, d, parts[part])
            held.append(None if t is None else t.clone(
                memory_format=torch.contiguous_format))
        out[name] = held
    return out


def param_specs(arch: ArchConfig, axis=None) -> LM:
    """An :class:`LM` of ``arch`` on the meta device: every parameter's
    name, shape and dtype, nothing allocated (``repro``'s
    ``param_specs``); with a model ``axis``, one rank's shards."""
    return LM(arch, torch.device("meta"), axis)


def param_count(arch: ArchConfig, include_embed: bool = True) -> int:
    """The parameters of ``arch``'s leaves; without ``embed`` and
    ``unembed`` when ``include_embed`` is False (``repro``'s)."""
    return sum(p.numel() for name, p in param_specs(arch).named_parameters()
               if include_embed or name not in ("embed", "unembed"))
