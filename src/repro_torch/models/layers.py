"""Model layers (the port of ``repro/models/layers.py``): RMSNorm,
rotary embeddings, GQA attention (causal, sliding-window or
bidirectional, self- or cross-attention: the full-sequence path through
``flash_attention``, and the cached single-token decode path, whose
sliding-window cache is a ring), the SwiGLU / 2-matrix MLP and the
capacity-based top-k MoE.

The arithmetic lives in plain functions that take tensors, as ``repro``'s
do; ``RMSNorm``, ``Attention``, ``MLP`` and ``MoE`` hold the parameters
under ``repro``'s names and call them. Matmuls run in the config dtype
(bf16); norms, rotary embeddings, attention and the MoE router compute in
f32 and cast back, at the same points as ``repro``. The MoE is plain
PyTorch, as ``repro``'s is plain ``jnp`` outside any Pallas kernel: its
expert products are three ``torch.bmm`` over (E, C, D) buffers.

Built for a model axis (``tp``, a ``parallel.tensor.Axis`` of size m >
1), ``Attention`` holds its rank's Hq / m query and Hkv / m kv heads
where m divides both, and else, where m divides Hq Dh, its block of the
flat columns of wq (and of wk / wv where m divides Hkv Dh) and of the
rows of wo (its products gathered to whole heads: ``project``), ``MLP``
its d_ff / m hidden columns, and ``MoE`` its E / m experts where m
divides E (EP, ``repro``'s ``_moe_buffer_spec`` branch) or else each
expert's d_ff / m (expert-TP); such a module's output is the rank's
partial sum, which the block sums over the model group (``models.lm``).
Decode on such a model (``attention_decode`` and
``cross_attention_decode`` with ``axis``) gathers the new token's q, k
and v to every head, attends over the rank's block of the cache's
sequence slots and merges the ranks' partial softmaxes
(``parallel.tensor.merge_softmax``), then multiplies the rank's heads'
(or flat columns') rows of wo.
The MoE's router, top-k, capacity and aux loss stay replicated and equal
to ``repro``'s; under EP each rank fills only its experts' rows of the
dispatch buffer and takes only their picks in the combine. Not ported:
``maybe_shard`` (the layouts are the modules' own) and the perf flags
(``DECODE_GROUPED_GQA`` stays at its default, the repeat of the cache's
heads; ``MOE_BUF_2D`` only shards).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.parallel import tensor as par


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rmsnorm(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation.
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def empty_param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = empty_param((d,), dtype, device)

    def forward(self, x):
        return rmsnorm(self.scale, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (S,) or (B, S) absolute positions.
    Rotates the interleaved pairs (x[..., 0::2], x[..., 1::2])."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)        # (D/2,)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, None]                           # (1, 1, S, D/2)
    else:
        ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def project(x, w, width: int, tp=None, b=None):
    """x @ w (+ b) with all ``width`` columns: where w holds only this
    rank's block of them (a flat column split over the model axis
    ``tp``), the ranks' products gathered (``parallel.tensor.
    gather_cols``)."""
    y = x @ w
    if b is not None:
        y = y + b
    return y if y.shape[-1] == width else par.gather_cols(y, tp)


def project_qkv(p, x, n_heads, n_kv_heads, head_dim, tp=None):
    """q (B, H, S, Dh), k and v (B, Hkv, S, Dh) from x (B, S, D); ``p``
    maps wq/wk/wv (and bq/bk/bv with a QKV bias) to tensors; ``tp``: the
    model axis of a flat column split (see :func:`project`)."""
    B, S, _ = x.shape
    q, k, v = (project(x, p[w], n * head_dim, tp, p.get(b)) for w, b, n in
               (("wq", "bq", n_heads), ("wk", "bk", n_kv_heads),
                ("wv", "bv", n_kv_heads)))
    q = q.reshape(B, S, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    return q, k, v


def attention_train(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                    window: int = 0, causal: bool = True, positions=None,
                    kv_override=None, tp=None):
    """Full-sequence attention (training / prefill) through
    ``flash_attention``. Returns (out, (k, v)). ``kv_override`` supplies
    (k, v) (B, Hkv, Sk, Dh) computed elsewhere (cross-attention): then
    only q is projected, and no rope is applied. ``repro`` projects k and
    v there too and drops them, so the values are the same. ``tp``: the
    model axis of a flat column split: q, k and v are gathered to the
    whole heads, K5 runs on all of them, and the rank's columns of its
    output meet its rows of wo (a partial sum)."""
    B, S, _ = x.shape
    if kv_override is not None:
        q = project(x, p["wq"], n_heads * head_dim, tp, p.get("bq"))
        q = q.reshape(B, S, n_heads, head_dim).transpose(1, 2)
        k, v = kv_override
    else:
        q, k, v = project_qkv(p, x, n_heads, n_kv_heads, head_dim, tp)
        if rope_theta > 0:
            if positions is None:
                positions = torch.arange(S, device=x.device)
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    return par.local_chunk(o, tp, -1) @ p["wo"], (k, v)


def project_gathered(ys, widths, tp=None) -> list:
    """The products ``ys`` with all their ``widths`` columns: those that
    hold this rank's block of a flat column split over ``tp`` (fewer
    columns than their width) gathered in ONE all-gather a dtype
    (``parallel.tensor.gather_last``; no gradient: decode), the whole ones
    as they are."""
    ys = list(ys)
    part = [i for i, (y, n) in enumerate(zip(ys, widths)) if y.shape[-1] != n]
    for dt in dict.fromkeys(ys[i].dtype for i in part):
        same = [i for i in part if ys[i].dtype == dt]
        for i, y in zip(same, par.gather_last([ys[i] for i in same], tp)):
            ys[i] = y
    return ys


def decode_qkv(p, x, n_heads, n_kv_heads, head_dim, tp=None):
    """The new token's q (B, Hq, 1, Dh), k and v (B, Hkv, 1, Dh) at every
    head from x (B, 1, D): the products that ``tp`` splits (by heads or
    flat columns) gathered in ONE all-gather (``parallel.tensor.
    gather_last``), those it leaves whole as they are. ``p`` without wk
    gives q alone (cross-attention)."""
    B = x.shape[0]
    names = [(w, b, n) for w, b, n in (("wq", "bq", n_heads),
                                       ("wk", "bk", n_kv_heads),
                                       ("wv", "bv", n_kv_heads)) if w in p]
    ys = []
    for w, b, _ in names:
        y = x @ p[w]
        ys.append(y if p.get(b) is None else y + p[b])
    ys = project_gathered(ys, [n * head_dim for _, _, n in names], tp)
    return [y.reshape(B, 1, n, head_dim).transpose(1, 2)
            for y, (_, _, n) in zip(ys, names)]


def split_kv_attention(q, cache_k, cache_v, valid, head_dim: int, axis):
    """One token's attention over the cache slots this rank holds, merged
    over the model ``axis`` (``parallel.tensor.merge_softmax``; None: the
    rank holds the whole sequence): q (B, Hq, 1, Dh) at every head,
    cache_k/v (B, Hkv, n, Dh), ``valid`` (n,) the live slots (None: all).
    Returns the f32 output (B, Hq, 1, Dh)."""
    group = q.shape[1] // cache_k.shape[1]
    kf = torch.repeat_interleave(cache_k.float(), group, dim=1)
    vf = torch.repeat_interleave(cache_v.float(), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) \
        / (head_dim ** 0.5)
    if valid is not None:
        scores = torch.where(valid[None, None, None, :], scores, -1e30)
    if axis is None or axis.size == 1:      # the whole sequence: one softmax
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), vf)
    mx = scores.amax(-1)
    e = torch.exp(scores - mx[..., None])
    return par.merge_softmax(mx, e.sum(-1),
                             torch.einsum("bhqk,bhkd->bhqd", e, vf), axis)


def _slots(cache_k, seq: int, axis):
    """(first, count) of the rank's slots of a cache of ``seq``
    (``parallel.tensor.cache_slots``), checked against what it holds."""
    first, n = par.cache_slots(seq, axis)
    if cache_k.shape[2] != n:
        raise ValueError(f"this rank's cache holds {cache_k.shape[2]} slots"
                         f", not the {n} of a cache of {seq} over a model "
                         f"axis of {axis.size if axis else 1}")
    return first, n


def _merged_out(p, q, cache_k, cache_v, valid, seq: int, tp, axis, dtype):
    """q's attention over the rank's slots, merged over ``axis`` unless
    the rank holds all ``seq`` of them, cast to ``dtype``; then the rank's
    heads' (or flat columns') rows of wo: its partial sum where ``tp``
    splits, else the whole output."""
    B, H, _, Dh = q.shape
    o = split_kv_attention(q, cache_k, cache_v, valid, Dh,
                           axis if cache_k.shape[2] != seq else None)
    o = o.to(dtype).transpose(1, 2).reshape(B, 1, H * Dh)
    return par.local_chunk(o, tp, -1) @ p["wo"]


def attention_decode(p, x, cache_k, cache_v, pos: int, *, n_heads,
                     n_kv_heads, head_dim, rope_theta, window: int = 0,
                     seq: int = None, tp=None, axis=None):
    """Single-token decode against a KV cache, plain PyTorch (``repro``
    computes it outside any kernel too).

    x: (B, 1, D); cache_k/v: (B, Hkv, n, Dh), the slots
    ``parallel.tensor.cache_slots(seq, axis)`` of a cache of ``seq``
    (default n: the whole cache); pos: the position of the new token,
    whose k/v are written IN PLACE at slot min(pos, seq - 1), or pos % seq
    for a sliding-window ring cache, by the rank holding it, where
    ``repro`` returns a new cache. On a model split over the model
    ``axis`` (n_heads / n_kv_heads the whole counts, ``tp`` the axis of
    wq's split or None) the new token's q, k and v are gathered to every
    head (``decode_qkv``), every rank attends over its slots for every
    head, their live mask from the slots' global indices (a ring wraps
    across the ranks), the partials merge over the axis, and the rank's
    rows of wo give its partial sum. Returns (out, cache_k, cache_v).
    """
    seq = seq or cache_k.shape[2]
    first, n = _slots(cache_k, seq, axis)
    q, k, v = decode_qkv(p, x, n_heads, n_kv_heads, head_dim, tp)
    if rope_theta > 0:
        posv = torch.full((1,), pos, device=x.device)   # no host copy
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    slot = (pos % seq if window > 0 else min(pos, seq - 1)) - first
    if 0 <= slot < n:
        cache_k[:, :, slot] = k[:, :, 0].to(cache_k.dtype)
        cache_v[:, :, slot] = v[:, :, 0].to(cache_v.dtype)
    kpos = torch.arange(first, first + n, device=x.device)
    valid = kpos <= pos
    if window > 0 and pos >= seq:     # ring cache: all slots live once full
        valid = torch.ones_like(valid)
    return _merged_out(p, q, cache_k, cache_v, valid, seq, tp, axis,
                       x.dtype), cache_k, cache_v


def cross_attention_decode(p, x, cross_k, cross_v, *, n_heads, n_kv_heads,
                           head_dim, seq: int = None, tp=None, axis=None,
                           **_):
    """One token's cross-attention over the cached k and v of the encoder
    output, plain PyTorch with an f32 softmax (``repro``'s ``xattn``
    step of ``_block_decode``; no kernel, no mask, no rope, no bias).
    x: (B, 1, D); cross_k/v: (B, Hkv, n, Dh), the slots
    ``parallel.tensor.cache_slots(seq, axis)`` of the ``seq`` frames
    (default n: all of them). Returns (B, 1, D). On a model split over
    ``axis`` (n_heads, n_kv_heads the whole counts, ``tp`` wq's split or
    None) q is gathered to every head, attends over the rank's frames,
    the partials merge, and the rank's rows of wo give its partial sum."""
    seq = seq or cross_k.shape[2]
    _slots(cross_k, seq, axis)
    q, = decode_qkv({"wq": p["wq"]}, x, n_heads, n_kv_heads, head_dim, tp)
    return _merged_out(p, q, cross_k, cross_v, None, seq, tp, axis,
                       x.dtype)


class Attention(nn.Module):
    """GQA attention weights: wq (D, H Dh), wk/wv (D, Hkv Dh), wo
    (H Dh, D), and bq/bk/bv with a QKV bias. ``window`` > 0 makes it
    sliding-window attention, whose decode cache is a ring;
    ``causal=False`` makes its full-sequence pass bidirectional (an
    encoder's, or cross-attention with ``kv``). With a model axis ``tp``
    of size m (``self.tp`` set where m divides H Dh, else None: whole):
    where m also divides H and Hkv, it holds heads [i H / m, (i + 1) H /
    m) and kv heads [i Hkv / m, ...) of rank i (``self.heads``); else the
    flat columns [i H Dh / m, ...) of wq and bq, of wk, wv, bk and bv
    where m divides Hkv Dh (else they are whole, and ``partial``: their
    gradient is the rank's part), and the rows of wo, and runs the whole
    heads (``attention_train``'s ``tp``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool, rope_theta: float, dtype,
                 device=None, window: int = 0, causal: bool = True,
                 tp=None):
        super().__init__()
        m = tp.size if tp is not None else 1
        nq, nkv = n_heads * head_dim, n_kv_heads * head_dim
        self.tp = tp if m > 1 and nq % m == 0 else None
        if m > 1 and self.tp is None and nkv % m == 0:
            raise NotImplementedError(
                f"a model axis of {m} splits wk ({nkv} columns) but not wq "
                f"({nq}): the port runs no such attention")
        self.heads = self.tp is None or (n_heads % m == 0
                                         and n_kv_heads % m == 0)
        whole = dict(n_heads=n_heads, n_kv_heads=n_kv_heads)
        self.partial = ()
        if self.tp is not None:
            nq //= m
            if nkv % m:
                self.partial = ("wk", "wv") + (("bk", "bv") if qkv_bias
                                               else ())
            else:
                nkv //= m
            if self.heads:
                n_heads, n_kv_heads = n_heads // m, n_kv_heads // m
        self.causal = causal
        self.shape = dict(n_heads=n_heads, n_kv_heads=n_kv_heads,
                          head_dim=head_dim, rope_theta=rope_theta,
                          window=window)
        # decode's: the whole heads, wq's split and the model axis
        self.decode_shape = dict(self.shape, **whole, tp=self.tp,
                                 axis=tp if m > 1 else None)
        self.wq = empty_param((d_model, nq), dtype, device)
        self.wk = empty_param((d_model, nkv), dtype, device)
        self.wv = empty_param((d_model, nkv), dtype, device)
        self.wo = empty_param((nq, d_model), dtype, device)
        if qkv_bias:
            self.bq = empty_param((nq,), dtype, device)
            self.bk = empty_param((nkv,), dtype, device)
            self.bv = empty_param((nkv,), dtype, device)

    def params(self):
        return dict(self.named_parameters())

    def flat(self):
        """The model axis of a flat column split, else None."""
        return None if self.heads else self.tp

    def forward(self, x, kv=None):
        """(out, (k, v)) over the sequence; ``kv`` is ``kv_override``."""
        return attention_train(self.params(), x, causal=self.causal,
                               kv_override=kv, tp=self.flat(), **self.shape)

    def decode(self, x, cache_k, cache_v, pos: int, seq: int = None):
        """One token (``attention_decode``); on a split model cache_k/v
        are the rank's slots of a cache of ``seq``."""
        return attention_decode(self.params(), x, cache_k, cache_v, pos,
                                seq=seq, **self.decode_shape)[0]

    def cross_decode(self, x, cross_k, cross_v, seq: int = None):
        return cross_attention_decode(self.params(), x, cross_k, cross_v,
                                      seq=seq, **self.decode_shape)


# ---------------------------------------------------------------------------
# MLP (SwiGLU, or the plain 2-matrix MLP)
# ---------------------------------------------------------------------------

def mlp(p, x, act: str = "silu"):
    if p.get("w_gate") is not None:     # gated (SwiGLU-style)
        h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_up"])
    else:                               # plain 2-matrix MLP
        h = act_fn(act)(x @ p["w_up"])
    return h @ p["w_down"]


class MLP(nn.Module):
    """w_gate (swiglu) and w_up (D, F), w_down (F, D); with a model axis
    ``tp`` of size m that divides F, rank i's F / m hidden columns
    (``self.tp`` set)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None,
                 mlp_type: str = "swiglu", act: str = "silu", tp=None):
        super().__init__()
        m = tp.size if tp is not None else 1
        self.tp = tp if m > 1 and d_ff % m == 0 else None
        if self.tp is not None:
            d_ff //= m
        self.act = act
        if mlp_type == "swiglu":
            self.w_gate = empty_param((d_model, d_ff), dtype, device)
        self.w_up = empty_param((d_model, d_ff), dtype, device)
        self.w_down = empty_param((d_ff, d_model), dtype, device)

    def forward(self, x):
        return mlp(dict(self.named_parameters()), x, self.act)


# ---------------------------------------------------------------------------
# MoE (capacity-based top-k dispatch)
# ---------------------------------------------------------------------------

# Token blocks larger than this run chunk by chunk, each with its own
# capacity (bounds the dispatch buffers); read at call time, as in repro.
MOE_CHUNK_TOKENS = 1 << 17


def moe_route(router, xf, top_k: int, dp=None):
    """Router and top-k of a flat token block xf (T, D): f32 logits
    ``xf.float() @ router``, softmax, the top_k experts of each token in
    descending weight (``torch.topk``'s sorted order is ``lax.top_k``'s;
    ties are where the two may differ), their weights renormalised by
    max(sum, 1e-9), and the Switch load-balancing loss E * sum_e
    mean-prob_e * share_e, where share_e is the fraction of the picks
    that went to e. ``dp``: a data axis (``parallel.tensor.Axis``) whose
    ranks' blocks (T tokens each, in rank order) route as one, as
    ``repro``'s jitted step routes its global batch: the aux is that of
    the d T tokens, the mean probabilities summed over the axis
    (``reduce_from``) and the shares from every rank's pick counts
    (``gather_rows``); each rank back-propagates d times the replicated
    aux, since the trainer averages its ranks' gradients. Without a split
    axis both collectives return their input. Returns (topw (T, K) f32,
    tope (T, K) int64, aux, before): ``before`` (E,) the picks of each
    expert on the ranks before this one, which offset its places (None
    without a data axis)."""
    T = xf.shape[0]
    E = router.shape[1]
    d = 1 if dp is None else dp.size
    probs = torch.softmax(xf.float() @ router, dim=-1)
    topw, tope = torch.topk(probs, top_k, dim=-1, sorted=True)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    counts = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, tope.reshape(-1), torch.ones(T * top_k, dtype=torch.float32,
                                        device=xf.device))
    every = par.gather_rows(counts[None], dp)                # (d, E)
    mean = par.reduce_from(probs.sum(0), dp) / (T * d)
    aux = E * torch.sum(mean * (every.sum(0) / (T * top_k * d)))
    before = None if dp is None else every[:dp.index].sum(0).long()
    return topw, tope, par.scale_grad(aux, float(d)), before


def expert_places(e_flat, n_experts: int):
    """Each pick's place in its expert: its rank among the picks of the
    same expert in the order of ``e_flat`` (the T K picks, token-major).
    These are the integers of ``repro``'s cumsum of the (T K, E) one-hot
    down the picks; here they come from one sort of the unique keys
    expert * T K + pick, since a scan down the one-hot's T K rows runs
    column by column on the card: 14.8267 ms at T K = 65,536 over 32
    experts on an H100 (80GB HBM3, 700 W), the sort 0.3058 ms. The keys
    are unique, so the order does not rest on the sort being stable."""
    n = e_flat.numel()
    pick = torch.arange(n, device=e_flat.device)
    key, order = torch.sort(e_flat * n + pick)
    first = torch.searchsorted(key, torch.arange(
        n_experts, dtype=key.dtype, device=key.device) * n)
    return torch.empty_like(e_flat).scatter_(
        0, order, pick - first[key // n])


def moe_dispatch(xf, tope, n_experts: int, capacity: int, first: int = 0,
                 count: int | None = None, before=None):
    """The (E, C, D) expert buffers of xf (T, D) for the picks tope
    (T, K). The T K picks, token-major with slot k = 0 the highest
    weight, take places in their expert in that order
    (``expert_places``); a pick at place C or later is dropped. Only the
    kept rows are written (their (expert, place) are unique), which
    equals ``repro``'s scatter-add of zeros for the dropped ones. With
    ``count`` < E (EP) the buffers are those of experts [first, first +
    count) only, and every other expert's pick is dropped here.
    ``before`` (E,): the picks of each expert ahead of this block (routed
    over a data axis), added to its places. Returns
    (buf, row, keep): row (e - first) C + place of each pick in the
    flattened buffer (count C for a dropped one), keep its mask, each
    (T K,)."""
    T, D = xf.shape
    K = tope.shape[1]
    count = n_experts if count is None else count
    e_flat = tope.reshape(T * K)
    place = expert_places(e_flat, n_experts)
    if before is not None:
        place = place + before[e_flat]
    keep = place < capacity
    if count != n_experts:
        e_flat = e_flat - first
        keep = keep & (e_flat >= 0) & (e_flat < count)
    row = torch.where(keep, e_flat * capacity + place, count * capacity)
    # A spare last row takes the dropped picks and is cut off.
    buf = xf.new_zeros((count * capacity + 1, D)).index_copy(
        0, row, torch.repeat_interleave(xf, K, dim=0))
    return buf[:-1].view(count, capacity, D), row, keep


def expert_ffn(p, buf, act: str = "silu"):
    """The experts' SwiGLU on their buffers: act(buf w_gate) * (buf w_up),
    then w_down, three ``torch.bmm`` at the buffers' dtype."""
    h = act_fn(act)(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def moe_combine(out_buf, row, keep, topw):
    """Each token's output: its K picks' rows of out_buf (E, C, D), zero
    for a dropped pick, weighted by topw cast to out_buf's dtype and
    summed over K -> (T, D)."""
    E, C, D = out_buf.shape
    T, K = topw.shape
    got = out_buf.reshape(E * C, D)[torch.where(keep, row, 0)]
    got = torch.where(keep[:, None], got, 0)
    w = topw.reshape(T * K, 1).to(got.dtype)
    return (got * w).reshape(T, K, D).sum(dim=1)


def moe_tokens(p, xf, *, n_experts: int, top_k: int,
               capacity_factor: float, act: str = "silu", tp=None, sp=None,
               dp=None):
    """Capacity-based top-k MoE over a flat token block xf (T, D), with
    capacity C = max(int(T K / E * capacity_factor), 4) a expert.
    Returns (out (T, D), aux).

    ``tp``: the model axis when ``p`` holds this rank's experts (EP:
    ``w_gate`` has fewer than E rows) or each expert's share of d_ff
    (expert-TP); ``out`` is then the rank's partial sum. ``sp``: the model
    axis when xf is the sequence gathered under SP; each rank then
    back-propagates 1 / m of the replicated aux, and its router's
    gradient is a partial sum. Without ``sp``, a split MoE's input and
    weights enter through ``copy_to``, so the router's gradient is whole
    on every rank. ``dp``: a data axis (``parallel.tensor.Axis``) of d >
    1 ranks whose blocks route together (``moe_route``), with the
    capacity of their d T tokens."""
    topw, tope, aux, before = moe_route(p["router"], xf, top_k, dp)
    T = xf.shape[0] * (1 if dp is None else dp.size)
    if sp is not None:
        aux = par.scale_grad(aux, 1.0 / sp.size)
    elif tp is not None:
        xf, topw = par.copy_to(xf, tp), par.copy_to(topw, tp)
    C = max(int(T * top_k / n_experts * capacity_factor), 4)
    count = p["w_gate"].shape[0]
    first = tp.index * count if count < n_experts else 0
    buf, row, keep = moe_dispatch(xf, tope, n_experts, C, first, count,
                                  before)
    return moe_combine(expert_ffn(p, buf, act), row, keep, topw), aux


def moe(p, x, *, n_experts: int, top_k: int, capacity_factor: float = 1.25,
        act: str = "silu", chunk_tokens: int | None = None, tp=None,
        sp=None, dp=None):
    """GShard-style capacity-based top-k MoE of x (B, S, D) -> (out, aux).
    Token blocks of more than ``chunk_tokens`` (default
    ``MOE_CHUNK_TOKENS``) that it divides run chunk by chunk, capacity
    per chunk, aux the mean over the chunks, as in ``repro``. ``tp``,
    ``sp`` and ``dp``: see :func:`moe_tokens`."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    if chunk_tokens is None:
        chunk_tokens = MOE_CHUNK_TOKENS
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, act=act, tp=tp, sp=sp,
              dp=dp)
    if chunk_tokens and T > chunk_tokens and T % chunk_tokens == 0:
        outs, auxs = zip(*(moe_tokens(p, xc, **kw)
                           for xc in xf.split(chunk_tokens)))
        return torch.cat(outs).reshape(B, S, D), torch.stack(auxs).mean()
    out, aux = moe_tokens(p, xf, **kw)
    return out.reshape(B, S, D), aux


class MoE(nn.Module):
    """MoE weights: ``router`` (D, E) in f32 whatever the config dtype,
    ``w_gate`` and ``w_up`` (E, D, F), ``w_down`` (E, F, D). With a model
    axis ``tp`` of size m: rank i's experts [i E / m, (i + 1) E / m)
    where m divides E (EP), else each expert's F / m hidden columns where
    m divides F (expert-TP), else whole (``self.tp`` None); the router
    is whole on every rank."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 capacity_factor: float, dtype, device=None,
                 act: str = "silu", tp=None):
        super().__init__()
        m = tp.size if tp is not None else 1
        ep = m > 1 and n_experts % m == 0
        self.tp = tp if ep or (m > 1 and d_ff % m == 0) else None
        experts = n_experts // m if ep else n_experts
        if self.tp is not None and not ep:
            d_ff //= m
        self.shape = dict(n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor, act=act)
        self.router = empty_param((d_model, n_experts), torch.float32,
                                  device)
        self.w_gate = empty_param((experts, d_model, d_ff), dtype, device)
        self.w_up = empty_param((experts, d_model, d_ff), dtype, device)
        self.w_down = empty_param((experts, d_ff, d_model), dtype, device)

    def forward(self, x, sp=None, dp=None):
        """(out, aux) of x (B, S, D); ``sp``: the model axis when x is the
        sequence gathered under SP; ``dp``: the data axis whose ranks'
        tokens route together (see :func:`moe_tokens`)."""
        return moe(dict(self.named_parameters()), x, **self.shape,
                   tp=self.tp, sp=sp, dp=dp)
