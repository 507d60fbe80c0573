"""Recurrent and state-space layers (the port of
``repro/models/recurrent.py``): the chunkwise gated linear recurrence
(Mamba-2/SSD, GLA and mLSTM share it), the SSM heads and mLSTM built on
it, and the strictly sequential sLSTM.

  o_t = q_t . S_t,   S_t = a_t * S_{t-1} + k_t v_t^T          (per head)

with a scalar decay a_t in (0, 1] a head and step. ``chunked_gla`` takes
T in chunks of C: within a chunk the recurrence is a (C x C)
decay-masked product (``gla_intra``); across chunks a (dk x dv) state is
carried over the T / C boundaries (``gla_inter``), all in f32. mLSTM is
the same recurrence with its input gate folded into k and a normaliser
row n_t = a_t n_{t-1} + k_t beside the state, h = (S q) / max(|n . q|, 1).

``repro`` has no Pallas kernel here (its versions are plain ``jnp``), so
these are plain PyTorch. The arithmetic is ``repro``'s, with two changes
that leave the values as they are: the decay mask is applied to the
exponent before ``exp`` (``repro`` takes ``exp`` of the whole (C x C)
difference, whose masked upper triangle may overflow to inf, which
``torch.where``'s backward turns into NaN), and the sLSTM's four
recurrent products run as one (H, dh, 4 dh) batched product a step.
The modules hold their parameters under ``repro``'s leaf names; the
decay, gate and recurrent weights stay f32 in a bf16 model, as in
``repro``.

Built for a model axis (``tp``, a ``parallel.tensor.Axis`` of size m
> 1), each mixer holds the leaves ``repro``'s sanitized rules split cut
to its rank (the ``w_*`` and ``wq``/``wk``/``wv`` by columns, ``wo`` by
rows, wherever m divides the dim; ``w_decay``, ``b_decay``, ``b_f`` and
the sLSTM's ``r_*`` whole) and runs in one of two exact forms: by heads
where m divides the heads (the rank's heads alone, with its heads of the
whole leaves), else by flat columns (the products gathered to the whole
heads, the recurrence whole on every rank, the rank's columns of its
output kept for its rows of ``wo``). The output is the rank's partial
sum; ``partial`` names the whole leaves, whose gradient on a rank is its
part (``parallel.tensor.tp_partial``). A step (decode) takes the whole f32
state, which ``repro``'s spec replicates over the model axis, and
returns the whole new state on every rank: by heads the rank updates its
heads' slice and the slices are gathered in one all-gather for all the
mixer's state tensors (``parallel.tensor.gather_heads``); by flat columns
every rank updates the whole state from the gathered products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (act_fn, empty_param, project,
                                       project_gathered)
from repro_torch.parallel import tensor as par

_GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------------------
# Chunkwise gated linear recurrence (shared primitive)
# ---------------------------------------------------------------------------

def gla_intra(qc, kc, vc, cum, normalize: bool):
    """The within-chunk part: qc, kc (B, H, N, C, dk), vc (B, H, N, C,
    dv), cum (B, H, N, C) the within-chunk cumsum of log a. Returns
    (o_intra (B, H, N, C, dv), n_intra (B, H, N, C) or None):
    scores[i, j] = (q_i . k_j) exp(cum_i - cum_j) for j <= i, 0 above."""
    C = cum.shape[-1]
    rel = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones((C, C), dtype=torch.bool, device=cum.device).tril()
    decay = torch.exp(torch.where(causal, rel, float("-inf")))
    scores = torch.einsum("bhnid,bhnjd->bhnij", qc, kc) * decay
    o = torch.einsum("bhnij,bhnjv->bhniv", scores, vc)
    return o, (scores.sum(-1) if normalize else None)


def gla_inter(qc, kc, vc, cum, normalize: bool, state0, norm0):
    """The across-chunk part: the state S entering chunk c adds
    exp(cum_i) q_i S to its outputs, and leaves it as exp(total) S +
    sum_j exp(total - cum_j) k_j v_j^T (total = cum's last entry); one
    ``addcmul`` a chunk carries it. Returns (o_inter (B, H, N, C, dv),
    n_inter (B, H, N, C) or None, final S (B, H, dk, dv), final n (B, H,
    dk))."""
    B, H, N, C, dk = qc.shape
    dv = vc.shape[-1]
    total = cum[..., -1]                                  # (B, H, N)
    k_scaled = kc * torch.exp(total[..., None, None] - cum[..., None])
    kv = torch.einsum("bhnjd,bhnjv->bhndv", k_scaled, vc)
    q_scaled = qc * torch.exp(cum[..., None])
    a = torch.exp(total)
    S = qc.new_zeros((B, H, dk, dv)) if state0 is None else state0.float()
    n = qc.new_zeros((B, H, dk)) if norm0 is None else norm0.float()
    ksum = k_scaled.sum(-2) if normalize else None        # (B, H, N, dk)
    states, norms = [], []
    for c in range(N):
        states.append(S)
        S = torch.addcmul(kv[:, :, c], a[:, :, c, None, None], S)
        if normalize:
            norms.append(n)
            n = torch.addcmul(ksum[:, :, c], a[:, :, c, None], n)
    o = torch.einsum("bhnid,bhndv->bhniv", q_scaled, torch.stack(states, 2))
    n_inter = None
    if normalize:
        n_inter = torch.einsum("bhnid,bhnd->bhni", q_scaled,
                               torch.stack(norms, 2))
    elif norm0 is not None:     # repro decays a given norm0 all the same
        n = n * torch.exp(total.sum(-1))[..., None]
    return o, n_inter, S, n


def chunked_gla(q, k, v, log_a, *, chunk: int = 128,
                normalize: bool = False, state0=None, norm0=None):
    """q, k: (B, H, T, dk); v: (B, H, T, dv); log_a: (B, H, T) <= 0.

    Returns (o (B, H, T, dv) in q's dtype, final state (B, H, dk, dv),
    final norm (B, H, dk)), both f32. ``normalize=True`` adds the mLSTM
    normaliser's denominator. T must be a multiple of C = min(chunk, T),
    as in ``repro``."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    C = min(chunk, T)
    if T % C != 0:
        raise ValueError(f"sequence length {T} not a multiple of chunk {C}")
    N = T // C
    qc = q.float().reshape(B, H, N, C, dk)
    kc = k.float().reshape(B, H, N, C, dk)
    vc = v.float().reshape(B, H, N, C, dv)
    cum = torch.cumsum(log_a.float().reshape(B, H, N, C), dim=-1)
    o_intra, n_intra = gla_intra(qc, kc, vc, cum, normalize)
    o_inter, n_inter, S, n = gla_inter(qc, kc, vc, cum, normalize, state0,
                                       norm0)
    o = o_intra + o_inter
    if normalize:
        denom = torch.clamp_min(torch.abs(n_intra + n_inter), 1.0)
        o = o / denom[..., None]
    return o.reshape(B, H, T, dv).to(q.dtype), S, n


def gla_step(q, k, v, log_a, state, norm=None, *, normalize: bool = False):
    """One token of the recurrence (decode). q, k: (B, H, dk); v: (B, H,
    dv); log_a: (B, H); state: (B, H, dk, dv). Returns (o in q's dtype,
    state', norm')."""
    a = torch.exp(log_a.float())[..., None, None]
    kf = k.float()
    state = a * state + torch.einsum("bhd,bhv->bhdv", kf, v.float())
    o = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    if normalize:
        norm = a[..., 0] * norm + kf
        denom = torch.clamp_min(torch.abs(
            torch.einsum("bhd,bhd->bh", q.float(), norm)), 1.0)[..., None]
        o = o / denom
    return o.to(q.dtype), state, norm


# ---------------------------------------------------------------------------
# The two forms of a mixer split over the model axis
# ---------------------------------------------------------------------------

def _split_form(module, tp, width: int, n_heads: int):
    """Set ``module.tp`` (the model axis where m divides ``width``, the
    mixer's output width, whose rows of wo the rank holds; else None:
    whole) and ``module.heads`` (False: the flat column form, where m
    does not divide the heads). Returns m where split, else 1."""
    m = tp.size if tp is not None else 1
    module.tp = tp if m > 1 and width % m == 0 else None
    module.heads = module.tp is None or n_heads % m == 0
    return m if module.tp is not None else 1


def _cols(n: int, m: int) -> int:
    """The width a rank holds of a dim of n that ``repro``'s rule splits
    over m ranks (n where m does not divide it)."""
    return n // m if n % m == 0 else n


def _inputs(module, dims):
    """(the module's leaves, the model axis of the flat column form or
    None): in the heads form of a split mixer, the leaves ``dims`` names
    (leaf: its heads dim), which ``repro`` replicates, cut to this rank's
    heads."""
    p = dict(module.named_parameters())
    if module.tp is not None and module.heads:
        p.update({n: par.local_chunk(p[n], module.tp, d)
                  for n, d in dims.items()})
    return p, None if module.heads else module.tp


def _products(x, p, cols, tp, packed: bool) -> list:
    """x @ p[w] with all n columns for each (w, n) of ``cols``, x cast to
    the weight's dtype (the mLSTM's f32 gates take the f32 input): a flat
    column split's products gathered one by one (``layers.project``, with
    a gradient), or, ``packed`` (a decode step), in one all-gather a
    dtype (``layers.project_gathered``)."""
    ins = [x.to(p[w].dtype) for w, _ in cols]
    if not packed:
        return [project(xi, p[w], n, tp) for xi, (w, n) in zip(ins, cols)]
    return project_gathered([xi @ p[w] for xi, (w, _) in zip(ins, cols)],
                            [n for _, n in cols], tp)


def _own(module) -> slice:
    """The slice of a whole state's heads (dim 1) that this rank's step
    updates: its heads in the heads form of a split mixer, else all."""
    if module.tp is None or not module.heads:
        return slice(None)
    h = module.shape["n_heads"]
    return slice(module.tp.index * h, (module.tp.index + 1) * h)


def _whole(module, states) -> list:
    """The whole new states from each rank's slices (the heads form of a
    split mixer: one all-gather), else ``states`` as they are."""
    if module.tp is None or not module.heads:
        return list(states)
    return par.gather_heads(states, module.tp)


# ---------------------------------------------------------------------------
# Mamba-style SSM heads (alone in ``mamba_mlp``, beside attention in hymba)
# ---------------------------------------------------------------------------

def _ssm_qkva(p, x, n_heads: int, dk: int, dv: int, tp=None,
              packed: bool = False):
    """q, k (B, H, S, dk), v (B, H, S, dv) and log a (B, H, S) =
    log sigmoid(x w_decay + b_decay), the last in f32; ``tp``: the model
    axis of a flat column split, ``packed``: see ``_products``."""
    B, S, _ = x.shape
    q, k, v = (y.reshape(B, S, n_heads, -1).transpose(1, 2) for y in
               _products(x, p, (("wq", n_heads * dk), ("wk", n_heads * dk),
                                ("wv", n_heads * dv)), tp, packed))
    la = F.logsigmoid(x.float() @ p["w_decay"] + p["b_decay"])
    return q, k, v, la.transpose(1, 2)


def ssm_heads_train(p, x, *, n_heads: int, dk: int, dv: int = None,
                    chunk: int = 128, tp=None):
    """Full-sequence SSM heads of x (B, S, D) (value width ``dv``, D / H
    by default). Returns (out, final state). ``tp``: the model axis of a
    flat column split: the recurrence runs on the whole heads, and the
    rank's columns of o meet its columns of w_gate and rows of wo."""
    B, S, D = x.shape
    dv = dv or D // n_heads
    q, k, v, la = _ssm_qkva(p, x, n_heads, dk, dv, tp)
    o, state, _ = chunked_gla(q, k, v, la, chunk=chunk)
    o = par.local_chunk(o.transpose(1, 2).reshape(B, S, n_heads * dv), tp,
                        -1)
    gate = act_fn("silu")(x @ p["w_gate"])
    return (o * gate) @ p["wo"], state


def ssm_heads_step(p, x, state, *, n_heads: int, dk: int, dv: int = None,
                   tp=None):
    """One token: x (B, 1, D), state (B, H, dk, dv) (dv = D / H by
    default). Returns (out, state'). ``tp``: the model axis of a flat
    column split (see ``ssm_heads_train``)."""
    B, _, D = x.shape
    dv = dv or D // n_heads
    q, k, v, la = _ssm_qkva(p, x, n_heads, dk, dv, tp, packed=True)
    o, state, _ = gla_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], la[:, :, 0],
                           state)
    o = par.local_chunk(o.reshape(B, 1, n_heads * dv), tp, -1)
    gate = act_fn("silu")(x @ p["w_gate"])
    return (o * gate) @ p["wo"], state


class SSMHeads(nn.Module):
    """wq, wk (D, H dk), wv, w_gate (D, D), wo (D, D); w_decay (D, H) and
    b_decay (H,) in f32. With a model axis ``tp`` of size m that divides
    D: rank i's columns of wq / wk (where m divides H dk), wv and
    w_gate, and rows of wo; w_decay and b_decay stay whole (``repro``
    replicates them). Where m divides H that is heads [i H / m, ...),
    which the rank runs alone; else the flat column form. ``partial``:
    the whole leaves, whose gradient is the rank's part."""

    def __init__(self, d_model: int, n_heads: int, dk: int, dtype,
                 device=None, tp=None):
        super().__init__()
        m = _split_form(self, tp, d_model, n_heads)
        if m == 1 and tp is not None and tp.size > 1 \
                and (n_heads * dk) % tp.size == 0:
            raise NotImplementedError(
                f"a model axis of {tp.size} splits wq ({n_heads * dk} "
                f"columns) but not wo ({d_model} rows)")
        dv = d_model // n_heads
        run = n_heads // m if self.heads else n_heads
        self.shape = dict(n_heads=run, dk=dk, dv=dv)
        self.partial = ("w_decay", "b_decay") if m > 1 else ()
        if m > 1 and (n_heads * dk) % m:
            self.partial += ("wq", "wk")
        self.wq = empty_param((d_model, _cols(n_heads * dk, m)), dtype,
                              device)
        self.wk = empty_param((d_model, _cols(n_heads * dk, m)), dtype,
                              device)
        self.wv = empty_param((d_model, d_model // m), dtype, device)
        self.w_decay = empty_param((d_model, n_heads), torch.float32, device)
        self.b_decay = empty_param((n_heads,), torch.float32, device)
        self.w_gate = empty_param((d_model, d_model // m), dtype, device)
        self.wo = empty_param((d_model // m, d_model), dtype, device)

    def forward(self, x):
        p, tp = _inputs(self, {"w_decay": -1, "b_decay": -1})
        return ssm_heads_train(p, x, tp=tp, **self.shape)

    def step(self, x, state):
        """(out, the whole new state) of one token against the whole
        state (B, H, dk, dv)."""
        p, tp = _inputs(self, {"w_decay": -1, "b_decay": -1})
        out, new = ssm_heads_step(p, x, state[:, _own(self)], tp=tp,
                                  **self.shape)
        return out, _whole(self, [new])[0]


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunkwise parallel) and sLSTM (sequential)
# ---------------------------------------------------------------------------

def _mlstm_qkvifa(p, x, n_heads: int, dh: int, tp=None,
                  packed: bool = False):
    """q / sqrt(dh), k times the input gate sigmoid(x w_i), v, each (B, H,
    S, dh), and log a = log sigmoid(x w_f + b_f) (B, H, S) in f32;
    ``tp``: the model axis of a flat column split, ``packed``: see
    ``_products``."""
    B, S, _ = x.shape
    wq, wk, wv, wi, wf = _products(
        x, p, [(w, n_heads * dh) for w in ("wq", "wk", "wv")]
        + [(w, n_heads) for w in ("w_i", "w_f")], tp, packed)

    def heads(y):
        return y.reshape(B, S, n_heads, dh).transpose(1, 2)

    q = heads(wq) / (dh ** 0.5)
    k = heads(wk)
    v = heads(wv)
    i_gate = torch.sigmoid(wi).transpose(1, 2)
    la = F.logsigmoid(wf + p["b_f"]).transpose(1, 2)
    return q, k * i_gate[..., None].to(k.dtype), v, la


def mlstm_train(p, x, *, n_heads: int, dh: int = None, chunk: int = 128,
                tp=None):
    """Full-sequence mLSTM of x (B, S, D) (head width ``dh``, D / H by
    default). Returns (out, (state, norm)). ``tp``: the model axis of a
    flat column split (see ``ssm_heads_train``)."""
    B, S, D = x.shape
    dh = dh or D // n_heads
    q, k, v, la = _mlstm_qkvifa(p, x, n_heads, dh, tp)
    o, state, norm = chunked_gla(q, k, v, la, chunk=chunk, normalize=True)
    o = par.local_chunk(o.transpose(1, 2).reshape(B, S, n_heads * dh), tp,
                        -1)
    gate = act_fn("silu")(x @ p["w_gate"])
    return (o * gate) @ p["wo"], (state, norm)


def mlstm_step(p, x, state, norm, *, n_heads: int, dh: int = None,
               tp=None):
    """One token: x (B, 1, D), state (B, H, dh, dh), norm (B, H, dh) (dh =
    D / H by default). Returns (out, (state', norm')). ``tp``: the model
    axis of a flat column split."""
    B, _, D = x.shape
    dh = dh or D // n_heads
    q, k, v, la = _mlstm_qkvifa(p, x, n_heads, dh, tp, packed=True)
    o, state, norm = gla_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                              la[:, :, 0], state, norm, normalize=True)
    o = par.local_chunk(o.reshape(B, 1, n_heads * dh), tp, -1)
    gate = act_fn("silu")(x @ p["w_gate"])
    return (o * gate) @ p["wo"], (state, norm)


class MLSTM(nn.Module):
    """wq, wk, wv, w_gate, wo (D, D); w_i, w_f (D, H) and b_f (H,) in
    f32. With a model axis ``tp`` of size m that divides D: rank i's
    columns of wq / wk / wv / w_gate and rows of wo; where m divides H,
    its columns of w_i / w_f too, heads [i H / m, ...) that it runs alone,
    with its heads of the whole b_f; else the flat column form, w_i / w_f
    whole. ``partial``: the whole leaves."""

    def __init__(self, d_model: int, n_heads: int, dtype, device=None,
                 tp=None):
        super().__init__()
        m = _split_form(self, tp, d_model, n_heads)
        dh = d_model // n_heads
        self.shape = dict(n_heads=n_heads // m if self.heads else n_heads,
                          dh=dh)
        self.partial = ("b_f",) if m > 1 else ()
        if m > 1 and not self.heads:
            self.partial += ("w_i", "w_f")
        for name in ("wq", "wk", "wv"):
            setattr(self, name, empty_param((d_model, d_model // m), dtype,
                                            device))
        gates = _cols(n_heads, m)
        self.w_i = empty_param((d_model, gates), torch.float32, device)
        self.w_f = empty_param((d_model, gates), torch.float32, device)
        self.b_f = empty_param((n_heads,), torch.float32, device)
        self.w_gate = empty_param((d_model, d_model // m), dtype, device)
        self.wo = empty_param((d_model // m, d_model), dtype, device)

    def forward(self, x):
        p, tp = _inputs(self, {"b_f": -1})
        return mlstm_train(p, x, tp=tp, **self.shape)

    def step(self, x, state, norm):
        """(out, (state', norm')) whole, as ``SSMHeads.step``."""
        p, tp = _inputs(self, {"b_f": -1})
        own = _own(self)
        out, new = mlstm_step(p, x, state[:, own], norm[:, own], tp=tp,
                              **self.shape)
        return out, tuple(_whole(self, new))


def _slstm_pre(p, x, n_heads: int, dh: int, tp=None, packed: bool = False):
    """The input pre-activations of the four gates, f32, laid out (S, H,
    B, 4 dh) (gates z, i, f, o side by side), so that a step's recurrent
    products add to them in one ``baddbmm``; ``tp``: the model axis of a
    flat column split, ``packed``: see ``_products``."""
    B, S, _ = x.shape
    pre = [y.float().reshape(B, S, n_heads, dh) for y in _products(
        x, p, [(f"w_{g}", n_heads * dh) for g in _GATES], tp, packed)]
    return torch.cat(pre, dim=-1).permute(1, 2, 0, 3).contiguous()


def slstm_scan(pre, r, state):
    """The sLSTM's steps over pre (S, H, B, 4 dh) with the recurrent
    weights r (H, dh, 4 dh) (``r_z | r_i | r_f | r_o``) from state (c, n,
    h, m), each (H, B, dh) f32. Each step: the gates' pre-activations
    plus h r, z = tanh, the log-domain input and forget gates i, f with
    the stabiliser m' = max(f + m, i), c' = exp(f + m - m') c + exp(i -
    m') z, n' likewise with 1 for z, h' = sigmoid(o) c' / max(|n'|, 1).
    Returns (hs (S, H, B, dh), (c, n, h, m))."""
    c, n, h, m = state
    dh = c.shape[-1]
    hs = []
    for t in range(pre.shape[0]):
        g = torch.baddbmm(pre[t], h, r)
        zt = torch.tanh(g[..., :dh])
        it_ = g[..., dh:2 * dh]
        fm = g[..., 2 * dh:3 * dh] + m
        m = torch.maximum(fm, it_)
        i_s = torch.exp(it_ - m)
        f_s = torch.exp(fm - m)
        c = torch.addcmul(f_s * c, i_s, zt)
        n = torch.addcmul(i_s, f_s, n)
        h = torch.sigmoid(g[..., 3 * dh:]) * c / torch.clamp_min(
            torch.abs(n), 1.0)
        hs.append(h)
    return torch.stack(hs), (c, n, h, m)


def slstm_train(p, x, *, n_heads: int, dh: int = None, state0=None,
                tp=None, packed: bool = False):
    """The sLSTM over x (B, S, D), step by step (its memory mixing has no
    parallel form, xLSTM Sec. 2), from ``state0`` = (c, n, h, m), each
    (B, H, dh) f32, or zeros (head width ``dh``, D / H by default).
    Returns (out, (c, n, h, m)). ``tp``: the model axis of a flat column
    split: the steps run on the whole heads, and the rank's columns of h
    meet its rows of wo."""
    B, S, D = x.shape
    dh = dh or D // n_heads
    pre = _slstm_pre(p, x, n_heads, dh, tp, packed)
    r = torch.cat([p[f"r_{g}"].float() for g in _GATES], dim=-1)
    if state0 is None:
        state = tuple(pre.new_zeros((n_heads, B, dh)) for _ in range(4))
    else:
        state = tuple(s.float().transpose(0, 1) for s in state0)
    hs, state = slstm_scan(pre, r, state)
    out = par.local_chunk(hs.permute(2, 0, 1, 3).reshape(
        B, S, n_heads * dh), tp, -1)
    return out.to(x.dtype) @ p["wo"], tuple(s.transpose(0, 1)
                                            for s in state)


def slstm_step(p, x, state, *, n_heads: int, dh: int = None, tp=None):
    """One token: the train path at S = 1 (a flat column split's
    products gathered in one all-gather)."""
    return slstm_train(p, x, n_heads=n_heads, dh=dh, state0=state, tp=tp,
                       packed=True)


class SLSTM(nn.Module):
    """w_z, w_i, w_f, w_o, wo (D, D); r_z, r_i, r_f, r_o (H, dh, dh) in
    f32 (block-diagonal recurrent weights, one block a head). With a
    model axis ``tp`` of size m that divides D: rank i's columns of the
    w_* and rows of wo, the r_* whole (``repro`` replicates them, and
    ``partial`` names them); where m divides H, heads [i H / m, ...),
    which the rank runs alone with its blocks of r_*; else the flat
    column form."""

    def __init__(self, d_model: int, n_heads: int, dtype, device=None,
                 tp=None):
        super().__init__()
        m = _split_form(self, tp, d_model, n_heads)
        dh = d_model // n_heads
        self.shape = dict(n_heads=n_heads // m if self.heads else n_heads,
                          dh=dh)
        self.partial = tuple(f"r_{g}" for g in _GATES) if m > 1 else ()
        self.wo = empty_param((d_model // m, d_model), dtype, device)
        for g in _GATES:
            setattr(self, f"w_{g}", empty_param((d_model, d_model // m),
                                                dtype, device))
            setattr(self, f"r_{g}", empty_param((n_heads, dh, dh),
                                                torch.float32, device))

    def forward(self, x):
        p, tp = _inputs(self, {f"r_{g}": 0 for g in _GATES})
        return slstm_train(p, x, tp=tp, **self.shape)

    def step(self, x, state):
        """(out, (c, n, h, m)) whole, as ``SSMHeads.step``."""
        p, tp = _inputs(self, {f"r_{g}": 0 for g in _GATES})
        own = _own(self)
        out, new = slstm_step(p, x, tuple(s[:, own] for s in state), tp=tp,
                              **self.shape)
        return out, tuple(_whole(self, new))
