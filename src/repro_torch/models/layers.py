"""Dense model layers (the port of ``repro/models/layers.py``): RMSNorm,
rotary embeddings, GQA attention (full / sliding-window, the full-sequence
path through ``flash_attention`` and the cached single-token decode path)
and the SwiGLU / 2-matrix MLP.

The arithmetic lives in plain functions that take tensors, as ``repro``'s
do; ``RMSNorm``, ``Attention`` and ``MLP`` hold the parameters under
``repro``'s names and call them. Matmuls run in the config dtype (bf16);
norms, rotary embeddings and attention compute in f32 and cast back, at
the same points as ``repro``. Not ported: ``maybe_shard`` (no device mesh
yet), the MoE block and the perf flags (``DECODE_GROUPED_GQA`` stays at
its default, the repeat of the cache's heads).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention


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

def project_qkv(p, x, n_heads, n_kv_heads, head_dim):
    """q (B, H, S, Dh), k and v (B, Hkv, S, Dh) from x (B, S, D); ``p``
    maps wq/wk/wv (and bq/bk/bv with a QKV bias) to tensors."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if p.get("bq") is not None:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(B, S, n_kv_heads, head_dim).transpose(1, 2)
    return q, k, v


def attention_train(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                    window: int = 0, causal: bool = True, positions=None):
    """Full-sequence attention (training / prefill) through
    ``flash_attention``. Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope_theta > 0:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    return o @ p["wo"], (k, v)


def attention_decode(p, x, cache_k, cache_v, pos: int, *, n_heads,
                     n_kv_heads, head_dim, rope_theta, window: int = 0):
    """Single-token decode against a KV cache, plain PyTorch (``repro``
    computes it outside any kernel too).

    x: (B, 1, D); cache_k/v: (B, Hkv, S, Dh); pos: the position of the new
    token. Its k/v are written IN PLACE at slot min(pos, S - 1), or
    pos % S for a sliding-window ring cache, where ``repro`` returns a
    new cache. Returns (out, cache_k, cache_v).
    """
    B = x.shape[0]
    S = cache_k.shape[2]
    q, k, v = project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope_theta > 0:
        posv = torch.full((1,), pos, device=x.device)   # no host copy
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    slot = pos % S if window > 0 else min(pos, S - 1)
    cache_k[:, :, slot] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, slot] = v[:, :, 0].to(cache_v.dtype)

    group = n_heads // n_kv_heads
    kpos = torch.arange(S, device=x.device)
    valid = kpos <= pos
    if window > 0 and pos >= S:       # ring cache: all slots live once full
        valid = torch.ones_like(valid)
    qf = q.float()
    kf = torch.repeat_interleave(cache_k.float(), group, dim=1)
    vf = torch.repeat_interleave(cache_v.float(), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / (head_dim ** 0.5)
    scores = torch.where(valid[None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(x.dtype)
    o = o.transpose(1, 2).reshape(B, 1, n_heads * head_dim)
    return o @ p["wo"], cache_k, cache_v


class Attention(nn.Module):
    """GQA attention weights: wq (D, H Dh), wk/wv (D, Hkv Dh), wo
    (H Dh, D), and bq/bk/bv with a QKV bias."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool, rope_theta: float, dtype,
                 device=None):
        super().__init__()
        self.shape = dict(n_heads=n_heads, n_kv_heads=n_kv_heads,
                          head_dim=head_dim, rope_theta=rope_theta)
        self.wq = empty_param((d_model, n_heads * head_dim), dtype, device)
        self.wk = empty_param((d_model, n_kv_heads * head_dim), dtype, device)
        self.wv = empty_param((d_model, n_kv_heads * head_dim), dtype, device)
        self.wo = empty_param((n_heads * head_dim, d_model), dtype, device)
        if qkv_bias:
            self.bq = empty_param((n_heads * head_dim,), dtype, device)
            self.bk = empty_param((n_kv_heads * head_dim,), dtype, device)
            self.bv = empty_param((n_kv_heads * head_dim,), dtype, device)

    def params(self):
        return dict(self.named_parameters())

    def forward(self, x):
        return attention_train(self.params(), x, **self.shape)

    def decode(self, x, cache_k, cache_v, pos: int):
        return attention_decode(self.params(), x, cache_k, cache_v, pos,
                                **self.shape)


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
    def __init__(self, d_model: int, d_ff: int, dtype, device=None,
                 mlp_type: str = "swiglu", act: str = "silu"):
        super().__init__()
        self.act = act
        if mlp_type == "swiglu":
            self.w_gate = empty_param((d_model, d_ff), dtype, device)
        self.w_up = empty_param((d_model, d_ff), dtype, device)
        self.w_down = empty_param((d_ff, d_model), dtype, device)

    def forward(self, x):
        return mlp(dict(self.named_parameters()), x, self.act)
