"""Threefry-2x32 counter-based RNG that reproduces ``jax.random``'s bits
(threefry2x32 implementation, ``jax_threefry_partitionable=True``, the
jax 0.9 default).

The SA solvers' whole correctness story rests on the block draws:
SA and classical solvers, and a resumed solve, must sample the same
coordinate blocks from ``fold_in(key(seed), h)``. Matching JAX's stream
bit for bit lets the port's trajectories be held to ``repro``'s.

uint32 arithmetic is done in int64 tensors with masks, batched over a
leading axis of keys (the s draws of a group), on the keys' device.

JAX draws at the width of its default dtypes: 32 bits normally, 64 bits
under ``jax_enable_x64``. The port takes the width from the solve's
dtype (``bits_for``), so an f64 solve draws what JAX draws with x64 on
and an f32 solve what it draws with x64 off.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def bits_for(dtype) -> int:
    """JAX's sampling width for a solve of ``dtype``."""
    return 64 if dtype == torch.float64 else 32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key pair (k1, k2); all int64 tensors holding uint32 values,
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, bits: int = 32, device="cpu"):
    """``jax.random.key(seed)`` as its (2,) key data. At 64 bits the
    seed's high and low words; at 32 bits JAX holds the seed as an int32,
    so the high word is 0 and the low word is the seed mod 2^32."""
    seed = int(seed)
    hi = (seed >> 32) & _MASK if bits == 64 else 0
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: key (..., 2) and data (int or int64 tensor
    of ids) -> keys (broadcast shape, 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & _MASK)
    return torch.stack([o1, o2], dim=-1)


def split(key, num: int = 2):
    """``jax.random.split`` (partitionable form): key (..., 2) ->
    (..., num, 2)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(counts), counts)
    return torch.stack([o1, o2], dim=-1)


def _bit_pairs(keys, n: int):
    """The two threefry output words for counters 0..n-1 under each key:
    keys (B, 2) -> two (B, n) int64 tensors."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[:, 0, None], keys[:, 1, None],
                        torch.zeros_like(counts), counts)


def _mantissas(keys, n: int, bits: int):
    """The mantissa bits ``jax.random.uniform`` keeps: (B, n) int64 in
    [0, 2^23) at 32 bits, [0, 2^52) at 64 bits. uniform = mant * 2^-nmant
    exactly, so ordering on these integers is ordering on the floats."""
    o1, o2 = _bit_pairs(keys, n)
    if bits == 32:
        return (o1 ^ o2) >> 9
    return (o1 << 20) | (o2 >> 12)


def uniform(keys, n: int, bits: int = 32):
    """``jax.random.uniform(key, (n,))`` for each key: keys (B, 2) ->
    (B, n) in [0, 1), float32 at 32 bits and float64 at 64 bits."""
    mant = _mantissas(keys, n, bits)
    if bits == 32:
        return mant.to(torch.float32) * 2.0 ** -23
    return mant.to(torch.float64) * 2.0 ** -52


def randint(keys, minval: int, maxval: int, bits: int = 32):
    """``jax.random.randint(key, (), minval, maxval)`` for each key:
    keys (B, 2) -> (B,) int64 (JAX's modulus form over two draws)."""
    span = max(int(maxval) - int(minval), 1)
    if span >= 2 ** 31:
        raise ValueError(f"randint span {span} exceeds the supported 2^31")
    sub = split(keys)                                  # (B, 2, 2)

    def draw_mod(k):
        o1, o2 = _bit_pairs(k, 1)
        if bits == 32:
            return ((o1 ^ o2) % span)[:, 0]
        return (((o1 % span) * ((1 << 32) % span) + o2 % span) % span)[:, 0]

    higher, lower = draw_mod(sub[:, 0]), draw_mod(sub[:, 1])
    multiplier = (2 ** (bits // 2)) % span
    multiplier = (multiplier * multiplier) % span
    return int(minval) + (higher * multiplier + lower) % span
