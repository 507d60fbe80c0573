"""Plain PyTorch version of blocked causal / sliding-window GQA
attention (``repro/kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """Reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA).
    window > 0 enables sliding-window masking (Mistral-style): query i may
    attend keys j with  i - window < j <= i  (positions aligned at the
    sequence end: query i corresponds to absolute position
    i + (Sk - Sq), e.g. decode with a long KV cache).
    Computation in f32 regardless of input dtype; output cast back.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    qf = q.float()
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)

    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)
