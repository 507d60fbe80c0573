"""Architecture + shape configuration (the port of
``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig``; every workload shape is a
``ShapeConfig``. The fields are ``repro``'s; ``torch_dtype`` takes the
place of ``jnp_dtype``. ``input_specs(arch, shape)`` yields meta-device
stand-ins for every model input of a workload (no allocation), which the
dry run (``repro_torch.launch.dryrun``) runs against; ``param_count`` and
``active_param_count`` are ``repro``'s analytical counts, formulas and
approximations as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # per-layer block pattern, cycled over the depth. Entries:
    #   attn_mlp | swa_mlp | moe | mamba_mlp | mlstm | slstm | hybrid
    block_pattern: Tuple[str, ...] = ("attn_mlp",)
    qkv_bias: bool = False
    window: int = 0                # sliding-window size for swa blocks
    rope_theta: float = 10000.0
    pos_embed: str = "rope"        # rope | sinusoidal | none
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 0             # key dim of the linear-recurrence heads
    ssm_heads: int = 0             # 0 -> n_heads
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed source length (whisper: 1500)
    # modality frontend stubs
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_patches: int = 0             # vision stub: patches prepended to text
    meta_tokens: int = 0           # hymba: learnable prefix tokens
    norm: str = "rmsnorm"
    act: str = "silu"
    mlp_type: str = "swiglu"       # swiglu | mlp2
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which shapes this arch must SKIP (sub-quadratic requirement etc.)
    skip_shapes: Tuple[str, ...] = ()
    source: str = ""               # provenance of the hyperparameters

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def block_at(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    # repro's analytical counts, kept as they are: a gated 3 D F MLP for
    # every arch (whisper's 2 D F "mlp2" included) and an approximate
    # xLSTM cell; ``lm.param_count`` counts the leaves.
    def param_count(self) -> int:
        """Analytical parameter count (embeddings included)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        Hd = self.head_dim_
        qkv = D * (self.n_heads * Hd) + 2 * D * (self.n_kv_heads * Hd) \
            + (self.n_heads * Hd) * D
        mlp = 3 * D * F                          # gate/up/down (SwiGLU)
        total = 0
        for layer in range(self.n_layers):
            blk = self.block_at(layer)
            if blk in ("attn_mlp", "swa_mlp"):
                total += qkv + mlp
            elif blk == "moe":
                total += qkv + self.n_experts * 3 * D * F + D * self.n_experts
            elif blk == "mamba_mlp":
                total += self._ssm_params() + mlp
            elif blk == "hybrid":
                total += qkv + self._ssm_params() + mlp
            elif blk in ("mlstm", "slstm"):
                total += self._xlstm_params(blk)
            total += 2 * D                       # two norms
        total += V * D                           # embed
        if not self.tie_embeddings:
            total += D * V                       # unembed
        if self.is_encdec:
            enc = self.encoder_layers * (qkv + mlp + 2 * D)
            cross = self.n_layers * (qkv + D)    # cross-attn per dec layer
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * D * F
        n_moe_layers = sum(1 for layer in range(self.n_layers)
                           if self.block_at(layer) == "moe")
        return self.param_count() - n_moe_layers * inactive

    def _ssm_params(self) -> int:
        H = self.ssm_heads or self.n_heads
        dk = self.ssm_state
        dv = self.d_model // H
        D = self.d_model
        return D * H * (2 * dk + 2 * dv) + H * dv * D   # q,k,v,gate + out

    def _xlstm_params(self, kind: str) -> int:
        D = self.d_model
        if kind == "mlstm":
            up = 2 * D
            return D * up * 2 + up * D + 4 * up * up // 4
        return 4 * D * D + 4 * D * D // 4               # slstm approx


# ---------------------------------------------------------------------------
# Shape configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, object]:
    """Stand-ins for every model input of this workload, ``repro``'s
    shapes and dtypes, zeros on ``device`` (on the meta device nothing is
    allocated):

    train:   {tokens, targets [, frames | patches]}
    prefill: {tokens [, frames | patches]}
    decode:  {tokens (B, 1), cache, pos (a 0-dim int32) [, frames]}

    The decode cache is the port's layout, ``lm.init_cache``'s {entry:
    one tensor a layer}, where ``repro`` stacks each slot's layers.
    """
    from repro_torch.core.types import resolve_device
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = arch.torch_dtype

    def zeros(dims, dtype):
        return torch.zeros(dims, dtype=dtype, device=dev)

    extras: Dict[str, object] = {}
    text_len = S
    if arch.frontend == "vision_stub" and shape.kind != "decode":
        n_patch = min(arch.n_patches, S // 4)
        text_len = S - n_patch
        extras["patches"] = zeros((B, n_patch, arch.d_model), dt)
    if arch.frontend == "audio_stub":
        extras["frames"] = zeros((B, arch.encoder_seq, arch.d_model), dt)

    if shape.kind == "train":
        return {"tokens": zeros((B, text_len), i32),
                "targets": zeros((B, text_len), i32), **extras}
    if shape.kind == "prefill":
        return {"tokens": zeros((B, text_len), i32), **extras}
    # decode: one new token against a cache of length S.
    from repro_torch.models import lm as lm_lib     # deferred, avoids cycle
    out = {"tokens": zeros((B, 1), i32),
           "cache": lm_lib.init_cache(arch, B, S, device=dev),
           "pos": zeros((), i32)}
    if arch.frontend == "audio_stub":
        # cross-attention reads the (stub) encoder output each step.
        out["frames"] = extras["frames"]
    return out
