"""Architecture + shape configuration (the port of
``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig``; every workload shape is a
``ShapeConfig``. The fields are ``repro``'s; ``torch_dtype`` takes the
place of ``jnp_dtype``. ``repro``'s ``input_specs`` (ShapeDtypeStruct
stand-ins for the TPU dry-run) and its analytical parameter counts
(``param_count``, ``active_param_count``) are not ported: nothing in the
port calls them yet.
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

