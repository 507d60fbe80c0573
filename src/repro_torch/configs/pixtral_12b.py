"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The vision
frontend is a STUB: repro's input_specs provides precomputed patch embeddings
(B, n_patches, d_model) prepended to the text embeddings.
Pure full attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1e6,
    block_pattern=("attn_mlp",),
    frontend="vision_stub", n_patches=1024,
    skip_shapes=("long_500k",),
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="pixtral-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, n_patches=8)
