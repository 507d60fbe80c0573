"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
Pure full attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    block_pattern=("attn_mlp",),
    skip_shapes=("long_500k",),
    source="arXiv:2407.21783; unverified",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="llama3-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256)
