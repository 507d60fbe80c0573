"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
Pure full attention -> long_500k skipped (DESIGN.md §Arch-applicability).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000,
    block_pattern=("attn_mlp",),
    skip_shapes=("long_500k",),
    source="arXiv:2401.02385; hf",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="tinyllama-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256)
