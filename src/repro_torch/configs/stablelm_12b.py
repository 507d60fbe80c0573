"""stablelm-12b [dense] — [hf:stabilityai/stablelm-2-12b; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
Pure full attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    block_pattern=("attn_mlp",),
    skip_shapes=("long_500k",),
    source="hf:stabilityai/stablelm-2-12b; hf",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="stablelm-smoke", n_layers=2, d_model=80, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, head_dim=20)
