"""granite-moe-1b-a400m [moe] — 32 experts top-8, fine-grained d_ff=512
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155.
Pure full attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    block_pattern=("moe",), n_experts=32, top_k=8,
    skip_shapes=("long_500k",),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=32, vocab_size=256, n_experts=4, top_k=2)
