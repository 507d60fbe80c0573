"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert vocab=32000,
window=4096 (SWA bounds the KV cache) -> long_500k RUNS.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, window=4096,
    block_pattern=("moe",), n_experts=8, top_k=2,
    source="arXiv:2401.04088; hf",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab_size=256, window=32, n_experts=4,
    top_k=2)
