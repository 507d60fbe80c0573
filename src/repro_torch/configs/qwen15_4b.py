"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-4B; hf].

40L d_model=2560 20H (GQA kv=20, i.e. MHA) d_ff=6912 vocab=151936.
Pure full attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936, qkv_bias=True,
    block_pattern=("attn_mlp",),
    skip_shapes=("long_500k",),
    source="hf:Qwen/Qwen1.5-4B; hf",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="qwen-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256)
