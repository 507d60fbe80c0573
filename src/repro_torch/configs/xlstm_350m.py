"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks
[arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (xLSTM blocks carry their own projections;
no separate MLP) vocab=50304. Recurrent -> long_500k RUNS (O(1) state).
Pattern period 2: [mlstm, slstm] x 12.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, rope_theta=0.0, pos_embed="none",
    block_pattern=("mlstm", "slstm"),
    source="arXiv:2405.04517; unverified",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, vocab_size=256)
