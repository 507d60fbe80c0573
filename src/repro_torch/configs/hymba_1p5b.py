"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every layer,
meta tokens, SWA [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Adaptations (DESIGN.md): all layers use sliding-window attention
(window=1024; the released model interleaves 3 global layers — dropped to
keep the stack scan-homogeneous); SSM heads are the chunked scalar-decay
linear recurrence (Mamba-2/SSD form). Sub-quadratic -> long_500k RUNS.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    block_pattern=("hybrid",), window=1024,
    ssm_state=16, ssm_heads=25, meta_tokens=128,
    source="arXiv:2411.13676; hf",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="hymba-smoke", n_layers=2, d_model=100, n_heads=5,
    n_kv_heads=5, d_ff=128, vocab_size=256, window=32, ssm_state=4,
    ssm_heads=5, meta_tokens=4)
