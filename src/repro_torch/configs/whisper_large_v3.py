"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB
[arXiv:2212.04356; unverified].

32L (enc) + 32L (dec) d_model=1280 20H d_ff=5120 vocab=51866;
encoder length 1500 frames. repro's input_specs provides post-conv frame
embeddings (B, 1500, d_model). Decoder is full attention ->
long_500k skipped; decode shapes exercise the decoder self-attn cache at
the stated lengths (real Whisper caps at 448 positions — kept as
in repro, DESIGN.md).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866, rope_theta=0.0,
    pos_embed="sinusoidal", mlp_type="mlp2", act="gelu",
    tie_embeddings=True,
    block_pattern=("attn_mlp",),
    encoder_layers=32, encoder_seq=1500, frontend="audio_stub",
    skip_shapes=("long_500k",),
    source="arXiv:2212.04356; unverified",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="whisper-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, encoder_layers=2,
    encoder_seq=30)
