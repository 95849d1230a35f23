"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865 —
enc-dec, conv frontend stubbed. [arXiv:2212.04356; unverified]

The conv1d+GELU frontend is a STUB per the task block: ``input_specs()``
supplies precomputed frame embeddings (1500 × d_model). Real Whisper caps
target length at 448; the 32k decode cells are mechanical stress shapes
(noted in DESIGN.md §4). GELU MLP + LayerNorm + learned/sinusoidal
positions; no RoPE (use_rope handled by the bidir/causal kinds).
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    encdec=True,
    n_enc_layers=12,
    enc_len=1500,
    source="arXiv:2212.04356; unverified",
)
