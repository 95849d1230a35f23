"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

Interpretation (DESIGN.md §4): one weight-tied ("shared") attention+concat
block applied every 6th position, seeing concat(hidden, embedding); per-use
LoRA deltas omitted. 81 layers = 13 groups of (5 mamba + 1 shared attn) + 3
trailing mamba blocks. Linear state ⇒ long_500k runs.
"""
from . import ArchConfig
from ..models.mamba2 import SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, chunk=256, conv_width=4),
    hybrid_attn_every=6,
    source="arXiv:2411.15242; unverified",
)
