"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256 (16×256=4096 > d_model; o-proj
4096→3072), embeddings scaled by sqrt(d_model). [arXiv:2403.08295; hf]
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    emb_scale=True,
    rope_theta=10000.0,
    source="arXiv:2403.08295; hf:google/gemma-7b",
)
