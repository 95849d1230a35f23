"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The ViT frontend is a STUB per the task block: ``input_specs()`` supplies
precomputed patch embeddings (n_img_tokens × d_model) merged at the head of
the token sequence. head_dim=128 (nemo: 32×128=4096, o-proj 4096→5120).
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    n_img_tokens=256,           # one 1024px image at patch 16, pooled 4x
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
