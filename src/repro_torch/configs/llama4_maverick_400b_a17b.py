"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Interpretation notes (DESIGN.md §4): iRoPE — 3 of every 4 layers use
chunked-local attention (window 8192) with RoPE, every 4th layer is global
NoPE; MoE interleaved on every 2nd layer (HF ``interleave_moe_layer_step=2``)
with one shared expert; dense layers use ``intermediate_size_mlp=16384``.
The chunked-local window makes the arch legitimately sub-quadratic, so the
long_500k cell runs.
"""
from . import ArchConfig
from ..models.moe import MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,                 # interleaved dense layers (HF int_size_mlp)
    vocab=202048,
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
    moe_every=2,
    local_window=8192,
    local_period=4,
    zero_inference=False,   # 2-D expert sharding serves without weight gathers
    source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick scaled); unverified",
)
