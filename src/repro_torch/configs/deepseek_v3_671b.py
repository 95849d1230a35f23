"""deepseek-v3-671b [moe] — 61L d_model=7168 128H (MLA) d_ff=2048(expert)
vocab=129280, MoE 1 shared + 256 routed top-8, MTP. [arXiv:2412.19437; hf]

Interpretation notes (DESIGN.md §6): group-limited routing simplified to
plain top-8 over sigmoid scores with the aux-loss-free learned bias; first
3 layers dense (d_ff 18432); MLA dims per the paper (q_lora 1536, kv_lora
512, nope 128, rope 64, v 128); one MTP head (depth-1).
"""
from . import ArchConfig, MLAConfig
from ..models.moe import MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,             # MLA: kv expanded per-head from the latent
    head_dim=128,
    d_ff=18432,                 # dense layers 0..2
    vocab=129280,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  router="sigmoid_bias"),
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_dim=128),
    n_dense_layers=3,
    mtp=True,
    zero_inference=False,   # 2-D expert sharding serves without weight gathers
    source="arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3",
)
