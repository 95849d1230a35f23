"""mamba2-2.7b [ssm] — 64L d_model=2560 attn-free vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from . import ArchConfig
from ..models.mamba2 import SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,                 # d_inner / headdim = 5120 / 64
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,                     # attention-free, no FFN blocks
    vocab=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256, conv_width=4),
    source="arXiv:2405.21060; unverified",
)
