"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

Interpretation (DESIGN.md §4): one weight-tied ("shared") attention+concat
block applied every 6th position, seeing concat(hidden, embedding); per-use
LoRA deltas omitted. 81 layers = 13 groups of (5 mamba + 1 shared attn) + 3
trailing mamba blocks. Linear state ⇒ long_500k runs.

It is the JAX package's shape of the model, kept for parity with it, and
departs from the published Zamba2-7B (``Zamba2ForCausalLM``,
huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json):

- 32 heads of 112 over d, where the published block has 32 of 224 over
  2·d, scaled by (224/2)^-1/2 rather than 224^-1/2;
- one shared block, where the published model alternates two;
- no per-invocation adapters and no per-invocation linear;
- a learned ``w_concat`` from 2·d to d ahead of the block, where the
  published block reads the concatenation itself;
- residual adds after the attention and the MLP, where the published
  block has none and adds its output into the next Mamba layer's input;
- tanh GELU (``geglu``), where the published MLP's GELU is exact;
- B and C in one group, where the published layer has two;
- norms at eps 1e-6, where the published ones take 1e-5.

The published model runs on the same path as a ``PublishedHybridConfig``
(``hybrid_layer_ids``, ``n_mem_blocks``, ``adapter_rank``, ``norm_eps``,
with ``act="geglu_erf"`` and ``SSMConfig.n_groups``): ``models/lm.py``
and the benchmark's ``bench/configs/zamba2-7b-27L.json``.
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
