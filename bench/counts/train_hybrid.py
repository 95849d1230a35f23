"""Zamba2's operations in one training step, for a utilisation, by
``train_model``'s rules (recompute not counted):

- 6 operations a token for each parameter used as a product: every
  Mamba layer's projections and conv, and each shared block's
  attention, MLP, the invocation's adapter and linear at each
  invocation (a shared weight counts as often as it is used); the tied
  head once;
- causal attention: 12·d per visible (query, key) pair, query head and
  invocation, at the attention's head dim d;
- the SSD scan: 12·P·N per token, head and Mamba layer.
"""

from . import flash_fwd


def mamba_params(cfg: dict) -> int:
    """Product parameters of one Mamba-2 layer."""
    d, s = cfg["d_model"], cfg["ssm"]
    din = s["expand"] * d
    h = din // s["headdim"]
    gn = s["n_groups"] * s["d_state"]
    return (d * 2 * din + d * 2 * gn + d * h
            + s["conv_width"] * (din + 2 * gn) + din * d)


def invocation_params(cfg: dict) -> int:
    """Product parameters one invocation uses: the shared block's q, k,
    v over 2·d and its output, the MLP's gate, up and down, the
    invocation's adapter (d to r, r to gate|up) and linear."""
    d, H, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    ff, r = cfg["d_ff"], cfg["adapter_rank"]
    attn = 2 * d * hd * (H + 2 * kv) + H * hd * d
    return attn + 3 * d * ff + r * (d + 2 * ff) + d * d


def product_params(cfg: dict) -> int:
    """Parameters used as products in a token's forward, a shared weight
    once per invocation."""
    vocab = -(-cfg["vocab"] // 128) * 128
    return (cfg["n_layers"] * mamba_params(cfg)
            + len(cfg["hybrid_layer_ids"]) * invocation_params(cfg)
            + vocab * cfg["d_model"])


def step_flops(cfg: dict, workload: dict) -> float:
    """Operations of one step of ``workload`` (global batch × seq)."""
    b, s = workload["global_batch"], workload["seq"]
    sc = cfg["ssm"]
    h = sc["expand"] * cfg["d_model"] // sc["headdim"]
    flops = 6.0 * product_params(cfg) * b * s
    flops += 12.0 * cfg["head_dim"] * flash_fwd.pairs(s, s) \
        * cfg["n_heads"] * len(cfg["hybrid_layer_ids"]) * b
    flops += 12.0 * sc["headdim"] * sc["d_state"] * h * cfg["n_layers"] \
        * b * s
    return flops
