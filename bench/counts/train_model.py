"""The model's operations in one training step, for a utilisation: the
forward and backward the model needs, recompute not counted.

- 6 operations a token for each parameter used as a product (2 forward,
  4 backward); the tied embedding counts once, as the head's product,
  and its lookup counts nothing; gains, biases and per-head scalars are
  no products.
- causal attention: 12·d per visible (query, key) pair, query head and
  layer (QKᵀ and P·V forward, 2·2·d, and their gradients, 4·2·d).
- the SSD scan: 12·P·N per token, head and layer, what its recurrence
  needs (the state update and the output's read of it, 2·P·N each
  forward, twice that backward).
"""

from . import flash_fwd


def product_params(cfg: dict) -> int:
    """Parameters used as products in a token's forward."""
    d, n = cfg["d_model"], cfg["n_layers"]
    vocab = -(-cfg["vocab"] // 128) * 128
    if cfg["family"] == "ssm":
        s = cfg["ssm"]
        din = s["expand"] * d
        h = din // s["headdim"]
        gn = s["n_groups"] * s["d_state"]
        layer = d * 2 * din + d * 2 * gn + d * h + s["conv_width"] * (
            din + 2 * gn) + din * d
    else:
        h, kv, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], \
            cfg["head_dim"], cfg["d_ff"]
        layer = d * hd * (2 * h + 2 * kv) + 3 * d * ff
    return n * layer + vocab * d


def step_flops(cfg: dict, workload: dict) -> float:
    """Operations of one step of ``workload`` (global batch × seq)."""
    b, s = workload["global_batch"], workload["seq"]
    flops = 6.0 * product_params(cfg) * b * s
    n = cfg["n_layers"]
    if cfg["family"] == "ssm":
        sc = cfg["ssm"]
        h = sc["expand"] * cfg["d_model"] // sc["headdim"]
        flops += 12.0 * sc["headdim"] * sc["d_state"] * h * n * b * s
    else:
        flops += 12.0 * cfg["head_dim"] * flash_fwd.pairs(s, s) \
            * cfg["n_heads"] * n * b
    return flops
