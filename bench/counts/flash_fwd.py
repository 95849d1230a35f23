"""Causal attention's forward: 4·d operations per visible (query, key)
pair and query head (S = QKᵀ and P·V, two each), and each of q, k, v
and the output moved once."""


def pairs(sq: int, skv: int) -> int:
    """Visible pairs of a causal mask whose last query sees every key."""
    off = skv - sq
    return sum(min(skv, off + i + 1) for i in range(sq)) if off else \
        sq * (sq + 1) // 2


def cost(batch: int, heads: int, sq: int, skv: int, head_dim: int,
         elem_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one call on (batch, heads, sq, head_dim)
    queries against skv keys."""
    ops = 4.0 * head_dim * pairs(sq, skv) * batch * heads
    moved = elem_bytes * batch * heads * head_dim * (2 * sq + 2 * skv)
    return ops, float(moved)
