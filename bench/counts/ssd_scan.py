"""The chunked SSD scan's operations, one call on (b, L, h, P, N) with
chunks of Q and B, C in G groups: per row and chunk, C·Bᵀ over the
chunk's causal pairs once a group, and per head the intra-chunk
product over the causal pairs (P a pair), the chunk's state (P·N a
position) and the output's read of the state carried in (P·N a
position), two operations a multiply-add.  The state passing between
chunks is P·N additions a chunk and counts as none.  The backward is
twice the forward: each product's gradient is two products of its size.
"""


def cost(b: int, L: int, h: int, P: int, N: int, Q: int,
         G: int = 1) -> tuple[float, float]:
    """(forward, backward) operations of one call."""
    pairs = Q * (Q + 1) // 2
    per_chunk = G * pairs * N + h * (pairs * P + 2 * Q * P * N)
    fwd = 2.0 * b * (L // Q) * per_chunk
    return fwd, 2.0 * fwd
