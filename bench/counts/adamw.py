"""One AdamW step over n parameters with float32 master weights and
moments: the gradient, master, m and v read once, and master, m, v and
the trained parameter written once.  30 bytes a parameter with a float32
gradient and a bf16 parameter (28 where the gradient is bf16)."""


def cost(n_params: int, grad_bytes: int = 4,
         param_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes); the few operations a parameter are not what
    bounds it and count as none."""
    return 0.0, float(n_params * (grad_bytes + 3 * 4 + 3 * 4 + param_bytes))
