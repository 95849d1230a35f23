"""recompute_ms.train: device ms a step of remat's re-forward: the
program's ``lm.layer`` spans (one layer's group of blocks under
``checkpoint``) in phase ``recompute``, which end where checkpoint's
early stop ends them."""

from bench import spans


def read(ctx):
    return spans.ms_a_step(ctx, ("lm.layer",), ("recompute",))
