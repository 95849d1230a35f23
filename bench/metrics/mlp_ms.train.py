"""mlp_ms.train: device ms a step inside the program's ``layer.mlp``
spans (``models/lm.py``: each MLP block with its residual; forward,
remat's re-forward and backward).  The backward span of a group's last
block holds the whole group's re-forward, which is left out
(``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.ms_a_step(ctx, ("layer.mlp",))
