"""attention_ms.train: device ms a step inside the program's
``layer.attention`` spans (``models/lm.py``: each attention block with
its residual; forward, remat's re-forward and backward), remat's
re-forward of later blocks left out (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.ms_a_step(ctx, ("layer.attention",))
