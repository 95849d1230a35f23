"""ssd_ms.train: device ms a step inside the program's ``layer.scan``
spans (``models/mamba2.py``: the chunked SSD scan with its log-decays):
its forward, remat's re-forward and its backward, the scan's whole
cost."""

from bench import spans


def read(ctx):
    return spans.ms_a_step(ctx, ("layer.scan",))
