"""ssd_fwd_ms.train: device milliseconds a step of the kernels inside
the SSD scan's forward (``repro_torch.models.mamba2._ssd``), which runs
in the forward and again in remat's re-forward; its backward runs in
autograd's engine, outside the range."""

RANGES = {"ssd": "repro_torch.models.mamba2:_ssd"}


def read(ctx):
    ks = ctx.trace.in_range("ssd")
    if not ks or ctx.trace.steps <= 0:
        return None
    return sum(k.us for k in ks) / 1e3 / ctx.trace.steps
