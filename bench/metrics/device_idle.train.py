"""device_idle.train: the share of the traced window (the plain pass,
which records the device alone) in which no operation ran on the device,
in %."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
