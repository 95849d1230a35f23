"""train_mfu: the model's operations in the traced steps (recompute not
counted, ``bench/counts/train_model.py``) over the traced window's
seconds (the plain pass, which records the device alone) times the
card's bf16 peak, in %."""

from bench.counts import train_model


def read(ctx):
    if not ctx.peaks or ctx.trace.window_s <= 0:
        return None
    flops = train_model.step_flops(ctx.model, ctx.workload) * ctx.trace.steps
    return 100.0 * flops / (ctx.trace.window_s * ctx.peaks["bf16_flops"])
