"""hybrid_mfu.train: Zamba2's operations in the traced steps (recompute
not counted, ``bench/counts/train_hybrid.py``) over the traced window's
seconds (the plain pass, which records the device alone) times the
card's bf16 peak, in %."""

from bench.counts import train_hybrid


def read(ctx):
    if not ctx.peaks or ctx.trace.window_s <= 0 \
            or "hybrid_layer_ids" not in ctx.model:
        return None
    flops = train_hybrid.step_flops(ctx.model, ctx.workload) \
        * ctx.trace.steps
    return 100.0 * flops / (ctx.trace.window_s * ctx.peaks["bf16_flops"])
