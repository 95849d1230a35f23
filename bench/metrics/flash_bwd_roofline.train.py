"""flash_bwd_roofline.train: the flash backward's share of its roofline,
in %: each call's least time (8·d operations a visible pair and query
head at the bf16 peak, or its bytes at the HBM rate, ``bench/counts/
flash_bwd.py``) over the device time of every kernel that starts inside
a ``flash_attention_backward`` range, per call."""

from bench.counts import flash_bwd

RANGES = {"flash_attention_backward":
          "repro_torch.kernels.flash_attention:flash_attention_backward"}


def read(ctx):
    calls = len(ctx.trace.spans.get("flash_attention_backward", []))
    ks = ctx.trace.in_range("flash_attention_backward")
    if not calls or not ks or not ctx.peaks:
        return None
    w, m = ctx.workload, ctx.model
    ops, moved = flash_bwd.cost(w["global_batch"] // w["microbatches"],
                                m["n_heads"], w["seq"], w["seq"],
                                m["head_dim"])
    least = max(ops / ctx.peaks["bf16_flops"], moved / ctx.peaks["hbm_bytes_s"])
    return 100.0 * least * calls / (sum(k.us for k in ks) / 1e6)
