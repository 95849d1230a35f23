"""flash_fwd_roofline.train: the flash forward kernel's share of its
roofline, in %: each launch's least time (the larger of its operations
at the bf16 peak and its bytes at the HBM rate, ``bench/counts/
flash_fwd.py``, at the microbatch's (rows, query heads, seq, head dim))
over the launches' device time, the kernels found by name.  The forward
and remat's re-forward both launch it."""

import re

from bench.counts import flash_fwd

KERNEL = re.compile(r"flash_attention_(wgmma_|bf16x3_|simt_)?kernel")


def read(ctx):
    ks = [k for k in ctx.trace.kernels
          if KERNEL.search(k.name) and "bwd" not in k.name]
    if not ks or not ctx.peaks:
        return None
    w, m = ctx.workload, ctx.model
    ops, moved = flash_fwd.cost(w["global_batch"] // w["microbatches"],
                                m["n_heads"], w["seq"], w["seq"],
                                m["head_dim"])
    least = max(ops / ctx.peaks["bf16_flops"], moved / ctx.peaks["hbm_bytes_s"])
    return 100.0 * least * len(ks) / (sum(k.us for k in ks) / 1e6)
