"""ssd_roofline.train: the SSD scan kernels' share of their roofline, in
%: each forward and backward call's operations (``bench/counts/
ssd_scan.py`` at the microbatch's rows, the sequence and the model's
heads, head dim, state, chunk and groups) at the card's fp32 peak (the
kernels take every product in exact fp32 on the CUDA cores), over the
device time of the scan's kernels, found by name.  Each forward call
launches one ``cb_kernel`` and each backward call one ``dx_kernel``,
which count the calls; remat's re-forward is a forward call."""

import re

from bench.counts import ssd_scan

KERNEL = re.compile(r"\b(cb|states|pass|pass_bwd|out|dx|ds|dbc)_kernel\b")


def read(ctx):
    ks = [k for k in ctx.trace.kernels if KERNEL.search(k.name)]
    if not ks or not ctx.peaks or "ssm" not in ctx.model:
        return None
    fwd_calls = sum(1 for k in ks if KERNEL.search(k.name).group(1) == "cb")
    bwd_calls = sum(1 for k in ks if KERNEL.search(k.name).group(1) == "dx")
    w, m = ctx.workload, ctx.model
    s = m["ssm"]
    h = s["expand"] * m["d_model"] // s["headdim"]
    fwd, bwd = ssd_scan.cost(w["global_batch"] // w["microbatches"],
                             w["seq"], h, s["headdim"], s["d_state"],
                             min(s["chunk"], w["seq"]), s["n_groups"])
    least = (fwd * fwd_calls + bwd * bwd_calls) / ctx.peaks["fp32_flops"]
    return 100.0 * least / (sum(k.us for k in ks) / 1e6)
