"""adamw_roofline.train: the optimizer's share of its roofline, in %:
one AdamW pass's bytes (``bench/counts/adamw.py``: each parameter's
gradient, master, m and v read, master, m, v and parameter written) at
the HBM rate, over the device time of the kernels inside an
``adamw_update`` range, per call."""

from bench.counts import adamw

RANGES = {"adamw_update": "repro_torch.train.step:adamw_update"}


def read(ctx):
    calls = len(ctx.trace.spans.get("adamw_update", []))
    ks = ctx.trace.in_range("adamw_update")
    if not calls or not ks or not ctx.peaks:
        return None
    _, moved = adamw.cost(ctx.n_params, ctx.grad_bytes)
    least = moved / ctx.peaks["hbm_bytes_s"]
    return 100.0 * least * calls / (sum(k.us for k in ks) / 1e6)
