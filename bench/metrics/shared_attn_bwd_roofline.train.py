"""shared_attn_bwd_roofline.train: the shared blocks' attention backward
against the bf16 peak, in %: each call's operations (8·d a visible pair
and query head, ``bench/counts/flash_bwd.py``, at the microbatch's rows,
the model's heads and head dim and the sequence) at the card's bf16
peak, over the device time of every kernel that starts inside a
``flash_attention_backward`` range, per call.  It reads the same work
whatever route computes the gradient."""

from bench.counts import flash_bwd

RANGES = {"flash_attention_backward":
          "repro_torch.kernels.flash_attention:flash_attention_backward"}


def read(ctx):
    calls = len(ctx.trace.spans.get("flash_attention_backward", []))
    ks = ctx.trace.in_range("flash_attention_backward")
    if not calls or not ks or not ctx.peaks:
        return None
    w, m = ctx.workload, ctx.model
    ops, _ = flash_bwd.cost(w["global_batch"] // w["microbatches"],
                            m["n_heads"], w["seq"], w["seq"], m["head_dim"])
    return 100.0 * ops / ctx.peaks["bf16_flops"] * calls \
        / (sum(k.us for k in ks) / 1e6)
