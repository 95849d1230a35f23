"""loss_ms.train: device ms a step inside the program's ``lm.head``
(final norm, tied head, vocab mask) and ``train.xent`` (the
cross-entropy and z-loss, ``train/xent.py``) spans, forward and
backward."""

from bench import spans


def read(ctx):
    return spans.ms_a_step(ctx, ("lm.head", "train.xent"))
