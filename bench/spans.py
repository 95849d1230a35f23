"""What the readers of the program's spans share: the whole
``train.step`` trees of the traced window from the port's span store
(``repro_torch.obs``), and a span's device ms with remat's re-forward
charged to the re-forward alone.

The store holds the plain pass's steps first (the profiler does not
record during its warm-up step, and spans record only while it does),
then the ranged pass's; the readers take the plain pass, the window
that ``train_mfu`` reads.  A program without spans gives no steps, and
every reader then gives no number."""
from __future__ import annotations


def steps(ctx) -> list:
    """The first ``ctx.trace.steps`` whole step trees the store holds."""
    try:
        from repro_torch import obs
    except ImportError:
        return []
    return obs.steps("train.step")[:ctx.trace.steps]


def charged_ms(span) -> float:
    """The span's device ms less the parts covered by spans below it in
    phase ``recompute``, unless it is itself in that phase: remat's
    re-forward runs inside the backward span of a group's last block."""
    from repro_torch.obs import covered
    a, b = span.device
    if span.phase == "recompute":
        return b - a
    again = [s.device for s in span.walk() if s.phase == "recompute"]
    return (b - a) - covered(again, (a, b))


def ms_a_step(ctx, names, phases=None) -> float | None:
    """Device ms a step of the spans named ``names`` (in ``phases``, or
    all), each as :func:`charged_ms` counts it; None where the window
    has no such span."""
    trees = steps(ctx)
    found = [s for t in trees for s in t.walk() if s.name in names
             and (phases is None or s.phase in phases)]
    if not found:
        return None
    return sum(charged_ms(s) for s in found) / len(trees)
