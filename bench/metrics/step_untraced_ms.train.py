"""step_untraced_ms.train: device ms a step that no program span below
``train.step`` covers: the step's interval less the union of its
children's (the embedding, the float32 gradient accumulation, the zero
gradients, the learning rate and the metrics' glue)."""

from bench import spans


def read(ctx):
    trees = spans.steps(ctx)
    if not trees:
        return None
    return sum(t.self_ms("device") for t in trees) / len(trees)
