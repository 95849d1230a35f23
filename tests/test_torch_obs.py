"""The port's spans (``repro_torch.obs``) on a tiny dense LM and a tiny
Mamba-2 LM, remat on and off, one and two microbatches: off outside a
profiler and bit for bit the same numbers under one, one tree a step,
the counts by (name, phase), a backward twin for every layer span, spans
closed when their body raises (checkpoint's early stop too), and self
times that add up to the step."""
from __future__ import annotations

import collections
import dataclasses
import functools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_flatten
from torch.utils.checkpoint import checkpoint

from repro_torch import configs, obs
from repro_torch.models.common import materialize
from repro_torch.models.lm import LM
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train.step import TrainConfig, make_train_step

ARCHS = ("granite-8b", "mamba2-2.7b")
#: spans with a backward twin, and those each layer opens
TWINNED = ("lm.layer", "layer.attention", "layer.mlp", "layer.scan",
           "lm.head", "train.xent")
PER_LAYER = {"granite-8b": ("lm.layer", "layer.attention", "layer.mlp"),
             "mamba2-2.7b": ("lm.layer", "layer.scan")}
CASES = [(a, remat, k) for a in ARCHS for remat in (False, True)
         for k in (1, 2)]


def _setup(arch: str):
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              act_dtype="float32")
    model = LM(cfg)
    params = materialize(model.param_recs(),
                         torch.Generator().manual_seed(3),
                         default_dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    return cfg, model, params, batch


def _step(arch: str, remat: bool, k: int, profiled: bool):
    """One training step from fixed parameters; returns the parameters,
    the optimizer state and the metrics after it."""
    cfg, model, params, batch = _setup(arch)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), microbatches=k, remat=remat,
                       warmup_steps=1, total_steps=10)
    step_fn = make_train_step(model, tcfg)
    opt = adamw_init(params, tcfg.opt)
    if not profiled:
        return step_fn(params, opt, batch, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        return step_fn(params, opt, batch, 3)


@pytest.fixture(autouse=True)
def _empty_store():
    obs.clear()
    yield
    obs.clear()


@functools.lru_cache(maxsize=None)
def _traced(arch: str, remat: bool, k: int):
    """Two profiled steps: the store's trees and counts after them."""
    obs.clear()
    _step(arch, remat, k, profiled=True)
    _step(arch, remat, k, profiled=True)
    return obs.steps(), obs.counts()


@pytest.mark.parametrize("arch,remat,k", CASES)
def test_spans_change_no_number_and_are_off_outside_a_profiler(arch, remat,
                                                               k):
    plain = _step(arch, remat, k, profiled=False)
    assert not obs.counts() and not obs.STORE.trees
    traced = _step(arch, remat, k, profiled=True)
    assert obs.counts() and len(obs.steps()) == 1
    a, spec_a = tree_flatten(plain)
    b, spec_b = tree_flatten(traced)
    assert spec_a == spec_b
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), i


@pytest.mark.parametrize("arch,remat,k", CASES)
def test_one_tree_a_step_with_counts_by_name_and_phase(arch, remat, k):
    cfg, *_ = _setup(arch)
    trees, c = _traced(arch, remat, k)
    assert len(trees) == 2 and all(t.name == "train.step" for t in trees)
    n = cfg.n_layers * k
    assert c[("train.step", None)] == c[("optim.adamw", None)] == 2
    for name in PER_LAYER[arch]:
        assert c[(name, "fwd")] == c[(name, "bwd")] == 2 * n, name
        assert c.get((name, "recompute"), 0) == (2 * n if remat else 0)
    for name in ("lm.head", "train.xent"):
        assert c[(name, "fwd")] == c[(name, "bwd")] == 2 * k
    if arch == "granite-8b":
        assert c[("kernel.flash_fwd", "fwd")] == \
            c[("kernel.flash_bwd", "bwd")] == 2 * n
    assert not any(phase == "recompute" for _, phase in c) or remat
    for t in trees:
        spans = list(t.walk())
        assert sum(s.name == "train.step" for s in spans) == 1
        assert not any(s.open for s in spans)


@pytest.mark.parametrize("arch,remat,k", CASES)
def test_every_forward_layer_span_has_a_backward_twin_in_its_step(arch,
                                                                  remat, k):
    tree = _traced(arch, remat, k)[0][-1]
    by = collections.Counter((s.name, s.phase) for s in tree.walk())
    for name in TWINNED:
        assert by[(name, "fwd")] == by[(name, "bwd")], name
    for s in tree.walk():
        if s.phase == "bwd":
            a, b = s.host
            assert 0.0 <= a <= b <= tree.host[1]
        if s.phase == "recompute":      # inside some backward span
            up = s.parent
            while up.phase == "recompute":
                up = up.parent
            assert up.phase == "bwd", s.name


@pytest.mark.parametrize("arch,remat,k", CASES)
def test_self_times_add_up_to_the_step(arch, remat, k):
    tree = _traced(arch, remat, k)[0][-1]
    total = sum(s.self_ms("host") for s in tree.walk())
    a, b = tree.host
    assert total == pytest.approx(b - a, rel=1e-9, abs=1e-9)
    for s in tree.walk():
        assert s.self_ms("host") >= -1e-9
        for c in s.children:
            assert s.host[0] <= c.host[0] <= c.host[1] <= s.host[1]
    # on the CPU the device is the host
    assert [s.device for s in tree.walk()] == [s.host for s in tree.walk()]


def test_spans_close_when_their_body_raises():
    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("outer", None):
            with pytest.raises(ValueError):
                with obs.span("inner"):
                    raise ValueError
            with pytest.raises(ValueError):
                obs.layer("failing", lambda t: (_ for _ in ()).throw(
                    ValueError()), x)
            with obs.span("after"):
                pass
    (tree,) = obs.steps("outer")
    assert [s.name for s in tree.children] == ["inner", "failing", "after"]
    assert not any(s.open for s in tree.walk())


def test_checkpoint_early_stop_closes_the_recomputed_span():
    """Non-reentrant checkpoint stops its re-forward by raising once the
    tensors the backward needs are back: the span it raised in closes,
    and one after it never opens."""
    def body(x):
        with obs.span("saves"):
            y = x.sin()                  # saves x: the re-forward ends here
        with obs.span("after"):
            return y * 2.0               # saves nothing
    x = torch.linspace(0, 1, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("step", None):
            checkpoint(body, x, use_reentrant=False).sum().backward()
    c = obs.counts()
    assert c[("saves", "fwd")] == c[("saves", "recompute")] == 1
    assert c[("after", "fwd")] == 1 and ("after", "recompute") not in c
    (tree,) = obs.steps("step")
    assert not any(s.open for s in tree.walk())
    assert torch.allclose(x.grad, 2.0 * torch.cos(x.detach()))


def test_off_costs_no_boundary_and_no_span():
    x = torch.ones(2, requires_grad=True)
    y = obs.layer("lm.layer", lambda t: t * 3.0, x)
    assert type(y.grad_fn).__name__ == "MulBackward0"
    with obs.span("train.step", None):
        pass
    assert not obs.counts() and not obs.steps("train.step")


def test_the_store_keeps_the_last_steps():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(obs.KEEP + 3):
            with obs.span("train.step", None):
                pass
    assert len(obs.steps()) == obs.KEEP
    assert obs.counts()[("train.step", None)] == obs.KEEP + 3


def test_boundaries_pass_dtensors_through(tmp_path):
    """A layer's boundaries keep a DTensor a DTensor of the same
    placements, forward and backward (a one-rank gloo mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        x = DTensor.from_local(torch.arange(6.0).reshape(3, 2), mesh,
                               [Shard(0)]).requires_grad_()
        with profile(activities=[ProfilerActivity.CPU]):
            with obs.span("train.step", None):
                y = obs.layer("lm.layer", lambda t: t * 2.0, x)
                assert isinstance(y, DTensor)
                assert tuple(y.placements) == (Shard(0),)
                y.redistribute(mesh, [Replicate()]).to_local().sum() \
                    .backward()
        assert isinstance(x.grad, DTensor)
        assert torch.equal(x.grad.full_tensor(), torch.full((3, 2), 2.0))
        c = obs.counts()
        assert c[("lm.layer", "fwd")] == c[("lm.layer", "bwd")] == 1
    finally:
        dist.destroy_process_group()


def test_an_unused_output_keeps_its_producers_out_of_the_backward():
    """An output nothing reads (a scan's final state) passes its own
    boundary: its producers stay out of the backward, as without the
    span, and hold no gradient memory there."""
    ran = []

    def fn(t):
        dead = t.exp()
        dead.grad_fn.register_prehook(lambda g: ran.append(1))
        return t * 2.0, dead
    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("train.step", None):
            y, _ = obs.layer("layer.scan", fn, x)
            y.sum().backward()
    assert not ran
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    c = obs.counts()
    assert c[("layer.scan", "fwd")] == c[("layer.scan", "bwd")] == 1
