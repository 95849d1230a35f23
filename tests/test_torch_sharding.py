"""The port's sharding-rule engine against the JAX package's, exactly, in
one process (no mesh: rules and specs are pure Python): ``rules`` for
each mode × ``fsdp`` × ``pods_in_batch``; for every arch × shape it
supports × ``multi_pod``, ``rule_for``, the parameter spec tree, the
batch specs, the optimizer specs (both ``quantize_state`` values),
``input_specs``, and ``build_cell``'s rule, specs, abstract arguments and
``model_flops_global``; the spec → placements mapping; and the
checks that need no process group.  Specs compare as tuples
(``tuple(jax_spec)``, the port's ``P`` is a tuple).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import cell as jcell  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import cell as tcell  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.optim import OptConfig as TOptConfig  # noqa: E402

CELLS = [(a, s, mp) for a, s in jconfigs.cells() for mp in (False, True)]


def _jflat(tree) -> dict:
    """{path: leaf} of a JAX tree, specs and ShapeDtypeStructs as
    leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): v for p, v in leaves}


def _tflat(tree, prefix: str = "") -> dict:
    """{path: leaf} of a port tree, in JAX's ``keystr`` form."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_tflat(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, tcommon.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tflat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _same_specs(jtree, ttree) -> int:
    j, t = _jflat(jtree), _tflat(ttree)
    assert list(j) == list(t)
    for k in j:
        assert isinstance(t[k], tcommon.P), k
        assert tuple(t[k]) == tuple(j[k]), (k, t[k], j[k])
    return len(j)


def _same_abstract(jtree, ttree) -> int:
    j, t = _jflat(jtree), _tflat(ttree)
    assert list(j) == list(t)
    for k in j:
        assert t[k].device.type == "meta", k
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert str(t[k].dtype)[6:] == str(j[k].dtype), (k, t[k].dtype,
                                                        j[k].dtype)
    return len(j)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "long"])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("pods", [True, False])
def test_rules_equal_jax(mode, fsdp, pods):
    for kw in ({}, {"seq_axis": "model"}, {"act_embed_axis": "model"},
               {"kv_seq_axis": ("pod", "data")},
               {"fsdp_axes": ("pod", "data")}):
        assert tcommon.rules(mode, fsdp=fsdp, pods_in_batch=pods, **kw) \
            == jcommon.rules(mode, fsdp=fsdp, pods_in_batch=pods, **kw)


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_cell_specs_equal_jax(arch, shape, multi_pod):
    """rule_for, the parameter spec tree, batch specs and both optimizer
    spec trees, for one cell."""
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js, ts = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    jr = jcell.rule_for(jc, js, multi_pod)
    tr = tcell.rule_for(tc, ts, multi_pod)
    assert tr == jr
    jrecs, trecs = JLM(jc).param_recs(), TLM(tc).param_recs()
    assert _same_specs(jcommon.spec_tree(jrecs, jr),
                       tcommon.spec_tree(trecs, tr)) > 0
    _same_specs(jcell.batch_specs(jc, js, jr), tcell.batch_specs(tc, ts, tr))
    for q in (False, True):
        _same_specs(jcell.opt_specs(jrecs, jr, JOptConfig(quantize_state=q)),
                    tcell.opt_specs(trecs, tr, TOptConfig(quantize_state=q)))
        _same_abstract(jcell.opt_abstract(jrecs,
                                          JOptConfig(quantize_state=q)),
                       tcell.opt_abstract(trecs,
                                          TOptConfig(quantize_state=q)))


@pytest.mark.parametrize("arch,shape", jconfigs.cells())
def test_input_specs_equal_jax(arch, shape):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    _same_abstract(jconfigs.input_specs(jc, shape),
                   tconfigs.input_specs(tc, shape))
    _same_abstract(jcommon.abstract_tree(JLM(jc).param_recs()),
                   tcommon.abstract_tree(TLM(tc).param_recs()))


@pytest.mark.parametrize("arch,shape", jconfigs.cells())
def test_build_cell_equal_jax(arch, shape):
    """The single-pod cell (the multi-pod rule is the same code, held by
    ``test_cell_specs_equal_jax``): rule, argument and result specs,
    abstract arguments and model flops; the step is the port's own."""
    j = jcell.build_cell(arch, shape)
    t = tcell.build_cell(arch, shape)
    assert t.rule == j.rule
    assert t.model_flops_global == j.model_flops_global
    assert t.shape.name == j.shape.name and t.arch == j.arch
    _same_specs(j.in_specs, t.in_specs)
    _same_specs(j.out_specs, t.out_specs)
    _same_abstract(j.abstract_args, t.abstract_args)
    assert callable(t.fn)


def test_build_cell_refuses_what_jax_refuses():
    for build in (jcell.build_cell, tcell.build_cell):
        with pytest.raises(ValueError, match="skips long_500k"):
            build("granite-8b", "long_500k")


def test_spec_normalised_as_jax():
    for parts in ((("data",), None), (("pod", "data"), None), ((), "model"),
                  (None,), (), (["a", "b"],)):
        assert tuple(tcommon.P(*parts)) == tuple(JP(*parts))


class _Mesh:
    """What ``placements`` reads of a ``DeviceMesh``."""

    def __init__(self, names):
        self.mesh_dim_names, self.ndim = tuple(names), len(names)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    pod = _Mesh(("pod", "data", "model"))
    assert tcommon.placements(tcommon.P(("pod", "data"), None, "model"),
                              pod) == (Shard(0), Shard(0), Shard(2))
    assert tcommon.placements(tcommon.P(None, "data"), pod) == \
        (Replicate(), Shard(1), Replicate())
    assert tcommon.placements(tcommon.P(), pod) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="'pod'"):
        tcommon.placements(tcommon.P(("pod", "data")), _Mesh(("data",
                                                               "model")))
    with pytest.raises(ValueError, match="twice"):
        tcommon.placements(tcommon.P("model", "model"), pod)


def test_constrain_without_a_mesh_returns_its_input():
    """JAX's early return for a fully replicated spec, and the port's for
    a tensor that is not a DTensor."""
    rule = tcommon.rules("train", pods_in_batch=False)
    x = torch.ones(2, 3)
    assert tcommon.constrain(x, rule, (None, "hd")) is x
    assert tcommon.constrain(x, rule, ("batch", "act_heads")) is x
    assert tcommon.with_sharding(x, "data", None) is x


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_local_mesh(1, 1, device="cpu")


def test_shardings_tree_matches_spec_tree():
    cfg = tconfigs.reduced(tconfigs.get_config("granite-8b"))
    recs = TLM(cfg).param_recs()
    rule = tcell.rule_for(cfg, tconfigs.SHAPES["train_4k"], False)
    mesh = _Mesh(("data", "model"))
    sh = tcommon.shardings(recs, mesh, rule)
    specs = tcommon.spec_tree(recs, rule)
    assert [s.spec for s in tcommon.leaves(sh)] == tcommon.leaves(specs)
    assert tcommon.leaves(tcell.shard(mesh, specs)) == tcommon.leaves(sh)


def test_abstract_tree_allocates_nothing():
    cfg = tconfigs.get_config("deepseek-v3-671b")
    tree = tcommon.abstract_tree(TLM(cfg).param_recs())
    n = sum(t.numel() for t in tcommon.leaves(tree))
    assert n == cfg.param_count() > 6e11
    assert all(t.device.type == "meta" for t in tcommon.leaves(tree))
    j = jcommon.abstract_tree(JLM(jconfigs.get_config(
        "deepseek-v3-671b")).param_recs())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(j))
    assert jnp.dtype(jax.tree.leaves(j)[0].dtype) == jnp.bfloat16


def test_sharded_context_nests():
    """``sharded`` enters DTensor's implicit replication once: an inner
    ``with`` (the step around the model's forward) leaves it on."""
    from torch.distributed.tensor import DTensor
    rule = tcommon.rules("train", pods_in_batch=False)
    flag = DTensor._op_dispatcher
    assert not flag._allow_implicit_replication
    with tcommon.sharded(rule):
        with tcommon.sharded(rule):
            assert flag._allow_implicit_replication
        assert flag._allow_implicit_replication
    assert not flag._allow_implicit_replication
    with tcommon.sharded(None):
        assert not flag._allow_implicit_replication


def test_on_replicas_without_a_mesh_is_the_call():
    x = torch.arange(6.0).reshape(2, 3)
    out = tcommon.on_replicas(lambda a, t: {"s": a["v"] + t}, {"v": x}, x)
    assert torch.equal(out["s"], 2 * x)


def test_cell_steps_run_on_one_process():
    """``build_cell``'s callables on plain tensors of the reduced granite
    (a reduced shape: the rule's constraints change nothing without a
    mesh): the train step equals ``make_train_step`` without a rule, and
    prefill then decode equal the model's own."""
    import dataclasses
    from repro_torch import optim as toptim
    from repro_torch.train import TrainConfig, make_train_step
    cfg = tconfigs.reduced(tconfigs.get_config("granite-8b"))
    cfg = dataclasses.replace(cfg, act_dtype="float32")
    shape = tconfigs.ShapeSpec("tiny", "train", 16, 2)
    tcfg = TrainConfig(opt=TOptConfig(lr=1e-3), warmup_steps=1,
                       total_steps=10)
    cell = tcell.build_cell("granite-8b", shape, cfg=cfg, tcfg=tcfg)
    assert cell.rule["moe_groups"] == 16
    params = tcommon.materialize(cell.model.param_recs(),
                                 torch.Generator().manual_seed(0),
                                 default_dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    runs = []
    for step in (cell.fn, make_train_step(cell.model, tcfg)):
        p = tcommon.tmap(lambda t: t.clone(), params)
        p, _, m = step(p, toptim.adamw_init(p, tcfg.opt), batch, 0)
        runs.append((p, float(m["loss"])))
    assert runs[0][1] == runs[1][1]
    for a, b in zip(tcommon.leaves(runs[0][0]), tcommon.leaves(runs[1][0])):
        assert torch.equal(a, b)
    pre = tcell.build_cell("granite-8b", tconfigs.ShapeSpec(
        "tiny", "prefill", 16, 2), cfg=cfg)
    dec = tcell.build_cell("granite-8b", tconfigs.ShapeSpec(
        "tiny", "decode", 32, 2), cfg=cfg)
    from repro_torch.serve.engine import make_caches
    caches = make_caches(pre.model, 2, 32, "cpu")
    ref = make_caches(pre.model, 2, 32, "cpu")
    got, caches = pre.fn(params, {"tokens": toks}, caches)
    want, ref = pre.model.prefill(params, {"tokens": toks}, ref)
    assert torch.equal(got, want)
    nxt = torch.argmax(got[:, -1], -1)[:, None]
    got, _ = dec.fn(params, caches, nxt, 16)
    want, _ = dec.model.decode_step(params, ref, nxt, 16)
    assert torch.equal(got, want)
