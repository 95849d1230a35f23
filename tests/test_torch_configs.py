"""The port's architecture configs and parameter records against the JAX
package's: the same ten configs down to ``source``, the same reduced
configs field for field, the same record trees (shapes, axes, init,
scale), the same parameter counts; and ``materialize``'s rules."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.common import PRec as JPRec  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.frontends import resolve_path  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402


def _plain(x):
    """A config as nested dicts of plain values (the sub-config classes
    differ between the packages; their fields must not)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def test_ids_and_shapes_match():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: _plain(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: _plain(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.cells() == jconfigs.cells()
    assert list(tconfigs.all_configs()) == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_and_counts_match(arch):
    """Every field down to ``source=``; ``param_count`` and
    ``active_param_count`` from the port's own record tree."""
    ours, theirs = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert _plain(ours) == _plain(theirs)
    assert ours.subquadratic == theirs.subquadratic
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_reduced_matches(arch):
    ours = tconfigs.reduced(tconfigs.get_config(arch))
    theirs = jconfigs.reduced(jconfigs.get_config(arch))
    assert _plain(ours) == _plain(theirs)


def _records(tree):
    """(path, shape, axes, scale, init, explicit dtype name) per record."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            dt = (None if x.dtype is None
                  else str(x.dtype).split(".")[-1]
                  if isinstance(x.dtype, torch.dtype)
                  else np.dtype(x.dtype).name)
            out.append((path, x.shape, x.axes, x.scale, x.init, dt))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_record_trees_match(arch):
    """Parameter and cache records of the reduced config, record for
    record (JAX's ``PRec`` leaves against the port's)."""
    jm = JLM(jconfigs.reduced(jconfigs.get_config(arch)))
    tm = TLM(tconfigs.reduced(tconfigs.get_config(arch)))
    assert _records(tm.param_recs()) == _records(jm.param_recs())
    assert _records(tm.cache_recs(2, 64)) == _records(jm.cache_recs(2, 64))
    assert [(len(s.blocks), s.repeat) for s in tm.stages] == \
        [(len(s.blocks), s.repeat) for s in jm.stages]
    assert tm.padded_vocab == jm.padded_vocab
    leaves = jax.tree.leaves(jm.param_recs(),
                             is_leaf=lambda x: isinstance(x, JPRec))
    assert len(common.leaves(tm.param_recs())) == len(leaves)


def test_granite_at_published_widths():
    """tp=1 gives granite-8b's published shapes: 8 kv heads, not the 16
    that tp=16 pads them to; 8.05 B parameters, 16.1 GB in bf16."""
    cfg = dataclasses.replace(tconfigs.get_config("granite-8b"), tp=1)
    recs = TLM(cfg).param_recs()
    attn = recs["stages"][0]["blocks"][0]
    assert attn["wk"].shape == (36, 4096, 8, 128)
    assert attn["wq"].shape == (36, 4096, 32, 128)
    assert TLM(tconfigs.get_config("granite-8b")).param_recs()[
        "stages"][0]["blocks"][0]["wk"].shape[2] == 16
    n = cfg.param_count()
    assert n == 8_053_362_688
    assert round(2 * n / 1e9, 1) == 16.1


def test_input_specs_waits_for_its_item():
    with pytest.raises(NotImplementedError, match="item 6"):
        tconfigs.input_specs(tconfigs.get_config("granite-8b"), "train_4k")


def test_configs_package_keeps_the_stencil_listings():
    """The C frontend still resolves the paper's listings by bare name
    from ``configs/stencils`` beside the new ``configs/__init__.py``."""
    p = resolve_path("stencil_3d7pt.c")
    assert p is not None and p.parent.name == "stencils"
    assert p.parent.parent == __import__("pathlib").Path(
        tconfigs.__file__).parent


def test_materialize_rules():
    """zeros/ones/fill constants; normal draws at ``scale`` or
    ``shape[-2] ** -0.5`` (the heads axis of ``wq``); the same seed gives
    the same tensors; records with a type keep it."""
    recs = {"wq": common.PRec((64, 4, 512), ("embed", "heads", "hd")),
            "w": common.PRec((256, 64), ("embed", "ff"), scale=0.1),
            "z": common.PRec((8,), ("embed",), init="zeros"),
            "o": common.PRec((8,), ("embed",), init="ones"),
            "f": common.PRec((5,), (None,), dtype=torch.int32, init="fill",
                             scale=-1),
            "r": common.PRec((64, 8), ("embed", None), dtype=torch.float32)}
    a = common.materialize(recs, torch.Generator().manual_seed(3))
    b = common.materialize(recs, torch.Generator().manual_seed(3))
    for k in recs:
        assert torch.equal(a[k], b[k])
    assert a["wq"].dtype == torch.bfloat16 and a["r"].dtype == torch.float32
    assert a["f"].dtype == torch.int32 and (a["f"] == -1).all()
    assert (a["z"] == 0).all() and (a["o"] == 1).all()
    np.testing.assert_allclose(a["wq"].float().std().item(), 4 ** -0.5,
                               rtol=0.02)
    np.testing.assert_allclose(a["w"].float().std().item(), 0.1, rtol=0.02)
    np.testing.assert_allclose(a["r"].std().item(), 64 ** -0.5, rtol=0.05)
    with pytest.raises(ValueError, match="generator"):
        common.materialize({"w": recs["w"]})


def test_materialize_draws_stacks_layer_by_layer():
    """A stacked leaf is drawn one layer at a time: its layers follow one
    generator stream, so the tree is the same whatever the device
    default."""
    rec = common.PRec((3, 16, 32), ("layers", "embed", "ff"))
    g = torch.Generator().manual_seed(5)
    t = common.materialize({"w": rec}, g, default_dtype=torch.float32)["w"]
    g = torch.Generator().manual_seed(5)
    for i in range(3):
        want = torch.randn(16, 32, generator=g) * 16 ** -0.5
        assert torch.equal(t[i], want)
