"""The port's checkpoint store (counterparts of ``tests/test_ckpt.py``'s
single-device cases) and checkpoints across packages in both directions:
a trainer's tree — bf16 params, a float32 master, int8 moments with
float32 scales, an int32 step — written by one package restores in the
other bit for bit, with the same keys, dtype strings and manifest.

Elastic re-sharding (``test_elastic_reshard``: save from one mesh,
restore onto others with ``restore(..., shardings=...)``) runs on gloo
ranks in ``tests/test_torch_dist.py``, across packages both ways.
"""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402

from repro_torch import ckpt, convert  # noqa: E402
from repro_torch.models.common import leaves, tmap  # noqa: E402

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((8, 16)).astype(
            np.float32)),
        "e": torch.from_numpy(rng.standard_normal((4, 4)).astype(
            np.float32)).bfloat16(),
        "q": {"q": torch.arange(-8, 8, dtype=torch.int8).reshape(4, 4),
              "scale": torch.ones(4, 1)},
        "stages": [{"k": torch.zeros(2, 3)}],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_roundtrip_keys_and_manifest(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 3, tree, extra={"note": "hi"})
    assert ckpt.latest_step(tmp_path) == 3
    out, manifest = ckpt.restore(tmp_path, 3, tree)
    assert manifest["extra"]["note"] == "hi"
    assert set(manifest["leaves"]) == {"w", "e", "q.q", "q.scale",
                                       "stages.0.k", "step"}
    assert manifest["leaves"]["e"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert np.load(tmp_path / "step_00000003" / "e.npy").dtype == np.uint16


def test_latest_step_ignores_incomplete(tmp_path):
    ckpt.save(tmp_path, 5, _tree())
    (tmp_path / "step_00000009").mkdir()     # crashed save: no manifest
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "absent") is None


def test_async_saver_writes_a_snapshot(tmp_path):
    """The saver copies to the host before its thread writes, so the
    optimizer's in-place updates after ``submit`` do not reach the
    checkpoint."""
    tree = _tree(1)
    saver = ckpt.AsyncSaver(tmp_path)
    saver.submit(1, tree)
    want = tree["w"].clone()
    tree["w"].add_(1.0)
    saver.submit(2, tree)    # waits for the first
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 2
    out, _ = ckpt.restore(tmp_path, 1, tree)
    np.testing.assert_array_equal(out["w"].numpy(), want.numpy())


def test_restore_onto_a_device_and_missing_leaf(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 1, tree)
    out, _ = ckpt.restore(tmp_path, 1, tree, device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(out))
    with pytest.raises(KeyError, match="missing leaf extra"):
        ckpt.restore(tmp_path, 1, dict(tree, extra=torch.zeros(1)))


def _jax_state():
    """A JAX trainer tree: bf16 params, after one AdamW step with an fp32
    master and int8 moments."""
    rng = np.random.default_rng(2)
    params = {"embed": jnp.asarray(rng.standard_normal((8, 4)),
                                   jnp.bfloat16),
              "stages": [{"blocks": [{"wq": jnp.asarray(
                  rng.standard_normal((2, 4, 4)), jnp.bfloat16)}]}]}
    cfg = joptim.OptConfig(quantize_state=True)
    opt = joptim.adamw_init(params, cfg)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), jnp.float32), params)
    params, opt, _ = joptim.adamw_update(grads, params, opt, cfg, 1e-2)
    return {"params": params, "opt": opt}


def _port(tree):
    return tmap(lambda a: convert.array_tensor(a, "cpu"),
                jax.tree.map(np.asarray, tree))


def _same(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(b.dtype)[6:] == str(a.dtype) and b.shape == a.shape
        want = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            want = want.view(np.uint16).view(np.int16)
        np.testing.assert_array_equal(_bits(b), want)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _jax_state()
    jckpt.save(tmp_path, 4, jtree, extra={"step": 4})
    assert ckpt.latest_step(tmp_path) == 4
    out, manifest = ckpt.restore(tmp_path, 4, _port(jtree))
    assert manifest["extra"] == {"step": 4}
    _same(jtree, out)
    assert out["opt"]["m"]["embed"]["q"].dtype == torch.int8
    assert out["opt"]["master"]["embed"].dtype == torch.float32


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _jax_state()
    ttree = _port(jtree)
    ckpt.save(tmp_path, 6, ttree)
    out, _ = jckpt.restore(tmp_path, 6, jtree)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(
            np.uint8), np.asarray(b).reshape(-1).view(np.uint8))
    # the manifests the two packages write agree
    jckpt.save(tmp_path / "jax", 6, jtree)
    ours = json.loads((tmp_path / "step_00000006" / "manifest.json"
                       ).read_text())
    theirs = json.loads((tmp_path / "jax" / "step_00000006" /
                         "manifest.json").read_text())
    assert ours == theirs


def test_store_imports_no_ml_dtypes():
    """The card machine has no ml_dtypes: bf16 goes through int16 views."""
    for path in (PORT / "ckpt").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(m.split(".")[0] == "ml_dtypes" for m in names)
