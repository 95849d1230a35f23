"""The port's optimizer against the JAX package's (counterparts of
``tests/test_optim.py``): ``adamw_update`` over several steps (plain,
fp32 masters over bf16 params, int8 state, a clipped case),
``cosine_schedule``, ``global_norm``, the int8 (de)quantizers, and a JAX
AdamW state carried across by ``convert.adamw_state``.

Inputs are made once with numpy from a seed and go through both
packages.  Tolerances: float32 values within 1e-6 relative plus 1e-7
(the same arithmetic in the same order; XLA's and torch's ``pow`` and
``sqrt`` may differ in the last bit); bf16 parameters within one bf16
step of JAX's (a last-bit difference of the fp32 master can round the
other way); the int8 ``q`` of a quantized moment equal, not close.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import convert, optim  # noqa: E402
from repro_torch.models.common import leaves, tmap  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

F32 = dict(rtol=1e-6, atol=1e-7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if x.dtype == jnp.bfloat16 else np.asarray(x)


def _params(rng, dtype):
    """A small tree of the LM's shapes: a stacked (layers, d, f) matrix,
    a vector and a list."""
    arrays = {"w": rng.standard_normal((2, 8, 16)).astype(np.float32),
              "ln": rng.standard_normal((16,)).astype(np.float32),
              "stages": [{"b": rng.standard_normal((4, 8)).astype(
                  np.float32)}]}
    j = jax.tree.map(lambda a: jnp.asarray(a, dtype), arrays)
    return j, _t(j)


def _t(tree):
    """A JAX tree as the port's CPU tensors, each leaf in its own type."""
    return tmap(lambda a: convert.array_tensor(a, "cpu"),
                jax.tree.map(np.asarray, tree))


def _grads(rng, scale=1.0):
    return {"w": rng.standard_normal((2, 8, 16)).astype(np.float32) * scale,
            "ln": rng.standard_normal((16,)).astype(np.float32) * scale,
            "stages": [{"b": rng.standard_normal((4, 8)).astype(np.float32)
                        * scale}]}


def _close_trees(jtree, ttree, bf16: bool = False):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if a.dtype == jnp.int8:
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        elif a.dtype == jnp.bfloat16 and bf16:
            np.testing.assert_allclose(_np(b), _np(a), rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(_np(b), _np(a), **F32)


CASES = {
    "plain": (dict(master_fp32=False), jnp.float32, 1.0),
    "master_bf16": (dict(), jnp.bfloat16, 1.0),
    "quantized": (dict(quantize_state=True), jnp.float32, 1.0),
    "quantized_bf16": (dict(quantize_state=True), jnp.bfloat16, 1.0),
    "clipped": (dict(clip_norm=0.5), jnp.float32, 30.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_update_matches_jax_over_steps(case):
    kw, dtype, gscale = CASES[case]
    cfg_j = joptim.OptConfig(lr=1e-2, **kw)
    cfg_t = optim.OptConfig(lr=1e-2, **kw)
    rng = np.random.default_rng(0)
    jp, tp = _params(rng, dtype)
    js = joptim.adamw_init(jp, cfg_j)
    ts = optim.adamw_init(tp, cfg_t)
    _close_trees(js, ts)
    for step in range(4):
        g = _grads(rng, gscale)
        lr = joptim.cosine_schedule(step, peak_lr=cfg_j.lr, warmup_steps=2,
                                    total_steps=10)
        jp, js, jm = joptim.adamw_update(jax.tree.map(jnp.asarray, g), jp,
                                         js, cfg_j, lr)
        tlr = optim.cosine_schedule(step, peak_lr=cfg_t.lr, warmup_steps=2,
                                    total_steps=10)
        tp, ts, tm = optim.adamw_update(
            tmap(torch.from_numpy, g), tp, ts, cfg_t, tlr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        _close_trees(jp, tp, bf16=True)
        _close_trees(js, ts, bf16=True)
        assert int(ts["step"]) == step + 1
    for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
        assert str(b.dtype)[6:] == str(a.dtype)


def test_adamw_matches_the_hand_reference():
    """tests/test_optim.py's hand-computed first step."""
    cfg = optim.OptConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                          weight_decay=0.0, clip_norm=0.0)
    w = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    state = optim.adamw_init(p, cfg)
    p2, _, _ = optim.adamw_update({"w": torch.from_numpy(g)}, p, state, cfg,
                                  lr=cfg.lr)
    m, v = 0.1 * g, 0.01 * g ** 2
    want = w - cfg.lr * (m / 0.1) / (np.sqrt(v / 0.01) + cfg.eps)
    np.testing.assert_allclose(p2["w"].numpy(), want, rtol=1e-5)


def test_weight_decay_decoupled_and_clip_reports_the_norm():
    cfg = optim.OptConfig(lr=1e-2, weight_decay=0.1, clip_norm=0.0)
    p = {"w": torch.ones(4)}
    p2, _, _ = optim.adamw_update({"w": torch.zeros(4)}, p,
                                  optim.adamw_init(p, cfg), cfg, lr=cfg.lr)
    np.testing.assert_allclose(p2["w"].numpy(), 1.0 - 1e-3, rtol=1e-6)
    cfg = optim.OptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    g = {"w": torch.tensor([300.0, 400.0])}
    p = {"w": torch.zeros(2)}
    _, _, m = optim.adamw_update(g, p, optim.adamw_init(p, cfg), cfg, lr=0.0)
    assert float(m["grad_norm"]) == 500.0 == float(optim.global_norm(g))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 55, 99, 100, 140])
def test_cosine_schedule_matches_jax_for_int_and_tensor_steps(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100,
              final_frac=0.1)
    want = np.float32(joptim.cosine_schedule(step, **kw))
    for s in (step, torch.tensor(step, dtype=torch.int32),
              torch.tensor(float(step))):
        got = optim.cosine_schedule(s, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)


def test_cosine_schedule_shape():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100, final_frac=0.1)
    assert float(optim.cosine_schedule(0, **kw)) == 0.0
    assert float(optim.cosine_schedule(10, **kw)) == 1.0
    assert float(optim.cosine_schedule(5, **kw)) == 0.5
    assert abs(float(optim.cosine_schedule(100, **kw)) - 0.1) < 1e-5


def test_global_norm_matches_jax():
    g = _grads(np.random.default_rng(3), 2.0)
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(optim.global_norm(tmap(torch.from_numpy, g)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_quantize_matches_jax_bit_for_bit(sqrt_domain):
    """Round half to even on both sides: q equal, scale equal; and the
    dequantized values equal."""
    x = np.random.default_rng(4).standard_normal((6, 128)).astype(
        np.float32) * 3.0
    if sqrt_domain:
        x = np.abs(x) ** 2
    # entries exactly half-way between two int8 steps
    x[0, :4] = np.float32(127.0), np.float32(0.5), np.float32(1.5), \
        np.float32(-2.5)
    jq = jadamw._quantize(jnp.asarray(x), sqrt_domain)
    tq = tadamw._quantize(torch.from_numpy(x), sqrt_domain)
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(),
                                  np.asarray(jq["scale"]))
    np.testing.assert_array_equal(
        tadamw._dequantize(tq, sqrt_domain).numpy(),
        np.asarray(jadamw._dequantize(jq, sqrt_domain)))


def test_quantize_roundtrip_bounded_and_sqrt_domain_keeps_small_v():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 128)).astype(np.float32) * 3.0)
    err = (tadamw._dequantize(tadamw._quantize(x)) - x).abs()
    assert float((err / x.abs().amax(-1, keepdim=True)).max()) <= \
        1.0 / 127 / 2 + 1e-6
    v = torch.tensor([[1.0, 1e-3, 1e-4] + [0.0] * 125])
    lin = tadamw._dequantize(tadamw._quantize(v))
    sq = tadamw._dequantize(tadamw._quantize(v, sqrt_domain=True),
                            sqrt_domain=True)
    assert float(lin[0, 2]) == 0.0
    assert 0.3e-4 < float(sq[0, 2]) < 3e-4


@pytest.mark.parametrize("quantize", [False, True])
def test_jax_state_carried_across_continues_as_jax(quantize):
    """A JAX state after one JAX step converts leaf for leaf (int8 ``q``
    and float32 ``scale`` kept as they are); the port's next step equals
    JAX's next step."""
    cfg_j = joptim.OptConfig(lr=1e-2, quantize_state=quantize)
    cfg_t = optim.OptConfig(lr=1e-2, quantize_state=quantize)
    rng = np.random.default_rng(5)
    jp, _ = _params(rng, jnp.bfloat16)
    js = joptim.adamw_init(jp, cfg_j)
    jp, js, _ = joptim.adamw_update(jax.tree.map(jnp.asarray, _grads(rng)),
                                    jp, js, cfg_j, 1e-2)
    ts = convert.adamw_state(jax.tree.map(np.asarray, js), "cpu")
    tp = _t(jp)
    assert jax.tree.structure(js) == jax.tree.structure(
        jax.tree.map(lambda t: 0, ts, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))
    for a, b in zip(jax.tree.leaves(js), leaves(ts)):
        assert str(b.dtype)[6:] == str(a.dtype)
        np.testing.assert_array_equal(_np(b), _np(a))
    g = _grads(rng)
    jp, js, _ = joptim.adamw_update(jax.tree.map(jnp.asarray, g), jp, js,
                                    cfg_j, 1e-2)
    tp, ts, _ = optim.adamw_update(tmap(torch.from_numpy, g), tp, ts, cfg_t,
                                   1e-2)
    _close_trees(jp, tp, bf16=True)
    _close_trees(js, ts, bf16=True)
