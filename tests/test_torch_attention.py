"""The modules under the LM stack against the JAX package's, block by
block: the kernel-holding attention module (causal GQA on the flash
kernel at lengths that need padding, groups 1, 2 and 4, with and without
a cache, and the cases the rule leaves to the grouped plain path), MoE
(counterparts of ``tests/test_moe.py``), Mamba-2, and the norms and RoPE.

float32 parameters from JAX's ``materialize`` and numpy inputs from a
seed; on the CPU ``ops.flash_attention`` runs the kernel's plain
version, and a spy counts the calls that reach it.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

import _lm_parity as lp  # noqa: E402

#: one attention or MoE block in float32: the outputs reach |30| (the
#: init's heads-axis fan-in makes the scores large, the softmax sharp),
#: and XLA's and torch's f32 sums differ in their last bits: 1e-4 of the
#: value plus 5e-4 (under 2e-5 of the largest output; 3.5e-4 seen)
BLOCK_TOL = dict(rtol=1e-4, atol=5e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tcommon.tmap(lambda a: torch.from_numpy(np.array(a)), tree)


def _block(recs, seed=0):
    """JAX float32 parameters of one block, as numpy."""
    return _np(jcommon.materialize(recs, jax.random.PRNGKey(seed),
                                   default_dtype=jnp.float32))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def flash_spy(monkeypatch):
    """Count the calls that reach ``ops.flash_attention`` and, under it,
    the kernel's plain version (what runs on the CPU)."""
    calls = {"flash": [], "plain": 0}
    real_flash, real_plain = ops.flash_attention, fa.plain

    def flash(q, k, v, **kw):
        calls["flash"].append((tuple(q.shape), tuple(k.shape), kw))
        return real_flash(q, k, v, **kw)

    def plain(*a, **kw):
        calls["plain"] += 1
        return real_plain(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", flash)
    monkeypatch.setattr(fa, "plain", plain)
    return calls


def _gqa_cfg(kv_heads: int):
    return dataclasses.replace(lp.configs("granite-8b", "float32")[1],
                               n_kv_heads=kv_heads)


@pytest.mark.parametrize("s", [7, 13, 61])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("cache_pos,cache_len",
                         [(None, 0), (0, 128), (5, 128), (5, 100), (40, 100)],
                         ids=["no_cache", "cache_pos0", "cache_pos5",
                              "cache_pos5_len100", "cache_pos40_len100"])
def test_causal_gqa_runs_on_flash_and_matches_jax(s, groups, cache_pos,
                                                  cache_len, flash_spy):
    """q padded to 64 rows, kv heads broadcast so that query head n reads
    kv head n // g, q_offset = pos; k and v cut to pos + s rows rounded up
    to 64 — with a cache, a slice of it whose slots past pos + s hold
    noise that causality must keep out (JAX masks them with kv_len), and
    zero-padded where the rounding passes a max_len of 100."""
    cfg = _gqa_cfg(4 // groups)
    p = _block(jattn.gqa_recs(cfg))
    x = _x((2, s, cfg.d_model))
    jcache = tcache = None
    if cache_pos is not None:
        shape = (2, cache_len, cfg.n_kv_heads, cfg.head_dim)
        noise = {"k": _x(shape, 2), "v": _x(shape, 3)}
        jcache = {k: jnp.asarray(v) for k, v in noise.items()}
        tcache = _t(noise)
    jo, jc = jattn.gqa_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             cfg, cache=jcache, pos=cache_pos)
    to, tc = tattn.gqa_apply(_t(p), torch.from_numpy(x), cfg,
                             cache=tcache, pos=cache_pos)
    np.testing.assert_allclose(lp.np32(to), lp.np32(jo), **BLOCK_TOL)
    assert len(flash_spy["flash"]) == 1 and flash_spy["plain"] == 1
    qs, ks, kw = flash_spy["flash"][0]
    assert qs == (2, 4, 64, cfg.head_dim)
    assert ks == (2, 4, -(-((cache_pos or 0) + s) // 64) * 64, cfg.head_dim)
    assert kw == {"causal": True, "q_offset": cache_pos or 0}
    if cache_pos is not None:
        for k in ("k", "v"):
            np.testing.assert_allclose(lp.np32(tc[k]), lp.np32(jc[k]),
                                       **BLOCK_TOL)


def test_flash_reads_kv_head_n_over_g(flash_spy):
    """The broadcast order is the one ``_grouped_scores`` implies: with
    4 query heads on 2 kv heads, heads 0 and 1 read kv head 0."""
    q, k, v = (torch.from_numpy(_x(shape, seed)) for shape, seed in
               (((1, 8, 4, 32), 1), ((1, 8, 2, 32), 2), ((1, 8, 2, 32), 3)))
    out = tattn.flash(q, k, v, q_offset=0)
    want = tattn.attend(q, k, v, "causal")
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    swapped = tattn.attend(q, k.flip(2), v.flip(2), "causal")
    assert not np.allclose(out.numpy(), swapped.numpy(), atol=1e-3)


@pytest.mark.parametrize("case", ["decode", "local", "bidir", "ring",
                                  "positions"])
def test_plain_path_cases_match_jax_without_flash(case, flash_spy):
    """Decode (one query row), local and bidirectional masks, ring slots
    and explicit positions take the grouped plain path: the kernel is not
    reached, and the block matches JAX's."""
    cfg = dataclasses.replace(_gqa_cfg(2), local_window=8)
    p = _block(jattn.gqa_recs(cfg))
    s = 1 if case in ("decode", "ring") else 12
    x = _x((2, s, cfg.d_model))
    kw = {"kind": {"local": "local", "bidir": "bidir"}.get(case, "causal"),
          "window": 8 if case == "local" else 0}
    jc = tc = None
    if case in ("decode", "ring"):
        W = 8 if case == "ring" else 32
        shape = (2, W, cfg.n_kv_heads, cfg.head_dim)
        noise = {"k": _x(shape, 2), "v": _x(shape, 3)}
        if case == "ring":
            noise["pos"] = np.array([8, 9, 10, 3, 4, 5, 6, 7], np.int32)
        jc = {k: jnp.asarray(v) for k, v in noise.items()}
        tc = _t(noise)
        kw["pos"] = 11
    if case == "positions":
        kw["positions"] = np.arange(12)[None] + 3
    jkw = {k: (jnp.asarray(v) if k == "positions" else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if k == "positions" else v)
           for k, v in kw.items()}
    jo, _ = jattn.gqa_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            cfg, cache=jc, **jkw)
    to, _ = tattn.gqa_apply(_t(p), torch.from_numpy(x), cfg, cache=tc,
                            **tkw)
    np.testing.assert_allclose(lp.np32(to), lp.np32(jo), **BLOCK_TOL)
    assert flash_spy["flash"] == []


def test_flash_rule():
    assert tattn.takes_flash("causal", None, 7, 32, 32)
    assert not tattn.takes_flash("causal", None, 1, 32, 32)       # decode
    assert not tattn.takes_flash("local", None, 7, 32, 32)
    assert not tattn.takes_flash("bidir", None, 7, 32, 32)
    assert not tattn.takes_flash("causal", torch.arange(7), 7, 32, 32)
    assert not tattn.takes_flash("causal", None, 7, 48, 32)       # MLA
    assert not tattn.takes_flash("causal", None, 7, 32, 32,
                                 positions=torch.arange(7))


#: FlashAttentionFn's gradients against autograd through ``plain`` on the
#: same operands: float32 within the last bits of the same float32 sums;
#: bf16 within 1e-2 of the largest gradient (both compute in float32 and
#: round to bf16 once, after sums in another order)
FN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
          torch.bfloat16: 1e-2}


def _through_plain(monkeypatch):
    """ops.flash_attention replaced by autograd through the plain
    version."""
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw:
                        fa.plain(q, k, v, causal=kw["causal"],
                                 q_offset=kw["q_offset"]))


def _grad_case(dtype, groups, s, seed=7):
    rng = np.random.default_rng(seed)
    shapes = ((2, s, 4, 32), (2, s, 4 // groups, 32), (2, s, 4 // groups,
                                                       32), (2, s, 4, 32))
    q, k, v, w = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in shapes)
    return [t.to(dtype).requires_grad_() for t in (q, k, v)], w


def _flash_grads(attn, dtype, groups, s):
    (q, k, v), w = _grad_case(dtype, groups, s)
    out = attn(q, k, v)
    (out.float() * w).sum().backward()
    return out, [t.grad for t in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("s", [32, 64], ids=["pads_32_to_64", "no_pad"])
def test_flash_function_gradients_match_autograd_through_plain(
        dtype, groups, s, monkeypatch):
    """Through ``attention.flash`` (q padded to 64 rows and sliced back,
    kv heads ``repeat_interleave``d, casts): the Function's backward gives
    what autograd through plain gives, and in float32 what autograd
    through the grouped plain path (JAX's math) gives, so kv head n // g
    sums its g query heads' gradients."""
    before = fa.flash_attention.backward_calls
    out, got = _flash_grads(lambda q, k, v: tattn.flash(q, k, v, 0),
                            dtype, groups, s)
    assert fa.flash_attention.backward_calls == before + 1
    with monkeypatch.context() as m:
        _through_plain(m)
        _, want = _flash_grads(lambda q, k, v: tattn.flash(q, k, v, 0),
                               dtype, groups, s)
    refs = [want]
    if dtype == torch.float32:
        refs.append(_flash_grads(lambda q, k, v: tattn.attend(
            q, k, v, "causal"), dtype, groups, s)[1])
    for ref in refs:
        for g, r in zip(got, ref):
            assert g.dtype == dtype and g.shape == r.shape
            if dtype == torch.float32:
                np.testing.assert_allclose(g.numpy(), r.numpy(),
                                           **FN_TOL[dtype])
            else:
                np.testing.assert_allclose(
                    g.float().numpy(), r.float().numpy(), rtol=0,
                    atol=FN_TOL[dtype] * float(r.float().abs().max()))


def test_flash_function_padded_rows_get_zero_gradient():
    """q rows past the real 13 (the padding ``flash`` adds) get no output
    gradient, so they get no gradient either, and the keys only they see
    (positions 13..63) get none."""
    (q, k, v), _ = _grad_case(torch.float32, 1, 64)
    qh, kh, vh = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = ops.flash_attention(qh, kh, vh, causal=True, q_offset=0)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    do[:, :, 13:] = 0
    out.backward(do)
    for t in (qh, kh, vh):
        assert torch.count_nonzero(t.grad[:, :, 13:]) == 0
        assert torch.count_nonzero(t.grad[:, :, :13]) > 0


@pytest.mark.parametrize("which", ["q", "k", "v", "none", "no_grad"])
def test_flash_grad_fn_is_the_function_whenever_grad_is_needed(which):
    qkv = [torch.randn(1, 2, 64, 32) for _ in range(3)]
    if which in "qkv":
        qkv["qkv".index(which)].requires_grad_()
    if which == "no_grad":
        qkv[0].requires_grad_()
        with torch.no_grad():
            out = ops.flash_attention(*qkv, causal=True, q_offset=0)
    else:
        out = ops.flash_attention(*qkv, causal=True, q_offset=0)
    name = type(out.grad_fn).__name__ if out.grad_fn is not None else None
    assert name == ("FlashAttentionFnBackward" if which in "qkv" else None)


def test_mla_and_cross_stay_off_the_kernel(flash_spy):
    """MLA (v dim differs from its qk dim) and cross attention match JAX
    on the plain path."""
    cfg = lp.configs("deepseek-v3-671b", "float32")[1]
    p = _block(jattn.mla_recs(cfg))
    x = _x((2, 9, cfg.d_model))
    jo, _ = jattn.mla_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            cfg)
    to, _ = tattn.mla_apply(_t(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(lp.np32(to), lp.np32(jo), **BLOCK_TOL)
    wcfg = lp.configs("whisper-small", "float32")[1]
    pc = _block(jattn.cross_recs(wcfg))
    enc = _x((2, 16, wcfg.d_model), 4)
    xj, xt = jnp.asarray(x[:, :, :wcfg.d_model]), torch.from_numpy(
        x[:, :, :wcfg.d_model].copy())
    jpc = jax.tree.map(jnp.asarray, pc)
    jo = jattn.cross_apply(jpc, xj, jattn.encode_kv(jpc, jnp.asarray(enc)),
                           wcfg)
    tpc = _t(pc)
    to = tattn.cross_apply(tpc, xt, tattn.encode_kv(
        tpc, torch.from_numpy(enc)), wcfg)
    np.testing.assert_allclose(lp.np32(to), lp.np32(jo), **BLOCK_TOL)
    assert flash_spy["flash"] == []


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
def _moe(arch, **moe_kw):
    cfg = lp.configs(arch, "float32")[1]
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    jcfg = dataclasses.replace(lp.configs(arch, "float32")[0],
                               moe=jmoe.MoEConfig(**dataclasses.asdict(
                                   cfg.moe)))
    return cfg, jcfg, _block(jmoe.moe_recs(jcfg))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_matches_jax_and_dispatches_agree(arch):
    cfg, jcfg, p = _moe(arch)
    x = _x((2, 16, cfg.d_model))
    want = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp, xt = _t(p), torch.from_numpy(x)
    scatter = tmoe.moe_apply(tp, xt, cfg, dispatch="scatter")
    einsum = tmoe.moe_apply(tp, xt, cfg, dispatch="einsum")
    np.testing.assert_allclose(lp.np32(scatter), lp.np32(want), **BLOCK_TOL)
    np.testing.assert_allclose(lp.np32(einsum), lp.np32(scatter),
                               rtol=2e-3, atol=2e-3)


def test_moe_capacity_drops_the_same_tokens_as_jax():
    """capacity_factor 0.25: both dispatches drop the same pairs, and
    JAX drops them too."""
    cfg, jcfg, p = _moe("deepseek-v3-671b", capacity_factor=0.25)
    x = _x((2, 32, cfg.d_model), 2)
    want = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp, xt = _t(p), torch.from_numpy(x)
    scatter = tmoe.moe_apply(tp, xt, cfg)
    einsum = tmoe.moe_apply(tp, xt, cfg, dispatch="einsum")
    full = tmoe.moe_apply(tp, xt, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0)))
    np.testing.assert_allclose(lp.np32(scatter), lp.np32(want), **BLOCK_TOL)
    np.testing.assert_allclose(lp.np32(einsum), lp.np32(scatter),
                               rtol=2e-3, atol=2e-3)
    assert np.abs(lp.np32(full) - lp.np32(scatter)).max() > 1e-2


def test_moe_group_local_matches_global():
    """Four groups with ample capacity == one group; both packages take
    the groups from ``rule['moe_groups']``."""
    cfg, jcfg, p = _moe("deepseek-v3-671b", capacity_factor=8.0)
    x = _x((4, 16, cfg.d_model), 5)
    tp, xt = _t(p), torch.from_numpy(x)
    o1 = tmoe.moe_apply(tp, xt, cfg)
    o4 = tmoe.moe_apply(tp, xt, cfg, rule={"moe_groups": 4})
    j4 = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                        rule={"moe_groups": 4})
    np.testing.assert_allclose(lp.np32(o4), lp.np32(o1), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(lp.np32(o4), lp.np32(j4), **BLOCK_TOL)


def test_router_sigmoid_bias_selection_only():
    """The bias shifts selection; the combine weights renormalize over
    the selected set (as JAX's ``_route``)."""
    cfg, jcfg, p = _moe("deepseek-v3-671b")
    xt = torch.from_numpy(_x((8, cfg.d_model), 3))
    tp = _t(p)
    w, khot, idx = tmoe._route(tp, xt, cfg.moe)
    jw, _, _ = jmoe._route(jax.tree.map(jnp.asarray, p), jnp.asarray(
        xt.numpy()), jcfg.moe)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    assert int(khot.sum(1).min()) == cfg.moe.top_k
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-4)
    tp2 = dict(tp, router_bias=tp["router_bias"].clone())
    tp2["router_bias"][0] = 100.0
    _, khot2, _ = tmoe._route(tp2, xt, cfg.moe)
    assert bool((khot2[:, 0] > 0).all())


def test_load_balance_stats_match_jax():
    cfg, jcfg, p = _moe("deepseek-v3-671b")
    x = _x((2, 16, cfg.d_model), 4)
    ours = tmoe.load_balance_stats(_t(p), torch.from_numpy(x), cfg)
    theirs = jmoe.load_balance_stats(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jcfg)
    for k in ("router_entropy", "max_load"):
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]),
                                   rtol=1e-5)
    assert float(ours["router_entropy"]) > 0
    assert float(ours["max_load"]) >= 1.0


# ----------------------------------------------------------------------
# Mamba-2
# ----------------------------------------------------------------------
def test_mamba2_chunked_scan_and_recurrence_match_jax():
    """Three chunks of 16 through the SSD scan into a cache, then one
    recurrent step, against JAX; the conv window stays bf16 as
    ``mamba2_cache_shape`` says while the activations are bf16."""
    cfg = lp.configs("mamba2-2.7b", "float32")[1]
    p = _block(jmamba.mamba2_recs(cfg))
    x = _x((2, 49, cfg.d_model), 6)
    shapes = tmamba.mamba2_cache_shape(cfg, 2)
    assert shapes["ssm"][1] == torch.float32
    assert shapes["conv"][1] == torch.bfloat16
    jshapes = jmamba.mamba2_cache_shape(cfg, 2)
    assert {k: v[0] for k, v in shapes.items()} == \
        {k: v[0] for k, v in jshapes.items()}
    jc = {k: jnp.zeros(v[0], v[1]) for k, v in jshapes.items()}
    tc = {k: torch.zeros(v[0], dtype=v[1]) for k, v in shapes.items()}
    jp, tp = jax.tree.map(jnp.asarray, p), _t(p)
    jo, jc = jmamba.mamba2_apply(jp, jnp.asarray(x[:, :48]), cfg, cache=jc,
                                 pos=0)
    to, tc = tmamba.mamba2_apply(tp, torch.from_numpy(x[:, :48].copy()), cfg,
                                 cache=tc, pos=0)
    np.testing.assert_allclose(lp.np32(to), lp.np32(jo), **BLOCK_TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(lp.np32(tc[k]), lp.np32(jc[k]),
                                   **BLOCK_TOL)
    jo, _ = jmamba.mamba2_apply(jp, jnp.asarray(x[:, 48:]), cfg, cache=jc,
                                pos=48)
    to, _ = tmamba.mamba2_apply(tp, torch.from_numpy(x[:, 48:].copy()), cfg,
                                cache=tc, pos=48)
    np.testing.assert_allclose(lp.np32(to), lp.np32(jo), **BLOCK_TOL)
    with pytest.raises(AssertionError):
        tmamba.mamba2_apply(tp, torch.zeros(1, 40, cfg.d_model), cfg)


# ----------------------------------------------------------------------
# Norms and RoPE
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_jax(dtype):
    x = _x((2, 5, 64), 7)
    g, bta = _x((64,), 8) * 0.1, _x((64,), 9) * 0.1
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(tcommon.dtype_of(dtype))
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        lp.np32(tcommon.rms_norm(tx, torch.from_numpy(g))),
        lp.np32(jcommon.rms_norm(jx, jnp.asarray(g))), **tol)
    np.testing.assert_allclose(
        lp.np32(tcommon.layer_norm(tx, torch.from_numpy(g),
                                   torch.from_numpy(bta))),
        lp.np32(jcommon.layer_norm(jx, jnp.asarray(g), jnp.asarray(bta))),
        **tol)
    q = _x((2, 5, 4, 32), 10)
    pos = np.arange(5)[None] + 7
    np.testing.assert_allclose(
        lp.np32(tcommon.rope(torch.from_numpy(q).to(tx.dtype),
                             torch.from_numpy(pos), 1e6)),
        lp.np32(jcommon.rope(jnp.asarray(q).astype(dtype), jnp.asarray(pos),
                             1e6)), **tol)
