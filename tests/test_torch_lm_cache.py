"""Prefill and decode on the port against the JAX package's, caches
included, for every family (counterpart of
``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``):
llama4's ring buffer (a prefill longer than the window, and decode steps
that wrap it), deepseek's MLA with the absorbed decode, zamba2's shared
block, whisper's cross attention, pixtral's patch embeddings and the
Mamba-2 chunked scan with its one-step recurrence.

JAX's cache tree goes across with ``convert.lm_caches`` where a test
starts from one; the port's caches after each call are held against
JAX's leaf for leaf.  float32 throughout, at ``F32_TOL`` for logits
and ``CACHE_ATOL``/``CACHE_RTOL`` for cache values.  The last test holds
the port to itself in the configs' own types: prefill + decode ==
forward, as the JAX test does.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.serve.engine import make_caches as j_make_caches  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.serve.engine import make_caches  # noqa: E402

import _lm_parity as lp  # noqa: E402

ARCHS = jconfigs.ARCH_IDS
MAX_LEN = 64


#: cache leaves: k and v grow with the residual stream (to 11 in the
#: llama4 cases), and the 95-token llama4 prefill carries the sharp
#: softmax's f32 differences (F32_TOL) through three layers into its
#: last ring (3.9e-3 at most): 5e-3 plus 1e-3 of the value
CACHE_ATOL, CACHE_RTOL = 5e-3, 1e-3
#: the port against itself in bf16: decode after prefill against the full
#: forward's last logits
BF16_SELF_TOL = 0.25


def _same_caches(tcaches, jcaches):
    """Every cache leaf within CACHE_ATOL + CACHE_RTOL (ring positions
    exactly)."""
    got = common.leaves(tcaches)
    want = jax.tree.leaves(jcaches)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))
        else:
            np.testing.assert_allclose(lp.np32(g), lp.np32(w),
                                       rtol=CACHE_RTOL, atol=CACHE_ATOL)


def _run_both(p, jb, tb, n_prompt: int, steps: int, max_len: int = MAX_LEN):
    """Prefill ``n_prompt`` tokens, then ``steps`` decode steps, in both
    packages; logits and caches held together after every call."""
    b = jb["tokens"].shape[0]
    jc = j_make_caches(p.jmodel, b, max_len)
    tc = convert.lm_caches(jax.tree.map(np.asarray, jc), p.tcfg, b, max_len,
                           "cpu")
    jl, jc = p.jmodel.prefill(p.jparams,
                              dict(jb, tokens=jb["tokens"][:, :n_prompt]), jc)
    tl, tc = p.tmodel.prefill(p.tparams,
                              dict(tb, tokens=tb["tokens"][:, :n_prompt]), tc)
    np.testing.assert_allclose(lp.np32(tl), lp.np32(jl), rtol=0,
                               atol=lp.F32_TOL)
    _same_caches(tc, jc)
    for i in range(n_prompt, n_prompt + steps):
        jl, jc = p.jmodel.decode_step(p.jparams, jc,
                                      jb["tokens"][:, i:i + 1], jnp.int32(i))
        tl, tc = p.tmodel.decode_step(p.tparams, tc,
                                      tb["tokens"][:, i:i + 1], i)
        np.testing.assert_allclose(lp.np32(tl), lp.np32(jl), rtol=0,
                                   atol=lp.F32_TOL)
        _same_caches(tc, jc)
    return tl


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax(arch):
    p = lp.pair(arch)
    jb, tb = lp.batch(p.jcfg, 2, 16)
    last = _run_both(p, jb, tb, n_prompt=14, steps=2)
    full = lp.np32(p.tmodel.forward(p.tparams, tb))
    np.testing.assert_allclose(lp.np32(last)[:, 0], full[:, -1], rtol=0,
                               atol=lp.F32_TOL)


@pytest.mark.parametrize("n_prompt, steps", [(95, 1), (60, 6)],
                         ids=["prefill_past_window", "decode_wraps_ring"])
def test_llama4_ring_buffer_matches_jax(n_prompt, steps):
    """Window 64: a prefill of 95 tokens keeps the ring's tail (s >= W);
    a prefill of 60 then decodes positions 60..65, writing slots 60..63
    and wrapping to 0 and 1."""
    p = lp.pair("llama4-maverick-400b-a17b")
    jb, tb = lp.batch(p.jcfg, 1, n_prompt + steps)
    last = _run_both(p, jb, tb, n_prompt, steps, max_len=128)
    full = lp.np32(p.tmodel.forward(p.tparams, tb))
    np.testing.assert_allclose(lp.np32(last)[:, 0], full[:, -1], rtol=0,
                               atol=lp.F32_TOL)


def test_mla_absorbed_decode_is_the_expanded_form():
    """deepseek's decode scores the query against the latent (wk_b and
    wv_b absorbed); it agrees with the expanded forward it replaces."""
    p = lp.pair("deepseek-v3-671b", act_dtype=None)   # float32 by config
    jb, tb = lp.batch(p.jcfg, 2, 12)
    caches = make_caches(p.tmodel, 2, MAX_LEN)
    _, caches = p.tmodel.prefill(p.tparams,
                                 dict(tb, tokens=tb["tokens"][:, :11]),
                                 caches)
    lg, _ = p.tmodel.decode_step(p.tparams, caches, tb["tokens"][:, 11:], 11)
    full = lp.np32(p.tmodel.forward(p.tparams, tb))
    np.testing.assert_allclose(lp.np32(lg)[:, 0], full[:, -1], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_forward_in_config_dtype(arch):
    """The port alone in the configs' own types (bf16 parameters and, but
    for deepseek, activations): two decode steps after a prefill give the
    full forward's last logits within BF16_SELF_TOL, and its argmax
    wherever the forward's top-two gap exceeds twice that.  Both attention
    paths score in float32, so the gap is the bf16 rounding of
    activations and caches (0.15 at most, zamba2 and pixtral)."""
    cfg = lp.configs(arch)[1]
    p = lp.pair(arch, param_dtype="bfloat16", act_dtype=None)
    jb, tb = lp.batch(cfg, 2, 16)
    full = lp.np32(p.tmodel.forward(p.tparams, tb))
    caches = make_caches(p.tmodel, 2, MAX_LEN)
    _, caches = p.tmodel.prefill(p.tparams,
                                 dict(tb, tokens=tb["tokens"][:, :14]),
                                 caches)
    for i in (14, 15):
        lg, caches = p.tmodel.decode_step(p.tparams, caches,
                                          tb["tokens"][:, i:i + 1], i)
    lg, want = lp.np32(lg)[:, 0], full[:, -1]
    assert np.abs(lg - want).max() < BF16_SELF_TOL
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * BF16_SELF_TOL
    np.testing.assert_array_equal(lg.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
