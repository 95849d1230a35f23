"""The port's LM forward against ``repro.models.lm.LM.forward`` for every
reduced config: JAX parameters carried across (``convert.lm_params``),
numpy batches from a seed.

- float32 (``act_dtype="float32"``, float32 parameters): logits within
  ``F32_TOL`` (2e-3; ``tests/_lm_parity.py`` says why) and the same
  argmax everywhere.
- The configs' own types (bf16 parameters; bf16 activations except
  deepseek's float32): both packages' logits against JAX's float32
  forward of the same bf16 parameters.  This init's attention scores
  reach the hundreds, where bf16 rounding picks the softmax's winner, so
  JAX's own bf16 logits stand up to 3.4 from its float32 ones (llama4;
  0.07 for mamba2, which has no attention).  The port's bf16 error must
  stay within 1.5x JAX's plus 0.05, and its argmax must equal the float32
  reference's wherever that reference's top-two gap exceeds this bound.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.lm import LM as JLM  # noqa: E402
from repro import configs as jconfigs  # noqa: E402

import _lm_parity as lp  # noqa: E402

ARCHS = jconfigs.ARCH_IDS
B, S = 2, 32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_matches_jax(arch):
    p = lp.pair(arch)
    jb, tb = lp.batch(p.jcfg, B, S)
    want = lp.np32(p.jmodel.forward(p.jparams, jb))
    got = lp.np32(p.tmodel.forward(p.tparams, tb))
    assert got.shape == (B, S, p.tmodel.padded_vocab)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=lp.F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_config_dtype_within_jax_bf16_error(arch):
    p = lp.pair(arch, param_dtype="bfloat16", act_dtype=None)
    jb, tb = lp.batch(p.jcfg, B, S)
    cfg32 = dataclasses.replace(p.jcfg, act_dtype="float32")
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, p.jparams)
    ref = lp.np32(JLM(cfg32).forward(params32, jb))
    theirs = lp.np32(p.jmodel.forward(p.jparams, jb))
    ours = lp.np32(p.tmodel.forward(p.tparams, tb))
    assert np.isfinite(ours).all()
    bound = 1.5 * np.abs(theirs - ref).max() + 0.05
    assert np.abs(ours - ref).max() <= bound
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > bound
    np.testing.assert_array_equal(ours.argmax(-1)[clear],
                                  ref.argmax(-1)[clear])


def test_forward_return_hidden_and_mtp_head_match_jax():
    """deepseek's multi-token-prediction head on the final hidden states
    (MLA, float32)."""
    p = lp.pair("deepseek-v3-671b")
    jb, tb = lp.batch(p.jcfg, B, 16)
    jl, jh = p.jmodel.forward(p.jparams, jb, return_hidden=True)
    tl, th = p.tmodel.forward(p.tparams, tb, return_hidden=True)
    np.testing.assert_allclose(lp.np32(th), lp.np32(jh), rtol=0,
                               atol=lp.F32_TOL)
    nxt = np.roll(np.asarray(jb["tokens"]), -1, axis=1)
    want = lp.np32(p.jmodel.mtp_forward(p.jparams, jh, jnp.asarray(nxt)))
    got = lp.np32(p.tmodel.mtp_forward(
        p.tparams, th, tb["tokens"].roll(-1, dims=1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=lp.F32_TOL)


def test_vocab_padding_is_masked():
    """A vocab that is not a multiple of 128 pads the embedding; the
    padded logits are -2^30, as JAX's ``_head`` sets them."""
    p = lp.pair("granite-8b", vocab=500)
    jb, tb = lp.batch(p.jcfg, 1, 8)
    got = lp.np32(p.tmodel.forward(p.tparams, tb))
    want = lp.np32(p.jmodel.forward(p.jparams, jb))
    assert got.shape[-1] == 512
    assert (got[..., 500:] == -2.0 ** 30).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=lp.F32_TOL)
