"""The port's loss against the JAX package's: ``loss_fn``'s loss,
metrics and the gradient of every parameter leaf against
``jax.value_and_grad`` on six reduced configs (granite-8b on the flash
path, deepseek-v3's MLA, MoE and MTP, llama4's local attention and MoE,
Mamba-2, Zamba2's shared block, whisper's encoder-decoder), granite's
under a sharding rule on one process, and ``_xent`` alone (bf16 and
float32 logits, z-loss on and off, padded vocab columns, the labels on
the first and the last real column, whole and in chunks of rows).  The step itself, remat and the launcher:
``tests/test_torch_train_step.py``.

JAX's float32 parameters are carried across by ``convert.lm_params`` and
the batches made once with numpy from a seed.  Tolerances
(``_lm_parity.GRAD_TOL``, ``LOSS_RTOL``): each leaf's gradient within
3e-3 of that leaf's largest entry (the attention scores of this init
reach the hundreds, and the softmax amplifies last-bit differences of
XLA's and torch's matmuls: 1.1e-3 seen, on llama4; most configs 1e-4 or
less); the loss and its metrics within 2e-6 relative.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.train import step as jstep  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train import xent  # noqa: E402

import _lm_parity as lp  # noqa: E402

ARCHS = ["granite-8b", "deepseek-v3-671b", "llama4-maverick-400b-a17b",
         "mamba2-2.7b", "zamba2-7b", "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    p = lp.pair(arch)
    jb, tb = lp.train_batch(p.jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda pp: jstep.loss_fn(p.jmodel, pp, jb, remat=True),
        has_aux=True))(p.jparams)
    before = fa.flash_attention.backward_calls
    tl, tm, tg = lp.port_grads(p.tmodel, p.tparams, tb)
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(tm[name].detach()),
                                   float(jm[name]), rtol=lp.LOSS_RTOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        lp.leaf_close(a, b, lp.GRAD_TOL)
    # causal GQA's gradient went through the flash Function's backward,
    # once a layer
    if arch == "granite-8b":
        assert fa.flash_attention.backward_calls - before == \
            p.tcfg.n_layers
        assert all(float(g.abs().max()) > 0 for g in tg)


def test_sharding_rule_waits_for_distribution():
    """Named when the port refused a rule; the rule now threads through.
    On one process (plain tensors, no mesh) the port's constraints change
    nothing, and the loss and every gradient under ``rule_for(granite,
    train_4k)`` equal JAX's under the same rule on a (1, 1) mesh; the
    sharded step itself: ``tests/test_torch_dist.py``."""
    from repro.launch import cell as jcell
    from repro.launch import mesh as jmesh
    from repro_torch.launch import cell as tcell
    p = lp.pair("granite-8b")
    jb, tb = lp.train_batch(p.jcfg)
    jrule = jcell.rule_for(p.jcfg, jcell.configs.SHAPES["train_4k"], False)
    trule = tcell.rule_for(p.tcfg, tcell.configs.SHAPES["train_4k"], False)
    assert trule == jrule
    with jmesh.make_local_mesh(1, 1):
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda pp: jstep.loss_fn(p.jmodel, pp, jb, rule=jrule,
                                     remat=True), has_aux=True))(p.jparams)
    tl, tm, tg = lp.port_grads(p.tmodel, p.tparams, tb, rule=trule)
    np.testing.assert_allclose(float(tl), float(jl), rtol=lp.LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(jg), tg):
        lp.leaf_close(a, b, lp.GRAD_TOL)
    assert callable(tstep.make_train_step(p.tmodel, tstep.TrainConfig(),
                                          rule=trule))


#: ``_xent``'s own inputs: (b, s, V) logits whose last PAD columns are the
#: head's padded vocab (-2**30), from one seed
XENT_SHAPE, PAD = (3, 9, 260), 4


@pytest.mark.parametrize("cut", [0, 1])
@pytest.mark.parametrize("chunk_rows", [None, 2])
@pytest.mark.parametrize("pad", [0, PAD])
@pytest.mark.parametrize("z_coef", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_matches_jax(dtype, z_coef, pad, chunk_rows, cut,
                          monkeypatch):
    """``_xent`` (the port's chunked cross-entropy, :mod:`.xent`) against
    JAX's on the same logits in their own type: both means within
    ``LOSS_RTOL`` and the logits' gradient, in that type, within
    ``GRAD_TOL`` of its largest entry; whole or in chunks of
    ``chunk_rows`` rows, so that a row of the batch takes several.  With
    ``cut`` = 1 the port takes the whole logits and the labels of all but
    the last position, as ``loss_fn`` calls it, and JAX the logits'
    ``[:, :-1]``: the last position's gradient is 0 in both."""
    import jax.numpy as jnp
    if chunk_rows is not None:
        monkeypatch.setattr(xent, "CHUNK_BYTES",
                            chunk_rows * 4 * XENT_SHAPE[-1])
    rng = np.random.default_rng(7)
    lg = (rng.standard_normal(XENT_SHAPE) * 4).astype(np.float32)
    real = XENT_SHAPE[-1] - pad
    lg[..., real:] = -2.0 ** 30
    labels = rng.integers(0, real, XENT_SHAPE[:2])
    n = XENT_SHAPE[1] - cut
    labels[0, 0], labels[-1, n - 1] = 0, real - 1
    jl = jnp.asarray(lg).astype(dtype)

    def jloss(x):
        return jstep._xent(x[:, :n], jnp.asarray(labels[:, :n]), z_coef)
    jce, jz = jloss(jl)
    jg = jax.grad(lambda x: sum(jloss(x)))(jl)
    tl = torch.from_numpy(lg).to(getattr(torch, dtype)).requires_grad_()
    ce, z = tstep._xent(tl, torch.from_numpy(labels[:, :n]), z_coef)
    (ce + z).backward()
    np.testing.assert_allclose(float(ce.detach()), float(jce),
                               rtol=lp.LOSS_RTOL)
    np.testing.assert_allclose(float(z.detach()), float(jz),
                               rtol=lp.LOSS_RTOL)
    assert tl.grad.dtype == tl.dtype
    lp.leaf_close(jg, tl.grad, lp.GRAD_TOL)
