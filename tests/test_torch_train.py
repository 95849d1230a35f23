"""The port's loss against the JAX package's: ``loss_fn``'s loss,
metrics and the gradient of every parameter leaf against
``jax.value_and_grad`` on six reduced configs (granite-8b on the flash
path, deepseek-v3's MLA, MoE and MTP, llama4's local attention and MoE,
Mamba-2, Zamba2's shared block, whisper's encoder-decoder), and
granite's under a sharding rule on one process.  The step itself, remat and the launcher:
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

jax = pytest.importorskip("jax")

from repro.train import step as jstep  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

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
