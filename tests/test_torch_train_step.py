"""The port's training step against the JAX package's: one
``make_train_step`` step with 1 and 2 microbatches, microbatches against
one batch, remat on against off, remat refused with caches, and
``python -m repro_torch.launch.train --device cpu``.  The gradients of
``loss_fn`` against JAX's: ``tests/test_torch_train.py``.

Tolerances: the metrics within ``_lm_parity.LOSS_RTOL`` (2e-6 relative;
the grad norm within ``GRAD_TOL``, 3e-3), the moments within
``GRAD_TOL`` of each leaf's largest entry, and the parameters after one
AdamW step within rtol 1e-5 and 1e-3·lr wherever JAX's gradient is above
``SIGNED`` of its leaf's largest entry, and within 2·lr elsewhere: Adam's
first update is ±lr·g/(|g| + eps), so an entry whose gradient lies within
the float32 noise of zero may step either way, and every other entry
steps as JAX's does (its update's sign and size; 2.4e-7 apart at most,
the last bit of a parameter of about 2).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import optim as toptim  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.common import leaves, tmap  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

import _lm_parity as lp  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
#: gradients above this share of their leaf's largest entry are clear of
#: the float32 noise (GRAD_TOL at worst, 1e-4 on granite)
SIGNED = 1e-3


@pytest.mark.parametrize("k", [1, 2])
def test_one_train_step_matches_jax(k):
    p = lp.pair("granite-8b")
    jb, tb = lp.train_batch(p.jcfg, b=4)
    lr = 1e-3
    jt = jstep.TrainConfig(opt=joptim.OptConfig(lr=lr), microbatches=k,
                           warmup_steps=1, total_steps=10)
    tt = tstep.TrainConfig(opt=toptim.OptConfig(lr=lr), microbatches=k,
                           warmup_steps=1, total_steps=10)
    jp, jo, jm = jax.jit(jstep.make_train_step(p.jmodel, jt))(
        p.jparams, joptim.adamw_init(p.jparams, jt.opt), jb, jnp.int32(5))
    tp = tmap(lambda t: t.clone(), p.tparams)
    tp, to, tm = tstep.make_train_step(p.tmodel, tt)(
        tp, toptim.adamw_init(tp, tt.opt), tb, 5)
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=lp.LOSS_RTOL if name != "grad_norm"
                                   else lp.GRAD_TOL)
    step_lr = float(jm["lr"])
    # after one step m = (1 - b1) times the clipped gradient
    for a, b, g in zip(jax.tree.leaves(jp), leaves(tp),
                       jax.tree.leaves(jo["m"])):
        a, b, g = lp.np32(a), lp.np32(b), np.abs(lp.np32(g))
        signed = g > SIGNED * g.max()
        assert signed.mean() > 0.1
        np.testing.assert_allclose(b[signed], a[signed], rtol=1e-5,
                                   atol=1e-3 * step_lr)
        np.testing.assert_allclose(b[~signed], a[~signed], rtol=1e-5,
                                   atol=2 * step_lr)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jo[key]), leaves(to[key])):
            lp.leaf_close(a, b, lp.GRAD_TOL)
    for a, b in zip(leaves(tp), leaves(to["master"])):
        np.testing.assert_array_equal(lp.np32(a), lp.np32(b))
    assert int(to["step"]) == 1


def test_microbatches_accumulate_like_one_batch():
    """k = 1 and k = 4 give the same loss and, after one step, the same
    parameters within the accumulation order's noise (JAX's
    ``test_microbatch_equivalence``), in bf16."""
    p = lp.pair("granite-8b", param_dtype="bfloat16", act_dtype=None)
    _, tb = lp.train_batch(p.jcfg, b=8, s=32)
    out = []
    for k in (1, 4):
        tcfg = tstep.TrainConfig(opt=toptim.OptConfig(lr=1e-2),
                                 microbatches=k, warmup_steps=1,
                                 total_steps=10)
        params = tmap(lambda t: t.clone(), p.tparams)
        params, _, m = tstep.make_train_step(p.tmodel, tcfg)(
            params, toptim.adamw_init(params, tcfg.opt), tb, 5)
        out.append((params, float(m["loss"])))
    assert abs(out[0][1] - out[1][1]) / abs(out[0][1]) < 1e-2
    flat = [torch.cat([t.float().ravel() for t in leaves(o[0])])
            for o in out]
    np.testing.assert_allclose(flat[1].numpy(), flat[0].numpy(), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b"])
def test_remat_on_equals_remat_off(arch):
    p = lp.pair(arch)
    _, tb = lp.train_batch(p.jcfg)
    on = lp.port_grads(p.tmodel, p.tparams, tb, remat=True)
    off = lp.port_grads(p.tmodel, p.tparams, tb, remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[2], off[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_refuses_caches():
    from repro_torch.serve import make_caches
    p = lp.pair("granite-8b")
    _, tb = lp.train_batch(p.jcfg)
    caches = make_caches(p.tmodel, 2, 32)
    x = p.tmodel._embed(p.tparams, tb["tokens"], tb)
    with pytest.raises(ValueError, match="remat"):
        p.tmodel._run_stages(p.tparams, x, caches=caches, pos=0, remat=True)


def test_padded_vocab_fill_trains_as_jax():
    """The head's in-place fill of the padded vocab entries (vocab 500
    padded to 512) under autograd: the loss and every gradient are
    JAX's, and the padded rows of the embedding get none."""
    p = lp.pair("granite-8b", vocab=500)
    jb, tb = lp.train_batch(p.jcfg)
    (jl, _), jg = jax.value_and_grad(
        lambda pp: jstep.loss_fn(p.jmodel, pp, jb), has_aux=True)(p.jparams)
    tl, _, tg = lp.port_grads(p.tmodel, p.tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=lp.LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(jg), tg):
        lp.leaf_close(a, b, lp.GRAD_TOL)
    embed = tg[0]
    assert p.tmodel.padded_vocab == 512 and embed.shape[0] == 512
    assert torch.count_nonzero(embed[500:]) == 0


def test_launcher_runs_on_the_cpu(capsys):
    assert launch_train.main(["--device", "cpu", "--steps", "3",
                              "--batch", "4", "--seq", "32"]) == 0
    out = capsys.readouterr().out
    assert "[train] granite-8b reduced on cpu: step 3" in out


def test_launcher_module_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "4", "--seq", "32", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "2", "--quantize-opt"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "step 3" in res.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
