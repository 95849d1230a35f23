"""The port's serving engine and launcher (counterparts of
``tests/test_serve.py``): greedy generation against the JAX engine's
tokens and against the teacher-forced forward, the bucketed request
driver, sampling under a ``torch.Generator``, and
``python -m repro_torch.launch.serve --device cpu``."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serve import Engine as JEngine  # noqa: E402

from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.common import materialize  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import BatchedServer, Engine, Request  # noqa: E402

import _lm_parity as lp  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-8b in float32, JAX's parameters in both packages."""
    return lp.pair("granite-8b")


@pytest.mark.parametrize("arch", ["granite-8b", "pixtral-12b",
                                  "whisper-small",
                                  "llama4-maverick-400b-a17b"])
def test_greedy_generate_matches_jax_engine(arch, granite):
    """float32, JAX's parameters: the same tokens as JAX's engine, with
    pixtral's patch embeddings and whisper's frames passed as extras,
    and llama4's local layers on ring buffers (window 64 < max_len)."""
    p = granite if arch == "granite-8b" else lp.pair(arch)
    jb, tb = lp.batch(p.jcfg, 2, 10)
    jx = {k: v for k, v in jb.items() if k != "tokens"}
    tx = {k: v for k, v in tb.items() if k != "tokens"}
    max_len = 128 if p.jcfg.local_window else 64
    want = JEngine(p.jmodel, p.jparams, max_len=max_len).generate(
        jb["tokens"], 6, extras=jx)
    got = Engine(p.tmodel, p.tparams, max_len=max_len).generate(
        tb["tokens"], 6, extras=tx)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_matches_teacher_forced_forward(granite):
    """Each generated token is the argmax of the full forward over the
    prompt and the tokens generated before it."""
    p = granite
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, p.tcfg.vocab, (2, 8)))
    gen = Engine(p.tmodel, p.tparams, max_len=64).generate(toks, 5)
    logits = p.tmodel.forward(p.tparams, {"tokens": torch.cat([toks, gen],
                                                              dim=1)})
    for i in range(5):
        assert torch.equal(logits[:, 8 + i - 1].argmax(-1), gen[:, i])


def test_serving_a_trainers_params_builds_no_graph(granite):
    """Parameters that require grad (a trainer's) serve the tokens their
    detached copies serve, and neither prefill, decode nor generate
    records a graph: the logits have no ``grad_fn``."""
    from repro_torch.models.common import tmap
    from repro_torch.serve import make_caches
    p = granite
    live = tmap(lambda t: t.detach().clone().requires_grad_(), p.tparams)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, p.tcfg.vocab, (2, 9)))
    eng = Engine(p.tmodel, live, max_len=64)
    logits, caches = eng.prefill({"tokens": toks},
                                 make_caches(p.tmodel, 2, 64))
    assert logits.grad_fn is None
    logits, _ = eng.decode(caches, logits[:, -1].argmax(-1)[:, None], 9)
    assert logits.grad_fn is None and not logits.requires_grad
    got = eng.generate(toks, 5)
    want = Engine(p.tmodel, p.tparams, max_len=64).generate(toks, 5)
    assert torch.equal(got, want)


def test_batched_server_buckets_and_left_pads(granite):
    p = granite
    eng = Engine(p.tmodel, p.tparams, max_len=64)
    srv = BatchedServer(eng, batch_size=3)
    reqs = [Request(uid=i, tokens=[1 + i, 2, 3][: 1 + i % 3], max_new=4)
            for i in range(7)]
    for r in reqs:
        srv.submit(r)
    done = srv.drain()
    assert [r.uid for r in done] == list(range(7))
    assert all(r.done and len(r.result) == 4 for r in done)
    assert srv._served == [3, 3, 1]
    # the first bucket's shortest prompt was left-padded with token 0
    alone = eng.generate(torch.tensor([[0, 0, 1]]), 4)
    assert done[0].result == alone[0].tolist()


def test_sampling_is_reproducible_and_skips_padded_vocab():
    """Above temperature 0 the caller's generator decides: the same seed
    gives the same tokens, and a vocab padded to 512 is never sampled
    past its 500 real entries (their logits are -2^30)."""
    cfg = dataclasses.replace(lp.configs("granite-8b")[1], vocab=500)
    model = LM(cfg)
    params = materialize(model.param_recs(), torch.Generator().manual_seed(0))
    eng = Engine(model, params, max_len=64)
    toks = torch.zeros(4, 4, dtype=torch.long)

    def run(seed):
        return eng.generate(toks, 24, temperature=5.0,
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(torch.cat([a, c]).max()) < 500
    assert len(torch.unique(a)) > 20          # the temperature spreads it


def test_engine_states_the_kv_block_and_the_length(granite):
    """Any max_len serves, as in JAX: at 100 (not a multiple of the
    kernel's kv block of 64) a prompt of 70 reaches past the cache when
    rounded to 128 kv rows, and the tokens are JAX's all the same.  A
    prompt and its new tokens must fit the cache."""
    p = granite
    toks = np.random.default_rng(4).integers(0, p.tcfg.vocab, (2, 70))
    want = JEngine(p.jmodel, p.jparams, max_len=100).generate(
        jnp.asarray(toks, dtype=jnp.int32), 6)
    got = Engine(p.tmodel, p.tparams, max_len=100).generate(
        torch.from_numpy(toks), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = lp.configs("granite-8b")[1]
    model = LM(cfg)
    params = materialize(model.param_recs(), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="exceed max_len=64"):
        Engine(model, params, max_len=64).generate(
            torch.zeros(1, 60, dtype=torch.long), 5)


def test_launcher_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "5",
                              "--max-new", "3", "--batch-size", "2"]) == 0
    out = capsys.readouterr().out
    assert "5 requests, 15 tokens" in out and "batches=[2, 2, 1]" in out


def test_launcher_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "mamba2-2.7b", "--requests", "3", "--max-new", "2",
         "--seed", "3"], capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] mamba2-2.7b (reduced) on cpu: 3 requests" in proc.stdout


def test_entry_points_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--requests", "1"])
