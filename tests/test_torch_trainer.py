"""The port's Trainer and data pipeline (counterparts of
``tests/test_train.py``'s CPU cases): the loss falls over 15 steps,
checkpoint resume and failure injection replay deterministically, the
int8 optimizer state converges with the fp32 one, the watchdog flags
stragglers, the prefetcher replays, host slices partition the batch,
``SyntheticLM``'s batches are bit-identical to the JAX package's — and
the card's own faults (out of device memory, a kernel that does not
build or launch) are raised, not replayed from a checkpoint.

Every trainer here runs reduced granite-8b on the CPU (``device="cpu"``)
from the default seed.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.kernels._build import KernelError
from repro_torch.models.lm import LM
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.loop import Watchdog


def _setup(**tkw):
    cfg = configs.reduced(configs.get_config("granite-8b"))
    data = SyntheticLM(vocab=cfg.vocab, seq=32, global_batch=8)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), warmup_steps=2,
                       total_steps=100, **tkw)
    return LM(cfg), data, tcfg


def _losses(tr):
    return [m["loss"] for m in tr.metrics_log if "loss" in m]


def test_loss_decreases():
    model, data, tcfg = _setup()
    tr = Trainer(model, data, tcfg, device="cpu")
    tr.run(15)
    losses = _losses(tr)
    assert len(losses) == 15 and losses[-1] < losses[0]
    assert set(tr.metrics_log[0]) >= {"ce", "z_loss", "loss", "grad_norm",
                                      "lr", "step", "dt", "straggler"}


def test_ckpt_resume_and_failure_injection(tmp_path):
    """Crash at step 7 -> restore from step 5 -> replay the deterministic
    data -> finish; the losses from the restart on equal a clean run's."""
    model, data, tcfg = _setup()
    boom = {"armed": True}

    def failure_hook(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    tr = Trainer(model, data, tcfg, ckpt_dir=tmp_path, ckpt_every=5,
                 failure_hook=failure_hook, device="cpu")
    _, _, step = tr.run(10)
    assert step == 10
    events = [m for m in tr.metrics_log if m.get("event") == "restart"]
    assert len(events) == 1 and events[0]["step"] == 5
    tr2 = Trainer(model, data, tcfg, device="cpu")
    tr2.run(10)
    ref = {m["step"]: m["loss"] for m in tr2.metrics_log if "loss" in m}
    for m in tr.metrics_log:
        if "loss" in m and m["step"] >= 5:
            assert abs(m["loss"] - ref[m["step"]]) < 1e-3
    # a new trainer on the same directory resumes at the last step
    tr3 = Trainer(model, data, tcfg, ckpt_dir=tmp_path, device="cpu")
    assert tr3.restore_state()[2] == 10


def test_quantized_opt_state_converges():
    """int8 m/v AdamW trains within noise of fp32 AdamW."""
    finals = {}
    for quant in (False, True):
        model, data, _ = _setup()
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3, quantize_state=quant),
                           warmup_steps=2, total_steps=100)
        tr = Trainer(model, data, tcfg, device="cpu")
        tr.run(15)
        finals[quant] = np.mean(_losses(tr)[-5:])
    assert abs(finals[True] - finals[False]) / finals[False] < 0.12


def test_failure_without_a_checkpoint_dir_restarts_from_the_start():
    """With no checkpoint directory a node failure restarts from step 0
    and fresh parameters, as the loop's ``state is None`` branch intends.
    JAX's ``Trainer.restore_state`` calls ``ckpt.latest_step(None)`` there
    and raises ``TypeError`` (ROADMAP.md Queue 3): shown by the second
    half, which runs the JAX package's loop."""
    model, data, tcfg = _setup()
    boom = {"armed": True}

    def failure_hook(step):
        if step == 2 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    tr = Trainer(model, data, tcfg, failure_hook=failure_hook, device="cpu")
    _, _, step = tr.run(4)
    assert step == 4
    events = [m for m in tr.metrics_log if m.get("event") == "restart"]
    assert len(events) == 1 and events[0]["step"] == 0
    steps = [m["step"] for m in tr.metrics_log if "loss" in m]
    assert steps == [0, 1, 0, 1, 2, 3]

    jtrain = pytest.importorskip("repro.train")
    jdata = pytest.importorskip("repro.data")
    jconfigs = pytest.importorskip("repro.configs")
    from repro.models.lm import LM as JLM
    jcfg = jconfigs.reduced(jconfigs.get_config("granite-8b"))
    boom["armed"] = True
    jtr = jtrain.Trainer(JLM(jcfg), jdata.SyntheticLM(
        vocab=jcfg.vocab, seq=16, global_batch=2), jtrain.TrainConfig(),
        failure_hook=failure_hook)
    with pytest.raises(TypeError):
        jtr.run(4)


@pytest.mark.parametrize("fault", [
    lambda: torch.OutOfMemoryError("CUDA out of memory"),
    lambda: KernelError("flash_attention_wgmma kernel launch failed: "
                        "cudaError_t 700"),
    lambda: RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
    lambda: RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling "
                         "`cublasGemmEx(handle, opa, opb, m, n, k, ...)`")],
    ids=["out_of_memory", "kernel_error", "cuda_error", "cublas_status"])
def test_card_faults_are_raised_not_replayed(tmp_path, fault):
    """All are RuntimeErrors in PyTorch (a sticky CUDA error is a plain
    one where torch has no ``AcceleratorError``); replaying them from a
    checkpoint would turn a card fault into a silent retry."""
    model, data, tcfg = _setup()
    calls = []

    def failure_hook(step):
        calls.append(step)
        if step == 2:
            raise fault()

    tr = Trainer(model, data, tcfg, ckpt_dir=tmp_path, ckpt_every=1,
                 failure_hook=failure_hook, device="cpu")
    with pytest.raises(type(fault())):
        tr.run(4)
    assert calls == [0, 1, 2]
    assert not any(m.get("event") == "restart" for m in tr.metrics_log)


def test_trainer_needs_a_card_unless_given_the_cpu():
    model, data, tcfg = _setup()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, data, tcfg)


def test_watchdog_flags_stragglers():
    wd = Watchdog(factor=3.0)
    for i in range(10):
        assert not wd.observe(i, 1.0)
    assert wd.observe(10, 10.0)
    assert wd.straggler_steps == [10]


def test_prefetcher_replays_deterministically():
    data = SyntheticLM(vocab=64, seq=16, global_batch=4)
    pf = Prefetcher(data, start_step=3)
    step, b = pf.next()
    pf.close()
    assert step == 3
    np.testing.assert_array_equal(b["tokens"], data.batch(3)["tokens"])


def test_sharded_host_loading_partition():
    parts = [SyntheticLM(vocab=97, seq=8, global_batch=8,
                         n_hosts=4, host_id=i).batch(5) for i in range(4)]
    assert all(p["tokens"].shape == (2, 8) for p in parts)
    again = SyntheticLM(vocab=97, seq=8, global_batch=8,
                        n_hosts=4, host_id=2).batch(5)
    np.testing.assert_array_equal(parts[2]["tokens"], again["tokens"])


def test_labels_learnable_structure():
    b = SyntheticLM(vocab=101, seq=64, global_batch=4).batch(0)
    toks = b["tokens"]
    assert ((toks[:, :-1] * 31 + 7) % 101 == toks[:, 1:]).mean() > 0.8


@pytest.mark.parametrize("seed,step,n_hosts,host_id",
                         [(0, 0, 1, 0), (3, 17, 1, 0), (1, 5, 4, 2)])
def test_synthetic_batches_bit_identical_to_jax(seed, step, n_hosts,
                                                host_id):
    jdata = pytest.importorskip("repro.data")
    kw = dict(vocab=49152, seq=64, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    want = jdata.SyntheticLM(**kw).batch(step)
    got = SyntheticLM(**kw).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
