"""The port's distribution on gloo ranks on the CPU, held to the JAX
package on an Auto mesh of forced host devices (``run_with_devices``;
meshes built by ``repro.launch.mesh._make_mesh``/``make_local_mesh``,
whose Auto axes keep JAX's sharded oracles running on this jax) and to
the port's own single-process results.

Three spawned groups and two JAX processes, each under its own timeout
(``_torch_ranks.run_ranks``), shared by the tests below through module
fixtures:

* JAX on 8 devices: ``compressed_psum_tree`` once and over 8 repeats of
  error feedback, ``gpipe`` over 8 stages (forward and gradients), the
  granite step single-device and on a (2, 2) mesh, a checkpoint saved
  from an array sharded over a (2, 4) mesh, and granite's parameters;
* 8 port ranks: ``compressed_psum_tree`` and ``gpipe`` on the same
  numpy inputs;
* 4 port ranks on a (2, 2) mesh: the sharded granite step from JAX's
  parameters (and on rank 0 the single-device step), the ten reduced
  configs' sharded forwards against their unsharded ones, elastic
  re-sharding onto (2, 2), (4, 1) and (1, 4) (JAX's checkpoint too),
  ``Trainer(rule=..., mesh=...)`` with a failure and a restore, the
  shard-local einsum and the escapes (``on_replicas`` on a rank's rows,
  the label pick and log-sum-exp on vocab shards, the lookup), the
  loss's recorded ops against a rank's logits shard, the reduced
  deepseek-v3's loss with its MTP head sharded against unsharded, the
  flash path's refusal of a (1, 4) mesh, the SSD scan on (batch, head)
  shards against the unsharded scan and its recorded ops against a
  rank's head shard, the loss on uneven vocab slices (67 over 2, 5 over
  4) and its recorded ops, the loss's peak of allocated bytes on bf16
  logits (even and uneven vocab) against a rank's shard, and the
  reduced mamba2-2.7b (on an uneven vocab) and zamba2-7b losses sharded
  against unsharded;
* JAX on 4 devices: the port's sharded checkpoint restored onto a JAX
  (2, 2) mesh.

Tolerances: the compressed mean within 1e-6 of JAX's (the sums' order
differs between gloo and XLA) and the residual, a local computation,
equal; ``gpipe`` at JAX's own tolerances (2e-5; gradients rtol 1e-4,
atol 1e-5).  The sharded step in bf16 (JAX's test's setting): its loss
within 2e-2 of JAX's sharded loss (JAX's own test's tolerance) and
within ``STEP_RTOL`` of the port's single-device loss (JAX's own sharded
and single-device losses lie 2.2e-4 apart on this input).  bf16 at this
init moves gradients chaotically (a bf16 rounding of a score moves which
key the softmax picks: the sharded and unsharded bf16 gradients differ
by up to a fifth of a leaf's largest entry), so the gradients and the
parameters after the step compare in float32: loss and grad norm within
``STEP_RTOL_F32`` (the grad norm within ``GRAD_NORM_RTOL``), parameters
as ``test_torch_train_step.py`` holds them against JAX.  The sharded
forwards within ``_lm_parity.F32_TOL`` of the unsharded ones (float32;
sharded contractions sum in another order, and this init's softmax
amplifies the last bits, as between XLA and torch).  The trainer on the
mesh in float32: losses within ``STEP_RTOL_F32`` and each master's move
within ``MOVED_TOL`` of the single-process trainer's.  The shard-local
einsum and the escapes against full float64 tensors within 1e-12, the
head-sharded scan within ``SCAN_TOL``.  The sharded MTP, mamba2 and
zamba2 losses in float32: metrics within ``STEP_RTOL_F32``, gradients
within ``MTP_GRAD_TOL`` (zamba2: ``ZAMBA2_GRAD_TOL``).
"""
import concurrent.futures

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

import _lm_parity as lp  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402

from repro_torch import ckpt, configs  # noqa: E402
from repro_torch.ckpt.store import flatten  # noqa: E402

#: the sharded step's loss against the port's single-device loss: bf16
#: (JAX's own two lie 2.2e-4 apart) and float32
STEP_RTOL = 5e-4
STEP_RTOL_F32 = 1e-5
#: the float32 grad norm, sharded against single-device (measured 1.8e-5:
#: this init's softmax amplifies the sums' order in the gradients)
GRAD_NORM_RTOL = 1e-4
#: the trainer on the mesh against the trainer on one process (float32,
#: 4 steps): each master's move from the first draw, per leaf, within
#: MOVED_TOL of the leaf's largest move (measured 1.5e-2, where Adam's
#: g / (|g| + eps) meets gradients near the noise; a step lost or
#: replayed from a stale checkpoint moves it by 0.3 or more) and on
#: average within MOVED_MEAN_TOL (measured 1.4e-5)
MOVED_TOL = 3e-2
MOVED_MEAN_TOL = 1e-3
#: the reduced deepseek-v3's sharded gradients against its unsharded ones,
#: each leaf's max difference over its largest entry (float32; measured
#: 1.8e-5, the sums' order); the reduced mamba2-2.7b's too (measured
#: 1.9e-6)
MTP_GRAD_TOL = 1e-4
#: the reduced zamba2-7b's, whose shared attention blocks' softmax
#: amplifies the sums' order as in the sharded forwards (measured 2.7e-4;
#: 3.1e-4 with the scan's heads gathered)
ZAMBA2_GRAD_TOL = 1e-3
#: the head-sharded scan against the unsharded one in float64 (each head
#: scans alone; B's and C's gradients add the heads' shares in another
#: order)
SCAN_TOL = 1e-10
#: the whole loss on an uneven vocab, which casts the logits to float32
#: as the model's loss does: the loss's difference and the logits'
#: gradient's over its largest entry (measured 1.0e-7 and 9.3e-8)
UNEVEN_XENT_TOL = 1e-6

JAX_ORACLE = r"""
import sys
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro import ckpt, configs
from repro.dist import compressed_psum_tree, gpipe
from repro.launch.cell import rule_for, shard
from repro.launch.mesh import _make_mesh, make_local_mesh
from repro.models.common import materialize, spec_tree
from repro.models.lm import LM
from repro.optim import OptConfig, adamw_init
from repro.train import TrainConfig, make_train_step

out_dir = sys.argv[1]
inputs = np.load(out_dir + "/inputs.npz")
g, ws, x, toks = (inputs[k] for k in ("g", "ws", "x", "tokens"))
res = {}

mesh = _make_mesh((8,), ("data",))
@partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
         out_specs=(P(None), P("data")), check_rep=False)
def cpsum(gl, el):
    o, e = compressed_psum_tree(gl[0], el[0], "data")
    return o[None], e[None]
# eagerly once (its residual is compared bit for bit: under jit XLA may
# rewrite the division), then jitted for the repeats
o, e = cpsum(jnp.asarray(g), jnp.zeros_like(g))
res["cp_mean"], res["cp_err"] = np.asarray(o[0]), np.asarray(e)
cpsum_jit = jax.jit(cpsum)
acc, e = jnp.zeros_like(g[0]), jnp.zeros_like(g)
for _ in range(8):
    o, e = cpsum_jit(jnp.asarray(g), e)
    acc = acc + o[0]
res["cp_acc"] = np.asarray(acc)

pmesh = _make_mesh((8,), ("pod",))
stage = lambda w, h: jnp.tanh(h @ w)
piped = gpipe(stage, pmesh, axis="pod", n_microbatches=4)
res["gp_y"] = np.asarray(jax.jit(piped)(jnp.asarray(ws), jnp.asarray(x)))
res["gp_grad"] = np.asarray(jax.jit(jax.grad(
    lambda w: jnp.sum(piped(w, jnp.asarray(x)) ** 2)))(jnp.asarray(ws)))

cfg = configs.reduced(configs.get_config("granite-8b"))
model = LM(cfg)
rule = rule_for(cfg, configs.SHAPES["train_4k"], multi_pod=False)
tcfg = TrainConfig(opt=OptConfig(lr=1e-3), warmup_steps=1, total_steps=10)
params = materialize(model.param_recs(), jax.random.PRNGKey(0))
ckpt.save(out_dir + "/params", 0, {"params": params})
opt = adamw_init(params, tcfg.opt)
batch = {"tokens": jnp.asarray(toks), "labels": jnp.roll(toks, -1, 1)}
_, _, m0 = jax.jit(make_train_step(model, tcfg))(params, opt, batch,
                                                 jnp.int32(0))
m22 = make_local_mesh(2, 2)
with m22:
    p = jax.device_put(params, shard(m22, spec_tree(model.param_recs(),
                                                    rule)))
    _, _, m1 = jax.jit(make_train_step(model, tcfg, rule=rule))(
        p, opt, batch, jnp.int32(0))
res["j_loss_single"] = float(m0["loss"])
res["j_loss_sharded"] = float(m1["loss"])

w = jnp.arange(64 * 32, dtype=jnp.float32).reshape(64, 32)
m24 = make_local_mesh(2, 4)
e = jax.random.normal(jax.random.PRNGKey(3), (4, 4)).astype(jnp.bfloat16)
ckpt.save(out_dir + "/jax_sharded", 1, {
    "w": jax.device_put(w, NamedSharding(m24, P("data", "model"))),
    "e": jax.device_put(e, NamedSharding(m24, P(None, "model")))})
res["e"] = np.asarray(e.astype(jnp.float32))
np.savez(out_dir + "/jax.npz", **res)
print("oracle OK")
"""

JAX_RESTORE = r"""
import sys
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro import ckpt, configs
from repro.launch.cell import rule_for, shard
from repro.launch.mesh import make_local_mesh
from repro.models.common import materialize, spec_tree
from repro.models.lm import LM

cfg = configs.reduced(configs.get_config("granite-8b"))
model = LM(cfg)
rule = rule_for(cfg, configs.SHAPES["train_4k"], multi_pod=False)
mesh = make_local_mesh(2, 2)
tmpl = {"params": materialize(model.param_recs(), jax.random.PRNGKey(0))}
sh = {"params": shard(mesh, spec_tree(model.param_recs(), rule))}
tree, manifest = ckpt.restore(sys.argv[1], 1, tmpl, shardings=sh)
leaves = jax.tree.leaves(tree)
assert all(isinstance(a.sharding, NamedSharding) for a in leaves)
assert all(a.sharding.mesh.shape == {"data": 2, "model": 2} for a in leaves)
np.savez(sys.argv[2], *[np.asarray(a.astype("float32")) for a in leaves])
print("restore OK", len(leaves), manifest["step"])
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


def _inputs() -> dict:
    """The numpy inputs both packages take, from one seed."""
    rng = np.random.default_rng(0)
    return {"g": rng.standard_normal((8, 64, 32)).astype(np.float32),
            "ws": (rng.standard_normal((8, 16, 16)) * 0.3).astype(
                np.float32),
            "x": rng.standard_normal((32, 16)).astype(np.float32),
            "tokens": rng.integers(0, 512, (8, 32)).astype(np.int32)}


@pytest.fixture(scope="module")
def oracle_and_ranks8(work):
    """JAX's oracle on 8 forced devices and the port's 8 ranks at once
    (the ranks need only the inputs)."""
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    path = work / "oracle.py"
    path.write_text(JAX_ORACLE)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 8,
                            "_torch_dist_ranks:compression_and_gpipe",
                            str(work / "inputs.npz"), timeout=240)
        out = run_with_devices(
            f"import runpy, sys\nsys.argv = ['oracle', {str(work)!r}]\n"
            f"runpy.run_path({str(path)!r})", n_devices=8, timeout=300)
        assert "oracle OK" in out
        return {**inputs, **dict(np.load(work / "jax.npz"))}, ranks.result()


@pytest.fixture(scope="module")
def jax_oracle(oracle_and_ranks8):
    return oracle_and_ranks8[0]


@pytest.fixture(scope="module")
def ranks8(oracle_and_ranks8):
    return oracle_and_ranks8[1]


@pytest.fixture(scope="module")
def ranks4(jax_oracle, work):
    return run_ranks(4, "_torch_dist_ranks:group4",
                     str(work / "params"), str(work / "inputs.npz"),
                     str(work / "jax_sharded"), str(work),
                     list(configs.ARCH_IDS), timeout=420)


def test_compressed_psum_matches_jax(jax_oracle, ranks8):
    for r, out in enumerate(ranks8):
        np.testing.assert_allclose(out["mean"], jax_oracle["cp_mean"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["err"], jax_oracle["cp_err"][r])
    exact = jax_oracle["g"].mean(0)
    rel = np.linalg.norm(ranks8[0]["mean"] - exact) / np.linalg.norm(exact)
    assert rel < 0.02, rel                  # one-shot int8 error small


def test_compressed_psum_error_feedback_converges(jax_oracle, ranks8):
    """Repeated compression of the same gradient converges to the exact
    mean (the residual is re-injected), as JAX's test asserts."""
    exact = jax_oracle["g"].mean(0)
    one = np.linalg.norm(ranks8[0]["mean"] - exact) / np.linalg.norm(exact)
    acc = ranks8[0]["acc"] / 8
    rel = np.linalg.norm(acc - exact) / np.linalg.norm(exact)
    assert rel < one / 2, (rel, one)
    np.testing.assert_allclose(ranks8[0]["acc"], jax_oracle["cp_acc"],
                               rtol=1e-5, atol=1e-5)


def _sequential(ws, x):
    h = torch.from_numpy(x)
    w = torch.from_numpy(ws).requires_grad_()
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i])
    (h ** 2).sum().backward()
    return h.detach().numpy(), w.grad.numpy()


def test_gpipe_forward_matches_sequential_and_jax(jax_oracle, ranks8):
    want, _ = _sequential(jax_oracle["ws"], jax_oracle["x"])
    for out in ranks8:              # every rank holds the whole result
        np.testing.assert_allclose(out["y"], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out["y"], jax_oracle["gp_y"], rtol=2e-5,
                                   atol=2e-5)


def test_gpipe_gradients_match_sequential_and_jax(jax_oracle, ranks8):
    _, want = _sequential(jax_oracle["ws"], jax_oracle["x"])
    g = ranks8[0]["grad"]
    assert ranks8[0]["grad_placements"] == [("Shard", 0)]
    np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g, jax_oracle["gp_grad"], rtol=1e-4,
                               atol=1e-5)


def test_sharded_step_matches_jax_sharded_step(jax_oracle, ranks4):
    """The bf16 loss on the (2, 2) mesh against JAX's on its (2, 2) Auto
    mesh, at JAX's test's tolerance."""
    step = ranks4[0]["step"]
    assert all(r["step"]["loss"] == step["loss"] for r in ranks4)
    jl = float(jax_oracle["j_loss_sharded"])
    assert abs(step["loss"] - jl) / jl < 2e-2, (step["loss"], jl)
    assert step["placed"]


@pytest.mark.parametrize("dt", ["", "_f32"])
def test_sharded_step_matches_single_device_step(jax_oracle, ranks4, dt):
    step = ranks4[0]["step" + dt]
    single = step["single"]
    rtol = STEP_RTOL if not dt else STEP_RTOL_F32
    assert abs(step["loss"] - single["loss"]) / single["loss"] < rtol
    assert step["placed"]
    if dt:      # bf16 gradients are chaotic at this init (module docstring)
        np.testing.assert_allclose(step["grad_norm"], single["grad_norm"],
                                   rtol=GRAD_NORM_RTOL)
    else:       # and the port's single-device bf16 step against JAX's
        jl = float(jax_oracle["j_loss_single"])
        assert abs(single["loss"] - jl) / jl < 2e-2, (single["loss"], jl)


def test_sharded_step_parameters_match_single_device(ranks4):
    """After one float32 step: parameters within rtol 1e-5 and 1e-3·lr
    where the single-device gradient is clear of the noise (above 1e-3 of
    its leaf's largest entry), 2·lr elsewhere (Adam's first step is
    ±lr·g/(|g| + eps)), and equal to their masters."""
    step = ranks4[0]["step_f32"]
    single = step["single"]
    lr = step["lr"]
    for a, b, g in zip(single["params"], step["params"], single["m"]):
        signed = np.abs(g) > 1e-3 * np.abs(g).max()
        assert signed.mean() > 0.1
        np.testing.assert_allclose(b[signed], a[signed], rtol=1e-5,
                                   atol=1e-3 * lr)
        np.testing.assert_allclose(b[~signed], a[~signed], rtol=1e-5,
                                   atol=2 * lr)
    for m, p in zip(step["master"], step["params"]):
        np.testing.assert_array_equal(m, p)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_sharded_forward_matches_unsharded(ranks4, arch):
    out = ranks4[0]["forwards"][arch]
    assert out["got"].shape == out["ref"].shape
    np.testing.assert_allclose(out["got"], out["ref"], rtol=0,
                               atol=lp.F32_TOL)
    # logits leave the model as JAX's constrain leaves them: batch over
    # data, vocab over model
    assert out["placements"] == [("Shard", 0), ("Shard", 2)]


def test_elastic_reshard_within_the_port(ranks4, work):
    out = ranks4[0]["elastic"]
    assert out["saved"] == 1
    for shape, local in (((2, 2), (32, 16)), ((4, 1), (16, 32)),
                         ((1, 4), (64, 8))):
        got = out[shape]
        assert got["equal"] and got["mesh"] == shape
        assert got["local_w"] == local
        assert got["dtypes"]["e"] == "torch.bfloat16"
        assert got["dtypes"]["q.q"] == "torch.int8"
        assert got["extra"] == {"mesh": [2, 2]}
    # and onto a single process without a mesh
    from _torch_dist_ranks import _tree
    tree = _tree()
    single, _ = ckpt.restore(work / "elastic", 1, tree, device="cpu")
    for key, t in flatten(tree).items():
        assert torch.equal(flatten(single)[key], t), key


def test_jax_sharded_checkpoint_restores_on_port_meshes(jax_oracle, ranks4):
    for shape in ((2, 2), (4, 1), (1, 4)):
        got = ranks4[0]["elastic"][shape]
        assert got["jax_w"]
        assert got["jax_e_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(got["jax_e"], jax_oracle["e"])


def test_port_sharded_checkpoint_restores_in_jax(ranks4, work):
    path = work / "restore.py"
    path.write_text(JAX_RESTORE)
    npz = work / "restored.npz"
    out = run_with_devices(
        f"import runpy, sys\nsys.argv = ['restore', "
        f"{str(work / 'port_params')!r}, {str(npz)!r}]\n"
        f"runpy.run_path({str(path)!r})", n_devices=4, timeout=300)
    assert "restore OK" in out
    got = np.load(npz)
    want = ranks4[0]["step"]["params"]
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)


def test_trainer_on_a_mesh_matches_one_process(ranks4):
    """The trainer on the mesh, through a failure and a restore of step
    2's checkpoint onto the mesh, against the trainer on one process in
    float32: the losses and how far every master moved."""
    out = ranks4[0]["trainer"]
    assert out["step"] == 4 and out["latest"] == 4
    assert out["events"] == ["restart"]
    assert out["dtensors"]
    single = out["single"]
    assert sorted(out["losses"]) == sorted(single["losses"]) == [0, 1, 2, 3]
    for s, loss in single["losses"].items():
        assert abs(out["losses"][s] - loss) / loss < STEP_RTOL_F32, (s, loss)
    for r in ranks4[1:]:                   # every rank logged the same
        assert r["trainer"]["losses"] == out["losses"]
    assert len(out["moved"]) == len(single["moved"])
    for got, want in zip(out["moved"], single["moved"]):
        top = np.abs(want).max()
        assert np.abs(got).max() > out["lr"] / 2        # every leaf moved
        diff = np.abs(got - want)
        assert diff.max() <= MOVED_TOL * top, diff.max() / top
        assert diff.mean() <= MOVED_MEAN_TOL * top, diff.mean() / top


@pytest.mark.parametrize("case", ["qkv projection", "output projection",
                                  "tied head", "one operand's sum",
                                  "plain weight"])
def test_sharded_einsum_matches_full_tensors(ranks4, case):
    """``common.einsum`` on DTensor operands (contracted on local shards,
    placements chosen per mesh dim) against the same einsum on full
    float64 tensors: the result and both gradients (the partial ones
    reduced where a replicated operand meets a split one)."""
    for r in ranks4:
        assert max(r["einsums"][case]) < 1e-12, r["einsums"][case]


@pytest.mark.parametrize("case, placed, rows", [
    ("rows", [("Shard", 0), ("Replicate", None)], 2),
    ("uneven rows", [("Replicate", None)] * 2, 3),
    ("no rows", [("Replicate", None)] * 2, 4),
    ("labels", [("Shard", 0), ("Replicate", None)], 2),
    ("logsumexp", [("Shard", 0), ("Replicate", None)], 2),
    ("logsumexp uneven", [("Shard", 0), ("Replicate", None)], 2),
    ("one-rank vocab", [("Shard", 0), ("Replicate", None)], 1),
    ("lookup", [("Shard", 0), ("Replicate", None)], 2)])
def test_escapes_keep_the_batch_split(ranks4, case, placed, rows):
    """``on_replicas`` (the escape for ops DTensor cannot shard) against
    full float64 tensors: with ``rows`` each rank computes its own rows of
    the batch only, and the result stays split over `data`; the loss's
    label pick and log-sum-exp on vocab shards (and on a vocab that does
    not split, through ``on_replicas``) and the embedding lookup keep the
    batch's split; on a `model` of one rank the loss equals the unsharded
    loss exactly."""
    for r in ranks4:
        got = r["escapes"][case]
        assert max(got["err"]) < 1e-12, got["err"]
        if case == "one-rank vocab":
            assert got["err"] == [0.0, 0.0]
        assert got["placements"] == placed
        assert got["local_rows"] == rows


def test_flash_refuses_a_model_size_that_splits_kv_heads(ranks4):
    """The reduced granite has 2 kv heads (JAX's reason for its (2, 2)
    mesh); on (1, 4) each rank's query heads would need another rank's kv
    head, and the flash path refuses rather than compute garbage."""
    for r in ranks4:
        assert "do not split evenly" in r["refusal"], r["refusal"]


def test_loss_backward_stays_on_the_logits_shard(ranks4):
    """The loss recorded by ``graph_analysis.Recorder`` on the (2, 2)
    mesh: no op of its forward or backward touches more elements than a
    rank's logits shard (the vocab-parallel log-sum-exp and label pick
    reduce (b, s) rows over `model`; DTensor's own ``logsumexp`` gathered
    the vocab)."""
    for r in ranks4:
        got = r["loss_ops"]
        assert got["n_backward"] > 0
        assert got["backward"] <= got["shard"], got
        assert got["all"] <= got["shard"], got


def _check_sharded_loss(ranks4, part: str, metrics: set, min_leaves: int,
                        grad_tol: float):
    """A ``sharded_loss`` result: every metric within ``STEP_RTOL_F32`` of
    the unsharded call's, every gradient within ``grad_tol`` of its leaf's
    largest entry, the same leaves reached, every rank alike."""
    out = ranks4[0][part]
    assert set(out["metrics"]) == metrics
    for name, (got, want) in out["metrics"].items():
        assert abs(got - want) <= STEP_RTOL_F32 * abs(want), (name, got,
                                                                want)
    assert all(a == b for a, b in out["reached"])
    assert sum(a for a, _ in out["reached"]) == len(out["grads"]) \
        >= min_leaves
    assert max(out["grads"]) < grad_tol, max(out["grads"])
    for r in ranks4[1:]:
        assert r[part]["metrics"] == out["metrics"]


def test_sharded_mtp_loss_matches_unsharded(ranks4):
    """``loss_fn`` of the reduced deepseek-v3, whose MTP head's logits go
    through the same vocab-parallel ``_xent``, on the (2, 2) mesh against
    the unsharded call in float32: every metric within ``STEP_RTOL_F32``
    and every gradient within ``MTP_GRAD_TOL`` of its leaf's largest
    entry; the backward reaches the same leaves."""
    _check_sharded_loss(ranks4, "mtp_loss", {"ce", "z_loss", "mtp_ce",
                                             "loss"}, 41, MTP_GRAD_TOL)


@pytest.mark.parametrize("part, tol", [("mamba2_loss", MTP_GRAD_TOL),
                                       ("zamba2_loss", ZAMBA2_GRAD_TOL)])
def test_sharded_ssm_loss_matches_unsharded(ranks4, part, tol):
    """``loss_fn`` of the reduced mamba2-2.7b (its vocab replaced by 515,
    which does not split over `model`'s 2 ranks: the scan on (batch,
    head) shards and the loss on uneven vocab slices in one step) and of
    the reduced zamba2-7b, on the (2, 2) mesh against the unsharded call
    in float32: the metrics, the gradient of every leaf the backward
    reaches, and the same leaves reached."""
    _check_sharded_loss(ranks4, part, {"ce", "z_loss", "loss"}, 10, tol)


@pytest.mark.parametrize("case", ["heads", "uneven heads"])
def test_head_sharded_scan_matches_unsharded(ranks4, case):
    """``mamba2._ssd`` through the model's escape on the (2, 2) mesh in
    float64, each rank on its rows and its heads, against the unsharded
    scan: y, the final state and the gradient of every operand within
    ``SCAN_TOL`` (B's and C's, which every head shares, are partial sums
    over `model`: a replicated label would drop the other ranks' heads).
    y and the state stay on (batch, head) shards; 3 heads, which do not
    split over 2 ranks, are gathered as before."""
    from _torch_dist_ranks import SSD_PLACED
    want_grads = [[(type(p).__name__, getattr(p, "dim", None)) for p in pl]
                  for pl in SSD_PLACED]
    for r in ranks4:
        got = r["ssd_heads"][case]
        assert max(got["err"].values()) < SCAN_TOL, got["err"]
        assert len(got["err"]) == 9
        assert got["grad_placements"] == want_grads
        if case == "heads":
            assert got["placements"] == [[("Shard", 0), ("Shard", 2)],
                                         [("Shard", 0), ("Shard", 1)]]
            assert got["local"] == [(2, 32, 2, 4), (2, 2, 4, 6)]
        else:
            assert got["placements"] == [[("Shard", 0),
                                          ("Replicate", None)]] * 2
            assert got["local"] == [(2, 32, 3, 4), (2, 3, 4, 6)]


def test_scan_ops_stay_on_the_head_shard(ranks4):
    """The head-sharded scan's forward and backward recorded by
    ``graph_analysis.Recorder``: no op touches more elements than a
    rank's (batch, head) shard of xh, its widest operand (with the heads
    gathered, xh's rows alone are twice that)."""
    for r in ranks4:
        got = r["scan_ops"]
        assert got["n_backward"] > 0
        assert got["whole"] == 4 * got["shard"]
        assert got["backward"] <= got["shard"], got
        assert got["all"] <= got["shard"], got


@pytest.mark.parametrize("case", ["67 over 2", "5 over 4"])
def test_uneven_vocab_loss_matches_whole(ranks4, case):
    """The loss on a vocab that does not divide `model` (67 over 2 ranks:
    34 + 33 columns; 5 over 4: 2 + 2 + 1 + 0, one rank empty), split
    (data, model), against the whole tensor: the log-sum-exp and the
    label pick (every rank's first and last columns among the labels) and
    their gradients in float64 within 1e-12, ``_xent`` within
    ``UNEVEN_XENT_TOL``; each rank reduces its own ``torch.chunk`` slice
    and keeps the batch's split."""
    slices = {"67 over 2": [34, 33], "5 over 4": [2, 2, 1, 0]}[case]
    for rank, r in enumerate(ranks4):
        got = r["uneven_loss"][case]
        for part in ("logsumexp", "labels"):
            assert max(got["err"][part]) < 1e-12, (part, got["err"])
        assert max(got["err"]["xent"]) < UNEVEN_XENT_TOL, got["err"]
        assert got["vocab_split"] == 1
        assert got["slice"] == slices[rank % len(slices)]
        assert got["placements"] == [("Shard", 0), ("Replicate", None)]
        assert got["local_rows"] == {"67 over 2": 2, "5 over 4": 4}[case]


@pytest.mark.parametrize("case", ["even", "uneven"])
def test_loss_peak_holds_one_gradient_of_the_shard(ranks4, case):
    """``_xent``'s forward and backward on bf16 (16, 8, V) logits over the
    (2, 2) mesh, V = 64 and 67 (34 + 33 columns), with the labels of the
    first 7 positions as ``loss_fn`` passes them, recorded by
    ``graph_analysis.capture`` with the chunk cut to 4 rows (16 chunks a
    shard): the peak of bytes allocated during the call, less its
    arguments, within 1.5 times a rank's bf16 logits shard plus two
    float32 chunks; the gradient comes back in bf16.  Read 6472 B of
    7168 (even, a 4096 B shard: the gradient, one chunk, the shifted
    labels) and 6760 of 7616 (34 columns).  The parent's loss on
    ``logits[:, :-1]``, which upcast the logits and kept the ``exp`` and
    ``gather``'s zeros and scatter, read 29808 B (7.28 shards) and 31600
    (7.26); the chunked loss on that slice, whose backward pads the
    gradient into a second buffer, read 7696 and 8176."""
    for r in ranks4:
        got = r["loss_peak"][case]
        assert got["grad"] and got["chunks"] == 16, got
        assert got["temp"] <= 1.5 * got["shard"] + 2 * got["chunk"], got


def test_uneven_loss_ops_stay_on_the_vocab_slice(ranks4):
    """The loss on (16, 8, 67) logits over the (2, 2) mesh recorded by
    ``graph_analysis.Recorder``: no op touches more elements than a
    rank's rows at the ceil slice (34 columns), where gathering the rows'
    vocab would touch 67."""
    for r in ranks4:
        got = r["uneven_loss_ops"]
        assert got["n_backward"] > 0
        assert got["local"] <= got["shard"] < got["whole_rows"]
        assert got["backward"] <= got["shard"], got
        assert got["all"] <= got["shard"], got
