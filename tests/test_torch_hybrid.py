"""Zamba2 as published on the port's training path (``models/lm.py``
with ``hybrid_layer_ids``) at a tiny size on the CPU.

- The port's ``LM`` against the benchmark's plain reference
  (``bench/reference/hybrid.py``): the loss, every leaf's gradient and
  two optimizer steps, in float32, on seeded weights; two shared blocks
  invoked twice each, B and C in two groups, the adapters.
- The reference against ``transformers``' ``Zamba2ForCausalLM`` with the
  weights mapped across: logits and loss.  This ties the reference to
  the published code.
- The shared blocks' invocations counted by (block, phase), their spans
  under a profile, and spans that leave the numbers as they are.

Tolerances carry their reasons at their definitions; a float32 model
whose products are taken in bfloat16 fails them (the last test).
"""
from __future__ import annotations

import functools
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import check, harness, weights  # noqa: E402
from bench.reference import common, hybrid  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tmap  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.train.step import TrainConfig, loss_fn  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

#: five layers, invocations ahead of layers 0, 1, 3 and 4: blocks 0, 1,
#: 0, 1; 8 Mamba heads in 2 groups; a head dim of 32 over 2·d = 64
TINY = {"family": "hybrid", "n_layers": 5, "d_model": 32, "n_heads": 2,
        "n_kv_heads": 2, "head_dim": 32, "d_ff": 48, "vocab": 300,
        "rope_theta": 10000.0, "act": "geglu_erf", "norm": "rmsnorm",
        "norm_eps": 1e-5, "tp": 1, "act_dtype": "float32",
        "hybrid_layer_ids": [0, 1, 3, 4], "n_mem_blocks": 2,
        "adapter_rank": 8,
        "ssm": {"d_state": 8, "headdim": 8, "expand": 2, "chunk": 16,
                "conv_width": 4, "n_groups": 2}}
TRAIN = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
         "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 100,
         "total_steps": 10000, "z_loss": 1e-4}
#: float32 against float32, the same equations in other orders (the
#: port's chunk loop and flash against the paper's minimal scan and the
#: blocked attention): the largest gradient error seen is 2.5e-5 of its
#: leaf's largest entry, the loss equal to the last bit; products taken
#: in bfloat16 move both by 1e-3 and more
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _batch(b: int, s: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, TINY["vocab"], (b, s), generator=g)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def _params(seed: int = 11):
    return weights.draw(hybrid.layout(TINY), seed, "cpu",
                        dtype=torch.float32)


def _program_grads(params, b, remat: bool = True):
    model = lm.LM(harness.arch_config(TINY))
    live = tmap(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = loss_fn(model, live, b,
                      tcfg=TrainConfig(z_loss=TRAIN["z_loss"]), remat=remat)
    loss.backward()
    return float(loss.detach()), dict(common.leaves(
        tmap(lambda t: t.grad, live)))


def _reference_grads(params, b, ops=None):
    tree = common._tmap(lambda t: t.detach().clone().requires_grad_(),
                        params)
    loss = hybrid.loss(tree, b["tokens"], b["labels"],
                       ops or common.Ops("fp32"), cfg=TINY, train=TRAIN)
    loss.backward()
    return float(loss.detach()), dict(common.leaves(
        common._tmap(lambda t: t.grad, tree)))


def _worst(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float((got[n] - want[n]).abs().max())
               / max(float(want[n].abs().max()), 1e-6) for n in want)


def test_layout_is_the_programs_parameter_tree():
    model = lm.LM(harness.arch_config(TINY))
    want = weights.shapes(tmap(lambda r: torch.empty(r.shape, device="meta"),
                               model.param_recs()))
    assert weights.shapes(_params()) == want
    # a stage from each invocation to the next: layers 0, 1-2, 3 and 4
    assert [st.repeat for st in model.stages] == [1, 2, 1, 1]
    assert len(want) == 2 + 4 * 11 + 2 * 9 + 4 * 3


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_the_reference(remat):
    params, b = _params(), _batch(2, 48, 3)
    lp, gp = _program_grads(params, b, remat)
    lr, gr = _reference_grads(params, b)
    assert abs(lp - lr) <= LOSS_RTOL * abs(lr)
    assert _worst(gp, gr) <= GRAD_RTOL
    # each shared block's weights get the sum over its two invocations
    assert float(gp["shared[0].attn.wq"].abs().max()) > 0
    assert float(gp["adapters[3].a_in"].abs().max()) > 0


def test_two_optimizer_steps_match_the_reference():
    """The port's ``make_train_step`` against the reference's ``follow``:
    every number the benchmark's check reads agrees."""
    params = _params(5)
    start = common._tmap(lambda t: t.clone(), params)
    batches = [_batch(2, 32, i) for i in range(2)]
    t = TRAIN
    tcfg = TrainConfig(opt=OptConfig(lr=t["lr"], b1=t["b1"], b2=t["b2"],
                                     eps=t["eps"],
                                     weight_decay=t["weight_decay"],
                                     clip_norm=t["clip_norm"]),
                       microbatches=1, z_loss=t["z_loss"],
                       warmup_steps=t["warmup_steps"],
                       total_steps=t["total_steps"])
    step_fn = make_train_step(lm.LM(harness.arch_config(TINY)), tcfg)
    opt = adamw_init(params, tcfg.opt)
    losses = []
    for i in range(2):
        params, opt, m = step_fn(params, opt, batches[i], i)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {k: v / (1.0 - t["b1"]) for k, v in
                    common.slice_norms(opt["m"]).items()}
    change = {n: float(torch.linalg.vector_norm(a - b_)) for (n, a), (_, b_)
              in zip(common.layer_slices(opt["master"]),
                     common.layer_slices(start))}
    ref = common.follow(functools.partial(hybrid.loss, cfg=TINY,
                                          train=TRAIN),
                        start, batches, TRAIN, 1, 2, common.Ops("fp32"))
    got = check.readings({"loss": losses, "grad": grad, "change": change},
                         ref)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-3


class _Bf16Ops(common.Ops):
    """The reference with both operands of every product rounded to
    bfloat16 (the products then taken in float32)."""

    def r(self, x):
        return x.bfloat16().float()


def test_bfloat16_products_fail_the_tolerances():
    params, b = _params(), _batch(2, 48, 3)
    lr, gr = _reference_grads(params, b)
    l16, g16 = _reference_grads(params, b, _Bf16Ops())
    assert abs(l16 - lr) > LOSS_RTOL * abs(lr) or _worst(g16, gr) > GRAD_RTOL
    assert _worst(g16, gr) > 10 * GRAD_RTOL


def test_invocations_are_counted_by_block_and_phase():
    """Two steps under remat: each of the four invocations once a step in
    the forward, the re-forward and the backward, blocks 0, 1, 0, 1."""
    params = _params()
    lm.shared_invocations.clear()
    for seed in (1, 2):
        _program_grads(params, _batch(1, 32, seed))
    assert dict(lm.shared_invocations) == {
        (k, phase): 4 for k in (0, 1) for phase in ("fwd", "recompute",
                                                     "bwd")}


def test_spans_nest_and_leave_the_gradients_bit_for_bit():
    params, b = _params(), _batch(1, 32, 4)
    _, plain_grads = _program_grads(params, b)
    obs.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _, traced = _program_grads(params, b)
        counts = obs.counts()
    finally:
        obs.clear()
    for name in plain_grads:
        assert torch.equal(plain_grads[name], traced[name]), name
    for name in ("layer.shared", "layer.attention", "layer.mlp"):
        for phase in ("fwd", "recompute", "bwd"):
            assert counts.get((name, phase)) == 4, (name, phase, counts)


def test_the_published_layer_keeps_no_cache():
    model = lm.LM(harness.arch_config(TINY))
    with pytest.raises(NotImplementedError):
        model.cache_recs(1, 32)


# ----------------------------------------------------------------------
# the reference against the published code
# ----------------------------------------------------------------------
def _hf_model(params):
    """``Zamba2ForCausalLM`` at TINY's sizes with ``params`` mapped in:
    gains stored as they multiply (1 + ours), the fused in-projection and
    gate|up split back, linear weights transposed, the conv as
    ``Conv1d``'s (ch, 1, width).  Its chunk covers the whole sequence:
    the naive scan it runs on a CPU passes states between chunks summed
    over the wrong axis (``modeling_zamba2.py``'s ``.sum(dim=2)`` over
    the target chunk, where ``modeling_mamba2.py`` transposes first), so
    only one chunk is the published model; the reference keeps its own
    chunks of 16, which ``ssm.ssd``'s test holds to the recurrence."""
    tf = pytest.importorskip("transformers")
    c = TINY
    types = ["hybrid" if i in c["hybrid_layer_ids"] else "mamba"
             for i in range(c["n_layers"])]
    s = c["ssm"]
    cfg = tf.Zamba2Config(
        vocab_size=c["vocab"], hidden_size=c["d_model"],
        num_hidden_layers=c["n_layers"], layers_block_type=types,
        mamba_d_state=s["d_state"], mamba_d_conv=s["conv_width"],
        mamba_expand=s["expand"], mamba_ngroups=s["n_groups"],
        n_mamba_heads=s["expand"] * c["d_model"] // s["headdim"],
        chunk_size=HF_CHUNK, intermediate_size=c["d_ff"],
        hidden_act="gelu", num_attention_heads=c["n_heads"],
        num_mem_blocks=c["n_mem_blocks"], adapter_rank=c["adapter_rank"],
        use_shared_attention_adapter=False, use_mem_rope=True,
        rope_theta=c["rope_theta"], rms_norm_eps=c["norm_eps"],
        time_step_min=1e-12, attn_implementation="eager")
    model = tf.Zamba2ForCausalLM(cfg).eval()
    assert model.config.hybrid_layer_ids == c["hybrid_layer_ids"]
    d, H, hd = c["d_model"], c["n_heads"], c["head_dim"]
    assert cfg.attention_head_dim == hd
    where = [(s, i) for s, (_, n) in enumerate(hybrid.stages(c))
             for i in range(n)]

    def stack(key, layer):
        s, i = where[layer]
        return params["stages"][s]["blocks"][0][key][i]
    m = model.model
    with torch.no_grad():
        m.embed_tokens.weight.copy_(params["embed"][:c["vocab"]])
        m.final_layernorm.weight.copy_(1 + params["final_ln"])
        for i, layer in enumerate(m.layers):
            dec = layer.mamba_decoder if types[i] == "hybrid" else layer
            mix = dec.mamba
            dec.input_layernorm.weight.copy_(1 + stack("ln", i))
            mix.in_proj.weight.copy_(torch.cat(
                [stack(k, i) for k in ("w_in_zx", "w_in_bc", "w_in_dt")],
                dim=1).T)
            mix.conv1d.weight.copy_(stack("conv_w", i).T[:, None, :])
            mix.conv1d.bias.copy_(stack("conv_b", i))
            mix.dt_bias.copy_(stack("dt_bias", i))
            mix.A_log.copy_(stack("A_log", i))
            mix.D.copy_(stack("D", i))
            mix.norm.weight.copy_(1 + stack("gate_ln", i))
            mix.out_proj.weight.copy_(stack("w_out", i).T)
            if types[i] != "hybrid":
                continue
            j = c["hybrid_layer_ids"].index(i)
            blk = params["shared"][j % c["n_mem_blocks"]]
            ad = params["adapters"][j]
            st = layer.shared_transformer
            att = st.self_attn
            st.input_layernorm.weight.copy_(1 + blk["attn"]["ln"])
            for name in ("q", "k", "v"):
                getattr(att, f"{name}_proj").weight.copy_(
                    blk["attn"][f"w{name}"].reshape(2 * d, H * hd).T)
            att.o_proj.weight.copy_(blk["attn"]["wo"].reshape(H * hd, d).T)
            st.pre_ff_layernorm.weight.copy_(1 + blk["mlp"]["ln"])
            ff = st.feed_forward
            ff.gate_up_proj.weight.copy_(torch.cat(
                [blk["mlp"]["w_gate"], blk["mlp"]["w_up"]], dim=1).T)
            ff.down_proj.weight.copy_(blk["mlp"]["w_out"].T)
            ff.gate_up_proj_adapter_list[j][0].weight.copy_(ad["a_in"].T)
            ff.gate_up_proj_adapter_list[j][1].weight.copy_(ad["a_out"].T)
            layer.linear.weight.copy_(ad["linear"].T)
    return model


HF_CHUNK = 64
#: float32 against float32 through other orders of the same equations
#: (HF's naive scan, its segment sums by masked cumulative sums, and its
#: eager attention, through five layers): 1.7e-5 of the logits' largest
#: entry seen; bfloat16 products move them by 1e-3 and more
HF_RTOL = 1e-4


def test_reference_matches_transformers_zamba2():
    params, b = _params(7), _batch(2, 48, 9)
    assert b["tokens"].shape[1] <= HF_CHUNK
    model = _hf_model(params)
    common.no_tf32()
    with torch.no_grad():
        want = model(input_ids=b["tokens"], labels=b["tokens"])
        got = hybrid.logits(params, b["tokens"], common.Ops("fp32"), TINY)
    assert got.shape == want.logits.shape
    err = float((got - want.logits).abs().max())
    assert err <= HF_RTOL * float(want.logits.abs().max()), err
    with torch.no_grad():
        mine = hybrid.loss(params, b["tokens"], b["labels"],
                           common.Ops("fp32"), TINY, dict(TRAIN, z_loss=0.0))
    assert math.isclose(float(mine), float(want.loss), rel_tol=1e-5)
