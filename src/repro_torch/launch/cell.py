"""Cell builder: everything needed to run one (arch × shape × mesh) cell.

Counterpart of ``repro.launch.cell``: the glue between configs, the
sharding-rule engine and the step functions.  ``build_cell`` returns the
step callable (the train step, prefill or decode, each under the cell's
``rule``), its arguments as meta-device tensors, and the argument and
result specs; :func:`shard` turns a spec tree into :class:`~repro_torch.
models.common.Sharding` leaves on a mesh.  JAX jits and lowers the
callable; the port calls it eagerly, one process per rank, on leaves
placed by those shardings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import configs
from ..models import common
from ..models.common import P
from ..models.lm import LM
from ..optim import OptConfig
from ..train import TrainConfig, make_train_step

# Big models quantize optimizer state to int8 (DESIGN.md §5 / §Perf): this
# is what lets deepseek-v3 fit the 512-chip multi-pod mesh.
_QUANTIZE_OPT = {"deepseek-v3-671b", "llama4-maverick-400b-a17b",
                 "qwen1.5-110b"}


def rule_for(cfg: configs.ArchConfig, shape: configs.ShapeSpec,
             multi_pod: bool) -> dict:
    """Pick the sharding-rule table for a cell (DESIGN.md §5).

    * train: FSDP over data (+pod when multi-pod), Megatron-SP sequence
      sharding for attention families, embed-activation sharding for
      SSM/hybrid (the chunked scan needs contiguous sequence).
    * decode: batch over data; MLA's head-free latent cache shards its
      sequence over `model` (flash-decoding on the latent).
    * long: batch=1 — KV sequence shards over `data` instead.
    """
    ssm_like = cfg.family in ("ssm", "hybrid")
    kind = "long" if shape.long else shape.kind
    # MoE dispatch groups = number of token shards on the data(+pod) axes
    # of the production mesh, whatever the mesh the rule runs on
    moe_groups = 16 * (2 if multi_pod else 1)
    if kind == "train":
        r = common.rules(
            "train", fsdp=True, pods_in_batch=multi_pod,
            seq_axis=None if ssm_like else "model",
            act_embed_axis="model" if ssm_like else None,
            fsdp_axes=("pod", "data") if multi_pod else ("data",))
    elif kind == "prefill":
        r = common.rules(
            "prefill", fsdp=cfg.zero_inference, pods_in_batch=multi_pod,
            seq_axis=None if ssm_like else "model",
            act_embed_axis="model" if ssm_like else None)
    elif kind == "decode":
        r = common.rules(
            "decode", fsdp=cfg.zero_inference, pods_in_batch=multi_pod,
            kv_seq_axis="model" if cfg.mla else None)
        if cfg.moe:
            # serving: 2-D expert-weight sharding (experts x eff) keeps the
            # weights resident instead of gathering them per token (§Perf)
            r["eff"] = "data"
    else:  # long_500k: batch=1, flash-decoding SP over `data`
        r = common.rules(
            "long", fsdp=cfg.zero_inference, pods_in_batch=multi_pod,
            kv_seq_axis="data")
        if cfg.moe:
            r["eff"] = "data"
        moe_groups = 1
    r["moe_groups"] = moe_groups
    return r


def _batch_axes(rule) -> Any:
    return rule.get("batch")


def batch_specs(cfg: configs.ArchConfig, shape: configs.ShapeSpec,
                rule: dict) -> dict:
    b = _batch_axes(rule)
    out = {"tokens": P(b, None)}
    if shape.kind == "train":
        out["labels"] = P(b, None)
    if cfg.n_img_tokens and shape.kind != "decode":
        out["patch_embeds"] = P(b, None, None)
    if cfg.encdec and shape.kind != "decode":
        out["frames"] = P(b, None, None)
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def opt_abstract(recs, optcfg: OptConfig):
    """Meta-device tree matching ``adamw_init``'s state structure."""
    def moment(r: common.PRec):
        if optcfg.quantize_state:
            return {"q": _meta(r.shape, torch.int8),
                    "scale": _meta(r.shape[:-1] + (1,) if r.shape else (1,),
                                   torch.float32)}
        return _meta(r.shape, torch.float32)

    state = {"step": _meta((), torch.int32),
             "m": common.tmap(moment, recs),
             "v": common.tmap(moment, recs)}
    if optcfg.master_fp32:
        state["master"] = common.tmap(
            lambda r: _meta(r.shape, torch.float32), recs)
    return state


def opt_specs(recs, rule, optcfg: OptConfig):
    def moment(r: common.PRec):
        spec = common.spec_of(r, rule)
        if optcfg.quantize_state:
            scale_spec = P(*(tuple(spec)[:-1] + (None,))) if r.shape else P()
            return {"q": spec, "scale": scale_spec}
        return spec

    state = {"step": P(),
             "m": common.tmap(moment, recs),
             "v": common.tmap(moment, recs)}
    if optcfg.master_fp32:
        state["master"] = common.spec_tree(recs, rule)
    return state


@dataclasses.dataclass
class Cell:
    arch: str
    shape: configs.ShapeSpec
    cfg: configs.ArchConfig
    model: LM
    fn: Callable                     # the step function
    abstract_args: tuple             # meta-device tensors of its arguments
    in_specs: tuple                  # P trees
    out_specs: Any                   # P tree (or prefix)
    rule: dict
    model_flops_global: float        # MODEL_FLOPS for the whole step


def build_cell(arch: str, shape_name: "str | configs.ShapeSpec", *,
               multi_pod: bool = False,
               tcfg: TrainConfig | None = None,
               cfg: configs.ArchConfig | None = None) -> Cell:
    # accept an ad-hoc ShapeSpec directly (reduced shapes that are not
    # registered in configs.SHAPES)
    shape = (shape_name if isinstance(shape_name, configs.ShapeSpec)
             else configs.SHAPES[shape_name])
    shape_name = shape.name
    cfg = cfg or configs.get_config(arch)
    if not cfg.supports(shape):
        raise ValueError(f"{arch} skips {shape_name} "
                         "(full attention is quadratic; DESIGN.md §4)")
    model = LM(cfg)
    rule = rule_for(cfg, shape, multi_pod)
    recs = model.param_recs()
    pspecs = common.spec_tree(recs, rule)
    pabs = common.abstract_tree(recs)
    bspecs = batch_specs(cfg, shape, rule)
    babs = configs.input_specs(cfg, shape)

    n_active = cfg.active_param_count()
    tokens = shape.batch * shape.seq

    if shape.kind == "train":
        tcfg = tcfg or TrainConfig(opt=OptConfig(
            quantize_state=arch in _QUANTIZE_OPT))
        step_fn = make_train_step(model, tcfg, rule=rule)
        oabs = opt_abstract(recs, tcfg.opt)
        ospecs = opt_specs(recs, rule, tcfg.opt)
        return Cell(
            arch=arch, shape=shape, cfg=cfg, model=model, fn=step_fn,
            abstract_args=(pabs, oabs, babs, _meta((), torch.int32)),
            in_specs=(pspecs, ospecs, bspecs, P()),
            out_specs=(pspecs, ospecs, P()),
            rule=rule, model_flops_global=6.0 * n_active * tokens)

    act = common.dtype_of(cfg.act_dtype)
    if shape.kind == "prefill":
        def prefill_fn(params, batch, caches):
            return model.prefill(params, batch, caches, rule=rule)

        crecs = model.cache_recs(shape.batch, shape.seq)
        cabs = common.abstract_tree(crecs, default_dtype=act)
        cspecs = common.spec_tree(crecs, rule)
        return Cell(
            arch=arch, shape=shape, cfg=cfg, model=model, fn=prefill_fn,
            abstract_args=(pabs, babs, cabs),
            in_specs=(pspecs, bspecs, cspecs),
            out_specs=(P(), cspecs),
            rule=rule, model_flops_global=2.0 * n_active * tokens)

    # decode (decode_32k / long_500k): one token against a seq-length cache
    def decode_fn(params, caches, tokens_, pos):
        return model.decode_step(params, caches, tokens_, pos, rule=rule)

    crecs = model.cache_recs(shape.batch, shape.seq)
    cabs = common.abstract_tree(crecs, default_dtype=act)
    cspecs = common.spec_tree(crecs, rule)
    return Cell(
        arch=arch, shape=shape, cfg=cfg, model=model, fn=decode_fn,
        abstract_args=(pabs, cabs, _meta((shape.batch, 1), torch.int32),
                       _meta((), torch.int32)),
        in_specs=(pspecs, cspecs, P(_batch_axes(rule), None), P()),
        out_specs=(P(), cspecs),
        rule=rule, model_flops_global=2.0 * n_active * shape.batch)


def shard(mesh, spec_tree_):
    """A spec tree as :class:`~repro_torch.models.common.Sharding` leaves
    on ``mesh`` (other leaves pass through)."""
    return common.tmap(
        lambda s: common.Sharding(mesh, s) if isinstance(s, P) else s,
        spec_tree_)
