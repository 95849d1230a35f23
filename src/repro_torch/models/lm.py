"""Generic LM assembly covering all ten architectures.

Counterpart of ``repro.models.lm``.  A model is a sequence of *stages*;
each stage is a repeating *group* of blocks whose parameters are stacked
on a leading layer axis, as in JAX.  Where JAX scans the stack with
``lax.scan``, the port loops over layer indices and takes each layer's
leaves as views (:func:`~repro_torch.models.common.take`), so a JAX
parameter or cache tree converts leaf for leaf
(:mod:`repro_torch.convert`).  Heterogeneous patterns (llama4's
3-local+1-global iRoPE, DeepSeek's dense-then-MoE, Zamba2's shared
attention block) are group structure.

Block kinds: attn (causal|local|nope|bidir), mla, mlp, moe, mamba,
shared_attn (weight-tied across applications, per-application KV cache),
cross (encoder-decoder).

Zamba2 as published (``cfg.hybrid_layer_ids``; :meth:`LM._invoke`) is
Mamba-2 layers, a stage of them from each layer it lists to the next,
and, before each layer it lists, an invocation of one of
``n_mem_blocks`` weight-shared blocks in turn (``params["shared"]``, one
dict a block), with an adapter and a linear of the invocation's own
(``params["adapters"]``, one dict an invocation): the block reads
concat(hidden, embedding), and what it gives is added to that Mamba
layer's input, not to the residual.  The invocation runs inside the
layer's group, so remat recomputes it with the layer, and the shared
weights' gradients sum over every invocation.  It trains and runs full
forwards; its blocks keep no KV cache.

``prefill`` and ``decode_step`` update the caches in place and return
them.  ``forward(..., remat=True)`` (training) recomputes each layer's
group of blocks in the backward pass
(``torch.utils.checkpoint.checkpoint``, non-reentrant), as JAX wraps its
scan body in ``jax.checkpoint``: only the layers' inputs are kept.  A
forward with caches takes no remat (training has none).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .. import obs
from . import attention, mamba2, mlp, moe
from .common import PRec, constrain, dtype_of, einsum, layer_norm, pad_heads
from .common import on_replicas, rms_norm, sharded, take, tmap


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str
    opts: dict = dataclasses.field(default_factory=dict)


#: the span (``repro_torch.obs``) around each kind of block that is one
#: layer; ``shared_attn`` opens both of its own
BLOCK_SPANS = {"attn": "layer.attention", "mla": "layer.attention",
               "mlp": "layer.mlp", "moe": "layer.mlp"}
#: invocations of the published Zamba2's shared blocks by (block, phase):
#: "fwd" and "recompute" counted as each runs, "bwd" as its backward
#: reaches the invocation's output
shared_invocations: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Stage:
    blocks: tuple[Block, ...]
    repeat: int


def build_stages(cfg) -> list[Stage]:
    if cfg.hybrid_layer_ids:
        # Zamba2 as published: a stage of Mamba layers from each
        # invocation of a shared block to the next (LM._invoke)
        cuts = sorted({0, *cfg.hybrid_layer_ids, cfg.n_layers})
        return [Stage((Block("mamba"),), b - a)
                for a, b in zip(cuts, cuts[1:])]
    if cfg.family == "ssm":
        return [Stage((Block("mamba"),), cfg.n_layers)]
    if cfg.family == "hybrid":
        # Zamba2: all n_layers are Mamba2 blocks; one weight-tied attn+MLP
        # block is applied after every `hybrid_attn_every` of them.
        per = cfg.hybrid_attn_every
        groups = cfg.n_layers // per
        blocks = tuple([Block("mamba") for _ in range(per)]
                       + [Block("shared_attn")])
        stages = [Stage(blocks, groups)]
        tail = cfg.n_layers - groups * per
        if tail:
            stages.append(Stage((Block("mamba"),), tail))
        return stages
    if cfg.encdec:
        return [Stage((Block("attn", {"kind": "causal"}), Block("cross"),
                       Block("mlp")), cfg.n_layers)]

    def ffn(i: int) -> Block:
        """FFN for layer index i within the repeating group: MoE layers are
        interleaved every ``moe_every`` (llama4: dense/MoE alternation)."""
        if cfg.moe and (cfg.moe_every <= 1
                        or i % cfg.moe_every == cfg.moe_every - 1):
            return Block("moe")
        return Block("mlp")

    if cfg.local_window:  # llama4 iRoPE: (period-1) local-RoPE + 1 global-NoPE
        per = cfg.local_period
        blocks = []
        for i in range(per - 1):
            blocks += [Block("attn", {"kind": "local"}), ffn(i)]
        blocks += [Block("attn", {"kind": "nope"}), ffn(per - 1)]
        assert cfg.n_layers % per == 0
        return [Stage(tuple(blocks), cfg.n_layers // per)]
    attn = Block("mla" if cfg.mla else "attn")
    stages = []
    if cfg.n_dense_layers:  # deepseek: first k layers use a dense FFN
        stages.append(Stage((attn, Block("mlp")), cfg.n_dense_layers))
    if cfg.moe and cfg.moe_every > 1:
        blocks = []
        for i in range(cfg.moe_every):
            blocks += [attn, ffn(i)]
        assert cfg.n_layers % cfg.moe_every == 0
        stages.append(Stage(tuple(blocks), cfg.n_layers // cfg.moe_every))
        return stages
    stages.append(Stage((attn, Block("moe") if cfg.moe else ffn(0)),
                        cfg.n_layers - cfg.n_dense_layers))
    return stages


# ----------------------------------------------------------------------
# Parameter records
# ----------------------------------------------------------------------
def _block_recs(blk: Block, cfg) -> dict:
    if blk.kind in ("attn", "shared_attn", "cross"):
        return attention.gqa_recs(cfg, bias=cfg.qkv_bias)
    if blk.kind == "mla":
        return attention.mla_recs(cfg)
    if blk.kind == "mlp":
        return mlp.mlp_recs(cfg)
    if blk.kind == "moe":
        return moe.moe_recs(cfg)
    if blk.kind == "mamba":
        return mamba2.mamba2_recs(cfg)
    raise ValueError(blk.kind)


def _published_shared_recs(cfg) -> dict:
    """One of Zamba2's shared blocks: attention over concat(hidden,
    embedding) (its norm and q, k, v at 2·d, the output back to d) and
    the gated MLP (norm, gate, up, down)."""
    d, hd = cfg.d_model, cfg.head_dim
    h = pad_heads(cfg.n_heads, cfg.tp)
    kv = pad_heads(cfg.n_kv_heads, cfg.tp)
    return {
        "attn": {
            "ln": PRec((2 * d,), ("embed",), init="zeros"),
            "wq": PRec((2 * d, h, hd), ("embed", "heads", "hd"),
                       scale=(2 * d) ** -0.5),
            "wk": PRec((2 * d, kv, hd), ("embed", "kv", "hd"),
                       scale=(2 * d) ** -0.5),
            "wv": PRec((2 * d, kv, hd), ("embed", "kv", "hd"),
                       scale=(2 * d) ** -0.5),
            "wo": PRec((h, hd, d), ("heads", "hd", "embed"),
                       scale=(h * hd) ** -0.5),
        },
        "mlp": mlp.mlp_recs(cfg),
    }


def _adapter_recs(cfg) -> dict:
    """One invocation's own weights: the MLP's low-rank adapter (d to r,
    r to gate|up) and the linear after the block."""
    d, r, ff = cfg.d_model, cfg.adapter_rank, cfg.d_ff
    return {"a_in": PRec((d, r), ("embed", None), scale=d ** -0.5),
            "a_out": PRec((r, 2 * ff), (None, "ff"), scale=r ** -0.5),
            "linear": PRec((d, d), ("embed", None), scale=d ** -0.5)}


def _stack(recs, n: int):
    return tmap(lambda r: PRec((n,) + r.shape, ("layers",) + r.axes,
                               scale=r.scale, dtype=r.dtype, init=r.init), recs)


class LM:
    def __init__(self, cfg):
        self.cfg = cfg
        self.stages = build_stages(cfg)
        # vocab padded to a multiple of 128; padded logits are masked in
        # _head
        self.padded_vocab = -(-cfg.vocab // 128) * 128

    # -- parameters ------------------------------------------------------
    def param_recs(self):
        cfg = self.cfg
        d = cfg.d_model
        recs: dict[str, Any] = {
            # tied in/out embedding: d^-1/2 init keeps head logits O(1)
            "embed": PRec((self.padded_vocab, d), ("vocab", "embed"),
                          scale=d ** -0.5),
            "final_ln": PRec((d,), ("embed",),
                             init="zeros" if cfg.norm == "rmsnorm" else "ones"),
        }
        if cfg.norm == "layernorm":
            recs["final_ln_b"] = PRec((d,), ("embed",), init="zeros")
        stage_recs = []
        for st in self.stages:
            blocks = [{} if blk.kind == "shared_attn"   # in recs['shared']
                      else _block_recs(blk, cfg) for blk in st.blocks]
            stage_recs.append(_stack({"blocks": blocks}, st.repeat))
        recs["stages"] = stage_recs
        if cfg.hybrid_layer_ids:
            recs["shared"] = [_published_shared_recs(cfg)
                              for _ in range(cfg.n_mem_blocks)]
            recs["adapters"] = [_adapter_recs(cfg)
                                for _ in cfg.hybrid_layer_ids]
        if any(b.kind == "shared_attn" for st in self.stages for b in st.blocks):
            shared = attention.gqa_recs(cfg)
            # Zamba2: the shared block sees concat(hidden, embedding) and is
            # a full transformer block (attn + MLP), weight-tied across uses.
            shared["w_concat"] = PRec((2 * d, d), ("embed", None),
                                      scale=(2 * d) ** -0.5)
            shared["mlp"] = mlp.mlp_recs(cfg)
            recs["shared"] = shared
        if cfg.encdec:
            enc_block = {"attn": attention.gqa_recs(cfg),
                         "mlp": mlp.mlp_recs(cfg)}
            recs["encoder"] = {
                "blocks": _stack(enc_block, cfg.n_enc_layers),
                "ln": PRec((d,), ("embed",), init="ones"),
                "ln_b": PRec((d,), ("embed",), init="zeros"),
            }
        if cfg.mtp:  # DeepSeek multi-token-prediction head: 1 extra block
            recs["mtp"] = {
                "proj": PRec((2 * d, d), ("embed", None), scale=(2 * d) ** -0.5),
                "ln_h": PRec((d,), ("embed",), init="zeros"),
                "ln_e": PRec((d,), ("embed",), init="zeros"),
                "attn": attention.mla_recs(cfg) if cfg.mla
                else attention.gqa_recs(cfg),
                "mlp": mlp.mlp_recs(cfg),
            }
        return recs

    # -- caches -----------------------------------------------------------
    def cache_recs(self, batch: int, max_len: int):
        """Zero-init cache records mirroring the stage structure."""
        cfg = self.cfg
        _no_cache(cfg)
        kvh = pad_heads(cfg.n_kv_heads, cfg.tp)
        hd = cfg.head_dim

        def blk_cache(blk: Block):
            if blk.kind in ("attn", "shared_attn"):
                local = (blk.opts.get("kind") == "local"
                         and cfg.local_window < max_len)
                s = cfg.local_window if local else max_len
                kv_axes = ("batch", "kv_seq", "act_kv", None)
                out = {}
                if local:
                    # ring buffer: kv_seq stays local to the window
                    kv_axes = ("batch", None, "act_kv", None)
                    out["pos"] = PRec((s,), (None,), dtype=torch.int32,
                                      init="fill", scale=-1)
                out["k"] = PRec((batch, s, kvh, hd), kv_axes, init="zeros")
                out["v"] = PRec((batch, s, kvh, hd), kv_axes, init="zeros")
                return out
            if blk.kind == "mla":
                m = cfg.mla
                return {"latent": PRec((batch, max_len, m.kv_lora),
                                       ("batch", "kv_seq", None), init="zeros"),
                        "k_rope": PRec((batch, max_len, 1, m.qk_rope_dim),
                                       ("batch", "kv_seq", None, None),
                                       init="zeros")}
            if blk.kind == "mamba":
                shapes = mamba2.mamba2_cache_shape(cfg, batch)
                return {"ssm": PRec(shapes["ssm"][0],
                                    ("batch", "act_heads", None, None),
                                    dtype=shapes["ssm"][1], init="zeros"),
                        "conv": PRec(shapes["conv"][0],
                                     ("batch", None, "act_inner"),
                                     dtype=shapes["conv"][1], init="zeros")}
            if blk.kind == "cross":
                return {"ck": PRec((batch, cfg.enc_len, kvh, hd),
                                   ("batch", None, "act_kv", None), init="zeros"),
                        "cv": PRec((batch, cfg.enc_len, kvh, hd),
                                   ("batch", None, "act_kv", None), init="zeros")}
            return {}

        return [_stack({"blocks": [blk_cache(b) for b in st.blocks]},
                       st.repeat) for st in self.stages]

    # -- forward ----------------------------------------------------------
    def _apply_block(self, blk: Block, p, x, cache=None, pos=None,
                     shared=None, enc_out=None, x_emb=None, rule=None):
        """One block, residual included, inside the span of its layer
        (:data:`BLOCK_SPANS`).  The span's input is the block's whole
        input: the gradients that meet there are then summed in the
        order they were summed without the span."""
        args = (cache, pos, shared, enc_out, x_emb, rule)
        name = BLOCK_SPANS.get(blk.kind)
        if name is None:
            return self._block(blk, p, x, *args)
        return obs.layer(name, lambda x: self._block(blk, p, x, *args), x)

    def _block(self, blk: Block, p, x, cache, pos, shared, enc_out, x_emb,
               rule):
        cfg = self.cfg
        if blk.kind == "attn":
            kind = blk.opts.get("kind", "causal")
            dx, c = attention.gqa_apply(
                p, x, cfg, kind=kind if kind in ("local", "bidir")
                else "causal", cache=cache, pos=pos, rule=rule,
                window=cfg.local_window if kind == "local" else 0,
                use_rope=kind != "nope")
            return x + dx, c
        if blk.kind == "shared_attn":    # an attention and an MLP: two spans
            def attend(x):
                xin = einsum("bse,ed->bsd", torch.cat([x, x_emb], -1),
                             shared["w_concat"])
                dx, c = attention.gqa_apply(shared, xin, cfg, kind="causal",
                                            cache=cache, pos=pos, rule=rule)
                return x + dx, c
            x, c = obs.layer("layer.attention", attend, x)
            return obs.layer("layer.mlp", lambda x: x + mlp.mlp_apply(
                shared["mlp"], x, cfg, rule=rule), x), c
        if blk.kind == "mla":
            dx, c = attention.mla_apply(p, x, cfg, cache=cache, pos=pos,
                                        rule=rule)
            return x + dx, c
        if blk.kind == "mlp":
            return x + mlp.mlp_apply(p, x, cfg, rule=rule), cache
        if blk.kind == "moe":
            return x + moe.moe_apply(p, x, cfg, rule=rule), cache
        if blk.kind == "mamba":
            dx, c = mamba2.mamba2_apply(p, x, cfg, cache=cache, pos=pos,
                                        rule=rule)
            return x + dx, c
        if blk.kind == "cross":
            if enc_out is not None:     # forward / prefill: encode now
                enc_kv = attention.encode_kv(p, enc_out)
                if cache is not None:   # prefill: persist for decode steps
                    cache = {"ck": enc_kv[0].to(cache["ck"].dtype),
                             "cv": enc_kv[1].to(cache["cv"].dtype)}
            else:                       # decode: reuse cached encoder K/V
                enc_kv = (cache["ck"], cache["cv"])
            return x + attention.cross_apply(p, x, enc_kv, cfg,
                                             rule=rule), cache
        raise ValueError(blk.kind)

    def _invoke(self, hyb, x, x_emb, rule=None):
        """An invocation of shared block ``k`` (``hyb`` = (k, the block's
        params, the invocation's)) ahead of a Mamba layer:
        returns (x, x + the invocation's output), the layer's residual and
        its input, inside the span ``layer.shared`` with the attention's
        and the MLP's spans inside it.  Counted in
        :data:`shared_invocations`."""
        cfg = self.cfg
        k, bp, ap = hyb
        phase = "recompute" if torch._C._current_graph_task_id() != -1 \
            else "fwd"
        shared_invocations[(k, phase)] += 1
        # the heads read 2·d, and Zamba2 scales by (head_dim / 2)^-1/2
        scale = (cfg.head_dim / 2) ** -0.5

        def attend(u):
            return attention.gqa_apply(bp["attn"], u, cfg, rule=rule,
                                       scale=scale)[0]

        def block(x):
            o = obs.layer("layer.attention", attend,
                          torch.cat([x, x_emb], dim=-1))
            t = obs.layer("layer.mlp", lambda o: mlp.adapted_apply(
                bp["mlp"], ap, o, cfg), o)
            tau = einsum("bsd,de->bse", t, ap["linear"])
            if phase == "fwd" and tau.requires_grad:
                tau.register_hook(lambda g, k=k: _count_bwd(k))
            return x, x + tau
        return obs.layer("layer.shared", block, x)

    def _group(self, st: Stage, lp, x, shared, enc_out, x_emb, rule=None,
               hyb=None):
        """One layer's group of blocks without caches (JAX's scan body),
        inside the span ``lm.layer`` (under remat its re-forward too);
        ``hyb``, the published Zamba2's invocation ahead of this layer
        (:meth:`_invoke`), or None."""
        def body(x):
            if hyb is not None:             # the Mamba layer reads x + τ
                x, x_in = self._invoke(hyb, x, x_emb, rule)
                dx, _ = mamba2.mamba2_apply(lp[0], x_in, self.cfg,
                                            rule=rule)
                return x + dx
            for bi, blk in enumerate(st.blocks):
                x, _ = self._apply_block(blk, lp[bi], x, shared=shared,
                                         enc_out=enc_out, x_emb=x_emb,
                                         rule=rule)
            return x
        return obs.layer("lm.layer", body, x)

    def _hybrid_at(self, params, layer: int):
        """The published Zamba2's invocation ahead of ``layer`` for
        :meth:`_group`, or None."""
        ids = self.cfg.hybrid_layer_ids
        if layer not in ids:
            return None
        j = ids.index(layer)
        k = j % self.cfg.n_mem_blocks
        return k, params["shared"][k], params["adapters"][j]

    def _run_stages(self, params, x, caches=None, pos=None, enc_out=None,
                    x_emb=None, remat=False, rule=None):
        if remat and caches is not None:
            raise ValueError("remat recomputes a forward without caches "
                             "(training); a forward with caches takes none")
        if caches is not None:
            _no_cache(self.cfg)
        first = 0                       # the stage's first layer
        for si, st in enumerate(self.stages):
            pstack = params["stages"][si]["blocks"]
            cstack = caches[si]["blocks"] if caches is not None else None
            for i in range(st.repeat):
                lp = take(pstack, i)
                if cstack is None:
                    args = (st, lp, x, params.get("shared"), enc_out, x_emb,
                            rule, self._hybrid_at(params, first + i))
                    x = (checkpoint(self._group, *args, use_reentrant=False)
                         if remat else self._group(*args))
                    continue
                for bi, blk in enumerate(st.blocks):
                    bc = take(cstack[bi], i)
                    x, nc = self._apply_block(
                        blk, lp[bi], x, cache=bc, pos=pos,
                        shared=params.get("shared"), enc_out=enc_out,
                        x_emb=x_emb, rule=rule)
                    _store(cstack[bi], i, bc, nc)
            first += st.repeat
        return x, caches

    def _embed(self, params, tokens, batch_extra, rule=None):
        cfg = self.cfg
        x = _lookup(params["embed"], tokens).to(dtype_of(cfg.act_dtype))
        if cfg.emb_scale:
            x = x * math.sqrt(cfg.d_model)
        if cfg.n_img_tokens and "patch_embeds" in (batch_extra or {}):
            pe = batch_extra["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        if rule is not None:
            x = constrain(x, rule, ("batch", "seq", "act_embed"))
        return x

    def _encoder(self, params, frames, rule=None):
        cfg = self.cfg
        enc = params["encoder"]
        x = frames.to(dtype_of(cfg.act_dtype))
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for i in range(cfg.n_enc_layers):
            lp = take(enc["blocks"], i)
            dx, _ = attention.gqa_apply(lp["attn"], x, cfg, kind="bidir",
                                        use_rope=False, rule=rule)
            x = x + dx
            x = x + mlp.mlp_apply(lp["mlp"], x, cfg, rule=rule)
        return layer_norm(x, enc["ln"], enc["ln_b"])

    def forward(self, params, batch, remat=False, return_hidden=False, *,
                rule=None):
        """Full forward (training, prefill without a cache): returns
        logits, optionally also the final hidden states (for the MTP
        head); ``remat`` recomputes each layer in the backward pass.
        Under ``rule`` the parameters and the batch are DTensors on one
        mesh, and so are the results."""
        cfg = self.cfg
        with sharded(rule):
            x = self._embed(params, batch["tokens"], batch, rule)
            enc_out = (self._encoder(params, batch["frames"], rule)
                       if cfg.encdec else None)
            x_emb = x if cfg.hybrid_attn_every or cfg.hybrid_layer_ids \
                else None
            if cfg.hybrid_layer_ids:
                # the stack's own node: the gradients of the first
                # layer's uses meet there, with spans or without
                x = x.view_as(x)
            x, _ = self._run_stages(params, x, enc_out=enc_out, x_emb=x_emb,
                                    remat=remat, rule=rule)
            logits = self._head(params, x, rule)
        return (logits, x) if return_hidden else logits

    def mtp_forward(self, params, hidden, next_tokens, rule=None):
        """DeepSeek-V3 multi-token-prediction module (depth 1): the main
        model's final hidden state with the embedding of the *next* token,
        one extra block, the shared head — token t+2 at position t."""
        cfg = self.cfg
        mtp = params["mtp"]
        with sharded(rule):
            emb = _lookup(params["embed"], next_tokens).to(hidden.dtype)
            comb = torch.cat([rms_norm(hidden, mtp["ln_h"]),
                              rms_norm(emb, mtp["ln_e"])], dim=-1)
            x = einsum("bse,ed->bsd", comb, mtp["proj"])
            if cfg.mla:
                dx, _ = attention.mla_apply(mtp["attn"], x, cfg, rule=rule)
            else:
                dx, _ = attention.gqa_apply(mtp["attn"], x, cfg, rule=rule)
            x = x + dx
            x = x + mlp.mlp_apply(mtp["mlp"], x, cfg, rule=rule)
            return self._head(params, x, rule)

    def _head(self, params, x, rule=None):
        return obs.layer("lm.head", lambda x: self._logits(params, x, rule),
                         x)

    def _logits(self, params, x, rule=None):
        cfg = self.cfg
        x = (rms_norm(x, params["final_ln"], cfg.norm_eps)
             if cfg.norm == "rmsnorm"
             else layer_norm(x, params["final_ln"], params["final_ln_b"]))
        logits = einsum("bsd,vd->bsv", x, params["embed"])
        if self.padded_vocab != cfg.vocab:   # mask vocab-padding entries
            if isinstance(logits, DTensor):  # no in-place write to a shard
                pad = torch.arange(self.padded_vocab,
                                   device=x.device) >= cfg.vocab
                logits = torch.where(pad, -2.0 ** 30, logits)
            else:
                logits[..., cfg.vocab:] = -2.0 ** 30
        if rule is not None:
            logits = constrain(logits, rule, ("batch", None, "act_vocab"))
        return logits

    # -- serving ----------------------------------------------------------
    def prefill(self, params, batch, caches, rule=None):
        """Run the prompt into ``caches`` (from position 0); returns the
        last position's logits and the caches."""
        cfg = self.cfg
        with sharded(rule):
            x = self._embed(params, batch["tokens"], batch, rule)
            enc_out = (self._encoder(params, batch["frames"], rule)
                       if cfg.encdec else None)
            x_emb = x if cfg.hybrid_attn_every else None
            x, caches = self._run_stages(params, x, caches=caches, pos=0,
                                         enc_out=enc_out, x_emb=x_emb,
                                         rule=rule)
            return self._head(params, x[:, -1:], rule), caches

    def decode_step(self, params, caches, tokens, pos: int, rule=None):
        """tokens: (b, 1); pos: the position of these tokens."""
        cfg = self.cfg
        with sharded(rule):
            x = self._embed(params, tokens, None, rule)
            x_emb = x if cfg.hybrid_attn_every else None
            x, caches = self._run_stages(params, x, caches=caches,
                                         pos=int(pos), x_emb=x_emb,
                                         rule=rule)
            return self._head(params, x, rule), caches


def _count_bwd(k: int) -> None:
    shared_invocations[(k, "bwd")] += 1


def _no_cache(cfg) -> None:
    if cfg.hybrid_layer_ids:
        raise NotImplementedError(
            "the published Zamba2 layer trains and runs full forwards; its "
            "shared blocks keep no KV cache")


def _lookup(table, tokens):
    """Rows ``tokens`` of ``table``.  A DTensor table (vocab over `model`,
    embed over `data`) is gathered whole first: DTensor has no sharding
    strategy for an index into sharded rows.  Each rank looks up its own
    rows of the batch."""
    return on_replicas(lambda t, i: t[i], table, tokens, rows=(1,))


def _store(stack: dict, i: int, old: dict, new: dict) -> None:
    """Write layer ``i``'s new cache leaves into the stacked ``stack``.
    Leaves updated in place (the views ``old`` handed out) are skipped.  A
    leaf whose new type differs from the stack's (a bf16 conv window
    carried on in float32) retypes the whole stack, as JAX's scan output
    takes the type the body returns."""
    for key, t in new.items():
        if old is not None and t is old.get(key):
            continue
        if t.dtype != stack[key].dtype:
            stack[key] = stack[key].to(t.dtype)
        stack[key][i].copy_(t)


def _sinusoid(length: int, channels: int, dtype, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(channels // 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / channels)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)
