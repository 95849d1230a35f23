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

``prefill`` and ``decode_step`` update the caches in place and return
them.  ``remat`` (activation checkpointing) is a training concern and
waits for the training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from . import attention, mamba2, mlp, moe
from .common import PRec, dtype_of, einsum, layer_norm, pad_heads, rms_norm
from .common import take, tmap


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str
    opts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Stage:
    blocks: tuple[Block, ...]
    repeat: int


def build_stages(cfg) -> list[Stage]:
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
                     shared=None, enc_out=None, x_emb=None):
        cfg = self.cfg
        if blk.kind == "attn":
            kind = blk.opts.get("kind", "causal")
            dx, c = attention.gqa_apply(
                p, x, cfg, kind=kind if kind in ("local", "bidir")
                else "causal", cache=cache, pos=pos,
                window=cfg.local_window if kind == "local" else 0,
                use_rope=kind != "nope")
            return x + dx, c
        if blk.kind == "shared_attn":
            xin = einsum("bse,ed->bsd", torch.cat([x, x_emb], -1),
                         shared["w_concat"])
            dx, c = attention.gqa_apply(shared, xin, cfg, kind="causal",
                                        cache=cache, pos=pos)
            x = x + dx
            return x + mlp.mlp_apply(shared["mlp"], x, cfg), c
        if blk.kind == "mla":
            dx, c = attention.mla_apply(p, x, cfg, cache=cache, pos=pos)
            return x + dx, c
        if blk.kind == "mlp":
            return x + mlp.mlp_apply(p, x, cfg), cache
        if blk.kind == "moe":
            return x + moe.moe_apply(p, x, cfg), cache
        if blk.kind == "mamba":
            dx, c = mamba2.mamba2_apply(p, x, cfg, cache=cache, pos=pos)
            return x + dx, c
        if blk.kind == "cross":
            if enc_out is not None:     # forward / prefill: encode now
                enc_kv = attention.encode_kv(p, enc_out)
                if cache is not None:   # prefill: persist for decode steps
                    cache = {"ck": enc_kv[0].to(cache["ck"].dtype),
                             "cv": enc_kv[1].to(cache["cv"].dtype)}
            else:                       # decode: reuse cached encoder K/V
                enc_kv = (cache["ck"], cache["cv"])
            return x + attention.cross_apply(p, x, enc_kv, cfg), cache
        raise ValueError(blk.kind)

    def _run_stages(self, params, x, caches=None, pos=None, enc_out=None,
                    x_emb=None):
        for si, st in enumerate(self.stages):
            pstack = params["stages"][si]["blocks"]
            cstack = caches[si]["blocks"] if caches is not None else None
            for i in range(st.repeat):
                lp = take(pstack, i)
                for bi, blk in enumerate(st.blocks):
                    bc = take(cstack[bi], i) if cstack is not None else None
                    x, nc = self._apply_block(
                        blk, lp[bi], x, cache=bc, pos=pos,
                        shared=params.get("shared"), enc_out=enc_out,
                        x_emb=x_emb)
                    if cstack is not None:
                        _store(cstack[bi], i, bc, nc)
        return x, caches

    def _embed(self, params, tokens, batch_extra):
        cfg = self.cfg
        x = params["embed"][tokens].to(dtype_of(cfg.act_dtype))
        if cfg.emb_scale:
            x = x * math.sqrt(cfg.d_model)
        if cfg.n_img_tokens and "patch_embeds" in (batch_extra or {}):
            pe = batch_extra["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def _encoder(self, params, frames):
        cfg = self.cfg
        enc = params["encoder"]
        x = frames.to(dtype_of(cfg.act_dtype))
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for i in range(cfg.n_enc_layers):
            lp = take(enc["blocks"], i)
            dx, _ = attention.gqa_apply(lp["attn"], x, cfg, kind="bidir",
                                        use_rope=False)
            x = x + dx
            x = x + mlp.mlp_apply(lp["mlp"], x, cfg)
        return layer_norm(x, enc["ln"], enc["ln_b"])

    def forward(self, params, batch, return_hidden=False):
        """Full forward (prefill without a cache): returns logits,
        optionally also the final hidden states (for the MTP head)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch)
        enc_out = (self._encoder(params, batch["frames"])
                   if cfg.encdec else None)
        x_emb = x if cfg.hybrid_attn_every else None
        x, _ = self._run_stages(params, x, enc_out=enc_out, x_emb=x_emb)
        logits = self._head(params, x)
        return (logits, x) if return_hidden else logits

    def mtp_forward(self, params, hidden, next_tokens):
        """DeepSeek-V3 multi-token-prediction module (depth 1): the main
        model's final hidden state with the embedding of the *next* token,
        one extra block, the shared head — token t+2 at position t."""
        cfg = self.cfg
        mtp = params["mtp"]
        emb = params["embed"][next_tokens].to(hidden.dtype)
        comb = torch.cat([rms_norm(hidden, mtp["ln_h"]),
                          rms_norm(emb, mtp["ln_e"])], dim=-1)
        x = einsum("bse,ed->bsd", comb, mtp["proj"])
        if cfg.mla:
            dx, _ = attention.mla_apply(mtp["attn"], x, cfg)
        else:
            dx, _ = attention.gqa_apply(mtp["attn"], x, cfg)
        x = x + dx
        x = x + mlp.mlp_apply(mtp["mlp"], x, cfg)
        return self._head(params, x)

    def _head(self, params, x):
        cfg = self.cfg
        x = (rms_norm(x, params["final_ln"]) if cfg.norm == "rmsnorm"
             else layer_norm(x, params["final_ln"], params["final_ln_b"]))
        logits = einsum("bsd,vd->bsv", x, params["embed"])
        if self.padded_vocab != cfg.vocab:   # mask vocab-padding entries
            logits[..., cfg.vocab:] = -2.0 ** 30
        return logits

    # -- serving ----------------------------------------------------------
    def prefill(self, params, batch, caches):
        """Run the prompt into ``caches`` (from position 0); returns the
        last position's logits and the caches."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch)
        enc_out = (self._encoder(params, batch["frames"])
                   if cfg.encdec else None)
        x_emb = x if cfg.hybrid_attn_every else None
        x, caches = self._run_stages(params, x, caches=caches, pos=0,
                                     enc_out=enc_out, x_emb=x_emb)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, caches, tokens, pos: int):
        """tokens: (b, 1); pos: the position of these tokens."""
        cfg = self.cfg
        x = self._embed(params, tokens, None)
        x_emb = x if cfg.hybrid_attn_every else None
        x, caches = self._run_stages(params, x, caches=caches, pos=int(pos),
                                     x_emb=x_emb)
        return self._head(params, x), caches


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
