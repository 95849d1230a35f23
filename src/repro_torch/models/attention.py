"""Attention blocks: GQA (causal, local-chunked, NoPE, bidirectional), MLA
(DeepSeek) and cross attention, with KV caches for prefill and decode.

Counterpart of ``repro.models.attention``.  Causal prefill and the full
forward run on the port's hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`: on the card
``csrc/flash_attention_wgmma.cu`` for bf16, ``_bf16x3.cu`` for f32; on
the CPU its plain version).  One rule, :func:`takes_flash`, decides:

* **the kernel** when the attention is ``causal``, has no ring buffer
  (``kv_pos`` is None), has more than one query row, q, k and v share a
  head dim, and the query positions follow from ``pos`` — the full
  forward, and prefill into a ``max_len`` cache.  :func:`flash`
  broadcasts the kv heads (query head ``n`` reads kv head ``n // g``),
  pads q with zero rows to a multiple of :data:`FLASH_ROWS`, passes
  ``q_offset = pos``, and gives the kernel the first ``pos + s`` kv rows
  rounded up to a multiple of :data:`FLASH_ROWS`: the in-call keys
  without a cache, a slice of the ``max_len`` cache with one, zero-padded
  where the rounding passes its end.  Slots at or past ``pos + s`` lie
  after every real row's position, so the causal mask does what
  ``kv_len`` does in :func:`_mask`, and any ``max_len`` serves.
* **the grouped plain path** (:func:`attend`, JAX's math) for the rest:
  decode (one query row: the kernel takes no q block below 4, and the
  broadcast would copy the cache ``g`` times every step), ``local`` and
  ``bidir`` masks, ring slots, cross attention, and MLA, whose v dim
  differs from its qk dim.

Both paths score q·kᵀ in float32, as the kernel does.  Here the port
departs from JAX, whose bf16 models score in bf16: at the score
magnitudes of this parameter init (fan-in of ``wq`` is its heads axis,
so scores reach the hundreds, where a bf16 step is 0.5 or more) that
rounding decides which key the softmax picks, and prefill on the kernel
would disagree with decode on the plain path.

Nothing catches a failed build or launch to carry on with the plain path.
Caches are updated in place (a layer's cache leaves are views of the
stacked cache tensors) and returned.

Under a sharding ``rule`` (DTensor activations) q, k and v are
constrained to batch over the batch axes and heads over `model`, as in
JAX, and :func:`flash` runs the kernel on each rank's local (batch,
head) shard under ``local_map``: the kernel takes raw pointers, which a
DTensor has none of, and attention is local per (batch, head), so the
shards' results are the whole result.  The kv-head broadcast happens on
the shard, which is exact when the `model` size divides the kv heads
(contiguous head blocks keep query head n on kv head n // g); a mesh
where it does not is refused.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from .common import PRec, constrain, einsum, pad_heads, placements, resolve
from .common import rms_norm, rope
from .mlp import norm

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free
#: q and kv rows go to the flash kernel as a multiple of this: its blocks
#: must divide both lengths
FLASH_ROWS = 64


# ----------------------------------------------------------------------
# Parameter records
# ----------------------------------------------------------------------
def gqa_recs(cfg, bias: bool = False) -> dict[str, PRec]:
    h = pad_heads(cfg.n_heads, cfg.tp)
    kv = pad_heads(cfg.n_kv_heads, cfg.tp)
    d, hd = cfg.d_model, cfg.head_dim
    recs = {
        "wq": PRec((d, h, hd), ("embed", "heads", "hd")),
        "wk": PRec((d, kv, hd), ("embed", "kv", "hd")),
        "wv": PRec((d, kv, hd), ("embed", "kv", "hd")),
        "wo": PRec((h, hd, d), ("heads", "hd", "embed"),
                   scale=(h * hd) ** -0.5),
        "ln": PRec((d,), ("embed",), init="zeros"),
    }
    if cfg.norm == "layernorm":
        recs["ln"] = PRec((d,), ("embed",), init="ones")
        recs["ln_b"] = PRec((d,), ("embed",), init="zeros")
    if bias:
        recs["bq"] = PRec((h, hd), ("heads", "hd"), init="zeros")
        recs["bk"] = PRec((kv, hd), ("kv", "hd"), init="zeros")
        recs["bv"] = PRec((kv, hd), ("kv", "hd"), init="zeros")
    return recs


def mla_recs(cfg) -> dict[str, PRec]:
    """DeepSeek-V3 multi-head latent attention: KV compressed to a shared
    latent (kv_lora) + a decoupled RoPE key; Q via its own low-rank path."""
    m = cfg.mla
    d, h = cfg.d_model, pad_heads(cfg.n_heads, cfg.tp)
    nope, rope_d = m.qk_nope_dim, m.qk_rope_dim
    return {
        "wq_a": PRec((d, m.q_lora), ("embed", "latent")),
        "q_ln": PRec((m.q_lora,), ("latent",), init="zeros"),
        "wq_b": PRec((m.q_lora, h, nope + rope_d), ("latent", "heads", "hd")),
        "wkv_a": PRec((d, m.kv_lora + rope_d), ("embed", "latent")),
        "kv_ln": PRec((m.kv_lora,), ("latent",), init="zeros"),
        "wk_b": PRec((m.kv_lora, h, nope), ("latent", "heads", "hd")),
        "wv_b": PRec((m.kv_lora, h, m.v_dim), ("latent", "heads", "hd")),
        "wo": PRec((h, m.v_dim, d), ("heads", "hd", "embed"),
                   scale=(h * m.v_dim) ** -0.5),
        "ln": PRec((d,), ("embed",), init="zeros"),
    }


def cross_recs(cfg) -> dict[str, PRec]:
    return gqa_recs(cfg)


# ----------------------------------------------------------------------
# The grouped plain path (JAX's math, outside any kernel)
# ----------------------------------------------------------------------
def _grouped_scores(q, k, scale: float | None = None):
    """q: (b, sq, h, hd), k: (b, skv, kv, hd) -> (b, kv, g, sq, skv), in
    float32 whatever the inputs' type (module docstring), times ``scale``
    (1/sqrt(hd) when None)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    return s / math.sqrt(hd) if scale is None else s * scale


def _grouped_out(p, v):
    """p: (b, kv, g, sq, skv), v: (b, skv, kv, hd) -> (b, sq, h, hd)."""
    b, kvh, g, sq, skv = p.shape
    o = einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, sq, kvh * g, v.shape[-1])


def _softmax(scores, mask):
    scores = torch.where(mask, scores.float(), NEG_INF)
    return torch.softmax(scores, dim=-1)


def _causal_mask(sq: int, skv: int, q_start: int, device) -> torch.Tensor:
    """(sq, skv) lower-triangular mask with the query block starting at
    absolute position ``q_start`` into the kv sequence."""
    qp = torch.arange(sq, device=device)[:, None] + q_start
    return qp >= torch.arange(skv, device=device)[None, :]


def _mask(kind: str, q_pos, kv_pos, window: int, kv_len=None):
    """q_pos: (sq,), kv_pos: (skv,) absolute positions; kv_pos = -1 marks
    empty ring-buffer slots.  kinds: causal | local | bidir."""
    qp, kp = q_pos[:, None], kv_pos[None, :]
    if kind == "bidir":
        m = torch.ones_like(qp >= kp)
    else:
        m = qp >= kp
    if kind == "local" and window:
        m = m & ((qp // window) == (kp // window))
    m = m & (kp >= 0)
    if kv_len is not None:
        m = m & (kp < kv_len)
    return m


def attend(q, k, v, kind: str, q_pos=None, kv_pos=None, window: int = 0,
           kv_len=None, chunk_q: int = 512, scale: float | None = None):
    """Dense or q-chunked grouped attention with positional masking (the
    chunks give the same rows; they bound the score tile's memory).  Under
    autograd each chunk is recomputed in the backward, as JAX's scan body
    is (``jax.checkpoint``): otherwise every chunk's float32 score and
    probability tiles would stay alive until the backward."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(skv, device=q.device)

    def blockless(qq, qp):
        scores = _grouped_scores(qq, k, scale)
        p = _softmax(scores, _mask(kind, qp, kv_pos, window, kv_len))
        return _grouped_out(p.to(v.dtype), v)

    if sq <= max(chunk_q, 1024) or sq % chunk_q != 0:
        return blockless(q, q_pos)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        chunk = functools.partial(checkpoint, blockless, use_reentrant=False)
    else:
        chunk = blockless
    return torch.cat([chunk(q[:, i:i + chunk_q], q_pos[i:i + chunk_q])
                      for i in range(0, sq, chunk_q)], dim=1)


# ----------------------------------------------------------------------
# The kernel path
# ----------------------------------------------------------------------
def takes_flash(kind: str, kv_pos, sq: int, qk_dim: int, v_dim: int,
                positions=None) -> bool:
    """The one rule for the flash kernel (module docstring): causal, no
    ring slots, more than one query row, one head dim for q, k and v, and
    query positions that follow from ``pos`` (no explicit ``positions``)."""
    return (kind == "causal" and kv_pos is None and positions is None
            and sq > 1 and qk_dim == v_dim)


def _fit_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t``'s first ``rows`` rows (dim 1), zero-padded past its end."""
    return t[:, :rows] if t.shape[1] >= rows else \
        F.pad(t, (0, 0, 0, 0, 0, rows - t.shape[1]))


def _round_rows(n: int) -> int:
    return -(-n // FLASH_ROWS) * FLASH_ROWS


def flash(q, k, v, q_offset: int, rule=None,
          scale: float | None = None) -> torch.Tensor:
    """Causal attention on the flash kernel.  q: (b, sq, h, d); k, v:
    (b, skv, kvh, d) — the in-call keys (``q_offset`` 0, skv = sq) or a
    ``max_len`` cache holding them at ``q_offset`` — whose kv heads are
    broadcast to q's; q's first row sits at position ``q_offset``.  Only
    the first ``q_offset + sq`` kv rows, rounded up, reach the kernel.
    Returns (b, sq, h, d).  DTensor operands (under ``rule``) run on each
    rank's (batch, head) shard (module docstring).  ``scale`` is the
    softmax's (1/sqrt(d) when None)."""
    if isinstance(q, DTensor):
        return _flash_shards(q, k, v, q_offset, rule, scale)
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    kv_rows = _round_rows(int(q_offset) + sq)
    k, v = _fit_rows(k, kv_rows), _fit_rows(v, kv_rows)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)

    def heads_first(t):
        return t.to(dt).transpose(1, 2).contiguous()
    extra = {} if scale is None else {"scale": scale}
    o = ops.flash_attention(heads_first(_fit_rows(q, _round_rows(sq))),
                            heads_first(k), heads_first(v), causal=True,
                            q_offset=int(q_offset), **extra)
    return o[:, :, :sq].transpose(1, 2)


def _flash_shards(q, k, v, q_offset: int, rule, scale=None) -> torch.Tensor:
    """:func:`flash` on each rank's local shard under ``local_map``, with
    the placements JAX's ``constrain`` gives q (batch, -, act_heads, -)
    and k, v (batch, -, act_kv, -)."""
    mesh = q.device_mesh
    qp = placements(resolve(rule, ("batch", None, "act_heads", None)), mesh)
    kp = placements(resolve(rule, ("batch", None, "act_kv", None)), mesh)
    return local_map(lambda a, b_, c: flash(a, b_, c, q_offset, scale=scale),
                     out_placements=list(qp), in_placements=(qp, kp, kp),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _check_heads(mesh, rule, heads: int, kv_heads: int) -> None:
    """Refuse a mesh on which a rank's query heads would need another
    rank's kv heads: the mesh dims that split the heads must split the kv
    heads alike and evenly."""
    def split(axis):
        spec = resolve(rule, (None, axis))
        return [i for i, pl in enumerate(placements(spec, mesh))
                if pl.is_shard(1)]
    dims = split("act_heads")
    if dims != split("act_kv"):
        raise ValueError(f"query heads split over mesh dims {dims}, kv "
                         f"heads over {split('act_kv')}: the kv groups "
                         "would not line up")
    n = math.prod(mesh.size(i) for i in dims)
    if heads % n or kv_heads % n:
        raise ValueError(
            f"{heads} query and {kv_heads} kv heads do not split evenly "
            f"over {n} ranks of mesh dims "
            f"{[mesh.mesh_dim_names[i] for i in dims]}: each rank's query "
            "heads must read its own kv heads")


# ----------------------------------------------------------------------
# Cache writes (JAX's dynamic_update_slice, in place: its start is
# clamped so the update fits)
# ----------------------------------------------------------------------
def _write(cache_t: torch.Tensor, new: torch.Tensor, start: int) -> None:
    s = new.shape[1]
    start = max(0, min(int(start), cache_t.shape[1] - s))
    cache_t[:, start:start + s] = new.to(cache_t.dtype)


# ----------------------------------------------------------------------
# GQA block
# ----------------------------------------------------------------------
def gqa_apply(p, x, cfg, kind: str = "causal", positions=None, cache=None,
              pos=None, window: int = 0, use_rope: bool = True, rule=None,
              scale: float | None = None):
    """Returns (delta_x, cache).  cache: dict(k, v) for a ``max_len``
    cache, dict(k, v, pos) for a ring buffer of the window, or None.
    ``scale`` is the softmax's (1/sqrt(head_dim) when None)."""
    b, s, d = x.shape
    if isinstance(x, DTensor):
        _check_heads(x.device_mesh, rule, p["wq"].shape[1], p["wk"].shape[1])
    xn = norm(p, x, cfg)
    q = einsum("bsd,dnh->bsnh", xn, p["wq"])
    k = einsum("bsd,dnh->bsnh", xn, p["wk"])
    v = einsum("bsd,dnh->bsnh", xn, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    given = positions
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :] + \
            (0 if pos is None else int(pos))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if rule is not None:
        q = constrain(q, rule, ("batch", None, "act_heads", None))
        k = constrain(k, rule, ("batch", None, "act_kv", None))
        v = constrain(v, rule, ("batch", None, "act_kv", None))

    kv_len = None
    kv_pos = None
    q_pos = positions[0] if positions.dim() == 2 else positions
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        W = ck.shape[1]
        if "pos" in cache:
            # ring buffer (local-window layers): slot = position mod W
            cp = cache["pos"]
            if s >= W:       # prefill longer than the window: keep the tail
                ck.copy_(k[:, -W:])
                cv.copy_(v[:, -W:])
                cp.copy_(q_pos[-W:])
                # attention itself sees the FULL in-call k/v (early queries
                # need their own chunk, which the ring has already evicted)
                kv_pos = q_pos
            else:            # decode / short prefill (no intra-call wrap)
                slot = int(pos) % W
                _write(ck, k, slot)
                _write(cv, v, slot)
                start = max(0, min(slot, W - s))
                cp[start:start + s] = q_pos.to(cp.dtype)
                k, v, kv_pos = ck, cv, cp
        else:
            _write(ck, k, pos)
            _write(cv, v, pos)
            k, v = ck, cv
            kv_len = int(pos) + s
    if takes_flash(kind, kv_pos, s, q.shape[-1], v.shape[-1], given):
        o = flash(q, k, v, q_offset=0 if pos is None else int(pos),
                  rule=rule, scale=scale)
    else:
        o = attend(q, k, v, kind, q_pos=q_pos, kv_pos=kv_pos, window=window,
                   kv_len=kv_len, scale=scale)
    out = einsum("bsnh,nhd->bsd", o, p["wo"])
    if rule is not None:
        out = constrain(out, rule, ("batch", "seq", "act_embed"))
    return out, cache


# ----------------------------------------------------------------------
# MLA block (DeepSeek-V3).  The cache stores the compressed latent + rope
# key; K/V are re-expanded from the latent.
# ----------------------------------------------------------------------
def mla_apply(p, x, cfg, positions=None, cache=None, pos=None, rule=None):
    m = cfg.mla
    b, s, d = x.shape
    xn = rms_norm(x, p["ln"])
    ql = rms_norm(einsum("bsd,dr->bsr", xn, p["wq_a"]), p["q_ln"])
    q = einsum("bsr,rnh->bsnh", ql, p["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    kv_a = einsum("bsd,dr->bsr", xn, p["wkv_a"])
    latent, k_rope = kv_a[..., :m.kv_lora], kv_a[..., m.kv_lora:]
    latent = rms_norm(latent, p["kv_ln"])
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :] + \
            (0 if pos is None else int(pos))
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)

    kv_len, q_start = None, 0
    if cache is not None:
        _write(cache["latent"], latent, pos)
        _write(cache["k_rope"], k_rope, pos)
        latent, k_rope = cache["latent"], cache["k_rope"]
        kv_len, q_start = int(pos) + s, int(pos)

    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    skv = latent.shape[1]
    mask = _causal_mask(s, skv, q_start, x.device)
    if kv_len is not None:
        mask = mask & (torch.arange(skv, device=x.device)[None, :] < kv_len)

    if cache is not None and s == 1:
        # DECODE: weight absorption (DeepSeek-V3 inference form), in fp32
        # through the small absorbed q and o tensors, as JAX does
        lat = latent.float()
        q_lat = einsum("bqnh,rnh->bqnr", q_nope.float(), p["wk_b"].float())
        scores = (einsum("bqnr,bkr->bnqk", q_lat, lat)
                  + einsum("bqnh,bkoh->bnqk", q_rope, k_rope)) * scale
        pr = _softmax(scores, mask)
        o_lat = einsum("bnqk,bkr->bqnr", pr, lat)
        o = einsum("bqnr,rnh->bqnh", o_lat, p["wv_b"].float()).to(x.dtype)
    else:
        # TRAIN/PREFILL: expand keys/values from the latent (per head)
        k_nope = einsum("bsr,rnh->bsnh", latent, p["wk_b"])
        vv = einsum("bsr,rnh->bsnh", latent, p["wv_b"])
        if rule is not None:
            q_nope = constrain(q_nope, rule,
                               ("batch", None, "act_heads", None))
            k_nope = constrain(k_nope, rule,
                               ("batch", None, "act_heads", None))
            vv = constrain(vv, rule, ("batch", None, "act_heads", None))
        scores = (einsum("bqnh,bknh->bnqk", q_nope, k_nope)
                  + einsum("bqnh,bkoh->bnqk", q_rope, k_rope)) * scale
        pr = _softmax(scores, mask)
        o = einsum("bnqk,bknh->bqnh", pr.to(vv.dtype), vv)
    out = einsum("bsnh,nhd->bsd", o, p["wo"])
    if rule is not None:
        out = constrain(out, rule, ("batch", "seq", "act_embed"))
    return out, cache


# ----------------------------------------------------------------------
# Cross attention (whisper decoder).  Encoder K/V cached once at prefill.
# ----------------------------------------------------------------------
def cross_apply(p, x, enc_kv, cfg, rule=None):
    q = einsum("bsd,dnh->bsnh", norm(p, x, cfg), p["wq"])
    k, v = enc_kv
    o = attend(q, k, v, "bidir")
    return einsum("bsnh,nhd->bsd", o, p["wo"])


def encode_kv(p, enc_out):
    k = einsum("bsd,dnh->bsnh", enc_out, p["wk"])
    v = einsum("bsd,dnh->bsnh", enc_out, p["wv"])
    return k, v
