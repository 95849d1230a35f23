"""Model substrate: parameter records, sharding-rule engine, random
initialisation, norms, RoPE.

Counterpart of ``repro.models.common``.  Parameters are declared once as a
tree (nested dicts and lists) of :class:`PRec` (shape, logical axis names,
init scale).  Three interpreters map the record tree to
(a) :class:`P` trees (``PartitionSpec``) via a logical→mesh rule table,
(b) meta-device tensors (:func:`abstract_tree`: shapes and types, no
storage), and (c) tensors on a device, drawn from an explicit
``torch.Generator`` (:func:`materialize`).

The rule tables implement DP/FSDP/TP/EP/SP as roles of the two mesh axes
(``data``, ``model``) plus the replicated/pipelined ``pod`` axis, as in
JAX.  GSPMD's counterpart here is DTensor: a :class:`Sharding` (a
``DeviceMesh`` with named dims and a spec) gives each tensor dim's mesh
dims as DTensor placements (:func:`placements`: ``Shard(d)`` on the mesh
dims that tensor dim ``d`` names, ``Replicate()`` on the others), and
:func:`constrain` is ``redistribute``.  JAX is single-controller; torch
runs one process per rank (SPMD), so every rank executes the same model
code on its DTensor shards.  A DTensor has no sharding strategy for some
ops; :func:`on_replicas` runs such a stretch on plain tensors — each
rank's rows of the batch, gathered on every other dim — and each model
module names where it does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication


@dataclasses.dataclass(frozen=True)
class PRec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis name per dim
    scale: float | None = None         # None -> fan-in 1/sqrt(shape[-2])
    dtype: torch.dtype | None = None   # None -> builder default
    init: str = "normal"               # normal | zeros | ones | fill

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class P(tuple):
    """Counterpart of ``jax.sharding.PartitionSpec``: per tensor dim, a
    mesh-axis name, a tuple of them (one tensor dim over several mesh
    dims, major first) or None (replicated).  Normalised as JAX's is: a
    list becomes a tuple, a one-name tuple the name, an empty one None.
    A tuple, so it compares with ``tuple(jax_spec)``; a leaf of
    :func:`tmap` and :func:`leaves`, not an inner node."""

    def __new__(cls, *parts):
        def norm(a):
            if isinstance(a, (list, tuple)):
                a = tuple(a)
                return None if not a else a[0] if len(a) == 1 else a
            return a
        return super().__new__(cls, tuple(norm(a) for a in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_rec(x) -> bool:
    return isinstance(x, PRec)


def _inner(x) -> bool:
    return isinstance(x, (list, tuple)) and not isinstance(x, P)


def tmap(f: Callable, tree, *rest):
    """Apply ``f`` to every leaf of ``tree`` (a :class:`PRec`, :class:`P`,
    tensor or array; dicts, lists and other tuples are the inner nodes),
    with the matching leaves of ``rest`` as further arguments; returns a
    tree of the same shape."""
    if isinstance(tree, dict):
        return {k: tmap(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _inner(tree):
        return type(tree)(tmap(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return f(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flattening order (dict keys sorted,
    lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if _inner(tree):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def take(tree, i: int):
    """Layer ``i`` of a stacked tree: every leaf indexed on its first axis
    (views, so writes reach the stack)."""
    return tmap(lambda t: t[i], tree)


# ----------------------------------------------------------------------
# Logical -> mesh rule tables. `fsdp` additionally shards one weight dim
# over 'data' (ZeRO-3); serving modes keep weights TP-only.
# ----------------------------------------------------------------------
def rules(mode: str, *, fsdp: bool = True, pods_in_batch: bool = True,
          seq_axis: str | tuple | None = None,
          act_embed_axis: str | None = None,
          kv_seq_axis: str | tuple | None = None,
          fsdp_axes: tuple = ("data",)) -> dict[str, Any]:
    """Logical-axis -> mesh-axis rule table (JAX's, entry for entry).

    modes: train | prefill | decode | long.
    ``fsdp``       — shard the non-TP weight dim over ``fsdp_axes`` (ZeRO-3
                     for training; "zero-inference" weight sharding when a
                     serving config sets it).
    ``seq_axis``   — shard the residual stream's sequence dim (Megatron-SP /
                     Ulysses style; attention internals reshard seq<->heads).
    ``act_embed_axis`` — shard activations' embed dim instead (SSM/hybrid
                     families, where sequence must stay contiguous for the
                     chunked scan).
    ``kv_seq_axis``— shard KV caches' sequence dim (flash-decoding SP for
                     long-context decode, or `model` for MLA's head-free
                     latent cache).
    """
    batch = ("pod", "data") if pods_in_batch else ("data",)
    r: dict[str, Any] = {
        # weight axes
        "vocab": "model", "embed": None, "heads": "model", "kv": "model",
        "hd": None, "ff": "model", "experts": "model", "eff": None,
        "layers": None,
        "state": None, "conv": None, "inner": "model", "latent": None,
        # activation axes
        "batch": batch, "seq": seq_axis, "kv_seq": None,
        "act_embed": act_embed_axis,
        "act_heads": "model", "act_kv": "model", "act_ff": "model",
        "act_vocab": "model", "act_inner": "model", "act_experts": "model",
    }
    if mode == "long":
        r["batch"] = None          # long_500k: global_batch=1 cannot shard
    if fsdp:
        r["embed"] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    if kv_seq_axis is not None:
        r["kv_seq"] = kv_seq_axis
    return r


def resolve(rule: dict[str, Any], axes: tuple) -> P:
    """The spec of logical ``axes`` (None stays None) under ``rule``."""
    return P(*(rule.get(a) if a is not None else None for a in axes))


def spec_of(rec: PRec, rule: dict[str, Any]) -> P:
    return resolve(rule, rec.axes)


def spec_tree(recs, rule: dict[str, Any]):
    return tmap(lambda r: spec_of(r, rule), recs)


def abstract_tree(recs, default_dtype: torch.dtype = torch.bfloat16):
    """Meta-device tensors of the records' shapes and types (JAX's
    ``ShapeDtypeStruct`` tree): nothing is allocated."""
    return tmap(lambda r: torch.empty(r.shape, dtype=r.dtype or default_dtype,
                                      device="meta"), recs)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    named dims): ``Shard(d)`` on each mesh dim that tensor dim ``d``
    names, ``Replicate()`` on the others.  A tensor dim naming several
    mesh dims (``("pod", "data")``) is split over them in the mesh's
    order of dims, which is the spec's order for every rule here."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * mesh.ndim
    for d, part in enumerate(spec):
        for a in (() if part is None else
                  part if isinstance(part, tuple) else (part,)):
            if a not in names:
                raise ValueError(f"spec {spec} names mesh axis {a!r}; the "
                                 f"mesh has {names}")
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Counterpart of ``jax.sharding.NamedSharding``: a mesh and a spec."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, t: torch.Tensor) -> DTensor:
        """``t`` placed on the mesh.  A plain ``t`` holds the full value on
        every rank (SPMD: each rank drew or read the same tensor), and each
        rank keeps its own shard of it without communication; a DTensor is
        redistributed."""
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements)
        return distribute(t.to(self.mesh.device_type), self.mesh,
                          self.placements)


def distribute(t: torch.Tensor, mesh, place) -> DTensor:
    """A full tensor that every rank holds alike, as a DTensor: each rank
    keeps its shard (``src_data_rank=None``: no broadcast)."""
    return torch.distributed.tensor.distribute_tensor(
        t, mesh, place, src_data_rank=None)


def shardings(recs, mesh, rule: dict[str, Any]):
    return tmap(lambda r: Sharding(mesh, spec_of(r, rule)), recs)


def with_sharding(x, *spec):
    """``x`` redistributed to ``P(*spec)`` on its own mesh (JAX's
    ``with_sharding_constraint``); a tensor that is not a DTensor has no
    mesh and is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    want = placements(P(*spec), x.device_mesh)
    return x if tuple(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def constrain(x, rule: dict[str, Any], axes: tuple[str | None, ...]):
    resolved = resolve(rule, axes)
    if all(r is None for r in resolved):
        return x                      # fully replicated: no mesh needed
    return with_sharding(x, *resolved)


def sharded(rule) -> contextlib.AbstractContextManager:
    """The context a step under ``rule`` runs in: DTensor's implicit
    replication, so that a plain tensor the model makes (positions, masks,
    a bias) meets the DTensor activations as replicated, as a constant
    does under JAX's partitioner.  No rule, or inside such a context
    already (``implicit_replication`` does not nest): nothing."""
    if rule is None or DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()     # none, or already inside one
    return implicit_replication()


def on_replicas(fn: Callable, *args, rows: tuple[int, ...] = (),
                keep: tuple[str, dict[int, int], tuple[int, ...]] | None
                = None):
    """``fn(*args)`` on plain tensors, for ops DTensor has no sharding
    strategy for: every DTensor leaf of ``args`` (trees of dicts and
    lists) is gathered to ``Replicate()`` and passed as a plain tensor,
    and every tensor ``fn`` returns comes back as a DTensor on the same
    mesh.  Without a DTensor among ``args`` it is ``fn(*args)``.

    ``rows`` names the arguments batched on dim 0, on which ``fn`` works
    row by row (a lookup, a per-row gather, routing in token groups that
    do not cross a shard, a scan per sequence).  Their leaves keep dim 0
    split over the mesh dims that split it in the first DTensor among
    them (the batch axes) and are gathered on every other dim; a plain
    tensor there is cut to this rank's rows.  ``fn`` then sees this
    rank's rows only, and every tensor it returns must be batched on dim
    0 too: it comes back split the same way.  The other arguments are
    gathered whole.  Each rank computes only what its rows need, or the
    same values as the ranks that share its rows, so the result and its
    gradient are exact; the price is the gathers.

    ``keep = (axis, dims, out_dims)`` keeps one more split, for an ``fn``
    that also works head by head: argument ``i`` in ``dims`` stays split
    on its dim ``dims[i]`` over mesh dim ``axis`` (a scan's heads over
    `model`), and the ``k``-th tensor of the tuple ``fn`` returns comes
    back split there on its dim ``out_dims[k]``.  The other arguments are
    shared by every head, so their gradient from this rank's heads is a
    partial sum over ``axis``.  Where ``axis`` is not a mesh dim of more
    than one rank, already splits the rows, or does not divide a kept
    dim, ``keep`` is ignored: those dims are gathered as above."""
    mesh = next((t.device_mesh for t in leaves(list(args))
                 if isinstance(t, DTensor)), None)
    if mesh is None:
        return fn(*args)
    rep = (Replicate(),) * mesh.ndim
    lead = next((t for i in rows for t in leaves(args[i])
                 if isinstance(t, DTensor)), None)
    split = rep if lead is None else tuple(
        p if p == Shard(0) else Replicate() for p in lead.placements)
    n = row_shards(lead) if lead is not None else 1
    if any(t.shape[0] % n for i in rows for t in leaves(args[i])
           if isinstance(t, torch.Tensor)):
        split = rep                     # uneven rows: gather them too
    hd = _kept_dim(mesh, split, args, keep)

    def placed(i):
        """Argument ``i``'s placements in ``fn`` and its gradient's: a
        whole argument's gradient from this rank's rows (or heads) is a
        partial sum over the ranks that hold other rows (or heads)."""
        fwd, bwd = [], []
        for d, p in enumerate(split):
            if d == hd:
                kept = i in keep[1]
                fwd.append(Shard(keep[1][i]) if kept else Replicate())
                bwd.append(fwd[-1] if kept else Partial())
            else:
                fwd.append(p if i in rows else Replicate())
                bwd.append(fwd[-1] if i in rows or p != Shard(0)
                           else Partial())
        return tuple(fwd), tuple(bwd)

    def local(t, place):
        if not isinstance(t, torch.Tensor):
            return t
        fwd, bwd = place
        if not isinstance(t, DTensor):
            if fwd == rep:
                return t
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, fwd).to_local(grad_placements=bwd)

    def wrap(t, place=split):
        return DTensor.from_local(t, mesh, place, run_check=False) \
            if isinstance(t, torch.Tensor) else t
    local_args = [tmap(lambda t, pl=placed(i): local(t, pl), a)
                  for i, a in enumerate(args)]
    out = fn(*local_args)
    if hd is None:
        return tmap(wrap, out)
    return tuple(wrap(t, tuple(Shard(dim) if d == hd else p
                               for d, p in enumerate(split)))
                 for t, dim in zip(out, keep[2]))


def _kept_dim(mesh, split: tuple, args: tuple, keep) -> int | None:
    """The mesh dim ``keep`` of :func:`on_replicas` keeps split, or None
    where it cannot: no such mesh dim, one rank, a dim that already splits
    the rows, or a kept tensor dim it does not divide."""
    if keep is None or keep[0] not in mesh.mesh_dim_names:
        return None
    hd = mesh.mesh_dim_names.index(keep[0])
    size = mesh.size(hd)
    if size == 1 or split[hd] != Replicate():
        return None
    if any(t.shape[dim] % size for i, dim in keep[1].items()
           for t in leaves(args[i]) if isinstance(t, torch.Tensor)):
        return None
    return hd


def row_shards(t) -> int:
    """How many ways dim 0 of ``t`` is split (1 for a plain tensor): the
    product of the mesh dims that shard it there."""
    if not isinstance(t, DTensor):
        return 1
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        n *= size if p == Shard(0) else 1
    return n


def materialize(recs, generator: torch.Generator | None = None,
                default_dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str | None = None,
                shardings=None):
    """Tensors for a record tree, on ``device`` (the generator's by
    default), random leaves drawn from ``generator`` one leaf after
    another in the tree's order (a tree of constants, such as a cache,
    needs none).

    The JAX rules: ``zeros``, ``ones`` and ``fill`` (value in ``scale``)
    are constants; ``normal`` draws N(0, 1) times ``scale``, or
    ``shape[-2] ** -0.5`` (fan-in: the heads axis for ``wq``) when
    ``scale`` is None.  A leaf of three or more axes (the stacked layers)
    is drawn one slice of its first axis at a time, so the float32
    temporary is one layer's, not the whole stack's.  The values differ
    from JAX's; tests carry JAX's across through
    :func:`repro_torch.convert.lm_params`.

    ``shardings`` (a tree of :class:`Sharding` matching ``recs``) places
    each leaf on its mesh as soon as it is drawn, so no rank holds more
    than one full leaf at a time.  Every rank draws the same full leaf
    from the same seed and keeps its own shard (:meth:`Sharding.
    distribute`): the draws are one stream in the tree's order, so the
    values do not depend on the mesh, and placing them needs no
    collective.  JAX's single controller draws the global array once."""
    dev = torch.device(device if device is not None else
                       generator.device if generator is not None else "cpu")

    def one(r: PRec) -> torch.Tensor:
        dt = r.dtype or default_dtype
        if r.init == "zeros":
            return torch.zeros(r.shape, dtype=dt, device=dev)
        if r.init == "ones":
            return torch.ones(r.shape, dtype=dt, device=dev)
        if r.init == "fill":
            return torch.full(r.shape, r.scale, dtype=dt, device=dev)
        if generator is None:
            raise ValueError(f"materialize: a {r.init} leaf {r.shape} "
                             "needs a generator")
        fan_in = r.shape[-2] if len(r.shape) >= 2 else max(1, r.shape[-1])
        scale = r.scale if r.scale is not None else fan_in ** -0.5
        if len(r.shape) < 3:
            return (torch.randn(r.shape, generator=generator, device=dev)
                    * scale).to(dt)
        out = torch.empty(r.shape, dtype=dt, device=dev)
        for i in range(r.shape[0]):
            out[i] = torch.randn(r.shape[1:], generator=generator,
                                 device=dev) * scale
        return out

    if shardings is None:
        return tmap(one, recs)
    return tmap(lambda r, sh: sh.distribute(one(r)), recs, shardings)


def nbytes(tree) -> int:
    """Bytes of the tensors of a tree."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


# ----------------------------------------------------------------------
# Numerics (JAX's order of casts: statistics in float32, result in x's type)
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """RMS norm with a zero-centred gain: ``x / rms(x) * (1 + gamma)``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         scale: float = 1.0) -> torch.Tensor:
    """Rotary embedding over the last dim of x: (..., seq, heads, hd);
    ``positions`` (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = (theta ** (-torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)) * scale
    ang = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def pad_heads(n: int, tp: int = 16) -> int:
    """Pad head counts up to TP divisibility (Megatron-style GQA padding;
    llama4 40→48 Q heads, 8→16 KV heads at tp=16)."""
    return -(-n // tp) * tp


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's type promotion: operands of mixed
    floating types (bf16 weights against float32 activations) are cast to
    the promoted type first, where torch would refuse them.  Two operands
    of which one is a DTensor contract on their shards
    (:func:`_sharded_einsum`)."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    ops = tuple(t if t.dtype == dt else t.to(dt) for t in ops)
    if len(ops) == 2 and "->" in eq and "." not in eq and any(
            isinstance(t, DTensor) for t in ops):
        return _sharded_einsum(eq, *ops)
    return torch.einsum(eq, *ops)


def _sharded_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> DTensor:
    """A two-operand einsum of DTensors (a plain operand counts as
    replicated) as one local ``torch.einsum`` on each rank's shards, with
    the placements GSPMD would pick, mesh dim by mesh dim: a letter both
    operands shard stays sharded (a batch letter, or a free one: the
    output is sharded on it) or, contracted, leaves the output ``Partial``
    (a sum over ranks); a letter one operand shards is sharded in the
    other too (a chunk, no communication) when both carry it and it stays
    in the output, else the operand that shards a contracted letter is
    gathered (FSDP's all-gather of the weight); two operands sharding two
    letters on one mesh dim gather the smaller.  DTensor's own einsum
    flattens dims for its matmuls, and some torch versions refuse to
    flatten a dim sharded inside the group (a head dim on `model`)."""
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = next(t.device_mesh for t in (a, b) if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim

    def placed(t):
        if not isinstance(t, DTensor):
            return DTensor.from_local(t, mesh, rep, run_check=False)
        if any(p.is_partial() for p in t.placements):
            return t.redistribute(mesh, [Replicate() if p.is_partial()
                                         else p for p in t.placements])
        return t
    a, b = placed(a), placed(b)
    pa, pb, po = list(a.placements), list(b.placements), []
    for m in range(mesh.ndim):
        ka = la[pa[m].dim] if pa[m].is_shard() else None
        kb = lb[pb[m].dim] if pb[m].is_shard() else None
        if ka and kb and ka != kb:          # two letters on one mesh dim
            if (ka in out) != (kb in out):  # gather the contracted one's
                gather_a = ka not in out
            else:
                gather_a = a.numel() <= b.numel()
            if gather_a:
                pa[m], ka = Replicate(), None
            else:
                pb[m], kb = Replicate(), None
        if ka and not kb and ka in lb:
            if ka in out:
                pb[m], kb = Shard(lb.index(ka)), ka
            else:
                pa[m], ka = Replicate(), None
        if kb and not ka and kb in la:
            if kb in out:
                pa[m], ka = Shard(la.index(kb)), kb
            else:
                pb[m], kb = Replicate(), None
        key = ka or kb
        po.append(Replicate() if key is None else
                  Shard(out.index(key)) if key in out else Partial())
    if pa != list(a.placements):
        a = a.redistribute(mesh, pa)
    if pb != list(b.placements):
        b = b.redistribute(mesh, pb)
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    shape = torch.Size(size[k] for k in out)
    stride, n = [], 1
    for k in reversed(out):
        stride.insert(0, n)
        n *= size[k]

    def grad_placements(t, letters):
        # an operand replicated on a mesh dim where the other one is split
        # on a letter it lacks (kept in the output, or summed) meets one
        # shard of it on each rank: its gradient there is a partial sum
        # (data parallelism's gradient reduction)
        return [Partial() if p.is_replicate() and (q.is_partial() or (
            q.is_shard() and out[q.dim] not in letters)) else p
            for p, q in zip(t.placements, po)]
    return DTensor.from_local(
        torch.einsum(eq, a.to_local(grad_placements=grad_placements(a, la)),
                     b.to_local(grad_placements=grad_placements(b, lb))),
        mesh, po, run_check=False, shape=shape, stride=tuple(stride))


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (an ``ArchConfig.act_dtype``) as a
    torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]

