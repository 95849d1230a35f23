"""Graph-level analysis of a torch program: per-op cost records of one
call, the counterpart of :func:`~repro_torch.core.hlo_analysis
.analyze_hlo_text` for what the port itself runs.

Where the JAX package walks the compiled per-device HLO module, the port
records the call: :class:`Recorder` is a ``TorchDispatchMode`` that sees
every aten op the call dispatches, forward and backward, with its
operands and results.  An op whose operands include a DTensor is handed
back to DTensor (the mode returns ``NotImplemented``), so the recorder
sees what DTensor runs on each rank: the *local-shard* ops and the
collectives of its redistributions.  The counts are therefore per device,
as the per-device HLO's are.  DTensor also runs each op it has not seen
before once on fake tensors of the *global* shape, to learn its result's
shape and strides (``ShardingPropagator._propagate_tensor_meta_non_cached``);
no rank runs those, and the recorder skips them.  The result is the same
:class:`~repro_torch.core.hlo_analysis.HLOAnalysis`, with one
:class:`~repro_torch.core.hlo_analysis.OpCost` record per op that costs
anything, and every module total is accumulated at the point its record
is (so the records sum to the totals, the fleet analyzer's conservation).

The rules:

* **mxu_flops** (tensor cores): ``2·m·n·k`` for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` (and ``mv``, ``dot``), ``2·out·(c_in/groups)·
  kernel`` for a convolution, and for the flash op
  (``repro_torch::flash_attention``) ``4·d`` per visible (query, key) pair
  per (batch, head), the formula of PERF.md's flash bound
  (:func:`repro_torch.tune.space.attention_bound`): causal pairs only.  A
  GEMM counts here only if it runs on the tensor cores: bfloat16 or
  float16, or float32 where TF32 is allowed
  (``torch.backends.cuda.matmul.allow_tf32``, or ``tf32=``).  A float32
  GEMM with TF32 off, such as ``attention_backward``'s, runs on the CUDA
  cores and goes to **vpu_flops**.  The flash op takes its launch route's
  arithmetic: ``wgmma`` one bf16 pass, ``bf16x3`` three (float32 as three
  bf16 products, as the bound counts it), ``simt`` the CUDA cores.  Its
  backward's op (``repro_torch::flash_attention_backward``) counts
  ``10·d`` per visible pair (S recomputed, dP, dV, dQ, dK: two and a half
  forward passes, :func:`repro_torch.tune.space.attention_backward_bound`)
  on the tensor cores where ``backward_route`` takes the kernel.
* **vpu_flops** (CUDA cores): elementwise arithmetic one flop per output
  element, reductions one per input element, as ``hlo_analysis`` counts
  its elementwise ops and ``reduce``; softmax five per element (max,
  subtract, exp, sum, divide), its backward and ``logsumexp`` four; the
  bias add of ``addmm``/``baddbmm`` one per output element.  Casts,
  copies, concatenations and comparisons cost bytes, not flops (HLO's
  ``convert``, ``copy``, ``concatenate``, ``compare``).
* **hbm_bytes**: operand plus result bytes of every op that is not a view
  (the backward op adds the fp32 LSE and D rows it writes).
  Eager mode has no fusion, so each op is its own boundary.  An operand
  counts the distinct elements it reaches (an expanded dim once).  Views
  (every result aliases an operand's storage), ``prim.device``,
  ``wait_tensor`` and allocations that write nothing (``empty*``) cost
  nothing.  An in-place op reads its operands and writes its result
  once; ``copy_``, ``fill_`` and ``zero_`` do not read the tensor they
  overwrite.
* **Collectives**: the ``_c10d_functional`` all-reduce, all-gather,
  reduce-scatter and all-to-all, and DTensor's ``shard_dim_alltoall``,
  with their group size and ``wire_bytes`` from
  :func:`~repro_torch.core.hlo_analysis._collective_wire_bytes` of the
  result bytes, plus a ``schedule`` of
  :class:`~repro_torch.core.hlo_analysis.CollectiveRecord` in call order.
  A collective's operand and result bytes are HBM traffic too, as in
  ``hlo_analysis``.
* **Memory**: the argument bytes (the local shards of the call's tensor
  arguments) and the peak of live bytes during the call: the arguments
  plus every storage an op allocated that is still alive, ``empty*``'s
  too (they move no bytes but hold their storage), and the scratch the
  backward kernel holds while it runs
  (:func:`~repro_torch.kernels.flash_attention.backward_scratch`).  An
  in-place op allocates nothing.

A record's ``computation`` is the innermost :func:`scope` open when the
op ran (a caller names a stretch of its program, such as the optimizer),
else ``"backward"`` for the ops autograd's engine runs and ``"forward"``
for the rest; ``multiplier`` is 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .hlo_analysis import (CollectiveRecord, HLOAnalysis, OpCost,
                           _collective_wire_bytes)

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64",
}
_TENSOR_CORE = (torch.bfloat16, torch.float16)

# one flop per output element
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "floor",
    "ceil", "round", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "where", "exp", "exp2", "expm1", "log", "log1p", "log2",
    "tanh", "rsqrt", "sqrt", "pow", "reciprocal", "sin", "cos", "erf",
    "sigmoid", "silu", "gelu", "relu", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "addcmul", "addcdiv", "lerp",
    "silu_backward", "gelu_backward", "tanh_backward", "sigmoid_backward",
    "threshold_backward", "masked_fill",
}
# one flop per input element
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "norm", "linalg_vector_norm", "argmax", "argmin", "cumsum", "any",
    "all", "var_mean", "std_mean",
}
# flops per element of the (first) operand
_PER_ELEMENT = {"_softmax": 5, "_log_softmax": 5,
                "_softmax_backward_data": 4,
                "_log_softmax_backward_data": 4, "logsumexp": 4}
GEMMS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot",
         "convolution"}
# ops that move no bytes: device queries, waits, allocations that write
# nothing, aliases
_FREE = {"device", "wait_tensor", "empty", "empty_strided", "empty_like",
         "new_empty", "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "promote_types", "is_same_size",
         "resize_", "set_", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset"}
# the free ops that allocate a storage of their own
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}
# in-place ops that overwrite their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_"}
# collective op name -> wire-model kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_FLASH = "flash_attention"
_FLASH_BACKWARD = "flash_attention_backward"
#: DTensor's run of an op on global-shape fake tensors, for its result's
#: metadata (module docstring)
_META_RUN = "_propagate_tensor_meta_non_cached"


def shape_str(t: torch.Tensor) -> str:
    """An HLO-style type string of a tensor: ``bf16[4,128,512]``."""
    return _type_str(t.dtype, t.shape)


def _type_str(dtype: torch.dtype, shape) -> str:
    name = _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(int(s)) for s in shape)}]"


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` reaches: a dim of stride 0 (an
    expanded one) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= int(size)
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _gemm_flops(name: str, args) -> float:
    """2·m·n·k of one GEMM-like op from its operands' shapes."""
    a, b = (args[1], args[2]) if name.startswith("add") else args[:2]
    k = a.shape[-1]
    out = math.prod(a.shape[:-1]) * (b.shape[-1] if b.dim() > 1 else 1)
    return 2.0 * out * k


def _conv_flops(args, out: torch.Tensor) -> float:
    weight = args[1]
    per_out = math.prod(weight.shape[1:])      # c_in/groups x kernel
    return 2.0 * out.numel() * per_out


def flash_flops(q: torch.Tensor, k: torch.Tensor, causal: bool,
                q_offset: int) -> float:
    """``4·d`` flops per visible (query, key) pair per (batch, head), the
    formula of PERF.md's flash bound
    (:func:`repro_torch.tune.space.attention_bound`)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if causal:
        # sum over rows i of clip(i + q_offset + 1, 0, skv)
        pairs = sum(min(max(i + q_offset + 1, 0), skv) for i in range(sq))
    else:
        pairs = sq * skv
    return 4.0 * d * pairs * b * h


def _in_order(func, args, kwargs) -> list:
    """The op's arguments in its schema's order, keywords included."""
    return list(args) + [kwargs[a.name] for a in
                         func._schema.arguments[len(args):]
                         if a.name in kwargs]


def _flash_route(q, block_q: int, block_kv: int) -> str:
    from ..kernels import flash_attention as fa
    lim = fa.launch_limits(int(block_q), int(block_kv), int(q.shape[-1]),
                           q.dtype)
    return lim.route if lim.ok else "simt"


def _group_size(func, args, kwargs) -> int:
    """The group size of a functional collective: the size of the group
    its ``group_name`` argument names."""
    from torch.distributed import distributed_c10d as c10d
    names = [a.name for a in func._schema.arguments]
    got = dict(zip(names, _in_order(func, args, kwargs)))
    if "group_size" in got:
        return int(got["group_size"])
    return c10d._resolve_process_group(got["group_name"]).size()


# the open scopes, innermost last: one list for every thread, since
# autograd runs a card's backward on a thread of its own while the caller
# waits
_SCOPES: list[str] = []


@contextlib.contextmanager
def scope(name: str):
    """Label the records of the ops run inside with ``name`` (their
    ``computation``)."""
    _SCOPES.append(name)
    try:
        yield
    finally:
        _SCOPES.pop()


@dataclasses.dataclass
class GraphCapture:
    """What one recorded call cost: the per-device analysis and its
    memory."""
    analysis: HLOAnalysis
    argument_bytes: int = 0        # local shards of the tensor arguments
    output_bytes: int = 0          # results not aliasing an argument
    peak_bytes: int = 0            # arguments + allocations alive at once
    n_dispatched: int = 0          # every op seen, views and free ones too
    seconds: float = 0.0           # host seconds of the recorded call
    #: (label, bytes) of the allocations alive at the peak, largest first
    live_at_peak: list = dataclasses.field(default_factory=list)

    def memory(self) -> dict:
        return {"argument_bytes": int(self.argument_bytes),
                "output_bytes": int(self.output_bytes),
                "peak_bytes": int(self.peak_bytes),
                "temp_bytes": int(self.peak_bytes - self.argument_bytes),
                "total_per_device": int(self.peak_bytes)}


class Recorder(TorchDispatchMode):
    """Records every aten op of the calls made under it into
    :attr:`analysis` (module docstring).  ``tf32`` says whether float32
    GEMMs run on the tensor cores (default: the backend's flag when the
    recorder is made)."""

    def __init__(self, tf32: bool | None = None):
        super().__init__()
        self.tf32 = (torch.backends.cuda.matmul.allow_tf32 if tf32 is None
                     else bool(tf32))
        self.analysis = HLOAnalysis()
        self.n_dispatched = 0
        self.live = 0
        self.peak = 0
        self._alive: dict[int, int] = {}
        # [bytes, born, died, op, dtype, shape, computation] per
        # allocation, on one event clock; labels are made at the end
        self._allocs: list[list] = []
        self._clock = 0
        self._peak_at = 0
        self._meta_runs = 0
        self._saved = None

    # -- DTensor's metadata runs ----------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        run = self._saved = ShardingPropagator.__dict__[_META_RUN]

        def skipped(prop, op_schema):
            self._meta_runs += 1
            try:
                return run(prop, op_schema)
            finally:
                self._meta_runs -= 1
        setattr(ShardingPropagator, _META_RUN, skipped)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        setattr(ShardingPropagator, _META_RUN, self._saved)
        return super().__exit__(*exc)

    # -- memory -------------------------------------------------------
    def _allocated(self, t: torch.Tensor, name: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        self._alive[key] = st.nbytes()
        self.live += st.nbytes()
        self._clock += 1
        life = [st.nbytes(), self._clock, None, name, t.dtype, t.shape,
                self._computation()]
        self._allocs.append(life)
        if self.live > self.peak:
            self.peak, self._peak_at = self.live, self._clock
        weakref.finalize(st, self._freed, key, life)

    def _transient(self, tensors, name: str) -> None:
        """Storages an op holds only while it runs (a kernel's scratch):
        alive beside its results for one tick of the clock."""
        self._clock += 1
        n = 0
        for t in tensors:
            nb = t.untyped_storage().nbytes()
            n += nb
            self._allocs.append([nb, self._clock, self._clock + 1, name,
                                 t.dtype, t.shape, self._computation()])
        if self.live + n > self.peak:
            self.peak, self._peak_at = self.live + n, self._clock
        self._clock += 1

    def _freed(self, key: int, life: list) -> None:
        self.live -= self._alive.pop(key, 0)
        self._clock += 1
        life[2] = self._clock

    def live_at_peak(self) -> list[tuple[str, int]]:
        """(label, bytes) of every allocation alive at the peak, largest
        first: the op that made it, its shape and its computation."""
        at = self._peak_at
        live = [life for life in self._allocs
                if life[1] <= at and (life[2] is None or life[2] > at)]
        return [(f"{op} {_type_str(dtype, shape)} ({comp})", n)
                for n, _, _, op, dtype, shape, comp in
                sorted(live, key=lambda life: -life[0])]

    # -- dispatch -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._meta_runs:
            return func(*args, **kwargs)   # no rank runs it
        if any(isinstance(t, DTensor)
               for t in _pytree.tree_leaves((args, kwargs))):
            return NotImplemented     # DTensor runs it as local-shard ops
        if func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"):
            # a composite op reaches a mode whole under inference mode
            # (einsum, matmul): record the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.n_dispatched += 1
        self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        name = func._opname if hasattr(func, "_opname") else \
            func.__name__.split(".")[0]
        if name in _FREE:
            if name in _ALLOCATIONS:      # moves no bytes, holds memory
                for t in _tensors(out):
                    self._allocated(t, name)
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        mutable = func._schema.is_mutable
        fresh = [t for t in outs if _storage_key(t) not in in_keys]
        if outs and not fresh and not mutable:
            return                    # a view: every result aliases
        for t in fresh:
            self._allocated(t, name)
        a = self.analysis
        rec = OpCost(name=f"{name}.{len(a.ops)}", opcode=name,
                     computation=self._computation(),
                     shape=shape_str(outs[0]) if outs else "()",
                     multiplier=1)
        first = ins[0] if ins else None
        # ---- flops --------------------------------------------------
        mxu = vpu = extra = 0.0
        if name in GEMMS:
            f = (_conv_flops(args, outs[0]) if name == "convolution"
                 else _gemm_flops(name, args))
            dt = outs[0].dtype
            if dt in _TENSOR_CORE or (dt == torch.float32 and self.tf32):
                mxu = f
            else:
                vpu = f
            if name in ("addmm", "baddbmm", "addmv"):
                vpu += outs[0].numel()
            a.flops_by_shape[(name, rec.shape)] += f
        elif name == _FLASH:
            q, k, _, causal, bq, bkv, q_offset = _in_order(func, args,
                                                           kwargs)[:7]
            f = flash_flops(q, k, causal, q_offset)
            route = _flash_route(q, bq, bkv)
            if route == "simt":
                vpu = f
            else:
                mxu = f * (3 if route == "bf16x3" else 1)
            a.flops_by_shape[(name, rec.shape)] += f
        elif name == _FLASH_BACKWARD:
            q, k, _, _, causal, q_offset = _in_order(func, args,
                                                     kwargs)[:6]
            f = 2.5 * flash_flops(q, k, causal, q_offset)
            from ..kernels import flash_attention as fa
            if fa.backward_route(q, k, q_offset) == "kernel":
                mxu = f
                b, h, sq, d = q.shape
                self._transient(fa.backward_scratch(b * h, sq, d, "meta"),
                                f"{name} scratch")
            else:
                vpu = f
            extra = 8.0 * math.prod(q.shape[:3])     # LSE and D, fp32
            a.flops_by_shape[(name, rec.shape)] += f
        elif name in _ELEMENTWISE or name.rstrip("_") in _ELEMENTWISE:
            vpu = float(outs[0].numel()) if outs else 0.0
        elif name in _REDUCTIONS and first is not None:
            vpu = float(first.numel())
        elif name in _PER_ELEMENT and first is not None:
            vpu = float(_PER_ELEMENT[name] * first.numel())
        # ---- collectives ---------------------------------------------
        kind = _COLLECTIVES.get(name)
        wire = 0.0
        if kind is not None and outs:
            n = _group_size(func, args, kwargs)
            rbytes = tensor_bytes(outs[0])
            wire = _collective_wire_bytes(kind, rbytes, n)
            a.collective_wire_bytes += wire
            a.collective_by_kind[kind] += wire
            a.schedule.append(CollectiveRecord(kind, rbytes, wire, n, 1,
                                               rec.name))
            rec.group_size, rec.collective = n, kind
        # ---- bytes ------------------------------------------------------
        read = ins[1:] if name in _OVERWRITE else ins
        tb = float(sum(tensor_bytes(t) for t in read)
                   + sum(tensor_bytes(t) for t in outs)) + extra
        a.mxu_flops += mxu
        a.vpu_flops += vpu
        a.hbm_bytes += tb
        a.traffic_by_shape[(name, rec.shape)] += tb
        rec.mxu_flops, rec.vpu_flops, rec.hbm_bytes = mxu, vpu, tb
        rec.wire_bytes = wire
        if mxu or vpu or tb or wire:
            a.ops.append(rec)

    @staticmethod
    def _computation() -> str:
        if _SCOPES:
            return _SCOPES[-1]
        return ("backward" if torch._C._current_graph_task_id() != -1
                else "forward")


def capture(fn, *args, tf32: bool | None = None, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`Recorder`.  Returns the call's
    result and its :class:`GraphCapture`: the analysis, the argument bytes
    (local shards of the tensor arguments, each storage once), the bytes
    of results that alias no argument, the peak of live bytes and what
    was alive at it."""
    arg_tensors = {}
    for t in _tensors((args, kwargs)):
        loc = t._local_tensor if isinstance(t, DTensor) else t
        arg_tensors.setdefault(_storage_key(loc), tensor_bytes(loc))
    rec = Recorder(tf32=tf32)
    arg_bytes = sum(arg_tensors.values())
    t0 = time.perf_counter()
    with rec:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    out_bytes = 0
    seen = set(arg_tensors)
    for t in _tensors(out):
        loc = t._local_tensor if isinstance(t, DTensor) else t
        key = _storage_key(loc)
        if key not in seen:
            seen.add(key)
            out_bytes += tensor_bytes(loc)
    return out, GraphCapture(
        analysis=rec.analysis, argument_bytes=arg_bytes,
        output_bytes=out_bytes, peak_bytes=arg_bytes + rec.peak,
        n_dispatched=rec.n_dispatched, seconds=seconds,
        live_at_peak=rec.live_at_peak())
