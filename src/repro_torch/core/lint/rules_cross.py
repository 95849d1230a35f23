"""Cross rules (X3xx): request combinations that are individually valid
but jointly not (a copy of ``repro.core.lint.rules_cross``, in its words:
X302's "TPU machine description" is one with ``peak flops``/``hbm
bandwidth`` fields, which ``h100_sxm.yaml`` has).

Every name in the request resolves against a real registry entry — an
*unknown* name is an ordinary ``ValueError`` from the registries and
stays one.  These rules catch the pairs that pass name resolution and
then fail (or silently misbehave) deep inside the pipeline: an HLO model
pointed at a loop kernel, the compiled sweep plan under a predictor with
no closed form, the port scheduler on a machine that declares no ports.
"""
from __future__ import annotations

from typing import Iterable

from ..frontends.hlo import HLOProgram
from ..kernel_ir import LoopKernel
from .diagnostics import Diagnostic
from .engine import LintContext, LintRule, register_rule


def _kernel_kind(kernel) -> str | None:
    if isinstance(kernel, LoopKernel):
        return "loop"
    if isinstance(kernel, HLOProgram):
        return "hlo"
    return None


def _resolve_model(name):
    from ..model_api import resolve_model
    try:
        return resolve_model(str(name))
    except ValueError:
        return None                           # unknown name: not ours


@register_rule
class ModelInputKind(LintRule):
    """X301 — the requested model consumes a different kernel kind than
    the frontend produced (``ecm`` on an HLO dump, ``hlo-roofline`` on a
    C loop nest)."""

    code = "X301"
    family = "cross"
    title = "model/input-kind mismatch"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kind = _kernel_kind(ctx.kernel)
        if kind is None:
            return
        for name in _request_models(ctx):
            model = _resolve_model(name)
            if model is None or model.input_kind == kind:
                continue
            other = ("an HLO program (use the 'hlo' frontend)"
                     if model.input_kind == "hlo"
                     else "a loop kernel (use a c/builder/trace source)")
            suggestion = ("use -p hlo-roofline" if kind == "hlo"
                          else "use -p ecm / roofline, or pass an HLO "
                               "source")
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"model {model.name!r} consumes {other}, but "
                        f"the source loaded as a {kind} kernel",
                suggestion=suggestion,
                subject=model.name)


def _request_models(ctx: LintContext) -> list[str]:
    model = ctx.request.get("model")
    models = ctx.request.get("models")
    out = []
    if model:
        out.append(str(model))
    if models:
        out.extend(str(m) for m in models)
    return out


@register_rule
class HLOModelMachine(LintRule):
    """X302 — ``hlo-roofline`` needs the TPU fields of the machine file
    ('peak flops' / 'hbm bandwidth'); on a cache machine like IVY it
    would otherwise be costed with another chip's constants.  A dtype
    the machine has no peak entry for is the same failure."""

    code = "X302"
    family = "cross"
    title = "hlo model on non-TPU machine"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        m = ctx.machine
        for name in _request_models(ctx):
            model = _resolve_model(name)
            if model is None or model.input_kind != "hlo":
                continue
            if not m.peak_flops and not m.hbm_bandwidth:
                yield Diagnostic(
                    code=self.code, severity="error",
                    message=f"model {model.name!r} needs a TPU machine "
                            f"description, but {m.name!r} carries no "
                            "'peak flops' / 'hbm bandwidth' fields",
                    suggestion="use -m V5E (or add the TPU fields)",
                    subject=m.name)
                continue
            dtype = str(ctx.request.get("dtype", "BF16")).upper()
            if m.peak_flops and dtype not in m.peak_flops:
                yield Diagnostic(
                    code=self.code, severity="error",
                    message=f"machine {m.name!r} has no peak flops for "
                            f"dtype {dtype!r} (available: "
                            f"{sorted(m.peak_flops)})",
                    suggestion="pick a dtype the machine declares, or "
                               "add its peak",
                    subject=dtype)


@register_rule
class CompiledPredictor(LintRule):
    """X303 — the compiled sweep plan (``--dense``) batches analytic
    closed forms; a predictor without one (SIM) cannot take that path."""

    code = "X303"
    family = "cross"
    title = "compiled sweep under a closed-form-free predictor"
    needs = ()

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        if ctx.request.get("compiled") is not True:
            return
        predictor = str(ctx.request.get("predictor", "LC")).upper()
        try:
            from ..predictors import resolve_predictor
            p = resolve_predictor(predictor)
        except ValueError:
            return
        if not p.supports_compiled:
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"predictor {predictor!r} has no analytic "
                        "closed form to compile; --dense cannot batch "
                        "it",
                suggestion="drop --dense (per-point sweep) or use "
                           "--cache-predictor LC",
                subject=predictor)
        kernel = ctx.kernel
        if kernel is not None and not isinstance(kernel, LoopKernel):
            yield Diagnostic(
                code=self.code, severity="error",
                message="compiled sweeps evaluate LoopKernel closed "
                        f"forms; the source loaded as "
                        f"{type(kernel).__name__}",
                suggestion="use a c/builder/trace source, or drop "
                           "--dense",
                subject=type(kernel).__name__)


@register_rule
class NdSweepAxes(LintRule):
    """X307 — an N-dimensional sweep grid (multiple ``--range`` symbols
    and/or ``--cores-range``) under a predictor without analytic closed
    forms.  The compiled engine batches such grids by LC regime cell;
    the simulator has no closed form, so a ``--dense`` request is an
    error (naming each axis) and an auto-routed one degrades to
    per-point simulation over the full Cartesian product."""

    code = "X307"
    family = "cross"
    title = "N-D sweep grid under a closed-form-free predictor"
    needs = ()

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        axes = [str(s) for s in ctx.request.get("sweep_params") or []]
        if ctx.request.get("cores_axis"):
            axes.append("cores")
        if len(axes) <= 1:
            return
        predictor = str(ctx.request.get("predictor", "LC")).upper()
        try:
            from ..predictors import resolve_predictor
            p = resolve_predictor(predictor)
        except ValueError:
            return
        if p.supports_compiled:
            return
        grid = " × ".join(axes)
        if ctx.request.get("compiled") is True:
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"--dense over the ({grid}) grid needs analytic "
                        f"closed forms on every axis; predictor "
                        f"{predictor!r} has none",
                suggestion="drop --dense (per-point sweep) or use "
                           "--cache-predictor LC",
                subject=grid)
        else:
            yield Diagnostic(
                code=self.code, severity="warning",
                message=f"the ({grid}) grid cannot batch under predictor "
                        f"{predictor!r}; every grid point will run a "
                        "full cache simulation",
                suggestion="use --cache-predictor LC for batched "
                           "regime-cell evaluation, or shrink the grid",
                subject=grid)


@register_rule
class LoopOnlyOperation(LintRule):
    """X304 — operations defined only over the affine loop IR (blocking
    analysis, LC transition points) requested for a non-loop source."""

    code = "X304"
    family = "cross"
    title = "loop-only operation on non-loop source"
    needs = ("kernel",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        op = ctx.request.get("operation")
        if op not in ("blocking", "transition-points"):
            return
        if not isinstance(ctx.kernel, LoopKernel):
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"{op} analyzes symbolic loop kernels; the "
                        f"source loaded as "
                        f"{type(ctx.kernel).__name__}",
                suggestion="use a c/builder/trace source",
                subject=str(op))


@register_rule
class KernelDtypeSupport(LintRule):
    """X305 — the kernel's element size has no FLOPs-per-cycle class on
    this machine; the in-core model silently falls back to default
    rates."""

    code = "X305"
    family = "cross"
    title = "kernel dtype unsupported by machine"
    needs = ("kernel", "machine")

    _CLASS = {8: "DP", 4: "SP"}

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        kernel = ctx.loop_kernel
        m = ctx.machine
        if kernel is None or m.arch != "x86" or not m.flops_per_cycle:
            return
        cls = self._CLASS.get(kernel.dtype_bytes)
        if cls is not None and cls not in m.flops_per_cycle:
            yield Diagnostic(
                code=self.code, severity="warning",
                message=f"kernel elements are {kernel.dtype_bytes} B "
                        f"({cls}) but machine {m.name!r} declares no "
                        f"{cls} FLOPs-per-cycle class; default rates "
                        "will be used",
                suggestion=f"add a {cls} row to the machine's 'FLOPs "
                           "per cycle'",
                subject=cls)


@register_rule
class PortsModelAvailability(LintRule):
    """X306 — ``--incore ports`` on a machine whose description has no
    ``ports:`` table (entry-level coverage, given a table, is M203)."""

    code = "X306"
    family = "cross"
    title = "ports in-core model without a ports table"
    needs = ("machine",)

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        if str(ctx.request.get("incore", "simple")).lower() != "ports":
            return
        if ctx.machine.ports is None:
            yield Diagnostic(
                code=self.code, severity="error",
                message=f"--incore ports needs a ports: table, but "
                        f"machine {ctx.machine.name!r} declares none",
                suggestion="use --incore simple, or add a ports: "
                           "section to the machine file",
                subject=ctx.machine.name)
