"""The ``builder`` frontend: hand-constructed kernel IR.

Accepts an existing :class:`~repro_torch.core.kernel_ir.LoopKernel`
(passthrough, with ``constants`` applied via :meth:`LoopKernel.bind`) or a
dict of :func:`~repro_torch.core.kernel_ir.make_stencil` keyword arguments
— the programmatic alternative the Python builder API always offered,
behind the same registry as the C and trace frontends.
"""
from __future__ import annotations

import dataclasses

from ..kernel_ir import LoopKernel, make_stencil
from . import KernelFrontend, register_frontend


@register_frontend
class BuilderFrontend(KernelFrontend):
    name = "builder"
    produces = "loop"

    def matches(self, source) -> bool:
        return isinstance(source, (LoopKernel, dict))

    def load(self, source, name: str | None = None,
             constants: dict | None = None, **opts):
        if opts:
            raise TypeError(
                f"builder frontend got unknown options {sorted(opts)}")
        if isinstance(source, LoopKernel):
            k = source.bind(**(constants or {}))
            if name and name != k.name:
                k = dataclasses.replace(k, name=name)
            return k
        if isinstance(source, dict):
            kw = dict(source)
            if name:
                kw["name"] = name
            if constants:
                kw["constants"] = {**kw.get("constants", {}), **constants}
            return make_stencil(**kw)
        raise TypeError(
            f"builder frontend expects a LoopKernel or make_stencil kwargs "
            f"dict, got {type(source).__name__}")
