"""The ``c`` frontend: the paper's original input language.

Accepts C source text or a path to a ``.c`` file (resolved against the
bundled ``configs/stencils`` like the machine loader resolves YAML names)
and produces a :class:`~repro_torch.core.kernel_ir.LoopKernel` via
:mod:`repro_torch.core.c_parser`.
"""
from __future__ import annotations

import pathlib

from .. import c_parser
from . import KernelFrontend, register_frontend, resolve_path


def _looks_like_c(text: str) -> bool:
    return "for" in text and ("{" in text or ";" in text)


@register_frontend
class CFrontend(KernelFrontend):
    name = "c"
    produces = "loop"

    def matches(self, source) -> bool:
        if isinstance(source, pathlib.Path):
            return source.suffix == ".c"
        if not isinstance(source, str):
            return False
        if "\n" not in source and source.endswith(".c"):
            return True
        return _looks_like_c(source)

    def load(self, source, name: str | None = None,
             constants: dict | None = None, **opts):
        if opts:
            raise TypeError(f"c frontend got unknown options {sorted(opts)}")
        text, default_name, source_path = source, "kernel", ""
        if isinstance(source, pathlib.Path) or (
                isinstance(source, str) and "\n" not in source
                and source.endswith(".c")):
            path = resolve_path(source)
            if path is None:
                raise FileNotFoundError(
                    f"kernel source file not found: {source!r} "
                    "(tried cwd and the bundled configs/stencils)")
            text = path.read_text()
            default_name = path.stem
            source_path = str(path)
        return c_parser.parse_kernel(text, name=name or default_name,
                                     constants=constants,
                                     source_path=source_path)
