"""The ``hlo`` frontend: compiled XLA programs as analysis sources (a copy
of ``repro.core.frontends.hlo``).

Accepts HLO text, a path to a dumped ``.hlo``/``.txt`` module, or a
compiled executable exposing ``as_text()`` (the object ``jax.jit(f)
.lower(...).compile()`` returns), and produces an :class:`HLOProgram` —
the input of the registered ``"hlo-roofline"`` performance model.  Unlike
the loop frontends this does not build a :class:`LoopKernel`: HLO programs
are whole dataflow graphs, and their analysis (:mod:`repro_torch.core
.hlo_analysis`) walks the instruction stream directly.
"""
from __future__ import annotations

import dataclasses
import gzip
import hashlib
import pathlib

from . import KernelFrontend, register_frontend, resolve_path

_HLO_SUFFIXES = (".hlo", ".txt", ".hlo.gz")


@dataclasses.dataclass(frozen=True)
class HLOProgram:
    """A per-device HLO module plus the options its analysis needs."""
    text: str
    name: str = "hlo"
    default_group: int = 1           # collective group size when unannotated
    assume_rs_rewrite: bool = True   # cost AR+DS as reduce-scatter

    def cache_key(self) -> tuple:
        return ("hlo", self.name,
                hashlib.sha256(self.text.encode()).hexdigest(),
                self.default_group, self.assume_rs_rewrite)


def _looks_like_hlo(text: str) -> bool:
    return "HloModule" in text or "ENTRY" in text


@register_frontend
class HLOFrontend(KernelFrontend):
    name = "hlo"
    produces = "hlo"

    def matches(self, source) -> bool:
        if isinstance(source, HLOProgram):
            return True
        if hasattr(source, "as_text") and callable(source.as_text):
            return True
        if isinstance(source, pathlib.Path):
            return source.name.endswith(_HLO_SUFFIXES)
        if isinstance(source, str):
            if "\n" in source:
                return _looks_like_hlo(source)
            return source.endswith(_HLO_SUFFIXES)
        return False

    def load(self, source, name: str | None = None,
             constants: dict | None = None, default_group: int = 1,
             assume_rs_rewrite: bool = True, **opts):
        if opts:
            raise TypeError(f"hlo frontend got unknown options {sorted(opts)}")
        if constants:
            raise TypeError(
                "the hlo frontend has no symbolic constants to bind (-D); "
                "shapes are fixed at compile time")
        if isinstance(source, HLOProgram):
            return source
        default_name = "hlo"
        if hasattr(source, "as_text") and callable(source.as_text):
            text = source.as_text()
        elif isinstance(source, (str, pathlib.Path)) and (
                str(source).endswith(_HLO_SUFFIXES)
                and "\n" not in str(source)):
            path = resolve_path(source)
            if path is None:
                raise FileNotFoundError(f"HLO dump not found: {source!r}")
            if path.name.endswith(".hlo.gz"):
                text = gzip.decompress(path.read_bytes()).decode()
                default_name = path.name[:-len(".hlo.gz")]
            else:
                text = path.read_text()
                default_name = path.stem
        elif isinstance(source, str):
            text = source
        else:
            raise TypeError(
                f"hlo frontend expects HLO text, a dump path, or a compiled "
                f"executable, got {type(source).__name__}")
        return HLOProgram(text=text, name=name or default_name,
                          default_group=default_group,
                          assume_rs_rewrite=assume_rs_rewrite)
