"""Command-line launchers of the port (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun``) and the mesh and cell builders they share.

``dryrun`` is exported lazily (``repro_torch.launch.dryrun``): importing
the package must not import it, or ``python -m
repro_torch.launch.dryrun`` would find the module loaded before it runs.
"""
from __future__ import annotations

import importlib

__all__ = ["dryrun"]


def __getattr__(name: str):
    if name == "dryrun":
        return importlib.import_module(f"{__name__}.dryrun")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
