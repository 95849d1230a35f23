"""The machine files the port tests load: the port's own copies under
``src/repro_torch/machines/`` for the port's side, and, for a JAX oracle
inside a parity test, the JAX package's files of the same name (the
reference's side keeps reading its own tree)."""
from __future__ import annotations

import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "src" / "repro_torch" / "machines"
JAX_DIR = REPO / "src" / "repro" / "configs" / "machines"

IVY = str(PORT_DIR / "ivybridge_ep.yaml")
IVY122 = str(PORT_DIR / "ivybridge_ep_sec122.yaml")
V5E = str(PORT_DIR / "tpu_v5e.yaml")
H100 = str(PORT_DIR / "h100_sxm.yaml")


def jax_side(path):
    """The file a JAX oracle reads for the port's machine file ``path``:
    JAX's own copy where it has one (``h100_sxm.yaml`` has none, and is
    read from the port's tree by path as before); anything else as it
    is."""
    p = pathlib.Path(str(path))
    if p.parent == PORT_DIR and (JAX_DIR / p.name).is_file():
        return type(path)(JAX_DIR / p.name) if isinstance(
            path, pathlib.Path) else str(JAX_DIR / p.name)
    return path


def jax_argv(argv: list) -> list:
    """A command line for the JAX CLI: each port machine file swapped for
    JAX's own (:func:`jax_side`)."""
    return [jax_side(a) if isinstance(a, str) else a for a in argv]


def as_port_text(text: str) -> str:
    """JAX's output with its machine directory named as the port's, so a
    report that prints the file it read compares with the port's."""
    return text.replace(str(JAX_DIR), str(PORT_DIR))
