"""The ``graph`` frontend: the port's own programs as analysis sources.

``graph:<arch>[:<shape>]`` captures one call of the port's step for
``arch`` under :class:`~repro_torch.core.graph_analysis.Recorder` and
returns a :class:`GraphProgram`, the counterpart of an
:class:`~repro_torch.core.frontends.hlo.HLOProgram` for what the port
runs: the registered ``"hlo-roofline"`` model and the fleet analyzer
price it from its per-op records instead of from HLO text.

The default cell is the one ``scripts/gen_fleet_hlo.py`` lowers for the
JAX package's bundled dumps: the reduced config with ``tp=2``, a prefill
of 4 sequences of 128 tokens (``fleet_prefill``), on a (2, 2) mesh.  A
named shape (``graph:granite-8b:train_4k``) runs that shape's step on the
same config and mesh.  The capture runs on fake tensors over a fake
process group of 4 ranks (:func:`repro_torch.launch.dryrun.fake_world`),
so it needs no device, and a process that already holds a default
process group cannot start one: run it in a fresh process (``python -m
repro_torch fleet --config graph:<arch>``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from ..hlo_analysis import HLOAnalysis
from . import KernelFrontend, register_frontend

PREFIX = "graph:"
#: the mesh of the default cell, (data, model)
MESH = (2, 2)
#: the reduced configs' tensor-parallel width in the default cell
TP = 2


@dataclasses.dataclass(frozen=True)
class GraphProgram:
    """One captured call of the port: what it ran (arch, shape, mesh, a
    digest of the config) and its per-device analysis."""
    arch: str
    shape: str
    mesh: tuple
    config_digest: str
    analysis: HLOAnalysis = dataclasses.field(compare=False, hash=False,
                                              repr=False)

    @property
    def name(self) -> str:
        return f"{PREFIX}{self.arch}"

    def analysis_digest(self) -> str:
        rows = [rec.to_dict() for rec in self.analysis.ops]
        return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()
                              ).hexdigest()

    def cache_key(self) -> tuple:
        # "graph" first: never equal to an HLOProgram's ("hlo", ...)
        return ("graph", self.arch, self.shape, tuple(self.mesh),
                self.config_digest, self.analysis_digest())


def config_digest(cfg, shape) -> str:
    text = repr((dataclasses.asdict(cfg), dataclasses.asdict(shape)))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def capture_program(arch: str, shape: str | None = None) -> GraphProgram:
    """The default cell of ``arch`` (module docstring), or ``shape``'s step
    on its config and mesh, captured on a fake 4-rank process group."""
    from ... import configs
    from ...launch import cell as _cell
    from ...launch import dryrun
    from ...launch.mesh import make_local_mesh
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              tp=TP)
    spec = configs.SHAPES[shape] if shape else dryrun.FLEET_SHAPE
    cell = _cell.build_cell(arch, spec, cfg=cfg)
    with dryrun.fake_world(MESH[0] * MESH[1]):
        mesh = make_local_mesh(*MESH, device="cpu")
        cap = dryrun.capture_cell(cell, mesh)
    return GraphProgram(arch=cfg.name, shape=spec.name, mesh=MESH,
                        config_digest=config_digest(cfg, spec),
                        analysis=cap.analysis)


@register_frontend
class GraphFrontend(KernelFrontend):
    name = "graph"
    produces = "hlo"

    def matches(self, source) -> bool:
        return isinstance(source, GraphProgram) or (
            isinstance(source, str) and source.startswith(PREFIX))

    def load(self, source, name: str | None = None,
             constants: dict | None = None, **opts):
        if opts:
            raise TypeError(
                f"graph frontend got unknown options {sorted(opts)}")
        if constants:
            raise TypeError("the graph frontend has no symbolic constants "
                            "to bind (-D); shapes come from the config")
        if isinstance(source, GraphProgram):
            return source
        if not self.matches(source):
            raise TypeError(f"graph frontend expects '{PREFIX}<arch>"
                            f"[:<shape>]', got {source!r}")
        arch, _, shape = source[len(PREFIX):].partition(":")
        return capture_program(arch, shape or None)
