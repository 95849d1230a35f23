"""The stencil case study for one shape: predict, run, (time elsewhere).

The full-size counterpart of ``_StencilSpace.predict`` (whose grid
search over block edges is :mod:`repro_torch.tune.space`'s).
:func:`predict_seconds` traces the family's point function at the float32
the kernels run, models it with ECM and Roofline on ``cores`` = the SM
count (so the L2 is shared as on the chip), and converts to seconds the
way the JAX space's ``cores > 1`` branch does: total flops over the
predicted chip-level flop rate.  :func:`run` builds inputs from a numpy
seed and runs the family's ``ops`` wrapper; time it with
:func:`repro_torch.tune.measure.time_cuda`.  :func:`bound_seconds` is the
least time the card could take for one run, from the machine file's HBM
rate and fp32 peak.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Callable

import numpy as np
import torch

from .. import convert
from ..core import api, model_api
from ..core.ecm import ECMResult
from ..core.predictors import VolumePrediction
from ..core.roofline import RooflineResult
from ..kernels import longrange3d, ops, stencil3d7pt
from .measure import Bound


@dataclasses.dataclass(frozen=True)
class Family:
    module: ModuleType            # point function, kernel wrapper, plain version
    op: Callable                  # the ops wrapper the main path calls


FAMILIES = {
    "stencil3d7pt": Family(stencil3d7pt, ops.stencil3d7pt),
    "longrange3d": Family(longrange3d, ops.longrange3d),
}


def family(name: str) -> Family:
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown stencil family {name!r}; "
                         f"available: {sorted(FAMILIES)}") from None


@dataclasses.dataclass(frozen=True)
class StencilPrediction:
    family: str
    shape: tuple[int, int, int]
    cores: int
    flops_total: int
    ecm: ECMResult
    roofline: RooflineResult

    @property
    def ecm_s(self) -> float:
        return self.flops_total / self.ecm.performance_flops(self.cores)

    @property
    def roofline_s(self) -> float:
        return self.flops_total / self.roofline.performance


def kernel(name: str, shape: tuple[int, int, int]):
    """Family ``name``'s point function traced at the float32 the kernels
    run, with ``M`` and ``N`` of one ``(M, N, N)`` run bound."""
    M, N, _ = shape
    return api.load_kernel(family(name).module.point,
                           constants={"M": M, "N": N}, element_bytes=4)


def predict_seconds(name: str, shape: tuple[int, int, int],
                    machine="H100", cores: int | None = None,
                    calibrated: bool = False,
                    volumes: VolumePrediction | None = None,
                    incore: str = "simple") -> StencilPrediction:
    """ECM and (classic) Roofline predictions for one ``(M, N, N)`` run of
    family ``name``.  ``cores`` defaults to the machine's SM count;
    ``calibrated`` applies the machine file's calibration factors (as
    ``tune --apply-calibration`` writes them) to both models.  ``volumes``
    is a finished traffic prediction (a cache simulation, say) that both
    models take in place of the layer conditions at ``cores``; ``incore``
    names the ECM's in-core model."""
    mach = api.resolve_machine(machine)
    if cores is None:
        cores = int(mach.extra.get("SM count", mach.cores_per_socket))
    k = kernel(name, shape)
    M, N, _ = shape
    return StencilPrediction(
        family=name, shape=(M, N, N), cores=cores,
        flops_total=k.flops.total * k.total_iterations(),
        ecm=model_api.analyze("ecm", k, mach, cores=cores,
                              calibrated=calibrated, volumes=volumes,
                              incore=incore),
        roofline=model_api.analyze("roofline", k, mach, cores=cores,
                                   calibrated=calibrated, volumes=volumes))


def bound_seconds(name: str, args, machine="H100") -> Bound:
    """The bytes and operations bounds of one run of family ``name`` on
    ``args`` (as :func:`make_inputs` returns them) on ``machine``."""
    fam = family(name)
    mach = api.resolve_machine(machine)
    grids = [a for a in args if isinstance(a, torch.Tensor)]
    M, N, _ = grids[0].shape
    r = fam.module.RADIUS
    interior = max(0, M - 2 * r) * max(0, N - 2 * r) ** 2
    moved = sum(g.nbytes for g in grids) + grids[0].nbytes
    return Bound(bytes=moved, bytes_s=moved / mach.hbm_bandwidth,
                 ops_s=fam.module.FLOPS_PER_POINT * interior
                 / mach.peak_flops["FP32"])


def make_inputs(name: str, shape: tuple[int, int, int], device=None,
                seed: int = 0) -> tuple:
    """The family's operands, made with numpy from ``seed`` and moved to
    ``device``: the tensors, then the coefficients (host floats)."""
    fam = family(name)
    rng = np.random.default_rng(seed)
    grid = [rng.standard_normal(shape, dtype=np.float32)]
    if fam.module is longrange3d:
        grid.append(rng.standard_normal(shape, dtype=np.float32))
        grid.append(rng.uniform(0.5, 1.0, shape).astype(np.float32))
        coeffs = tuple(np.linspace(0.05, 0.25, 5))
    else:
        coeffs = tuple(np.linspace(0.1, 0.7, 7))
    return (*(convert.to_tensor(g, device) for g in grid), coeffs)


def run(name: str, shape: tuple[int, int, int], device=None,
        seed: int = 0) -> torch.Tensor:
    """One run of the family's ``ops`` wrapper on seeded inputs."""
    return family(name).op(*make_inputs(name, shape, device, seed))
