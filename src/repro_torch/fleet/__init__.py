"""Fleet-scale graph analysis: whole-model bottleneck reports (a copy of
the JAX package's ``repro.fleet``).

Where the rest of the repo analyzes one loop nest or prices one op, this
package walks an *entire compiled HLO module* — every dot, fusion,
collective, and while-looped layer stack — prices each instruction
against a machine description (Stengel-style ECM-per-op, arXiv:1410.5010),
and rolls the records up into a ranked bottleneck report whose totals
provably conserve against ``analyze_hlo_text``'s module totals:

    from repro_torch.fleet import FleetAnalyzer

    rep = FleetAnalyzer().analyze("granite-8b", "H100")
    print(rep.render())
    rep.to_dict()        # the artifact payload

CLI: ``python -m repro_torch fleet [--config NAME | --all] [-m MACHINE]``.
The report schema is the JAX package's word for word, so a report on the
same machine file equals JAX's ``to_dict()`` and passes
``scripts/fleet_gate.py`` against ``benchmarks/golden/fleet/``.  Two
defaults differ: the port's machine is its own card (``H100``, label
``h100_sxm``), and artifacts go under ``build/fleet``.  On the H100 the
schema's TPU words keep their keys: ``kind == "tpu"`` marks a machine
file with ``peak flops``/``hbm bandwidth``, ``MXU``/``VPU`` bound
tensor-core and CUDA-core work, and ``ICI`` the interconnect (NVLink).
"""
from .analyzer import (DEFAULT_MACHINES, DUMP_DIR, FleetAnalyzer,
                       dump_configs, load_program, machine_label)
from .pricing import BOUND_CLASSES, MachineRates, PricedOp, price_op, price_ops
from .report import FleetReport

__all__ = [
    "BOUND_CLASSES", "DEFAULT_MACHINES", "DUMP_DIR", "FleetAnalyzer",
    "FleetReport", "MachineRates", "PricedOp", "dump_configs",
    "load_program", "machine_label", "price_op", "price_ops",
]
