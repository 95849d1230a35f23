"""The paper's §3 case study end to end on the PyTorch/CUDA port (Listings
4 & 5, Figs 3-5): one ``analyze()`` call models the long-range stencil
from its C file and from the port's traced point function, on the same
memoized session; the CUDA long-range kernel runs against its plain
PyTorch version; and the plain version's own aten program, recorded by
the graph recorder, is priced by ``hlo-roofline`` on the H100 file.

    PYTHONPATH=src python examples/torch_stencil_modeling.py [--device cpu]

The kernel runs on the card unless ``--device cpu`` is named; on the CPU
the kernel's wrapper runs the plain version (no launch).
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import (analyze, get_session, graph_analysis,
                              load_machine, reports, trace_kernel)
from repro_torch.core.frontends.graph import GraphProgram
from repro_torch.kernels import longrange3d as lr
from repro_torch.kernels import ops, ref

#: the paper's machine (``repro_torch/machines/ivybridge_ep.yaml``)
IVY = "IVY"
C_FILE = "stencil_3d_long_range.c"      # resolves in the port's stencils
SIZES = {"M": 130, "N": 1015}
SHAPE = (12, 64, 64)
COEFFS = [0.5, 0.1, 0.05, 0.02, 0.01]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    print(f"=== python -m repro_torch analyze {C_FILE} -m IVY -p ECM "
          "-D M 130 -D N 1015 ===")
    for pred in ("LC", "SIM"):
        res = analyze(C_FILE, IVY, model="ecm", predictor=pred,
                      name="3d-long-range", constants=SIZES)
        print(f"[{pred}] {res.notation()}  -> saturating at "
              f"{res.saturation_cores} cores")

    print("\n=== the same kernel through the trace frontend "
          "(the port's point function) ===")
    traced = analyze(lr.point, IVY, model="ecm", predictor="LC",
                     constants=SIZES)
    c_res = analyze(C_FILE, IVY, model="ecm", predictor="LC",
                    name="3d-long-range", constants=SIZES)
    assert traced.to_dict() == c_res.to_dict(), "frontend parity violated"
    print(f"trace == c frontend, bit-identical: {traced.notation()}")
    k = trace_kernel(lr.point, constants=SIZES)
    print(f"traced IR: {len(k.reads())} reads, {len(k.writes())} write, "
          f"{k.flops.total} flops/it")

    ivy = load_machine(IVY)
    print()
    print(reports.lc_report(k, ivy, symbol="N"))

    print("\n=== scaling (paper Fig 5; session cache hit) ===")
    res = analyze(C_FILE, IVY, model="ecm", predictor="LC",
                  name="3d-long-range", constants=SIZES)
    for c, p in enumerate(res.scaling_curve(8), 1):
        print(f"  {c} cores: {p / 1e9:6.2f} GFLOP/s")
    stats = get_session(ivy).stats
    print(f"session: {stats.hits} cache hits / {stats.misses} misses")

    print("\n=== machine-readable result (Result.to_dict round-trip) ===")
    rt = reports.from_json(reports.to_json(res))
    assert rt.to_dict() == res.to_dict(), "JSON round trip changed the result"
    print(f"t_ecm={rt.t_ecm:.1f} cy/CL, saturation={rt.saturation_cores} "
          "cores (rebuilt from JSON)")

    print("\n=== the same stencil as a CUDA kernel ===")
    g = torch.Generator().manual_seed(0)
    u, v = (torch.randn(SHAPE, generator=g) for _ in range(2))
    roc = torch.randn(SHAPE, generator=g) * .1
    u, v, roc = (t.to(dev) for t in (u, v, roc))
    c = torch.tensor(COEFFS, dtype=torch.float32)
    before = lr.longrange3d.launches
    out = ops.longrange3d(u, v, roc, COEFFS)
    launched = lr.longrange3d.launches - before
    want = ref.longrange3d(u, v, roc, c.to(dev))
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    err = float((out - want).abs().max())
    plan = ops.plan(lr, u)
    route = (f"cuda (src/repro_torch/csrc/longrange3d.cu), {launched} "
             "launch" if launched else "plain PyTorch version (cpu, no "
             "launch)")
    print(f"route: {route}")
    print(f"long-range kernel == plain version on {SHAPE} on {dev} (max abs "
          f"err {err:.3g}; rtol 2e-4, atol 1e-5); launch plan: tile "
          f"{plan.bj}x{plan.bi}, {plan.c} points a thread, a ring of "
          f"{plan.stages} planes (the 3D layer condition in shared memory)")
    if dev.type == "cuda" and launched != 1:
        raise RuntimeError(f"expected one launch on {dev}, counted "
                           f"{launched}")

    print("\n=== and the plain version's aten program through the graph "
          "recorder ===")
    _, cap = graph_analysis.capture(ref.longrange3d, u, v, roc, c.to(dev))
    prog = GraphProgram(arch="longrange3d-ref", shape=str(SHAPE), mesh=(1,),
                        config_digest="", analysis=cap.analysis)
    hres = analyze(prog, "H100", model="hlo-roofline",
                   name="longrange3d-ref")
    print(reports.hlo_report(hres))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
