"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in a page.

Analyze a C stencil kernel with layer conditions, build the ECM and
Roofline models for Ivy Bridge EP (the paper's machine) and ECM for the
H100, predict the blocking factor, then run the 7-point stencil as a
hand-written CUDA kernel and hold it against its plain PyTorch version.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The kernel runs on the card unless ``--device cpu`` is named; on the CPU
the kernel's wrapper runs the plain version (no launch).
"""
import argparse
import pathlib

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import (blocking, ecm, load_machine, parse_kernel,
                              reports, roofline)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import stencil3d7pt as s7

ROOT = pathlib.Path(__file__).resolve().parent.parent
STENCILS = ROOT / "src" / "repro_torch" / "configs" / "stencils"
#: the paper's machine (``repro_torch/machines/ivybridge_ep.yaml``)
IVY = "IVY"
SHAPE = (10, 64, 64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    # 1. parse the kernel (paper Listing 1) and bind sizes (-D M ... -D N ...)
    kernel = parse_kernel((STENCILS / "stencil_3d7pt.c").read_text(),
                          constants={"M": 300, "N": 1000})
    machine = load_machine(IVY)

    # 2. ECM model with layer-condition cache prediction
    res = ecm.model(kernel, machine, predictor="LC")
    print(reports.ecm_report(res))
    print(f"ECM notation (IVY): {res.notation()}")

    # 3. Roofline with the in-core port model (the IACA stand-in)
    print(reports.roofline_report(roofline.model(kernel, machine)))

    # 4. the same ECM on the H100 machine file
    h100 = ecm.model(kernel, load_machine("H100"), predictor="LC")
    print(f"ECM notation (H100, one SM): {h100.notation()}")

    # 5. spatial blocking advice (solve C_req(t) <= C for the loop size)
    bs = blocking.lc_block_size(kernel, machine.level("L3").size_bytes, "N")
    print(f"\nL3 blocking factor for N: block at ~{bs} columns")

    # 6. the same stencil as a CUDA kernel, held against its plain version
    g = torch.Generator().manual_seed(0)
    a = torch.randn(SHAPE, generator=g, dtype=torch.float32).to(dev)
    coeffs = dict(W=.1, E=.2, N=.3, S=.15, F=.25, B=.05, s=-1.)
    before = s7.stencil3d7pt.launches
    out = ops.stencil3d7pt(a, [coeffs[c] for c in "WENSFB"] + [coeffs["s"]])
    launched = s7.stencil3d7pt.launches - before
    want = ref.stencil3d7pt(a, coeffs)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=1e-6)
    err = float((out - want).abs().max())
    route = (f"cuda (src/repro_torch/csrc/stencil3d7pt.cu), {launched} "
             "launch" if launched else "plain PyTorch version (cpu, no "
             "launch)")
    print(f"route: {route}")
    print(f"kernel matches the plain version on {SHAPE} on {dev} "
          f"(max abs err {err:.3g}; rtol 2e-5, atol 1e-6)")
    if dev.type == "cuda" and launched != 1:
        raise RuntimeError(f"expected one launch on {dev}, counted "
                           f"{launched}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
