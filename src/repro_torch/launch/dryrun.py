"""Dry run of one (arch × shape × mesh) cell on the host, priced on the
H100: the counterpart of ``repro.launch.dryrun``.

JAX lowers and compiles a cell on 256 or 512 forced host devices and
reads the per-device HLO.  The port runs the cell's step once, eagerly,
as one rank of the production mesh: a fake process group of 256 or 512
ranks (:func:`fake_world`), the mesh over it, the step's arguments as
fake tensors placed as the cell's specs say (each a DTensor holding this
rank's local shard), and the call recorded by
:class:`~repro_torch.core.graph_analysis.Recorder`.  Nothing is
allocated and no device is touched, so the 671B-parameter cells run on
any host.  Every layer runs: none is extrapolated from another.

The report is JAX's ``RooflineReport`` with its ``memory``,
``schedule_head`` and ``top_traffic``, written to
``build/dryrun/<arch>__<shape>__<mesh>.json``.  Unlike JAX's, which
prices on v5e constants, the three terms are priced on the H100 machine
file through :class:`~repro_torch.fleet.pricing.MachineRates` (tensor
cores, CUDA cores, HBM, NVLink), as the port's ``fleet`` is.

The mesh is a CPU mesh, on which DTensor would replace every all-to-all
with an all-gather and a chunk (gloo has no all-to-all);
:func:`device_collectives` restores the all-to-all a card's mesh runs, so
the schedule is the deployment's.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --list

A process holds one default process group, so a caller that has its own
(a card run over NCCL) runs the dry run in a child process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import configs
from ..core import api as _api
from ..core import graph_analysis, hlo_analysis
from ..fleet.pricing import MachineRates
from ..models import common
from .cell import build_cell
from .mesh import make_production_mesh

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: the prefill ``scripts/gen_fleet_hlo.py`` lowers for the bundled dumps
FLEET_SHAPE = configs.ShapeSpec("fleet_prefill", "prefill", seq=128,
                                batch=4)
MACHINE = "H100"


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    being rank 0: collectives return tensors of the right shape and move
    nothing.  Refuses to start when the process has a default group."""
    if dist.is_initialized():
        raise RuntimeError(
            "this process already has a default process group "
            f"({dist.get_backend()}, {dist.get_world_size()} ranks); the "
            "dry run starts its own fake one: run it in a fresh process")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def device_collectives():
    """DTensor's shard-to-shard redistribution as the all-to-all a card's
    mesh runs (``_dtensor::shard_dim_alltoall``), also on a CPU mesh, where
    torch replaces it with an all-gather and a chunk."""
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [m for m in (_collective_utils, placement_types)
            if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.shard_dim_alltoall = f


def fake_args(cell, mesh) -> tuple:
    """The cell's arguments as fake tensors (call under a
    ``FakeTensorMode``): each leaf with a spec a DTensor on ``mesh``
    holding this rank's local shard (chunked as DTensor chunks), and the
    step's scalar argument, the step number (train) or the decode
    position, as a Python int: 0, or the last slot of the cache."""
    scalar = 0 if cell.shape.kind == "train" else cell.shape.seq - 1
    coord = mesh.get_coordinate()

    def one(t, spec):
        full = torch.empty(t.shape, dtype=t.dtype)
        place = common.placements(spec, mesh)
        local = full
        for i, p in enumerate(place):
            if p.is_shard():
                local = torch.chunk(local, mesh.size(i), dim=p.dim)[coord[i]]
        return DTensor.from_local(local.clone(), mesh, place,
                                  run_check=False, shape=full.shape,
                                  stride=full.stride())
    return tuple(
        scalar if isinstance(a, torch.Tensor) and a.dim() == 0
        and not a.dtype.is_floating_point else common.tmap(one, a, spec)
        for a, spec in zip(cell.abstract_args, cell.in_specs))


def capture_cell(cell, mesh) -> graph_analysis.GraphCapture:
    """One call of ``cell.fn`` on fake arguments placed on ``mesh``,
    recorded.  The step's scalar argument, a Python int here, counts the
    bytes of the 0-dim tensor it stands for, as JAX's argument does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = fake_args(cell, mesh)
        with device_collectives():
            _, cap = graph_analysis.capture(cell.fn, *args)
    scalars = sum(a.element_size() for a, b in zip(cell.abstract_args, args)
                  if isinstance(b, int))
    cap.argument_bytes += scalars
    cap.peak_bytes += scalars
    return cap


def roofline(cap: graph_analysis.GraphCapture, rates: MachineRates, *,
             arch: str, shape: str, mesh: str, chips: int,
             model_flops_global: float) -> dict:
    """JAX's ``RooflineReport`` of one capture, priced at ``rates``: the
    compute term is the slower of the tensor cores and the CUDA cores (as
    ``hlo-roofline`` composes them), and ``roofline_fraction`` is taken at
    the machine's tensor-core peak."""
    ana = cap.analysis
    t_compute = max(ana.mxu_flops / rates.mxu_peak,
                    ana.vpu_flops / rates.vpu_peak)
    rep = hlo_analysis.RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        mxu_flops=ana.mxu_flops, vpu_flops=ana.vpu_flops,
        hbm_bytes=ana.hbm_bytes,
        collective_bytes=ana.collective_wire_bytes,
        collective_by_kind=dict(ana.collective_by_kind),
        t_compute=t_compute, t_memory=ana.hbm_bytes / rates.mem_bandwidth,
        t_collective=ana.collective_wire_bytes / rates.wire_bandwidth,
        model_flops=model_flops_global / chips,
        memory_per_device=float(cap.peak_bytes),
        argument_bytes=float(cap.argument_bytes),
        n_collectives=len(ana.schedule))
    rec = rep.to_dict()
    bound = rep.t_total_overlapped
    rec["roofline_fraction"] = (rep.model_flops / rates.mxu_peak / bound
                                if bound > 0 else 0.0)
    rec.update(machine=rates.machine, rates=rates.to_dict(),
               memory=cap.memory(),
               schedule_head=[{
                   "kind": r.kind, "bytes": r.result_bytes,
                   "x": r.multiplier, "group": r.group_size}
                   for r in ana.schedule[:24]],
               top_traffic=[{"op": n, "bytes": int(b)}
                            for n, b in ana.top_traffic(12)],
               live_at_peak=[{"op": n, "bytes": int(b)}
                             for n, b in cap.live_at_peak[:12]],
               n_ops=len(ana.ops), dispatched=cap.n_dispatched)
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_dir: pathlib.Path = OUT_DIR, verbose: bool = True) -> dict:
    """Run one cell on its production mesh as rank 0 of a fake process
    group and write its report (module docstring); returns the report."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, multi_pod=multi_pod)
    rates = MachineRates.from_machine(_api.resolve_machine(MACHINE))
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh.size()
        cap = capture_cell(cell, mesh)
    rec = roofline(cap, rates, arch=arch, shape=shape, mesh=mesh_name,
                   chips=chips, model_flops_global=cell.model_flops_global)
    rec.update(capture_s=round(cap.seconds, 2),
               host_s=round(time.perf_counter() - t0, 2))
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{arch}__{shape}__{mesh_name}.json", "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        gib = rec["memory"]["total_per_device"] / 2 ** 30
        print(f"[dryrun] {arch} x {shape} x {mesh_name}: "
              f"{rec['host_s']:.1f}s, {gib:.2f} GiB/device, "
              f"T=(c {rec['t_compute'] * 1e3:.2f} | m "
              f"{rec['t_memory'] * 1e3:.2f} | x "
              f"{rec['t_collective'] * 1e3:.2f}) ms on {rates.machine}, "
              f"dominant={rec['dominant']}, "
              f"collectives={sorted(rec['collective_by_kind'])}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run of (arch x shape) cells on the production "
                    "meshes, on the host, priced on the H100")
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every supported (arch x shape) cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR), metavar="DIR",
                    help="report directory (default build/dryrun)")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in configs.cells():
            print(f"{a:30s} {s}")
        return 0

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        todo = configs.cells()
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all, are required")

    failures = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, out_dir=pathlib.Path(args.out))
            except Exception as e:             # noqa: BLE001
                failures.append((arch, shape, mp, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall dry-run cells ran OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
