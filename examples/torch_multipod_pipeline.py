"""Pipeline parallelism over the pod axis on the PyTorch port (DESIGN.md
§5): run a GPipe schedule across ``--ranks`` simulated pods, one process
each, verify it against the sequential model, and differentiate through
it.

    PYTHONPATH=src python examples/torch_multipod_pipeline.py \
        [--device cpu] [--ranks 8]

The pods are simulated: each is one process of a ``torch.distributed``
group on this host.  With ``--device cpu`` the processes join a gloo group
on the CPU; with ``--device cuda`` (the default) an NCCL group with one
card a rank, and it raises unless there are as many cards as ranks.
"""
import argparse
import os
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch import device as _device
from repro_torch.dist import gpipe

D, B, M = 64, 32, 4
#: the sequential model's tolerance, as the reference example's
TOL = 2e-5


def stage(w, x):
    return torch.tanh(x @ w)


def inputs(n_stages: int) -> tuple:
    g = torch.Generator().manual_seed(0)
    ws = torch.randn(n_stages, D, D, generator=g) * 0.2
    x = torch.randn(B, D, generator=g)
    return ws, x


def rank_main(rank: int, n: int, dev_type: str, port: int):
    backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        dev = torch.device(dev_type, rank) if dev_type == "cuda" \
            else torch.device("cpu")
        mesh = init_device_mesh(dev_type, (n,), mesh_dim_names=("pod",))
        ws, x = inputs(n)
        ws, x = ws.to(dev), x.to(dev)
        piped = gpipe(stage, mesh, axis="pod", n_microbatches=M)
        y = piped(distribute_tensor(ws, mesh, [Shard(0)]), x)

        want = x
        for i in range(n):
            want = stage(ws[i], want)
        err = float((y - want).abs().max())
        torch.testing.assert_close(y, want, rtol=TOL, atol=TOL)

        live = distribute_tensor(ws, mesh, [Shard(0)]).requires_grad_()
        (piped(live, x) ** 2).sum().backward()
        seq = ws.clone().requires_grad_()
        h = x
        for i in range(n):
            h = stage(seq[i], h)
        (h ** 2).sum().backward()
        grad = live.grad.full_tensor()
        gerr = float((grad - seq.grad).abs().max())
        torch.testing.assert_close(grad, seq.grad, rtol=1e-4, atol=1e-5)
        if rank == 0:
            print(f"GPipe over {n} pods == sequential forward ({M} "
                  f"microbatches, {M + n - 1} ticks): max abs err {err:.3g}")
            print(f"backward pipeline OK: grad norm "
                  f"{float(grad.norm()):.3f}, max abs err against the "
                  f"sequential gradient {gerr:.3g}")
            bubble = (n - 1) / (M + n - 1)
            print(f"pipeline bubble fraction at M={M}: {bubble:.2f} "
                  "(drops as microbatches increase)")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=8,
                    help="simulated pods, one process each (default 8)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if B % M:
        raise ValueError("the microbatches must divide the batch")
    if dev.type == "cuda" and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(
            f"--device cuda runs one card a rank: {args.ranks} ranks need "
            f"{args.ranks} cards, this host has {torch.cuda.device_count()}; "
            "pass --device cpu to simulate the pods on the CPU")
    print(f"simulating {args.ranks} pods: {args.ranks} processes of one "
          f"host in a {'nccl' if dev.type == 'cuda' else 'gloo'} group, "
          f"on {dev.type}", flush=True)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(rank_main, args=(args.ranks, dev.type, free_port()),
             nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
