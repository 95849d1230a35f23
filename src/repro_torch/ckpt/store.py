"""Checkpoints: one ``.npy`` per leaf in an atomic step directory.

Counterpart of ``repro.ckpt.store``, with its layout, so a checkpoint
written by either package restores in the other:
``<dir>/step_%08d/<dotted.key>.npy`` plus ``manifest.json`` (step, extra,
each leaf's shape and dtype string).  A key joins dict keys and list
indices with ``.``; dict keys go in sorted order, as JAX flattens them.
bfloat16, which numpy lacks, is stored as its raw ``uint16`` bits
(``Tensor.view(torch.int16)`` and a numpy view, no ``ml_dtypes``) and
named ``"bfloat16"`` in the manifest.

Writes go to a tmp directory that is renamed into place, so a crash
mid-save never corrupts the latest complete checkpoint.  ``AsyncSaver``
copies the tensors to the host, then writes on a background thread.

Sharded leaves (DTensors): each leaf is written whole.  JAX's single
controller gathers a sharded array to the host; here every rank runs
``save`` (SPMD), every rank gathers each leaf (``full_tensor()``, a
collective), rank 0 writes and the others wait at a barrier.
:func:`restore` with ``shardings`` (a tree of
:class:`~repro_torch.models.common.Sharding`) puts each leaf onto its
mesh and placements whatever mesh wrote it — elastic re-sharding: every
rank reads the file and keeps its shard.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import device as _device
from ..models.common import tmap


def flatten(tree, prefix: str = "") -> dict:
    """{dotted key: leaf} of a tree of dicts and lists, in JAX's order
    (dict keys sorted, lists in order): the checkpoint's leaf names."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return flat


def _unflatten(tree, values: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}.{k}" if prefix
                              else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, f"{prefix}.{i}" if prefix
                                     else str(i)) for i, v in enumerate(tree))
    return values[prefix]


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """A host array and the dtype string the manifest records."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        t = t.numpy()
    arr = np.asarray(t)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.require(arr, requirements="C")    # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif arr.dtype.name != dtype:
        raise ValueError(f"a leaf stored as {arr.dtype} where the manifest "
                         f"says {dtype}")
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _gathered(tree):
    """``tree`` with each DTensor leaf gathered whole (a collective every
    rank takes part in), and whether there was one."""
    sharded = any(isinstance(v, DTensor) for v in flatten(tree).values())
    return tmap(lambda v: v.full_tensor() if isinstance(v, DTensor)
                else v, tree), sharded


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(directory, step: int, tree, extra: dict | None = None
         ) -> pathlib.Path:
    """Write ``tree`` as step ``step``.  With DTensor leaves every rank
    calls this: each leaf is gathered, rank 0 writes, and every rank
    returns once the step directory is in place."""
    tree, sharded = _gathered(tree)
    final = pathlib.Path(directory) / f"step_{step:08d}"
    if _writer():
        _write(directory, step, tree, extra)
    if sharded:
        dist.barrier()
    return final


def _write(directory, step: int, tree, extra: dict | None
           ) -> pathlib.Path:
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    manifest = {"step": step, "extra": extra or {},
                "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                           for k, (a, dt) in flat.items()}}
    for k, (a, _) in flat.items():
        np.save(tmp / (k + ".npy"), a)
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(directory, step: int, template, shardings=None, device=None):
    """Restore into the structure of ``template`` (a tree of tensors or
    arrays keyed as at save time).  With ``shardings`` (a tree of
    :class:`~repro_torch.models.common.Sharding` matching ``template``)
    each leaf is placed on its mesh and placements — the elastic
    re-shard path.  Otherwise each leaf goes to ``device``, or to its
    template leaf's device when None (the CPU for an array).  Returns
    ``(tree, manifest)``."""
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    with open(directory / "manifest.json") as f:
        manifest = json.load(f)
    meta = manifest["leaves"]
    places = flatten(shardings) if shardings is not None else {}
    values = {}
    for key, tmpl in flatten(template).items():
        if key not in meta:
            raise KeyError(f"checkpoint missing leaf {key}")
        sh = places.get(key)
        dev = ("cpu" if sh is not None
               else _device.resolve(device) if device is not None
               else tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
        t = _to_tensor(np.load(directory / (key + ".npy")),
                       meta[key]["dtype"], dev)
        values[key] = sh.distribute(t) if sh is not None else t
    return _unflatten(template, values), manifest


class AsyncSaver:
    """Serializes checkpoints on a background thread; at most one in flight
    (a second save blocks until the first lands — bounded staleness)."""

    def __init__(self, directory):
        self.directory = pathlib.Path(directory)
        self._thread: threading.Thread | None = None
        self._sharded = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()

    def submit(self, step: int, tree, extra: dict | None = None):
        """Copy ``tree`` to the host now and write it in the background.
        With DTensor leaves every rank calls this (each leaf is gathered
        here), rank 0 writes, and :meth:`wait` holds every rank until the
        write has landed."""
        self.wait()
        # gather and copy to the host before handing to the thread: the
        # optimizer updates the live tensors in place
        tree, self._sharded = _gathered(tree)
        host_tree = tmap(lambda v: v.detach().to("cpu", copy=True)
                         if isinstance(v, torch.Tensor) else v, tree)
        if _writer():
            self._thread = threading.Thread(
                target=_write, args=(self.directory, step, host_tree, extra),
                daemon=True)
            self._thread.start()
