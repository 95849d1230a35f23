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
Restoring onto a mesh (JAX's ``shardings=``) waits for the port's
distribution slice (ROADMAP.md Queue 1, item 5); :func:`restore` takes
a device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

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


def save(directory, step: int, tree, extra: dict | None = None
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


def restore(directory, step: int, template, device=None):
    """Restore into the structure of ``template`` (a tree of tensors or
    arrays keyed as at save time).  Each leaf goes to ``device``, or to
    its template leaf's device when None (the CPU for an array).  Returns
    ``(tree, manifest)``."""
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    with open(directory / "manifest.json") as f:
        manifest = json.load(f)
    meta = manifest["leaves"]
    values = {}
    for key, tmpl in flatten(template).items():
        if key not in meta:
            raise KeyError(f"checkpoint missing leaf {key}")
        dev = (_device.resolve(device) if device is not None
               else tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
        values[key] = _to_tensor(np.load(directory / (key + ".npy")),
                                 meta[key]["dtype"], dev)
    return _unflatten(template, values), manifest


class AsyncSaver:
    """Serializes checkpoints on a background thread; at most one in flight
    (a second save blocks until the first lands — bounded staleness)."""

    def __init__(self, directory):
        self.directory = pathlib.Path(directory)
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def submit(self, step: int, tree, extra: dict | None = None):
        self.wait()
        # copy to the host before handing to the thread: the optimizer
        # updates the live tensors in place
        host_tree = tmap(lambda v: v.detach().to("cpu", copy=True)
                         if isinstance(v, torch.Tensor) else v, tree)
        self._thread = threading.Thread(
            target=save, args=(self.directory, step, host_tree, extra),
            daemon=True)
        self._thread.start()
