"""Build the port's CUDA sources into plain-C shared libraries, load them
with ``ctypes``, and check what the kernel wrappers pass them.

Each ``csrc/<name>.cu`` exports ``extern "C"`` launch functions and is
compiled on its own by ``nvcc`` for ``sm_90a``, without PyTorch's headers
(a few seconds per file).  Libraries go under ``build/repro_torch/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is
compiled at import: the first launch of a kernel builds it, and
:func:`build_all` builds every source at once, one ``nvcc`` per source,
all started together.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("stencil3d7pt", "longrange3d", "flash_attention",
           "flash_attention_wgmma", "flash_attention_bf16x3",
           "flash_attention_bwd", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

class KernelError(RuntimeError):
    """A kernel that could not be built, loaded or launched: a fault of
    the card or its toolchain, which a training loop must not replay."""


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: per source: build seconds and the ptxas register/shared-memory report
BUILD_INFO: dict[str, dict] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "",
              os.path.join("/usr/local/cuda", "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built,
    tagged by its source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path,
            out: pathlib.Path, t0: float) -> str:
    """Wait for one nvcc; returns its error report, empty on success."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):"
                f"\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)          # atomic: concurrent builders never see half a file
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": _ptxas_lines(log)}
    return ""


def _ptxas_lines(log: str) -> list[str]:
    """The per-kernel register / shared-memory / spill report (ptxas puts
    the stack and spill counts on a line of their own)."""
    return [ln.strip() for ln in log.splitlines()
            if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln))
            or "spill" in ln]


def build_all(names=SOURCES) -> dict[str, dict]:
    """Build every missing library in parallel; returns :data:`BUILD_INFO`."""
    with _LOCK:
        t0 = time.perf_counter()
        todo = [n for n in names if not library_path(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        # wait for every compiler before reporting any failure
        errors = [_finish(n, proc, tmp, out, t0)
                  for n, proc, tmp, out in started]
        if any(errors):
            raise KernelError("\n".join(e for e in errors if e))
        for n in names:           # built by an earlier process
            log = library_path(n).with_suffix(".log")
            BUILD_INFO.setdefault(n, {
                "seconds": 0.0, "ptxas": ["(cached build)"]
                + (_ptxas_lines(log.read_text()) if log.exists() else [])})
        return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(library_path(name))))
    return lib


# ----------------------------------------------------------------------
# binding, and the checks every stencil wrapper makes before a launch
# ----------------------------------------------------------------------

def check_grid(*tensors: torch.Tensor) -> tuple[int, int]:
    """Validate stencil operands: float32, contiguous, one ``(M, N, N)``
    shape, one device.  Returns ``(M, N)``."""
    t0 = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"stencil kernels take float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[1] != t.shape[2]:
            raise ValueError(f"expected an (M, N, N) grid, got "
                             f"{tuple(t.shape)}")
        if t.shape != t0.shape or t.device != t0.device:
            raise ValueError("stencil operands must share shape and device")
        if not t.is_contiguous():
            raise ValueError("stencil operands must be contiguous")
    if t0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t0.device}")
    return int(t0.shape[0]), int(t0.shape[1])


def check_tile(tile: tuple[int, ...], shape) -> tuple[int, ...]:
    """Validate the grid that the launch plan ``(bj, bi, c, stages,
    chunk)`` of a ring stencil kernel gives on an ``(M, N, N)`` array;
    returns the plan.  Raises ``ValueError`` for a grid the kernel would
    refuse, on every device."""
    M, N = shape
    bj, chunk = tile[0], tile[4]
    if chunk < 1 or N * N >= 2 ** 31 or M >= 2 ** 31 \
            or -(-N // bj) > 65535 or -(-M // chunk) > 65535:
        raise ValueError(f"CTA tile {tile} on ({M}, {N}, {N}): needs a chunk "
                         "of at least one plane, N*N < 2**31 and at most "
                         "65535 tiles along j and chunks along k")
    return tile


def entry(name: str, argtypes: list, symbol: str = ""):
    """The ctypes binding of ``repro_<name>`` (or ``repro_<symbol>``) in
    ``csrc/<name>.cu`` with its argument types set (a pointer or the
    stream must be ``c_void_p``: a plain int would be cut to 32 bits) and
    an ``int`` result, the ``cudaError_t`` of the launch."""
    fn = getattr(library(name), f"repro_{symbol or name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def bind(name: str, n_ptrs: int, n_coef: int):
    """The binding of a stencil launch function: pointers, M, N, the plan
    ``(bj, bi, c, stages, chunk)`` and the coefficients by value, then the
    stream."""
    return entry(name, [ctypes.c_void_p] * n_ptrs
                 + [ctypes.c_longlong, ctypes.c_longlong]
                 + [ctypes.c_int] * 5
                 + [ctypes.c_float] * n_coef + [ctypes.c_void_p])


def compiled_limits(name: str, tile) -> tuple[int, int]:
    """(shared bytes, threads) of one CTA of the plan ``(bj, bi, c,
    stages)`` (a chunk, if given, is ignored) as the built library states
    them (``repro_<name>_limits``); raises :class:`KernelError` where the
    library refuses the plan.  Builds the library if needed."""
    fn = entry(name, [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
               symbol=f"{name}_limits")
    smem, threads = ctypes.c_longlong(), ctypes.c_int()
    check_status(f"{name}_limits", fn(*(int(x) for x in tile[:4]),
                                      ctypes.byref(smem),
                                      ctypes.byref(threads)))
    return smem.value, threads.value


def check_status(name: str, err: int) -> None:
    """Raise unless the launch function returned ``cudaSuccess``."""
    if err:
        raise KernelError(f"{name} kernel launch failed: cudaError_t {err}")
