"""Machine-description model (Kerncraft §2.2, adapted).

A copy of ``repro.core.machine`` in the same YAML dialect.  A machine
description carries three parts, mirroring the paper:
  1. execution architecture (ports, flops/cy, clock),
  2. memory hierarchy (per-level caches + inter-level transfer throughput),
  3. streaming-benchmark results (measured bandwidths per level/core-count).

The port bundles one machine in ``repro_torch/machines``:
  * ``h100_sxm.yaml`` — an NVIDIA H100 SXM with one SM modeled as one
    core: L1/shared memory per SM <- shared L2 <- HBM3.
Any other machine file of the same dialect loads by path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import pathlib
from typing import Any

import yaml

from . import identity as _identity

_MACHINE_DIR = pathlib.Path(__file__).resolve().parent.parent / "machines"

INF = float("inf")

#: Op kinds a ``ports:`` instruction table may declare — the single source
#: of truth shared with the op-stream IR (:mod:`repro_torch.core.incore.ir`).
PORT_OP_KINDS = ("ADD", "MUL", "DIV", "FMA", "LOAD", "STORE", "MXU", "VPU")

# accepted YAML keys; anything else raises (a misspelled key silently
# ignored would silently mis-model the machine)
_TOP_LEVEL_KEYS = frozenset({
    "model name", "arch", "clock", "cores per socket", "cacheline size",
    "FLOPs per cycle", "load bytes per cycle", "store bytes per cycle",
    "overlapping ports", "non-overlapping ports", "ports",
    "memory hierarchy", "main memory bandwidth", "benchmarks",
    "peak flops", "hbm bandwidth", "vmem size", "ici link bandwidth",
    "ici links", "chips", "extra", "calibration",
})
_CALIBRATION_KEYS = frozenset({"compute", "levels", "time", "meta"})
_PORT_TABLE_KEYS = frozenset({"names", "non-overlapping", "instructions"})
_PORT_ENTRY_KEYS = frozenset({"ports", "rate", "cycles per op",
                              "bytes per cycle", "latency"})


def _check_keys(d: dict, accepted: frozenset, where: str) -> None:
    unknown = sorted(str(k) for k in d if k not in accepted)
    if unknown:
        raise ValueError(
            f"unknown {where} key(s) {unknown}; accepted: "
            f"{sorted(accepted)}")


def _parse_size(v: Any) -> float:
    """Parse '32 kB' / '25.00 MB' / ints into bytes."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    units = {"b": 1, "kb": 1e3, "kib": 1024, "mb": 1e6, "mib": 1024**2,
             "gb": 1e9, "gib": 1024**3, "tb": 1e12, "tib": 1024**4}
    for u in sorted(units, key=len, reverse=True):
        if s.lower().endswith(u):
            return float(s[: -len(u)].strip()) * units[u]
    return float(s)


def _parse_bw(v: Any) -> float:
    """Parse '47.2 GB/s' into bytes/s."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower().replace("/s", "")
    return _parse_size(s)


def _parse_calibration(d: dict, level_names: list[str]) -> dict:
    """Validate a machine file's ``calibration:`` section (written by the
    JAX package's autotuner) into its normalized form:

    - ``compute``: one positive finite factor scaling the in-core cycle
      terms (T_OL / T_nOL / t_core);
    - ``levels``: per-memory-level factors scaling that level's transfer
      term — keys must name declared hierarchy levels;
    - ``time``: per-kernel-family wall-clock factors the tuner applies to
      its own seconds-level predictions;
    - ``meta``: free-form provenance (source report, date, errors).

    Factors are multiplicative measured/predicted ratios; 1.0 is identity.
    Models only apply them behind an explicit ``calibrated=True`` flag, so
    a calibrated machine file still reproduces every uncalibrated golden.
    """
    if not isinstance(d, dict):
        raise ValueError(
            f"'calibration' must be a mapping, got {type(d).__name__}")
    _check_keys(d, _CALIBRATION_KEYS, "calibration")

    def _factor(v, where: str) -> float:
        try:
            f = float(v)
        except (TypeError, ValueError):
            raise ValueError(
                f"calibration {where} must be a number, got {v!r}") from None
        if not math.isfinite(f) or f <= 0:
            raise ValueError(
                f"calibration {where} must be a positive finite factor, "
                f"got {v!r}")
        return f

    out: dict = {}
    if "compute" in d:
        out["compute"] = _factor(d["compute"], "'compute'")
    for section in ("levels", "time"):
        sec = d.get(section)
        if sec is None:
            continue
        if not isinstance(sec, dict):
            raise ValueError(
                f"calibration {section!r} must be a mapping, "
                f"got {type(sec).__name__}")
        out[section] = {str(k): _factor(v, f"{section}[{k!r}]")
                        for k, v in sec.items()}
    unknown = sorted(set(out.get("levels", {})) - set(level_names))
    if unknown:
        raise ValueError(
            f"calibration levels name undeclared hierarchy level(s) "
            f"{unknown}; declared: {level_names}")
    if "meta" in d:
        if not isinstance(d["meta"], dict):
            raise ValueError(
                "calibration 'meta' must be a mapping, "
                f"got {type(d['meta']).__name__}")
        out["meta"] = dict(d["meta"])
    return out


@dataclasses.dataclass(frozen=True)
class CacheLevel:
    """One level of the memory hierarchy.

    ``size_bytes`` is the capacity visible to one core's working set.
    ``cycles_per_cacheline`` is the documented transfer throughput from the
    *next* (farther) level into this one (paper: 'cycles per cacheline
    transfer'); ``None`` for the last level before main memory, where the
    measured memory bandwidth is used instead.
    """
    name: str
    size_bytes: float
    sets: int = 0
    ways: int = 0
    cl_size: int = 64
    replacement_policy: str = "LRU"
    write_allocate: bool = True
    write_back: bool = True
    cycles_per_cacheline: float | None = None
    cores_per_group: int = 1
    groups: int = 1
    overlap: bool = False          # does this transfer overlap compute?
    bandwidth_bytes_per_cycle: float | None = None  # alternative to cy/CL


@dataclasses.dataclass(frozen=True)
class PortEntry:
    """How one op kind schedules: eligible ports plus either a reciprocal
    throughput per scalar op (``cycles_per_op``, from the YAML ``rate`` or
    ``cycles per op``) or a per-port byte bandwidth (``bytes per cycle``,
    for width-scaled memory ops), and the instruction latency used by the
    dependence-chain bound."""
    kind: str
    ports: tuple[str, ...]
    cycles_per_op: float | None = None
    bytes_per_cycle: float | None = None
    latency: float = 0.0


@dataclasses.dataclass(frozen=True)
class PortTable:
    """The machine file's ``ports:`` section (the OSACA-style abstraction
    of the performance-relevant scheduler properties): declared port
    names, the subset forming the ECM's non-overlapping class (the load
    ports), and one :class:`PortEntry` per op kind."""
    names: tuple[str, ...]
    non_overlapping: tuple[str, ...]
    entries: dict[str, PortEntry]


def _parse_ports(d: dict) -> PortTable:
    _check_keys(d, _PORT_TABLE_KEYS, "ports-table")
    names = tuple(str(p) for p in d.get("names", []))
    if not names:
        raise ValueError("ports table declares no 'names'")
    nonov = tuple(str(p) for p in d.get("non-overlapping", []))
    bad = sorted(set(nonov) - set(names))
    if bad:
        raise ValueError(
            f"ports table 'non-overlapping' names undeclared port(s) "
            f"{bad}; declared: {list(names)}")
    entries: dict[str, PortEntry] = {}
    for kind, ed in (d.get("instructions") or {}).items():
        kind = str(kind)
        if kind not in PORT_OP_KINDS:
            raise ValueError(
                f"unknown ports instruction kind {kind!r}; accepted: "
                f"{list(PORT_OP_KINDS)}")
        _check_keys(ed, _PORT_ENTRY_KEYS, f"ports instruction {kind!r}")
        eports = tuple(str(p) for p in ed.get("ports", []))
        bad = sorted(set(eports) - set(names))
        if not eports or bad:
            raise ValueError(
                f"ports instruction {kind!r} must name declared port(s); "
                f"got {list(eports)}, declared: {list(names)}")
        rate, cpo = ed.get("rate"), ed.get("cycles per op")
        bpc = ed.get("bytes per cycle")
        given = [k for k, v in (("rate", rate), ("cycles per op", cpo),
                                ("bytes per cycle", bpc)) if v is not None]
        if len(given) != 1:
            raise ValueError(
                f"ports instruction {kind!r} needs exactly one throughput "
                f"form out of ['rate', 'cycles per op', 'bytes per cycle']"
                + (f"; got {given}" if given else ""))
        if float(ed[given[0]]) <= 0:
            raise ValueError(
                f"ports instruction {kind!r}: {given[0]!r} must be "
                f"positive, got {ed[given[0]]!r}")
        cycles = (1.0 / float(rate)) if rate is not None else \
            (float(cpo) if cpo is not None else None)
        entries[kind] = PortEntry(
            kind=kind, ports=eports, cycles_per_op=cycles,
            bytes_per_cycle=float(bpc) if bpc is not None else None,
            latency=float(ed.get("latency", 0.0)))
    return PortTable(names=names, non_overlapping=nonov, entries=entries)


@dataclasses.dataclass(frozen=True)
class BenchmarkKernel:
    name: str
    flops_per_iteration: int
    read_streams: int
    write_streams: int
    readwrite_streams: int
    bytes_per_iteration: float


@dataclasses.dataclass(frozen=True)
class BenchmarkResult:
    kernel: str
    level: str
    threads_per_core: int
    cores: tuple[int, ...]
    bandwidth_bytes: tuple[float, ...]   # measured bandwidth (w/o write-allocate)


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    arch: str                      # 'x86' | 'tpu' | 'gpu'
    clock_hz: float
    cores_per_socket: int
    cacheline_bytes: int
    # --- in-core model (the IACA-analog inputs) ---
    # throughput of each port class, per cycle, for the native SIMD width
    flops_per_cycle: dict[str, dict[str, float]]  # {'DP': {'ADD': 4, 'MUL': 4, ...}}
    load_bytes_per_cycle: float
    store_bytes_per_cycle: float
    overlapping_ports: tuple[str, ...]
    non_overlapping_ports: tuple[str, ...]
    # --- memory hierarchy, closest (L1/VMEM) first ---
    levels: tuple[CacheLevel, ...]
    main_memory_bandwidth: float   # saturated, bytes/s (ECM memory term)
    # scheduler port table (the "ports" in-core model; None = not declared)
    ports: PortTable | None = None
    # --- streaming benchmarks (Roofline inputs) ---
    kernels: dict[str, BenchmarkKernel] = dataclasses.field(default_factory=dict)
    results: tuple[BenchmarkResult, ...] = ()
    # --- accelerator extras (peak rates per dtype, HBM) ---
    peak_flops: dict[str, float] = dataclasses.field(default_factory=dict)  # dtype -> flops/s
    hbm_bandwidth: float = 0.0
    vmem_bytes: float = 0.0
    ici_link_bandwidth: float = 0.0
    ici_links: int = 4
    chips: int = 1
    extra: dict = dataclasses.field(default_factory=dict)
    # --- autotuner feedback: measured/predicted factors ---
    # normalized by _parse_calibration; empty = uncalibrated.  Opt-in:
    # models scale by these only under calibrated=True.
    calibration: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @functools.cached_property
    def fingerprint(self) -> str:
        """Content hash of the *normalized* machine description.

        Hashes the parsed dataclass payload — the result of
        :meth:`from_dict` — never the YAML path or file mtime, so two
        byte-identical (or merely equivalent after parsing: '32 kB' vs
        32000) machine files share one fingerprint, while editing any
        modeled value produces a new one.  It equals the JAX package's
        fingerprint of the same file, so cache keys agree across the two.
        """
        return _identity.stable_digest(dataclasses.asdict(self))

    @property
    def level_names(self) -> list[str]:
        return [lv.name for lv in self.levels]

    def level(self, name: str) -> CacheLevel:
        for lv in self.levels:
            if lv.name == name:
                return lv
        raise KeyError(name)

    def measured_bandwidth(self, level: str, cores: int = 1,
                           read_streams: int = 1, write_streams: int = 1,
                           readwrite_streams: int = 0) -> tuple[float, str]:
        """Pick the benchmark kernel that most closely matches the stream mix
        of the analyzed kernel (paper §2.3 Roofline) and return its measured
        bandwidth at ``cores`` for ``level``.
        """
        best: tuple[float, str] | None = None
        best_score = INF
        for res in self.results:
            if res.level != level:
                continue
            k = self.kernels[res.kernel]
            score = (abs(k.read_streams - read_streams)
                     + abs(k.write_streams - write_streams)
                     + abs(k.readwrite_streams - readwrite_streams))
            if score < best_score:
                idx = min(cores, len(res.cores)) - 1
                best = (res.bandwidth_bytes[idx], res.kernel)
                best_score = score
        if best is None:
            raise ValueError(f"no benchmark result for level {level}")
        return best

    def calibration_factor(self, kind: str, name: str | None = None) -> float:
        """The multiplicative calibration factor for one term class:
        ``("compute", None)`` for in-core cycles, ``("level", "VMEM")``
        for a transfer term, ``("time", family)`` for the tuner's
        seconds-level family factor.  1.0 when uncalibrated."""
        if not self.calibration:
            return 1.0
        if kind == "compute":
            return float(self.calibration.get("compute", 1.0))
        if kind in ("level", "time"):
            return float(self.calibration.get(
                kind + "s" if kind == "level" else kind, {}).get(name, 1.0))
        raise ValueError(
            f"unknown calibration factor kind {kind!r}; expected "
            "'compute', 'level', or 'time'")

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "Machine":
        _check_keys(d, _TOP_LEVEL_KEYS, "machine-description")
        levels = []
        for lv in d.get("memory hierarchy", []):
            if not isinstance(lv, dict) or "level" not in lv:
                raise ValueError(
                    "every 'memory hierarchy' entry needs a 'level' name; "
                    f"got {lv!r}")
            cpg = lv.get("cache per group", {})
            size = cpg.get("size")
            if size is None and cpg:
                size = cpg.get("sets", 0) * cpg.get("ways", 0) * cpg.get("cl_size", 64)
            levels.append(CacheLevel(
                name=lv["level"],
                size_bytes=_parse_size(size if size else lv.get("size", 0)),
                sets=int(cpg.get("sets", 0)),
                ways=int(cpg.get("ways", 0)),
                cl_size=int(cpg.get("cl_size", d.get("cacheline size", 64))),
                replacement_policy=cpg.get("replacement_policy", "LRU"),
                write_allocate=bool(cpg.get("write_allocate", True)),
                write_back=bool(cpg.get("write_back", True)),
                cycles_per_cacheline=lv.get("cycles per cacheline transfer"),
                cores_per_group=int(lv.get("cores per group", 1)),
                groups=int(lv.get("groups", 1)),
                overlap=bool(lv.get("overlap", False)),
                bandwidth_bytes_per_cycle=lv.get("bandwidth bytes per cycle"),
            ))
        kernels = {}
        results = []
        bench = d.get("benchmarks", {})
        for kname, kd in bench.get("kernels", {}).items():
            kernels[kname] = BenchmarkKernel(
                name=kname,
                flops_per_iteration=int(kd.get("FLOPs per iteration", 0)),
                read_streams=int(kd.get("read streams", {}).get("streams", 0)),
                write_streams=int(kd.get("write streams", {}).get("streams", 0)),
                readwrite_streams=int(kd.get("read+write streams", {}).get("streams", 0)),
                bytes_per_iteration=_parse_size(kd.get("read streams", {}).get("bytes", 0))
                + _parse_size(kd.get("write streams", {}).get("bytes", 0)),
            )
        for level_name, md in bench.get("measurements", {}).items():
            for tpc, block in md.items():
                for kname, bws in block.get("results", {}).items():
                    results.append(BenchmarkResult(
                        kernel=kname, level=level_name, threads_per_core=int(tpc),
                        cores=tuple(block["cores"]),
                        bandwidth_bytes=tuple(_parse_bw(b) for b in bws)))
        peak = {k: _parse_bw(v) for k, v in d.get("peak flops", {}).items()}
        return cls(
            name=d.get("model name", "unknown"),
            arch=d.get("arch", "x86"),
            clock_hz=_parse_bw(d.get("clock", "1 GHz").replace("Hz", "B")),
            cores_per_socket=int(d.get("cores per socket", 1)),
            cacheline_bytes=int(d.get("cacheline size", 64)),
            flops_per_cycle=d.get("FLOPs per cycle", {}),
            load_bytes_per_cycle=float(d.get("load bytes per cycle", 32)),
            store_bytes_per_cycle=float(d.get("store bytes per cycle", 16)),
            overlapping_ports=tuple(str(p) for p in d.get("overlapping ports", [])),
            non_overlapping_ports=tuple(str(p) for p in d.get("non-overlapping ports", [])),
            ports=_parse_ports(d["ports"]) if d.get("ports") else None,
            levels=tuple(levels),
            main_memory_bandwidth=_parse_bw(d.get("main memory bandwidth", 0)),
            kernels=kernels,
            results=tuple(results),
            peak_flops=peak,
            hbm_bandwidth=_parse_bw(d.get("hbm bandwidth", 0)),
            vmem_bytes=_parse_size(d.get("vmem size", 0)),
            ici_link_bandwidth=_parse_bw(d.get("ici link bandwidth", 0)),
            ici_links=int(d.get("ici links", 4)),
            chips=int(d.get("chips", 1)),
            extra=d.get("extra", {}),
            calibration=_parse_calibration(
                d["calibration"], [lv.name for lv in levels])
            if d.get("calibration") else {},
        )

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path) -> "Machine":
        path = pathlib.Path(path)
        if not path.exists() and not path.is_absolute():
            bundled = _MACHINE_DIR / path
            if not bundled.exists() and path.suffix != ".yaml":
                # accept suffixless bundled names: 'h100_sxm'
                bundled = bundled.with_suffix(".yaml")
            path = bundled
        with open(path) as f:
            try:
                d = yaml.safe_load(f)
            except yaml.YAMLError as e:
                raise ValueError(
                    f"machine file {path} is not valid YAML: {e}") from e
        if not isinstance(d, dict):
            raise ValueError(
                f"machine file {path} must hold a YAML mapping, "
                f"got {type(d).__name__}")
        try:
            return cls.from_dict(d)
        except (KeyError, TypeError) as e:
            raise ValueError(
                f"machine file {path} is malformed: "
                f"{type(e).__name__}: {e}") from e


@functools.lru_cache(maxsize=64)
def load(name: str) -> Machine:
    """Load a bundled machine description by short name (``H100``), by
    bundled file name, or by path.

    Memoized: Machine is frozen, and warm ``analyze(src, "H100", ...)``
    loops must not re-read YAML per call.
    """
    aliases = {
        "H100": "h100_sxm.yaml",
    }
    return Machine.from_yaml(aliases.get(name.upper(), name))
