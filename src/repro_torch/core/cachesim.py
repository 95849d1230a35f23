"""Set-associative cache-hierarchy simulator (the pycachesim analog, §2.4.1).

A copy of ``repro.core.cachesim``, held to it count for count: per-level
hits, misses, evictions and write-backs are equal on both backends, so the
arithmetic order and the RNG use (``random.Random(seed)`` for RR) are the
original's.  Two of its semantics are kept as they are, for parity:

* :func:`build_hierarchy` and the vector driver read each level's
  ``cache per group`` size and ignore ``cores per group``, and the SIM
  predictor drops ``cores``: one core sees the whole of a shared level
  (on ``h100_sxm.yaml`` one SM simulates all 50 MiB of L2, where the layer
  conditions divide it among the SMs);
* ``warmup_rows`` defaults to 2, which at stencil sizes warms neither a 3D
  layer condition nor a shared level.

Line-granular, inclusive write-back/write-allocate hierarchy with LRU /
FIFO / RR (random) replacement. Unlike layer conditions, the simulator sees
real set indices, so it reproduces associativity pathologies such as the L1
thrashing spike of the paper's Fig. 3 at N = 1792 = 7·256 (rows map to two
sets; 17 concurrently-live rows > 2 sets × 8 ways).

Two backends implement the same simulation (``--sim-backend``):

``scalar``
    The reference implementation: one Python ``OrderedDict`` operation per
    cache line touched.  Handles every replacement policy and write mode,
    but costs microseconds per access — unusable for production-scale
    sweeps.

``vector``
    The address stream of a whole row/tile of iterations is generated as
    NumPy integer arrays from the precompiled affine accesses, partitioned
    by set index, run-length collapsed (consecutive same-line accesses
    within a set are guaranteed hits), and driven through per-set
    ``(sets, ways)`` tag/stamp/dirty arrays — every set advances one run
    per step, so one Python-level step retires up to ``sets`` accesses.
    Per-level hit/miss/evict counts are *exactly* those of the scalar
    backend (pinned by test on the paper stencils); see
    :class:`_VectorCache` for the equivalence argument.  Supports LRU and
    FIFO with write-allocate; ``auto`` falls back to ``scalar`` otherwise
    (e.g. the RR policy, whose eviction choice is a stateful RNG walk).

The driver follows the paper's §2.4.1 protocol: run a warm-up phase, align
its end to a cache-line boundary, reset the statistics, simulate an exact
number of inner iterations, and read the steady-state counts.
"""
from __future__ import annotations

import dataclasses
import random
from collections import OrderedDict

import numpy as np
import sympy

from .kernel_ir import LoopKernel
from .machine import CacheLevel, Machine

SIM_BACKENDS = ("auto", "scalar", "vector")

# simulation options consumed by simulate(); everything else in a
# sim_kwargs dict is rejected early so typos don't silently no-op
SIM_OPTION_DEFAULTS = {"warmup_rows": 2, "measure_rows": 1, "seed": 0,
                       "backend": "auto"}


@dataclasses.dataclass
class CacheStats:
    loads: int = 0
    stores: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    writebacks: int = 0

    def reset(self) -> None:
        self.loads = self.stores = self.hits = self.misses = 0
        self.evictions = self.writebacks = 0


class Cache:
    """One set-associative cache level (scalar reference backend)."""

    def __init__(self, name: str, sets: int, ways: int, cl_size: int,
                 policy: str = "LRU", write_back: bool = True,
                 write_allocate: bool = True, parent: "Cache | None" = None,
                 seed: int = 0):
        self.name = name
        self.sets = sets
        self.ways = ways
        self.cl_size = cl_size
        self.policy = policy.upper()
        self.write_back = write_back
        self.write_allocate = write_allocate
        self.parent = parent
        self.stats = CacheStats()
        # per set: OrderedDict tag -> dirty (move_to_end models LRU recency)
        self._sets: list[OrderedDict[int, bool]] = [OrderedDict() for _ in range(sets)]
        self._rng = random.Random(seed)

    # ------------------------------------------------------------------
    def _locate(self, line: int) -> tuple[OrderedDict, int]:
        return self._sets[line % self.sets], line

    def _touch(self, s: OrderedDict, tag: int) -> None:
        if self.policy == "LRU":
            s.move_to_end(tag)
        # FIFO/RR: insertion order untouched

    def _evict_one(self, s: OrderedDict) -> None:
        if self.policy == "RR" or self.policy == "RANDOM":
            tag = self._rng.choice(list(s.keys()))
        else:  # LRU and FIFO both evict the head of the OrderedDict
            tag = next(iter(s))
        dirty = s.pop(tag)
        self.stats.evictions += 1
        if dirty and self.write_back and self.parent is not None:
            self.stats.writebacks += 1
            self.parent._write_line(tag)

    def _insert(self, line: int, dirty: bool) -> None:
        s, tag = self._locate(line)
        if tag in s:
            s[tag] = s[tag] or dirty
            self._touch(s, tag)
            return
        if len(s) >= self.ways:
            self._evict_one(s)
        s[tag] = dirty

    # -- external interface (line granularity) -------------------------
    def load_line(self, line: int) -> None:
        self.stats.loads += 1
        s, tag = self._locate(line)
        if tag in s:
            self.stats.hits += 1
            self._touch(s, tag)
            return
        self.stats.misses += 1
        if self.parent is not None:
            self.parent.load_line(line)
        self._insert(line, dirty=False)

    def store_line(self, line: int) -> None:
        self.stats.stores += 1
        s, tag = self._locate(line)
        if tag in s:
            self.stats.hits += 1
            s[tag] = True
            self._touch(s, tag)
            return
        self.stats.misses += 1
        if self.write_allocate:
            if self.parent is not None:
                self.parent.load_line(line)
            self._insert(line, dirty=True)
        else:
            self._write_line_through(line)

    def _write_line(self, line: int) -> None:
        """Receive a write-back from the child level (no allocate miss count)."""
        s, tag = self._locate(line)
        if tag in s:
            s[tag] = True
            self._touch(s, tag)
        else:
            # inclusive hierarchy: should normally hit; allocate to be safe
            if self.parent is not None:
                pass
            self._insert(line, dirty=True)

    def _write_line_through(self, line: int) -> None:
        if self.parent is not None:
            self.parent.store_line(line)

    def reset_stats(self) -> None:
        self.stats.reset()
        if self.parent:
            self.parent.reset_stats()


class MainMemory:
    """Terminal level: counts traffic, never misses."""

    def __init__(self) -> None:
        self.name = "MEM"
        self.stats = CacheStats()
        self.parent = None

    def load_line(self, line: int) -> None:
        self.stats.loads += 1
        self.stats.hits += 1

    def store_line(self, line: int) -> None:
        self.stats.stores += 1

    def _write_line(self, line: int) -> None:
        self.stats.stores += 1

    def reset_stats(self) -> None:
        self.stats.reset()


def _level_geometry(lv: CacheLevel) -> tuple[int, int]:
    """(sets, ways) for a level; sizes without explicit geometry get an
    8-way layout filling ``size_bytes`` (shared by both backends)."""
    ways = lv.ways or 8
    sets = lv.sets or max(1, int(lv.size_bytes // (max(1, ways) * lv.cl_size)))
    return sets, ways


def build_hierarchy(machine: Machine, seed: int = 0) -> list[Cache | MainMemory]:
    """First-level cache first; last element is main memory."""
    mem = MainMemory()
    levels: list[Cache | MainMemory] = [mem]
    parent: Cache | MainMemory = mem
    for lv in reversed(machine.levels):
        sets, ways = _level_geometry(lv)
        c = Cache(lv.name, sets, ways, lv.cl_size, lv.replacement_policy,
                  lv.write_back, lv.write_allocate, parent=parent, seed=seed)
        levels.insert(0, c)
        parent = c
    return levels


# ----------------------------------------------------------------------
# Vectorized backend
# ----------------------------------------------------------------------

# event kinds in the per-level address streams.  Child misses reach the
# parent as _LOAD (write-allocate fetches too, matching the scalar path);
# dirty evictions reach it as _WB, which updates recency/dirty state but
# never counts toward the parent's hits/misses.
_LOAD, _STORE, _WB = 0, 1, 2

_EMPTY = np.empty(0, dtype=np.int64)


class _VectorCache:
    """One set-associative level as ``(sets, ways)`` state arrays.

    State per way: the resident line number (``-1`` = empty), a stamp, and
    a dirty flag.  LRU re-stamps on every touch and evicts the minimum
    stamp; FIFO stamps only at insertion, so minimum stamp is insertion
    order.  Both match the scalar ``OrderedDict`` head eviction exactly.

    ``process`` consumes one chronological address block.  Correctness of
    the vectorization rests on three facts:

    * **Sets are independent.** No access touches state outside its set,
      so a stable partition by set index preserves each set's subsequence
      and any interleaving across sets is equivalent — one step retires
      one pending event of *every* set at once, conflict-free.
    * **Close re-touches are guaranteed hits** (the LRU inclusion
      property): if at most ``ways`` set-local events separate two
      touches of one line, fewer than ``ways`` distinct other lines
      intervened, so with write-allocate the line cannot have been
      evicted in between — the re-touch hits *whatever* the incoming
      state was.  Such events ("chain" events) are folded into their
      preceding non-guaranteed event (the "head"): their hits are
      counted in bulk and their dirty bits are or-ed into the head's
      insert/update.  Only heads — first-in-block touches and re-touches
      far enough apart to be evictable — run through the sequential
      per-set state machine, which is what makes steady-state stencil
      streams (~1 head per cache line per array) cheap.  The window is
      LRU-specific: FIFO evicts by insertion order and can drop a
      just-touched line, so FIFO levels fold only strictly adjacent
      re-touches (zero intervening set events ⇒ no possible eviction).
    * **Chain-end stamps are exact-or-safely-optimistic.** A head's
      recency stamp is set to the position of the *last* event of its
      chain.  Once the chain has ended this is the line's true last
      touch.  While the chain spans a later victim decision, the stamp
      is in the future and excludes the line from eviction — correct,
      because a line with a pending guaranteed hit cannot be the LRU
      victim (ways distinct evictors would contradict the ≤ ways-event
      gap), and a pigeonhole argument shows the ways resident lines of a
      full set can never *all* have spanning chains, so the true LRU
      victim is always selected.

    Output events carry ``2·pos`` (parent fetch) and ``2·pos + 1``
    (write-back of the victim that fetch evicted), preserving the scalar
    recursion order fetch-before-writeback after the final sort.
    """

    def __init__(self, name: str, sets: int, ways: int,
                 policy: str = "LRU", write_back: bool = True):
        self.name = name
        self.sets = sets
        self.ways = ways
        self.lru = policy.upper() == "LRU"
        # guaranteed-hit window for chain folding: the `ways`-event rule
        # is the LRU inclusion property and does NOT transfer to FIFO
        # (insertion-order eviction can drop a just-touched line), so
        # FIFO only folds strictly adjacent re-touches (gap 1: no event
        # of any kind intervened in the set, hence no possible eviction)
        self.chain_gap = ways if self.lru else 1
        self.write_back = write_back
        self.stats = CacheStats()
        # tag 0 marks an empty way: the driver lays arrays out from 1 MiB
        # so every real line number is positive, and the event clock starts
        # at 1 so real stamps beat the empty-way stamp 0 in victim argmin.
        # np.zeros is calloc-backed — tiny sims don't pay for the big
        # shared-L3 state up front.
        self.tags = np.zeros((sets, ways), dtype=np.int64)
        self.stamps = np.zeros((sets, ways), dtype=np.int64)
        self.dirty = np.zeros((sets, ways), dtype=bool)

    def reset_stats(self) -> None:
        self.stats.reset()

    def _heads(self, lines, kinds, pos):
        """Split one per-event block into state-machine heads and folded
        chains.

        Returns un-laid-out head arrays ``(line, kind, pos, eff_stamp,
        dirty)`` for :meth:`_layout`.  ``eff_stamp`` is the last
        chain-event position, ``dirty`` the or over the chain of
        store/write-back kinds.
        """
        n = lines.size
        set_idx = lines % self.sets
        if n < (1 << 26):
            # composite key (set, time): one plain argsort replaces a
            # stable sort — time is the index itself, so the key is unique
            order = np.argsort((set_idx << 26) | np.arange(n, dtype=np.int64))
        else:            # index bits would overflow into the set bits
            order = np.argsort(set_idx, kind="stable")
        s_set = set_idx[order]

        # set-local time index (the gap rule counts only same-set events)
        grp = np.empty(n, dtype=bool)
        grp[0] = True
        np.not_equal(s_set[1:], s_set[:-1], out=grp[1:])
        grp_start = np.flatnonzero(grp)
        grp_len = np.diff(np.append(grp_start, n))
        local = np.empty(n, dtype=np.int64)
        local[order] = np.arange(n, dtype=np.int64) \
            - np.repeat(grp_start, grp_len)

        # group by line — the set is a function of the line, so grouping by
        # line IS grouping by (set, line), and a stable sort keeps each
        # group in time order (one argsort instead of a 3-key lexsort)
        g = np.argsort(lines, kind="stable")
        g_line = lines[g]
        g_local = local[g]
        new_pair = np.empty(n, dtype=bool)
        new_pair[0] = True
        np.not_equal(g_line[1:], g_line[:-1], out=new_pair[1:])
        # guaranteed hit: same line seen at most `chain_gap` set-local
        # events ago — the LRU inclusion window, or adjacent-only for
        # FIFO (first-in-block occurrences are never guaranteed)
        chained = np.empty(n, dtype=bool)
        chained[0] = False
        np.less_equal(g_local[1:] - g_local[:-1], self.chain_gap,
                      out=chained[1:])
        chained &= ~new_pair

        head_idx = np.flatnonzero(~chained)          # in (line, time) order
        g_pos = pos[g]
        g_dirtyish = (kinds[g] != _LOAD).astype(np.int64)
        chain_last = np.append(head_idx[1:], n) - 1
        eff = g_pos[chain_last]
        dirty = np.add.reduceat(g_dirtyish, head_idx) > 0
        return (g_line[head_idx], kinds[g][head_idx], g_pos[head_idx],
                eff, dirty)

    def _layout(self, h_line, h_kind, h_pos, h_eff, h_dirty):
        """Sort head arrays rank-major: all sets' rank-0 heads first, then
        every set's rank-1 head, … — each state-machine step is then one
        contiguous slice (a view, no gather)."""
        h_set = h_line % self.sets
        n = h_set.size
        if self.sets <= (1 << 15):
            # composite (set, pos) key: set < 2^15, pos < 2^48
            ho = np.argsort((h_set << 48) | h_pos)   # set-grouped, in time
        else:
            ho = np.lexsort((h_pos, h_set))
        h_set = h_set[ho]
        counts = np.bincount(h_set, minlength=self.sets)
        per_set = counts[counts > 0]
        # rank of each head within its set (heads are set-grouped); a
        # stable sort by rank alone is rank-major and keeps sets distinct
        # (and ordered) within each rank slice
        rank = np.arange(n, dtype=np.int64) \
            - np.repeat(np.concatenate(([0], np.cumsum(per_set)))[:-1],
                        per_set)
        rm = np.argsort(rank, kind="stable")
        idx = ho[rm]
        # slice boundaries per rank: how many sets have > r pending heads
        widths = np.bincount(rank, minlength=0)
        return (h_set[rm], h_line[idx], h_kind[idx], h_pos[idx], h_eff[idx],
                h_dirty[idx], widths)

    def process(self, lines: np.ndarray, kinds: np.ndarray,
                pos: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Simulate one per-event address block (used for levels past the
        first, whose streams are miss/write-back traffic)."""
        n = lines.size
        if n == 0:
            return _EMPTY, _EMPTY, _EMPTY
        n_load = int((kinds == _LOAD).sum())
        n_access = n - int((kinds == _WB).sum())
        self.stats.loads += n_load
        self.stats.stores += n_access - n_load
        heads = self._layout(*self._heads(lines, kinds, pos))
        return self._machine(heads, n_access)

    def process_heads(self, heads, n_access: int, n_load: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Simulate a pre-chained block (driver-generated heads).

        ``heads`` are un-laid-out arrays ``(line, kind, pos, eff, dirty)``
        whose chains cover ``n_access`` load/store events in total.
        """
        self.stats.loads += n_load
        self.stats.stores += n_access - n_load
        return self._machine(self._layout(*heads), n_access)

    def _machine(self, heads, n_access: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The sequential core: one pending head per set per step.

        Heads arrive rank-major, so each step consumes one contiguous
        slice; every set in a slice is distinct, which makes all scatter
        updates conflict-free.
        """
        h_set, h_line, h_kind, h_pos, h_eff, h_dirty, widths = heads
        stats = self.stats
        tags_, stamps_, dirty_ = self.tags, self.stamps, self.dirty
        n = h_set.size
        ar = np.arange(widths[0] if widths.size else 0)
        lru = self.lru
        nsets = self.sets

        # per-step bookkeeping is deferred: the loop writes each step's
        # hit/victim slices into preallocated arrays; eviction masks,
        # counts, and parent-event assembly happen once at the end (the
        # step slices tile the head arrays in order, so slice writes
        # reassemble them exactly)
        hit_all = np.empty(n, dtype=bool)
        victim_all = np.empty(n, dtype=np.int64)
        vdirty_all = np.empty(n, dtype=bool)
        lo = 0
        for w in widths:
            sl = slice(lo, lo + w)
            lo += w
            cs = h_set[sl]                         # all distinct sets
            cline = h_line[sl]
            ceff = h_eff[sl]
            a = ar[:w]

            if w == nsets:      # every set active: rows align, no gather
                tags = tags_
                stamps = stamps_
            else:
                tags = tags_[cs]
                stamps = stamps_[cs]
            hw = (tags == cline[:, None]).argmax(axis=1)
            hit = tags[a, hw] == cline
            vw = stamps.argmin(axis=1)             # empty ways stamp 0
            way = np.where(hit, hw, vw)

            old_tag = tags[a, way]
            old_dirty = dirty_[cs, way]
            old_stamp = stamps[a, way]
            hit_all[sl] = hit
            victim_all[sl] = old_tag
            vdirty_all[sl] = old_dirty

            tags_[cs, way] = cline            # no-op on hits (tag == line)
            if lru:
                # maximum folds optimistic chain-end stamps: a miss victim
                # is never optimistic (pigeonhole), so max == eff there,
                # while overlapping same-line chains keep the later end
                stamps_[cs, way] = np.maximum(np.where(hit, old_stamp, 0),
                                              ceff)
            else:                             # FIFO: stamp only at insert
                stamps_[cs, way] = np.where(hit, old_stamp, h_pos[sl])
            dirty_[cs, way] = h_dirty[sl] | (hit & old_dirty)

        if n == 0:
            stats.hits += n_access
            return _EMPTY, _EMPTY, _EMPTY
        miss = ~hit_all
        evict = miss & (victim_all != 0)
        wb = evict & vdirty_all
        macc = miss & (h_kind != _WB)
        line = h_line
        pos = h_pos
        victim = victim_all
        access_misses = int(macc.sum())
        stats.evictions += int(evict.sum())
        stats.misses += access_misses
        stats.hits += n_access - access_misses

        fetch_lines = line[macc]              # parent fetch, order 2·pos
        fetch_pos = pos[macc] * 2
        if self.write_back:                   # victim write-back, 2·pos+1
            stats.writebacks += int(wb.sum())
            wb_lines = victim[wb]
            wb_pos = pos[wb] * 2 + 1
        else:
            wb_lines = wb_pos = _EMPTY
        nf, nw = fetch_lines.size, wb_lines.size
        if nf + nw == 0:
            return _EMPTY, _EMPTY, _EMPTY
        ol = np.concatenate((fetch_lines, wb_lines))
        ok = np.concatenate((np.zeros(nf, dtype=np.int64),
                             np.full(nw, _WB, dtype=np.int64)))
        op = np.concatenate((fetch_pos, wb_pos))
        o = np.argsort(op, kind="stable")
        return ol[o], ok[o], op[o]


class _VectorMemory:
    """Terminal level of the vector hierarchy: pure traffic counters."""

    name = "MEM"

    def __init__(self) -> None:
        self.stats = CacheStats()

    def reset_stats(self) -> None:
        self.stats.reset()

    def process(self, lines: np.ndarray, kinds: np.ndarray,
                pos: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        loads = int((kinds == _LOAD).sum())
        self.stats.loads += loads
        self.stats.hits += loads
        self.stats.stores += int((kinds == _WB).sum())
        return _EMPTY, _EMPTY, _EMPTY


def vector_unsupported_reason(machine: Machine) -> str | None:
    """Why the vector backend cannot simulate ``machine`` (None = it can)."""
    for lv in machine.levels:
        pol = lv.replacement_policy.upper()
        if pol not in ("LRU", "FIFO"):
            return (f"level {lv.name}: replacement policy {pol!r} "
                    "(vector backend supports LRU and FIFO)")
        if not lv.write_allocate:
            return (f"level {lv.name}: write_allocate=False "
                    "(vector backend models write-allocate hierarchies)")
    return None


def resolve_backend(machine: Machine, backend: str = "auto") -> str:
    """Resolve the ``--sim-backend`` switch against ``machine``.

    ``auto`` picks ``vector`` whenever the machine's hierarchy is in the
    vectorizable family and falls back to ``scalar`` otherwise; asking for
    ``vector`` on an unsupported machine is an error, not a silent
    fallback.
    """
    if backend not in SIM_BACKENDS:
        raise ValueError(f"unknown sim backend {backend!r}; "
                         f"available: {list(SIM_BACKENDS)}")
    reason = vector_unsupported_reason(machine)
    if backend == "auto":
        return "scalar" if reason else "vector"
    if backend == "vector" and reason:
        raise ValueError(f"sim backend 'vector' cannot simulate machine "
                         f"{machine.name!r}: {reason}")
    return backend


def normalize_sim_kwargs(sim_kwargs: dict | None, machine: Machine) -> dict:
    """Fill defaults and resolve ``backend`` so equivalent option dicts
    (``{}`` vs explicit defaults vs ``backend='auto'``) share one identity
    — the session uses this for its cache keys, reports for provenance."""
    kw = dict(sim_kwargs or {})
    unknown = set(kw) - set(SIM_OPTION_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown sim_kwargs {sorted(unknown)}; "
                         f"known: {sorted(SIM_OPTION_DEFAULTS)}")
    for k, v in SIM_OPTION_DEFAULTS.items():
        kw.setdefault(k, v)
    if int(kw["measure_rows"]) < 1:
        raise ValueError(
            f"measure_rows must be >= 1, got {kw['measure_rows']} "
            "(the steady-state counts are read from the measured rows)")
    if int(kw["warmup_rows"]) < 0:
        raise ValueError(f"warmup_rows must be >= 0, got {kw['warmup_rows']}")
    kw["backend"] = resolve_backend(machine, kw["backend"])
    return kw


@dataclasses.dataclass
class SimResult:
    iterations: int
    per_level: dict[str, CacheStats]
    # traffic INTO each level from the next-farther one, bytes per iteration
    load_bytes_per_it: dict[str, float]
    evict_bytes_per_it: dict[str, float]
    first_level_load_bytes_per_it: float
    first_level_store_bytes_per_it: float
    backend: str = "scalar"

    def total_bytes_per_it(self, level: str) -> float:
        return self.load_bytes_per_it[level] + self.evict_bytes_per_it[level]


class _AffineAccess:
    """Precompiled access: addr = base + const + Σ coeff_i * loopvar_i
    (all byte-valued integers; built by :func:`_compile_kernel` from the
    structure-stage symbolic coefficients)."""

    __slots__ = ("coeffs", "const", "is_write", "elem")

    def __init__(self, coeffs: list[int], const: int, is_write: bool,
                 elem: int):
        self.coeffs = coeffs
        self.const = const
        self.is_write = is_write
        self.elem = elem


# events per vector block: bounds peak memory (~a few × 8 B per event)
# while keeping the per-step numpy overhead amortized over many rows
_MAX_BLOCK_EVENTS = 1 << 22

# Two-stage compiled-setup cache.  The *structure* stage (offset
# expand/Poly extraction — the sympy work that dominates small
# simulations) depends only on the loop/access/array containers, which
# bind() shares across every point of a sweep; its coefficients stay
# symbolic in the kernel constants.  The *numeric* stage substitutes one
# point's constants into those small coefficient expressions — cheap
# enough that a SIM sweep pays the sympy cost once per kernel structure,
# not once per grid point.  Entries
# hold the containers to validate id() reuse, like session._STRUCT_KEYS.
_STRUCT_CACHE: dict[tuple, tuple] = {}
_STRUCT_CACHE_MAX = 128
_SETUP_CACHE: dict[tuple, tuple] = {}
_SETUP_CACHE_MAX = 128


def _num(expr, subs: dict) -> int:
    return expr if isinstance(expr, int) else int(expr.subs(subs))


def _compile_structure(kernel: LoopKernel):
    """Constants-independent stage: per-access offset coefficients, array
    sizes, and loop bounds as (small) sympy expressions over the kernel's
    symbolic constants; already-numeric pieces are plain ints."""
    key = (id(kernel.loops), id(kernel.accesses), id(kernel.arrays))
    ent = _STRUCT_CACHE.get(key)
    if ent is not None and ent[0] is kernel.loops \
            and ent[1] is kernel.accesses and ent[2] is kernel.arrays:
        return ent[3]
    loop_vars = [lp.var for lp in kernel.loops]
    lv_set = set(loop_vars)

    def _slim(expr):
        return int(expr) if not expr.free_symbols else expr

    acc_specs = []
    for a in kernel.accesses:
        off = sympy.expand(a.offset())
        if off.free_symbols & lv_set:
            poly = sympy.Poly(off, *loop_vars)
            coeffs = [_slim(poly.coeff_monomial(v)) for v in loop_vars]
            const = _slim(poly.coeff_monomial(1))
        else:
            coeffs = [0] * len(loop_vars)
            const = _slim(off)
        acc_specs.append((coeffs, const, a.is_write, a.array.element_bytes,
                          a.array.name))
    sizes = [(name, _slim(sympy.sympify(arr.size_elements)),
              arr.element_bytes) for name, arr in kernel.arrays.items()]
    bound_exprs = [(_slim(sympy.sympify(lp.start)),
                    _slim(sympy.sympify(lp.stop)), lp.step)
                   for lp in kernel.loops]
    spec = (acc_specs, sizes, bound_exprs)
    while len(_STRUCT_CACHE) >= _STRUCT_CACHE_MAX:
        _STRUCT_CACHE.pop(next(iter(_STRUCT_CACHE)))
    _STRUCT_CACHE[key] = (kernel.loops, kernel.accesses, kernel.arrays,
                          spec)
    return spec


def _compile_kernel(kernel: LoopKernel):
    """(accesses, bounds): precompiled affine accesses + loop bounds."""
    key = (id(kernel.loops), id(kernel.accesses), id(kernel.arrays),
           tuple(sorted(kernel.constants.items())))
    ent = _SETUP_CACHE.get(key)
    if ent is not None and ent[0] is kernel.loops \
            and ent[1] is kernel.accesses and ent[2] is kernel.arrays:
        return ent[3], ent[4]
    acc_specs, sizes, bound_exprs = _compile_structure(kernel)
    subs = kernel.subs()

    # lay out arrays back to back, 4 KiB aligned like a real allocator;
    # the 1 MiB base keeps every line number positive (vector backend
    # relies on 0 marking an empty way)
    bases: dict[str, int] = {}
    addr = 1 << 20
    for name, size_expr, eb in sizes:
        bases[name] = addr
        size = _num(size_expr, subs) * eb
        addr += (size + 4095) // 4096 * 4096

    accesses = [
        _AffineAccess([_num(c, subs) * eb for c in coeffs],
                      bases[aname] + _num(const, subs) * eb, is_write, eb)
        for coeffs, const, is_write, eb, aname in acc_specs]

    bounds = [(_num(b0, subs), _num(b1, subs), step)
              for b0, b1, step in bound_exprs]

    while len(_SETUP_CACHE) >= _SETUP_CACHE_MAX:
        _SETUP_CACHE.pop(next(iter(_SETUP_CACHE)))
    _SETUP_CACHE[key] = (kernel.loops, kernel.accesses, kernel.arrays,
                         accesses, bounds)
    return accesses, bounds


def simulate(kernel: LoopKernel, machine: Machine, warmup_rows: int = 2,
             measure_rows: int = 1, seed: int = 0,
             backend: str = "auto") -> SimResult:
    """Simulate ``warmup_rows`` inner rows, reset stats, measure
    ``measure_rows`` rows (a row = one full inner-loop sweep). The warm-up
    start is placed mid-array so the steady-state neighborhood exists, and
    rows are whole inner sweeps, so measurement is cache-line aligned
    (paper §2.4.1).

    ``backend`` selects the engine (``auto``/``scalar``/``vector``, see the
    module docstring); both produce identical per-level counts wherever the
    vector backend applies.
    """
    backend = resolve_backend(machine, backend)
    accesses, bounds = _compile_kernel(kernel)

    # choose a mid-domain starting point for outer loops (steady neighborhood)
    outer_vals = []
    for (b0, b1, _s) in bounds[:-1]:
        outer_vals.append(max(b0, (b0 + b1) // 2))
    i0, i1, istep = bounds[-1]
    cl = machine.cacheline_bytes

    # iterate consecutive (outer...) positions row by row: advance the
    # second-innermost loop var; wrap into the next-outer when exhausted.
    def advance(vals: list[int]) -> list[int]:
        vals = list(vals)
        for d in range(len(vals) - 1, -1, -1):
            b0, b1, s = bounds[d]
            vals[d] += s
            if vals[d] < b1:
                return vals
            vals[d] = b0
        return vals

    it_per_row = max(1, (i1 - i0 + istep - 1) // istep)

    if backend == "vector":
        per_level = _run_vector(machine, accesses, outer_vals, advance,
                                i0, i1, istep, cl, warmup_rows, measure_rows)
    else:
        per_level = _run_scalar(machine, accesses, outer_vals, advance,
                                i0, i1, istep, cl, warmup_rows, measure_rows,
                                seed)

    iters = it_per_row * measure_rows
    load_bpi: dict[str, float] = {}
    evict_bpi: dict[str, float] = {}
    for name in machine.level_names:
        load_bpi[name] = per_level[name].misses * cl / iters
        evict_bpi[name] = per_level[name].writebacks * cl / iters
    return SimResult(
        iterations=iters, per_level=per_level,
        load_bytes_per_it=load_bpi, evict_bytes_per_it=evict_bpi,
        first_level_load_bytes_per_it=float(
            sum(a.elem for a in accesses if not a.is_write) * istep),
        first_level_store_bytes_per_it=float(
            sum(a.elem for a in accesses if a.is_write) * istep),
        backend=backend,
    )


def _run_scalar(machine, accesses, outer_vals, advance, i0, i1, istep, cl,
                warmup_rows, measure_rows, seed) -> dict[str, CacheStats]:
    """Reference driver: one load_line/store_line call per access."""
    hierarchy = build_hierarchy(machine, seed)
    first = hierarchy[0]

    def run_row(vals: list[int]) -> None:
        fixed = [a.const + sum(c * v for c, v in zip(a.coeffs[:-1], vals))
                 for a in accesses]
        for i in range(i0, i1, istep):
            for a, f in zip(accesses, fixed):
                line = (f + a.coeffs[-1] * i) // cl
                if a.is_write:
                    first.store_line(line)
                else:
                    first.load_line(line)

    vals = list(outer_vals)
    for r in range(warmup_rows + measure_rows):
        if r == warmup_rows:
            for lvl in hierarchy:
                lvl.reset_stats()
        run_row(vals)
        vals = advance(vals)
    return {lvl.name: lvl.stats for lvl in hierarchy}


def _run_vector(machine, accesses, outer_vals, advance, i0, i1, istep, cl,
                warmup_rows, measure_rows) -> dict[str, CacheStats]:
    """Vector driver: blocks of whole rows flow level by level through the
    per-set state machines.

    When the kernel has at most ``ways(L1)`` accesses per iteration (and
    forward-marching streams), the first level's heads are generated
    *analytically*: each access site's run boundaries are the cache-line
    crossings of its affine address function, so the head lines, start
    iterations, and run-end stamps come straight from ``arange`` algebra —
    the per-event stream is never materialized at all.  Consecutive
    same-line touches of one site are then separated by fewer than
    ``ways`` events, so every run tail is a guaranteed hit (see
    :class:`_VectorCache`).  Otherwise a per-event fallback materializes
    the block stream and runs the generic chain analysis.
    """
    levels: list[_VectorCache | _VectorMemory] = []
    for lv in machine.levels:
        sets, ways = _level_geometry(lv)
        levels.append(_VectorCache(lv.name, sets, ways,
                                   lv.replacement_policy, lv.write_back))
    levels.append(_VectorMemory())

    n_it = max(0, (i1 - i0 + istep - 1) // istep) if istep > 0 else 0
    coeff_inner = np.array([a.coeffs[-1] for a in accesses], dtype=np.int64)
    acc_kinds = np.array([_STORE if a.is_write else _LOAD for a in accesses],
                         dtype=np.int64)
    outer_coeffs = np.array([a.coeffs[:-1] for a in accesses],
                            dtype=np.int64).reshape(len(accesses), -1)
    consts = np.array([a.const for a in accesses], dtype=np.int64)
    n_acc = len(accesses)
    n_load_sites = sum(1 for a in accesses if not a.is_write)
    first = levels[0]
    w_step = coeff_inner * istep            # bytes per iteration *index*
    # analytic run-chains lean on the LRU inclusion property (run tails
    # are up to n_acc events apart); FIFO levels take the per-event path.
    # They also assume each site's touched lines form one contiguous
    # range (cnt = last - first + 1), which only holds while a single
    # iteration cannot skip a whole cache line: any site striding past
    # the line size takes the per-event path too.
    compressed = (n_acc > 0 and isinstance(first, _VectorCache)
                  and first.lru and n_acc <= first.ways and istep > 0
                  and bool((coeff_inner >= 0).all())
                  and bool((w_step <= cl).all()))
    clock = 1      # global event position across blocks; ≥ 1 so real
    #                stamps always beat the empty-way sentinel 0

    def flush(rows: list[np.ndarray]) -> None:
        nonlocal clock
        if not rows or n_it == 0:
            return
        # per-(row, site) inner-start addresses, shape (R, n_acc)
        fp = np.array(rows, dtype=np.int64) @ outer_coeffs.T \
            + consts[None, :] + coeff_inner[None, :] * i0
        n_rows = fp.shape[0]
        total = n_rows * n_it * n_acc
        if compressed:
            # site-major segments: one segment per (site, row) run train
            fseg = fp.T.ravel()                       # (n_acc * R,)
            wseg = np.repeat(w_step, n_rows)
            l0 = fseg // cl
            cnt = (fseg + wseg * (n_it - 1)) // cl - l0 + 1
            nseg = cnt.size
            n_heads = int(cnt.sum())
            seg_off = np.concatenate(([0], np.cumsum(cnt)))[:-1]
            m = np.arange(n_heads, dtype=np.int64) - np.repeat(seg_off, cnt)
            h_line = np.repeat(l0, cnt) + m
            # first iteration index touching line l0+m: the smallest idx
            # with fseg + wseg*idx >= (l0+m)*cl  (m=0 starts at idx 0)
            wsafe = np.repeat(np.maximum(wseg, 1), cnt)
            h_it = np.where(
                m == 0, 0,
                -((np.repeat(fseg, cnt) - h_line * cl) // wsafe))
            # run-end iteration: one before the next head's start
            seg_end = np.empty(n_heads, dtype=bool)
            seg_end[-1] = True
            np.equal(m[1:], 0, out=seg_end[:-1])
            eff_it = np.where(seg_end, n_it - 1,
                              np.concatenate((h_it[1:], [0])) - 1)
            site = np.repeat(np.repeat(np.arange(n_acc, dtype=np.int64),
                                       n_rows), cnt)
            row_i = np.repeat(np.tile(np.arange(n_rows, dtype=np.int64),
                                      n_acc), cnt)
            base = clock + (row_i * n_it + h_it) * n_acc + site
            h_eff = clock + (row_i * n_it + eff_it) * n_acc + site
            h_kind = acc_kinds[site]
            ev = first.process_heads(
                (h_line, h_kind, base, h_eff, h_kind != _LOAD),
                n_access=total, n_load=n_rows * n_it * n_load_sites)
            rest = levels[1:]
        else:
            steps = np.arange(n_it, dtype=np.int64)
            lines = (fp[:, None, :]
                     + w_step[None, None, :] * steps[None, :, None]) // cl
            ev = (lines.reshape(-1), np.tile(acc_kinds, n_rows * n_it),
                  np.arange(clock, clock + total, dtype=np.int64))
            rest = levels
        clock += total
        for lvl in rest:
            ev = lvl.process(*ev)
        rows.clear()

    max_rows = max(1, _MAX_BLOCK_EVENTS // max(1, n_it * n_acc))
    vals = list(outer_vals)
    rows: list[list[int]] = []
    for r in range(warmup_rows + measure_rows):
        if r == warmup_rows:
            flush(rows)
            for lvl in levels:
                lvl.reset_stats()
        rows.append(list(vals))
        if len(rows) >= max_rows:
            flush(rows)
        vals = advance(vals)
    flush(rows)
    return {lvl.name: lvl.stats for lvl in levels}
