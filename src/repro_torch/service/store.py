"""Disk-backed, content-addressed result store (a copy of
``repro.service.store``: the same layout, envelope and digests, so a
store either package filled serves the other).

Every analysis result this project produces is a pure function of
``(kernel structure, machine contents, model, predictor, in-core model,
sim params)`` — the LC analysis cost amortization argument of Hammer et
al. (arXiv:1509.03778) applied fleet-wide: compute once anywhere, hit
everywhere.  The store materializes that purity on disk:

* **Content addressing** — a request key is the same tuple the memoizing
  :class:`~repro_torch.core.session.AnalysisSession` uses, except the machine
  is identified by its :attr:`~repro_torch.core.machine.Machine.fingerprint`
  (a hash of the *parsed* description, never the YAML path/mtime).  The
  key is reduced to a :func:`~repro_torch.core.identity.stable_digest`, which
  is process-independent — any worker, CLI invocation, or service
  replica pointed at the same cache root addresses the same entries.

* **Sharded JSON layout** — entry ``<digest>`` lives at
  ``<root>/<digest[:2]>/<digest>.json`` so no directory grows unbounded.
  Writes go through a temp file + :func:`os.replace`, so concurrent
  writers (the sweep worker pool, parallel services) can only ever
  publish complete entries.

* **Schema versioning** — :data:`SCHEMA_VERSION` is hashed into every
  digest *and* stamped into the envelope.  Bumping it (required whenever
  any ``Result.to_dict`` format changes) makes old entries unaddressable,
  and the envelope check catches hand-edited or truncated files: a stale
  or corrupt entry is a miss to be overwritten, never a crash and never
  a mis-deserialization.

Payloads are ``Result.to_dict()`` dicts (or the deduplicated sweep form
built by :func:`encode_results`), chosen precisely because the project
pins exact ``to_dict``/``from_dict`` round-trip parity for every model.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import uuid

from repro_torch.core import reports
from repro_torch.core.identity import stable_digest

#: Version of the on-disk entry format.  Bump whenever any model's
#: ``to_dict()`` payload changes shape (fields added/removed/renamed) —
#: digests include it, so old entries are silently skipped, not misread.
SCHEMA_VERSION = 1

_DIGEST_LEN = 32


@dataclasses.dataclass
class StoreStats:
    """Counters for one :class:`ResultStore` instance (in-process)."""
    lookups: int = 0
    hits: int = 0
    misses: int = 0                 # entry absent
    skipped_schema: int = 0         # entry present but written by another
    skipped_corrupt: int = 0        # ... schema / unreadable -> also a miss
    puts: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ResultStore:
    """Sharded JSON store mapping request keys to result payloads.

    ``get``/``put`` take the raw key tuple; digesting and enveloping are
    internal.  All failure modes on the read path (missing file, partial
    write from a crashed process, schema drift, hand-edited garbage)
    degrade to a miss — the caller recomputes and ``put`` overwrites.
    """

    def __init__(self, root: str | os.PathLike):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.stats = StoreStats()

    # -- addressing ----------------------------------------------------
    def digest(self, key: tuple) -> str:
        return stable_digest((SCHEMA_VERSION, key), _DIGEST_LEN)

    def path(self, key: tuple) -> pathlib.Path:
        d = self.digest(key)
        return self.root / d[:2] / f"{d}.json"

    # -- read / write --------------------------------------------------
    def get(self, key: tuple) -> dict | None:
        """The stored payload for ``key``, or None (any unreadable, stale,
        or absent entry is a miss)."""
        self.stats.lookups += 1
        path = self.path(key)
        try:
            with open(path) as f:
                env = json.load(f)
        except FileNotFoundError:
            self.stats.misses += 1
            return None
        except (OSError, ValueError):
            self.stats.skipped_corrupt += 1
            return None
        if not isinstance(env, dict) or "payload" not in env:
            self.stats.skipped_corrupt += 1
            return None
        if env.get("schema") != SCHEMA_VERSION:
            self.stats.skipped_schema += 1
            return None
        self.stats.hits += 1
        return env["payload"]

    def put(self, key: tuple, payload: dict,
            meta: dict | None = None) -> None:
        """Publish ``payload`` under ``key`` atomically (tmp + rename).

        ``meta`` is a small human-readable description of the key (model,
        machine, kernel name, ...) stored alongside for ``cache stats``
        and debugging; it never participates in addressing.
        """
        path = self.path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        env = {"schema": SCHEMA_VERSION, "digest": self.digest(key),
               "meta": meta or {}, "payload": payload}
        tmp = path.parent / f".tmp-{os.getpid()}-{uuid.uuid4().hex}"
        try:
            with open(tmp, "w") as f:
                json.dump(env, f, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            tmp.unlink(missing_ok=True)
            raise
        self.stats.puts += 1

    # -- administration ------------------------------------------------
    def entries(self):
        """All entry paths under the cache root (any schema version)."""
        yield from sorted(self.root.glob("??/*.json"))

    def summary(self, detail: bool = False) -> dict:
        """Entry count and total bytes; with ``detail``, also per-kind and
        per-schema counts (reads every envelope — an admin operation)."""
        n = 0
        total = 0
        kinds: dict[str, int] = {}
        schemas: dict[str, int] = {}
        for p in self.entries():
            n += 1
            total += p.stat().st_size
            if not detail:
                continue
            try:
                with open(p) as f:
                    env = json.load(f)
                kind = str((env.get("meta") or {}).get("kind", "?"))
                schema = str(env.get("schema", "?"))
            except (OSError, ValueError):
                kind, schema = "corrupt", "corrupt"
            kinds[kind] = kinds.get(kind, 0) + 1
            schemas[schema] = schemas.get(schema, 0) + 1
        out = {"root": str(self.root), "schema": SCHEMA_VERSION,
               "entries": n, "bytes": total}
        if detail:
            out["by_kind"] = kinds
            out["by_schema"] = schemas
        return out

    def clear(self) -> int:
        """Delete every entry (all schema versions); returns the count."""
        n = 0
        for p in self.entries():
            p.unlink(missing_ok=True)
            n += 1
        return n


# ----------------------------------------------------------------------
# Sweep payload codec: a 1000-point LC sweep typically holds only a
# handful of distinct results (traffic is piecewise-constant in the swept
# symbol), and the compiled engine broadcasts one frozen
# Result per regime.  Storing unique payloads + an index list keeps the
# entry small and — crucially for the warm path — keeps deserialization
# cost proportional to the number of *regimes*, not points.
# ----------------------------------------------------------------------

def encode_results(results: list) -> dict:
    """Deduplicate a result list into ``{"unique": [...], "index": [...]}``.

    Dedup is by object identity first (the broadcast fast path), then by
    payload digest, so equal-but-distinct objects also fold."""
    unique: list[dict] = []
    index: list[int] = []
    by_id: dict[int, int] = {}
    by_digest: dict[str, int] = {}
    for r in results:
        pos = by_id.get(id(r))
        if pos is None:
            d = r.to_dict()
            dg = stable_digest(d, _DIGEST_LEN)
            pos = by_digest.get(dg)
            if pos is None:
                pos = len(unique)
                unique.append(d)
                by_digest[dg] = pos
            by_id[id(r)] = pos
        index.append(pos)
    return {"unique": unique, "index": index}


def decode_results(payload: dict, shared: dict[str, object] | None = None):
    """Rebuild the result list from :func:`encode_results`' form.

    Points that shared one payload share one rebuilt object.  ``shared``
    (digest -> Result) extends that sharing across several payloads —
    the worker pool merges its shards through one such map, so a regime
    spanning a shard boundary still yields a single object."""
    objs = []
    for d in payload["unique"]:
        if shared is None:
            objs.append(reports.result_from_dict(d))
            continue
        dg = stable_digest(d, _DIGEST_LEN)
        obj = shared.get(dg)
        if obj is None:
            obj = shared[dg] = reports.result_from_dict(d)
        objs.append(obj)
    return [objs[i] for i in payload["index"]]
