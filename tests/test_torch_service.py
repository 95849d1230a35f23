"""The port's result store, service tier and worker pool
(``repro_torch.service``) against the JAX package's.

Every case of ``tests/test_service.py`` has a counterpart here: the
store's layout, envelope, schema and corruption handling, the sweep codec,
machine fingerprints, the service's memory, coalescing and disk tiers
(one computation per distinct key), the queue facade, and the spawned
worker pool with its fault hook.  On top of those, the store's digests
equal JAX's for the same request, and a store either package filled
serves the other with nothing computed and equal ``to_dict``.  The tune
key holds the device a report was measured on.
"""
import dataclasses
import json
import pathlib
import shutil
import threading

import pytest

pytest.importorskip("jax")

from repro.core import api as j_api  # noqa: E402
from repro.service import AnalysisService as JService  # noqa: E402
from repro.service import store as j_store  # noqa: E402

from repro_torch.core import api  # noqa: E402
from repro_torch.core.machine import Machine  # noqa: E402
from repro_torch.core.session import AnalysisSession  # noqa: E402
from repro_torch.service import (AnalysisRequest,  # noqa: E402
                                 AnalysisServer, AnalysisService,
                                 ResultStore, sweep_sharded)
from repro_torch.service import store as store_mod  # noqa: E402
from repro_torch.tune import tune, tuner  # noqa: E402
from _torch_machines import H100, IVY, jax_side  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
STENCIL = str(REPO / "src" / "repro_torch" / "configs" / "stencils" /
              "stencil_3d7pt.c")
LONGRANGE = str(pathlib.Path(STENCIL).with_name("stencil_3d_long_range.c"))


def _kernel(n=100, m=130):
    return api.load_kernel(STENCIL, {"M": m, "N": n})


def _analyze_args(n=100, machine=IVY):
    return dict(source=STENCIL, machine=machine, model="ecm",
                constants={"M": 130, "N": n})


def _dicts(rs):
    return [r.to_dict() for r in rs]


# ----------------------------------------------------------------------
# ResultStore
# ----------------------------------------------------------------------

def test_store_round_trip(tmp_path):
    store = ResultStore(tmp_path)
    key = ("analyze", "ecm", ("some", "key"), "fp", "LC")
    assert store.get(key) is None
    store.put(key, {"model": "ecm", "t_ecm": 46.2}, meta={"kind": "analyze"})
    assert store.get(key) == {"model": "ecm", "t_ecm": 46.2}
    path = store.path(key)
    assert path.parent.parent == store.root and len(path.parent.name) == 2
    assert store.stats.hits == 1 and store.stats.puts == 1
    # the same address and envelope as the JAX package's store
    theirs = j_store.ResultStore(tmp_path)
    assert theirs.path(key) == path and theirs.get(key) == store.get(key)


def test_store_distinct_keys_distinct_entries(tmp_path):
    store = ResultStore(tmp_path)
    store.put(("k", 1), {"v": 1})
    store.put(("k", 2), {"v": 2})
    assert store.get(("k", 1)) == {"v": 1}
    assert store.get(("k", 2)) == {"v": 2}
    assert store.summary()["entries"] == 2


def test_store_corrupt_entry_is_miss_then_overwritten(tmp_path):
    store = ResultStore(tmp_path)
    key = ("corrupt-me",)
    path = store.path(key)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text('{"schema": 1, "payload": {truncated')
    assert store.get(key) is None
    assert store.stats.skipped_corrupt == 1
    store.put(key, {"ok": True})
    assert store.get(key) == {"ok": True}


def test_store_schema_mismatch_is_skipped_never_deserialized(tmp_path):
    store = ResultStore(tmp_path)
    key = ("stale",)
    path = store.path(key)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schema": store_mod.SCHEMA_VERSION + 1,
                                "payload": {"model": "not-even-a-result"}}))
    assert store.get(key) is None
    assert store.stats.skipped_schema == 1


def test_store_digest_includes_schema_version(tmp_path, monkeypatch):
    store = ResultStore(tmp_path)
    key = ("versioned",)
    old = store.path(key)
    assert store_mod.SCHEMA_VERSION == j_store.SCHEMA_VERSION
    monkeypatch.setattr(store_mod, "SCHEMA_VERSION",
                        store_mod.SCHEMA_VERSION + 1)
    assert store.path(key) != old


def test_store_clear_and_summary(tmp_path):
    store = ResultStore(tmp_path)
    store.put(("a",), {"v": 1}, meta={"kind": "analyze"})
    store.put(("b",), {"v": 2}, meta={"kind": "sweep"})
    s = store.summary(detail=True)
    assert s["entries"] == 2 and s["bytes"] > 0
    assert s["by_kind"] == {"analyze": 1, "sweep": 1}
    assert s == j_store.ResultStore(tmp_path).summary(detail=True)
    assert store.clear() == 2
    assert store.summary()["entries"] == 0


def test_encode_decode_results_dedup():
    sess = AnalysisSession(api.resolve_machine(IVY))
    out = sess.sweep(_kernel(), "N", range(100, 400, 10), compiled=True)
    enc = store_mod.encode_results(out["ecm"])
    assert len(enc["index"]) == len(out["ecm"])
    assert len(enc["unique"]) < len(out["ecm"])
    dec = store_mod.decode_results(enc)
    assert _dicts(dec) == _dicts(out["ecm"])
    assert len({id(r) for r in dec}) == len(enc["unique"])
    # the JAX package's codec reads the port's payload point for point
    assert _dicts(j_store.decode_results(enc)) == _dicts(out["ecm"])


# ----------------------------------------------------------------------
# Machine fingerprinting (content, not path/mtime)
# ----------------------------------------------------------------------

def test_machine_fingerprint_identical_files_share(tmp_path):
    a, b = tmp_path / "copy_a.yaml", tmp_path / "renamed_b.yaml"
    shutil.copy(IVY, a)
    shutil.copy(IVY, b)
    ma, mb = Machine.from_yaml(a), Machine.from_yaml(b)
    assert ma.fingerprint == mb.fingerprint == Machine.from_yaml(
        IVY).fingerprint
    assert ma.fingerprint == \
        j_api.resolve_machine(jax_side(IVY)).fingerprint


def test_machine_fingerprint_edit_invalidates(tmp_path):
    src = open(IVY).read()
    edited = tmp_path / "edited.yaml"
    assert "clock: 3.0 GHz" in src
    edited.write_text(src.replace("clock: 3.0 GHz", "clock: 4.0 GHz"))
    assert Machine.from_yaml(edited).fingerprint \
        != Machine.from_yaml(IVY).fingerprint


def test_machine_fingerprint_on_hand_built_machine():
    m = api.resolve_machine(H100)
    assert dataclasses.replace(m).fingerprint == m.fingerprint
    assert dataclasses.replace(m, cacheline_bytes=64).fingerprint \
        != m.fingerprint
    assert m.fingerprint == j_api.resolve_machine(H100).fingerprint


def test_service_sessions_pool_by_fingerprint(tmp_path):
    svc = AnalysisService()
    a = tmp_path / "a.yaml"
    shutil.copy(H100, a)
    assert svc.session("H100") is svc.session(str(a))
    assert svc.session(api.resolve_machine(H100)) is svc.session("H100")


# ----------------------------------------------------------------------
# AnalysisService: tiers and parity
# ----------------------------------------------------------------------

def test_service_disk_parity_and_no_recompute(tmp_path):
    svc1 = AnalysisService(cache_dir=tmp_path)
    r1 = svc1.analyze(**_analyze_args())
    assert svc1.stats.computed == 1
    svc2 = AnalysisService(cache_dir=tmp_path)
    r2 = svc2.analyze(**_analyze_args())
    assert r2.to_dict() == r1.to_dict()
    assert svc2.stats.disk_hits == 1 and svc2.stats.computed == 0
    assert svc2.session_stats().misses == 0
    sess = svc2.session(IVY)
    r3 = sess.analyze(_kernel(), "ecm")
    assert r3 is r2 and sess.stats.result_hits == 1


def test_service_memory_tier_returns_same_object(tmp_path):
    svc = AnalysisService(cache_dir=tmp_path)
    r1 = svc.analyze(**_analyze_args())
    assert svc.analyze(**_analyze_args()) is r1
    assert svc.stats.memory_hits == 1


def test_service_without_store_still_memoizes():
    svc = AnalysisService()
    assert svc.store is None
    r1 = svc.analyze(**_analyze_args())
    assert svc.analyze(**_analyze_args()) is r1


def test_service_sweep_disk_round_trip(tmp_path):
    values = list(range(100, 300, 10))
    kw = dict(models=("ecm", "roofline"), constants={"M": 130})
    out1 = AnalysisService(cache_dir=tmp_path).sweep(
        STENCIL, IVY, "N", values, **kw)
    svc2 = AnalysisService(cache_dir=tmp_path)
    out2 = svc2.sweep(STENCIL, IVY, "N", values, **kw)
    assert svc2.stats.disk_hits == 1 and svc2.stats.computed == 0
    assert svc2.session_stats().misses == 0
    for m in ("ecm", "roofline"):
        assert _dicts(out2[m]) == _dicts(out1[m])


def test_service_sweep_key_ignores_engine_spelling(tmp_path):
    values = list(range(100, 160, 10))
    svc = AnalysisService(cache_dir=tmp_path)
    out1 = svc.sweep(STENCIL, IVY, "N", values, constants={"M": 130},
                     compiled=True)
    out2 = svc.sweep(STENCIL, IVY, "N", values, constants={"M": 130},
                     compiled=False)
    assert svc.stats.memory_hits == 1 and svc.stats.computed == 1
    assert _dicts(out1["ecm"]) == _dicts(out2["ecm"])


def test_service_distinct_options_key_separately(tmp_path):
    svc = AnalysisService(cache_dir=tmp_path)
    r_simple = svc.analyze(**_analyze_args(), incore="simple")
    r_ports = svc.analyze(**_analyze_args(), incore="ports")
    assert svc.stats.computed == 2
    assert r_simple.to_dict() != r_ports.to_dict()


def test_api_analyze_routes_through_service(tmp_path):
    svc = AnalysisService(cache_dir=tmp_path)
    r1 = api.analyze(STENCIL, IVY, constants={"M": 130, "N": 100},
                     service=svc)
    assert svc.stats.requests == 1
    direct = AnalysisSession(api.resolve_machine(IVY)).analyze(
        _kernel(), "ecm")
    assert r1.to_dict() == direct.to_dict()
    with pytest.raises(ValueError, match="not both"):
        api.analyze(STENCIL, IVY, constants={"M": 130, "N": 100},
                    service=svc, session=AnalysisSession(
                        api.resolve_machine(IVY)))


def test_threaded_identical_and_distinct_requests(tmp_path):
    svc = AnalysisService(cache_dir=tmp_path)
    sizes = [100, 200, 300, 400]
    n_threads = 16
    barrier = threading.Barrier(n_threads)
    results: list = [None] * n_threads
    errors: list = []

    def worker(i):
        try:
            barrier.wait()
            results[i] = svc.analyze(**_analyze_args(sizes[i % len(sizes)]))
        except Exception as e:               # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert svc.stats.computed == len(sizes)
    assert svc.session_stats().result_misses == len(sizes)
    assert svc.stats.memory_hits + svc.stats.coalesced \
        == n_threads - len(sizes)
    by_size: dict[int, list] = {}
    for i, r in enumerate(results):
        by_size.setdefault(sizes[i % len(sizes)], []).append(r)
    for group in by_size.values():
        assert all(r is group[0] for r in group)


def test_analyze_many_coalesces_and_preserves_order(tmp_path):
    svc = AnalysisService(cache_dir=tmp_path, threads=8)
    out = svc.analyze_many([_analyze_args(n)
                            for n in (100, 200, 100, 300, 200, 100)])
    assert svc.stats.computed == 3
    assert out[0] is out[2] is out[5] and out[1] is out[4]
    assert out[0] is not out[3]
    svc.close()


def test_sweep_many():
    svc = AnalysisService()
    reqs = [dict(source=STENCIL, machine=IVY, param="N",
                 values=range(100, 160, 10), constants={"M": m})
            for m in (130, 140, 130)]
    outs = svc.sweep_many(reqs)
    assert svc.stats.computed == 2
    assert _dicts(outs[0]["ecm"]) == _dicts(outs[2]["ecm"])
    svc.close()


def test_analysis_server_queue_facade():
    svc = AnalysisService()
    server = AnalysisServer(svc, batch_size=4)
    for uid in range(3):
        server.submit(AnalysisRequest(uid=uid, kind="analyze",
                                      request=_analyze_args(100)))
    server.submit(AnalysisRequest(
        uid=99, kind="sweep",
        request=dict(source=STENCIL, machine=IVY, param="N",
                     values=range(100, 140, 10), constants={"M": 130})))
    server.submit(AnalysisRequest(
        uid=100, kind="analyze",
        request=dict(source=STENCIL, machine=IVY, model="no-such-model",
                     constants={"M": 130, "N": 100})))
    done = server.drain()
    assert len(done) == 5 and all(r.done for r in done)
    by_uid = {r.uid: r for r in done}
    assert by_uid[0].result is by_uid[2].result
    assert "ecm" in by_uid[99].result
    assert by_uid[100].error and "no-such-model" in by_uid[100].error
    assert by_uid[100].result is None
    with pytest.raises(ValueError, match="unknown request kind"):
        server.submit(AnalysisRequest(uid=1, kind="nope"))
    svc.close()


# ----------------------------------------------------------------------
# the store is shared with the JAX package
# ----------------------------------------------------------------------

# (source, element_bytes, constants) for analyze and for sweep over N
REQUESTS = [(STENCIL, None, {"M": 130, "N": 100}),
            (LONGRANGE, None, {"M": 130, "N": 1015}),
            ("trace:stencil3d7pt", 4, {"M": 130, "N": 1015}),
            ("trace:longrange3d", 4, {"M": 130, "N": 1015})]
SWEEP_N = list(range(64, 1025, 96))


def _fill(svc, port: bool):
    """Analyze and sweep every request on both machines through ``svc``;
    returns the ``to_dict`` of everything served, in order."""
    out = []
    for machine in (IVY, H100):
        machine = machine if port else jax_side(machine)
        for src, eb, consts in REQUESTS:
            kw = ({"element_bytes": eb} if port else
                  {"frontend_opts": {"element_bytes": eb}}) if eb else {}
            for model in ("ecm", "roofline"):
                out.append(svc.analyze(src, machine, model, constants=consts,
                                       cores=4, **kw).to_dict())
            grid = svc.sweep(src, machine, "N", SWEEP_N,
                             models=("ecm", "roofline-iaca"),
                             constants={"M": consts["M"]}, **kw)
            out += [_dicts(rs) for rs in grid.values()]
    return out


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_store_filled_by_one_package_serves_the_other(filler, tmp_path):
    """Analyze and sweep entries (the C listings and the traced stencils,
    on Ivy Bridge and the H100 file) written by one package are read by
    the other with nothing computed, and their results are equal."""
    first = (JService if filler == "jax" else AnalysisService)(
        cache_dir=tmp_path)
    filled = _fill(first, port=filler == "port")
    assert first.stats.computed == 2 * len(REQUESTS) * 3
    second = (AnalysisService if filler == "jax" else JService)(
        cache_dir=tmp_path)
    served = _fill(second, port=filler == "jax")
    assert second.stats.computed == 0
    assert second.stats.disk_hits == first.stats.computed
    assert served == filled


def test_digests_equal_jax_s(tmp_path):
    """For the same request both services address the same file."""
    ours, theirs = AnalysisService(cache_dir=tmp_path / "t"), \
        JService(cache_dir=tmp_path / "j")
    for svc in (ours, theirs):
        svc.analyze(STENCIL, H100, "ecm", constants={"M": 130, "N": 1015},
                    cores=132, incore="ports")
        svc.sweep(STENCIL, H100, {"M": [64, 130], "N": [100, 500]},
                  constants={}, cores=[1, 132])
        svc.analyze(STENCIL, IVY if svc is ours else jax_side(IVY), "ecm",
                    predictor="SIM",
                    constants={"M": 20, "N": 40},
                    sim_kwargs={"warmup_rows": 3})
    names = [sorted(p.relative_to(svc.store.root) for p in
                    svc.store.entries()) for svc in (ours, theirs)]
    assert names[0] == names[1] and len(names[0]) == 3


# ----------------------------------------------------------------------
# the tuner's store branch
# ----------------------------------------------------------------------

TINY = {"m": 8, "n_min": 16, "n_max": 32}


def test_tune_keys_hold_the_device():
    """A report measured on the CPU is keyed apart from a card's (by the
    card's name), and a request that measures nothing touches no device.
    No card is needed to build the keys."""
    h100 = api.resolve_machine("H100")
    key = {dev: tuner.store_key("stencil3d7pt", h100, TINY, 2, True, 1, 3,
                                dev)
           for dev in ("cpu", "NVIDIA H100 80GB HBM3", None)}
    assert len(set(key.values())) == 3
    store = ResultStore.__new__(ResultStore)
    assert len({store.digest(k) for k in key.values()}) == 3
    assert tuner.device_key("cpu", True) == "cpu"
    assert tuner.device_key(None, False) is None
    assert tuner.device_key("cpu", False) is None


def test_tune_cache_round_trip(tmp_path):
    svc = AnalysisService(cache_dir=tmp_path)
    rep1 = tune("stencil3d7pt", "H100", config=TINY, measure=False,
                service=svc)
    assert svc.stats.computed == 1
    rep2 = tune("stencil3d7pt", "H100", config=TINY, measure=False,
                service=svc)
    assert svc.stats.computed == 1 and svc.stats.memory_hits == 1
    assert rep2.to_dict() == rep1.to_dict()
    svc2 = AnalysisService(cache_dir=tmp_path)
    rep3 = tune("stencil3d7pt", "H100", config=TINY, measure=False,
                service=svc2)
    assert svc2.stats.computed == 0 and svc2.stats.disk_hits == 1
    assert rep3.to_dict() == rep1.to_dict()


def test_measured_tune_replays_without_measuring(tmp_path, monkeypatch):
    """A tune measured on the CPU replays from disk with the measuring
    path never entered; a request that measures nothing is a miss."""
    kw = dict(config=TINY, top_k=1, reps=2, isolate=False, device="cpu")
    rep1 = tune("stencil3d7pt", "H100",
                service=AnalysisService(cache_dir=tmp_path), **kw)
    assert rep1.measured_chosen_s is not None

    def no_measuring(*a, **k):
        raise AssertionError("a warm replay measured")
    monkeypatch.setattr(tuner, "measure_candidate", no_measuring)
    svc = AnalysisService(cache_dir=tmp_path)
    assert tune("stencil3d7pt", "H100", service=svc,
                **kw).to_dict() == rep1.to_dict()
    assert svc.stats.disk_hits == 1 and svc.stats.computed == 0
    tune("stencil3d7pt", "H100", service=svc,
         **{**kw, "measure": False})
    assert svc.stats.computed == 1


# ----------------------------------------------------------------------
# Worker pool: sharded sweeps merge to the sequential result (spawned)
# ----------------------------------------------------------------------

def test_worker_pool_merge_equals_sequential_sweep(tmp_path):
    values = list(range(100, 400, 20))
    kernel = _kernel()
    mach = api.resolve_machine(IVY)
    sharded = sweep_sharded(kernel, mach, "N", values,
                            models=("ecm", "roofline-iaca"), workers=2)
    seq = AnalysisSession(mach).sweep(kernel, "N", values,
                                      models=("ecm", "roofline-iaca"),
                                      compiled=True)
    for m in ("ecm", "roofline-iaca"):
        assert _dicts(sharded[m]) == _dicts(seq[m])
    assert len({id(r) for r in sharded["ecm"]}) \
        == len({json.dumps(r.to_dict(), sort_keys=True)
                for r in seq["ecm"]})
    svc = AnalysisService(cache_dir=tmp_path)
    out = svc.sweep(STENCIL, IVY, "N", values, constants={"M": 130},
                    workers=2)
    assert svc.stats.worker_batches == 1
    svc2 = AnalysisService(cache_dir=tmp_path)
    out2 = svc2.sweep(STENCIL, IVY, "N", values, constants={"M": 130})
    assert svc2.stats.disk_hits == 1 and svc2.session_stats().misses == 0
    assert _dicts(out2["ecm"]) == _dicts(out["ecm"]) == _dicts(seq["ecm"])


def test_worker_pool_single_chunk_runs_inline():
    values = [100, 110]
    out = sweep_sharded(_kernel(), api.resolve_machine(IVY), "N", values,
                        workers=1)
    seq = AnalysisSession(api.resolve_machine(IVY)).sweep(
        _kernel(), "N", values)
    assert _dicts(out["ecm"]) == _dicts(seq["ecm"])


def test_worker_pool_rejects_non_loop_sources():
    with pytest.raises(TypeError, match="LoopKernel"):
        sweep_sharded("not a kernel", api.resolve_machine(IVY), "N",
                      [1, 2], workers=2)


_FAULT_VALUES = list(range(100, 400, 20))    # 15 points, 2 shards


@pytest.mark.parametrize("fault", ["exit", "raise"])
def test_worker_fault_surfaces_promptly(fault, monkeypatch):
    """A worker that hard-exits mid-shard surfaces as BrokenProcessPool,
    one that raises as its own exception — promptly, never a hang."""
    from concurrent.futures.process import BrokenProcessPool
    monkeypatch.setenv("REPRO_TORCH_WORKER_FAULT", fault)
    err, match = {"exit": (BrokenProcessPool, None),
                  "raise": (RuntimeError, "injected worker fault")}[fault]
    with pytest.raises(err, match=match):
        sweep_sharded(_kernel(), api.resolve_machine(IVY), "N",
                      _FAULT_VALUES, workers=2)


def test_worker_failure_leaves_no_partial_store_entries(tmp_path,
                                                        monkeypatch):
    svc = AnalysisService(cache_dir=tmp_path)
    monkeypatch.setenv("REPRO_TORCH_WORKER_FAULT", "raise")
    with pytest.raises(RuntimeError, match="injected worker fault"):
        svc.sweep(STENCIL, IVY, "N", _FAULT_VALUES, constants={"M": 130},
                  workers=2)
    assert svc.store.summary()["entries"] == 0
    assert svc.stats.computed == 0
    monkeypatch.delenv("REPRO_TORCH_WORKER_FAULT")
    out = svc.sweep(STENCIL, IVY, "N", _FAULT_VALUES, constants={"M": 130},
                    workers=2)
    assert svc.stats.computed == 1 and svc.store.summary()["entries"] == 1
    seq = AnalysisSession(api.resolve_machine(IVY)).sweep(
        _kernel(), "N", _FAULT_VALUES)
    assert _dicts(out["ecm"]) == _dicts(seq["ecm"])
