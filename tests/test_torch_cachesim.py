"""The port's cache simulator and ``predictor="SIM"`` against the JAX
package's, count for count.

The same kernels — the paper's C listings, builder kernels and the traced
4-byte stencils — go through both packages' ``simulate`` on both backends,
on the paper's Ivy Bridge files, the v5e VMEM file and the H100 file (all
by path): per-level hits, misses, evictions and write-backs must be equal,
not close.  The port's scalar and vector backends must agree with each
other, backend resolution and option normalization must behave alike, and
ECM/Roofline/``analyze`` results driven by SIM must give equal ``to_dict``.
"""
import dataclasses
import functools
import pathlib

import pytest

pytest.importorskip("jax")

from repro.core import api as j_api  # noqa: E402
from repro.core import blocking as j_blocking  # noqa: E402
from repro.core import cachesim as j_cachesim  # noqa: E402
from repro.core import compiled as j_compiled  # noqa: E402
from repro.core import ecm as j_ecm  # noqa: E402
from repro.core import kernel_ir as j_ir  # noqa: E402
from repro.core import reports as j_reports  # noqa: E402
from repro.core import roofline as j_roofline  # noqa: E402
from repro.core.machine import Machine as JMachine  # noqa: E402
from repro.core.session import AnalysisSession as JSession  # noqa: E402

from repro_torch.core import api, blocking, cachesim, compiled  # noqa: E402
from repro_torch.core import ecm, kernel_ir, roofline  # noqa: E402
from repro_torch.core.ecm import ECMResult  # noqa: E402
from repro_torch.core.machine import Machine  # noqa: E402
from repro_torch.core.predictors import predict_volumes  # noqa: E402
from repro_torch.core.roofline import RooflineResult  # noqa: E402
from repro_torch.core.session import AnalysisSession  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
MACHINES = {
    "ivy": REPO / "src/repro/configs/machines/ivybridge_ep.yaml",
    "ivy122": REPO / "src/repro/configs/machines/ivybridge_ep_sec122.yaml",
    "v5e": REPO / "src/repro/configs/machines/tpu_v5e.yaml",
    "h100": REPO / "src/repro_torch/machines/h100_sxm.yaml",
}


@functools.lru_cache(maxsize=None)
def _machines(name: str, policy: str | None = None,
              write_allocate: bool = True):
    """(ours, theirs) for machine ``name``, every level's replacement
    policy and write-allocate flag replaced when asked."""
    out = []
    for cls in (Machine, JMachine):
        m = cls.from_yaml(str(MACHINES[name]))
        if policy is not None or not write_allocate:
            levels = tuple(dataclasses.replace(
                lv, replacement_policy=policy or lv.replacement_policy,
                write_allocate=write_allocate) for lv in m.levels)
            m = dataclasses.replace(m, levels=levels)
        out.append(m)
    return tuple(out)


def _source(src, consts, element_bytes=None):
    opts = {"element_bytes": element_bytes} if element_bytes else {}
    return (api.load_kernel(src, consts, **opts),
            j_api._load_kernel_cached(src, None, None, consts, opts))


def _built(name, arrays, loops, reads, writes, flops, consts):
    """The same builder kernel from both packages' ``make_stencil``."""
    return tuple(ir.make_stencil(name, arrays, loops, reads=reads,
                                 writes=writes, flops=ir.FlopCount(**flops),
                                 constants=consts)
                 for ir in (kernel_ir, j_ir))


def _star2d(radius, n):
    reads = [("a", "j", f"i+{c}") for c in range(-radius, radius + 1)]
    reads += [("a", f"j+{c}", "i") for c in range(-radius, radius + 1) if c]
    return _built("star2d", {"a": ("M", "N"), "b": ("M", "N")},
                  [("j", radius, f"M-{radius}"), ("i", radius, f"N-{radius}")],
                  reads, [("b", "j", "i")],
                  {"add": len(reads) - 1, "mul": 1},
                  {"M": 4 * radius + 8, "N": n})


def _colcopy(n):
    """Column-order traversal of a row-major array: an inner stride of
    ``N * 8`` bytes, past the cache line for N > 8."""
    return _built("colcopy", {"a": ("N", "N"), "b": ("N", "N")},
                  [("j", 0, "N"), ("i", 0, "N")], [("a", "i", "j")],
                  [("b", "i", "j")], {"add": 1}, {"N": n})


# id -> (kernels, machine, policy, simulate options): the JAX suite's cases
# (tests/test_cachesim_vector.py), the second Ivy Bridge file, and the two
# 4-byte main-path stencils on the H100 file at a reduced N, at the JAX
# default warm-up and at one covering the 3D layer condition (2N + 2 rows
# for the 7-point stencil, 8N + 2 for the long-range one)
CASES = {
    "ivy-2d5pt": (lambda: _source("stencil_2d5pt.c", {"M": 120, "N": 200}),
                  "ivy", None, dict(warmup_rows=3, measure_rows=2)),
    "ivy-3d7pt": (lambda: _source("stencil_3d7pt.c", {"M": 30, "N": 50}),
                  "ivy", None, dict(warmup_rows=3, measure_rows=2)),
    "ivy-longrange": (lambda: _source("stencil_3d_long_range.c",
                                      {"M": 40, "N": 120}),
                      "ivy", None, dict(warmup_rows=3, measure_rows=2)),
    "ivy-3d7pt-aliasing": (lambda: _source("stencil_3d7pt.c",
                                           {"M": 20, "N": 256}),
                           "ivy", None, dict(warmup_rows=2, measure_rows=2)),
    "ivy-longrange-thrashing": (lambda: _source("stencil_3d_long_range.c",
                                                {"M": 20, "N": 1792}),
                                "ivy", None, dict(warmup_rows=2)),
    "ivy-fifo-2d5pt": (lambda: _source("stencil_2d5pt.c",
                                       {"M": 80, "N": 300}),
                       "ivy", "FIFO", dict(warmup_rows=3, measure_rows=2)),
    "ivy-fifo-thrashing": (lambda: _source("stencil_3d_long_range.c",
                                           {"M": 20, "N": 1792}),
                           "ivy", "FIFO", dict(warmup_rows=2)),
    "ivy-colcopy-wide-stride": (lambda: _colcopy(200), "ivy", None,
                                dict(warmup_rows=2, measure_rows=2)),
    "ivy-colcopy-line-stride": (lambda: _colcopy(8), "ivy", None,
                                dict(warmup_rows=2, measure_rows=2)),
    "ivy-star2d-r3-per-event": (lambda: _star2d(3, 121), "ivy", None,
                                dict(warmup_rows=2, measure_rows=2)),
    "ivy122-3d7pt": (lambda: _source("stencil_3d7pt.c", {"M": 30, "N": 50}),
                     "ivy122", None, dict(warmup_rows=3, measure_rows=2)),
    "ivy122-longrange": (lambda: _source("stencil_3d_long_range.c",
                                         {"M": 40, "N": 120}),
                         "ivy122", None, dict(warmup_rows=3)),
    "v5e-vmem-3d7pt": (lambda: _source("stencil_3d7pt.c",
                                       {"M": 20, "N": 200}),
                       "v5e", None, dict(warmup_rows=2, measure_rows=2)),
    "h100-3d7pt-4B-default": (lambda: _source("trace:stencil3d7pt",
                                              {"M": 16, "N": 64}, 4),
                              "h100", None, {}),
    "h100-3d7pt-4B-3d-lc": (lambda: _source("trace:stencil3d7pt",
                                            {"M": 16, "N": 64}, 4),
                            "h100", None, dict(warmup_rows=2 * 64 + 2)),
    "h100-longrange-4B-default": (lambda: _source("trace:longrange3d",
                                                  {"M": 24, "N": 40}, 4),
                                  "h100", None, {}),
    "h100-longrange-4B-3d-lc": (lambda: _source("trace:longrange3d",
                                                {"M": 24, "N": 40}, 4),
                                "h100", None, dict(warmup_rows=8 * 40 + 2)),
}


def _stats(res) -> dict:
    return {lvl: dataclasses.asdict(s) for lvl, s in res.per_level.items()}


def _summary(res) -> tuple:
    return (_stats(res), res.load_bytes_per_it, res.evict_bytes_per_it,
            res.first_level_load_bytes_per_it,
            res.first_level_store_bytes_per_it, res.iterations, res.backend)


@functools.lru_cache(maxsize=None)
def _simulate(case: str, backend: str) -> tuple:
    """(ours, theirs) summaries of one case on one backend."""
    kernels, mach, policy, kw = CASES[case]
    ours_k, theirs_k = kernels()
    ours_m, theirs_m = _machines(mach, policy)
    return (_summary(cachesim.simulate(ours_k, ours_m, backend=backend, **kw)),
            _summary(j_cachesim.simulate(theirs_k, theirs_m, backend=backend,
                                         **kw)))


@pytest.mark.parametrize("backend", ["scalar", "vector"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_equals_jax(case, backend):
    """Per-level hits, misses, evictions and write-backs, and the bytes
    per iteration derived from them, equal the JAX package's."""
    ours, theirs = _simulate(case, backend)
    assert ours == theirs
    assert ours[-1] == backend


@pytest.mark.parametrize("case", sorted(CASES))
def test_scalar_equals_vector(case):
    """The port's two engines count alike wherever the vector one
    applies; only the backend tag differs."""
    scalar, _ = _simulate(case, "scalar")
    vector, _ = _simulate(case, "vector")
    assert scalar[:-1] == vector[:-1]


@pytest.mark.parametrize("seed", [0, 7])
def test_rr_policy_falls_back_to_scalar_and_equals_jax(seed):
    """RR's eviction is a walk of ``random.Random(seed)``: ``auto`` takes
    the scalar engine in both packages, and the RNG use is the same, so
    the counts are equal seed by seed."""
    ours_k, theirs_k = _source("stencil_3d_long_range.c", {"M": 20, "N": 300})
    ours_m, theirs_m = _machines("ivy", "RR")
    ours = cachesim.simulate(ours_k, ours_m, warmup_rows=3, seed=seed)
    theirs = j_cachesim.simulate(theirs_k, theirs_m, warmup_rows=3,
                                 seed=seed)
    assert ours.backend == "scalar"
    assert _summary(ours) == _summary(theirs)


def test_simulator_sees_the_whole_shared_l2_on_the_h100():
    """The reference's semantics, copied: one SM simulates all 50 MiB of
    the L2 (``cores per group`` and ``cores`` ignored), so the deep
    warm-up shows the 3D layer condition (8 B per 7-point update at the
    memory level) that LC at 132 SMs does not (20 B), at the main path's
    N = 512 with the depth cut to 16 planes."""
    ours_k, _ = _source("trace:stencil3d7pt", {"M": 16, "N": 512}, 4)
    h100, _ = _machines("h100")
    lc = predict_volumes(ours_k, h100, "LC", cores=132)
    sims = {cores: predict_volumes(ours_k, h100, "SIM", cores=cores,
                                   sim_kwargs={"warmup_rows": 2 * 512 + 2})
            for cores in (1, 132)}
    assert sims[1].bytes_per_it == sims[132].bytes_per_it
    assert lc.volume("L2") == 20.0
    assert sims[1].volume("L2") == pytest.approx(8.0, abs=0.5)
    shallow = predict_volumes(ours_k, h100, "SIM")
    assert shallow.params["warmup_rows"] == 2
    assert shallow.volume("L2") > 12.0        # no 3D reuse at the default


# ----------------------------------------------------------------------
# backend resolution and option normalization
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mach, policy, write_allocate", [
    ("ivy", None, True), ("ivy122", None, True), ("v5e", None, True),
    ("h100", None, True), ("ivy", "FIFO", True), ("ivy", "RR", True),
    ("ivy", None, False)])
@pytest.mark.parametrize("backend", ["auto", "scalar", "vector", "turbo"])
def test_backend_resolution_equals_jax(mach, policy, write_allocate,
                                       backend):
    ours_m, theirs_m = _machines(mach, policy, write_allocate)
    assert cachesim.vector_unsupported_reason(ours_m) == \
        j_cachesim.vector_unsupported_reason(theirs_m)
    outcomes = []
    for mod, m in ((cachesim, ours_m), (j_cachesim, theirs_m)):
        try:
            outcomes.append(("ok", mod.resolve_backend(m, backend)))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    if mach == "h100" and backend == "auto":
        assert outcomes[0] == ("ok", "vector")


@pytest.mark.parametrize("kwargs", [
    None, {}, {"backend": "auto"}, {"warmup_rows": 2, "measure_rows": 1,
                                    "seed": 0, "backend": "vector"},
    {"backend": "scalar", "seed": 3}, {"warmup_rows": 0},
    {"warmup": 3}, {"measure_rows": 0}, {"warmup_rows": -1},
    {"backend": "turbo"}])
def test_normalize_sim_kwargs_equals_jax(kwargs):
    """Defaults filled and ``auto`` resolved alike; the same options are
    refused with the same message."""
    assert cachesim.SIM_OPTION_DEFAULTS == j_cachesim.SIM_OPTION_DEFAULTS
    assert cachesim.SIM_BACKENDS == j_cachesim.SIM_BACKENDS
    ours_m, theirs_m = _machines("ivy")
    outcomes = []
    for mod, m in ((cachesim, ours_m), (j_cachesim, theirs_m)):
        try:
            outcomes.append(("ok", mod.normalize_sim_kwargs(kwargs, m)))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("mach", ["ivy", "ivy122", "v5e", "h100"])
def test_session_keys_normalize_sim_options(mach):
    """``{}``, explicit defaults and ``backend='auto'`` are one cache
    entry, keyed as JAX keys them; LC drops sim options entirely."""
    ours_m, theirs_m = _machines(mach)
    k, _ = _source("stencil_2d5pt.c", {"M": 40, "N": 64})
    sess, jsess = AnalysisSession(ours_m), JSession(theirs_m)
    spellings = [{}, {"warmup_rows": 2, "measure_rows": 1,
                      "backend": "auto"}, None]
    assert len({sess.sim_key("SIM", kw or {}) for kw in spellings}) == 1
    for kw in spellings + [{"backend": "scalar"}, {"warmup_rows": 7}]:
        assert sess.sim_key("SIM", kw or {}) == \
            jsess.sim_key("SIM", kw or {})
        assert sess.sim_key("LC", kw or {}) == () == \
            jsess.sim_key("LC", kw or {})
    sess.volumes(k, "SIM", sim_kwargs={})
    sess.volumes(k, "SIM", sim_kwargs=spellings[1])
    assert (sess.stats.volume_misses, sess.stats.volume_hits) == (1, 1)
    sess.volumes(k, "LC", sim_kwargs={"warmup_rows": 7})
    sess.volumes(k, "LC", sim_kwargs={"warmup_rows": 9})
    assert (sess.stats.volume_misses, sess.stats.volume_hits) == (2, 2)
    with pytest.raises(ValueError, match="unknown sim_kwargs"):
        sess.volumes(k, "SIM", sim_kwargs={"warmup": 3})


# ----------------------------------------------------------------------
# models driven by SIM
# ----------------------------------------------------------------------

SIM_OPTIONS = {"default": None,
               "windows": {"warmup_rows": 3, "measure_rows": 2},
               "scalar": {"backend": "scalar"}}
MODEL_SOURCES = {
    "c-3d7pt": ("stencil_3d7pt.c", {"M": 30, "N": 50}, None),
    "c-longrange": ("stencil_3d_long_range.c", {"M": 40, "N": 120}, None),
    "trace-3d7pt-4": ("trace:stencil3d7pt", {"M": 16, "N": 64}, 4),
}


@pytest.mark.parametrize("opts", sorted(SIM_OPTIONS))
@pytest.mark.parametrize("mach", ["ivy", "ivy122", "v5e", "h100"])
@pytest.mark.parametrize("src", sorted(MODEL_SOURCES))
def test_models_driven_by_sim_equal_jax(src, mach, opts):
    """``ecm.model``, ``roofline.model`` and ``api.analyze`` (all three
    registered loop models) with ``predictor="SIM"`` give the JAX
    package's ``to_dict``; the results carry the resolved options, tag
    themselves ``SIM:<backend>`` and round-trip through ``from_dict``."""
    source, consts, eb = MODEL_SOURCES[src]
    ours_k, theirs_k = _source(source, consts, eb)
    ours_m, theirs_m = _machines(mach)
    kw = SIM_OPTIONS[opts]
    backend = (kw or {}).get("backend", "vector")
    e = ecm.model(ours_k, ours_m, predictor="SIM", sim_kwargs=kw)
    je = j_ecm.model(theirs_k, theirs_m, predictor="SIM", sim_kwargs=kw)
    assert e.to_dict() == je.to_dict()
    assert e.predictor == "SIM"
    assert e.predictor_params == {**cachesim.SIM_OPTION_DEFAULTS,
                                  **(kw or {}), "backend": backend}
    assert e.notation().endswith(f"[SIM:{backend}] [simple]")
    assert ECMResult.from_dict(e.to_dict()).to_dict() == e.to_dict()
    assert j_reports.result_from_dict(e.to_dict()).to_dict() == e.to_dict()
    for variant in ("classic", "IACA"):
        r = roofline.model(ours_k, ours_m, predictor="SIM", variant=variant,
                           sim_kwargs=kw)
        jr = j_roofline.model(theirs_k, theirs_m, predictor="SIM",
                              variant=variant, sim_kwargs=kw)
        assert r.to_dict() == jr.to_dict()
        assert RooflineResult.from_dict(r.to_dict()).to_dict() == r.to_dict()
    for model in ("ecm", "roofline", "roofline-iaca"):
        got = api.analyze(source, str(MACHINES[mach]), model,
                          predictor="SIM", constants=consts,
                          element_bytes=eb, sim_kwargs=kw)
        want = j_api.analyze(source, str(MACHINES[mach]), model,
                             predictor="SIM", constants=consts,
                             frontend_opts={"element_bytes": eb} if eb
                             else None, sim_kwargs=kw)
        assert got.to_dict() == want.to_dict()


def test_session_and_direct_sim_results_indistinguishable():
    ours_m, _ = _machines("ivy")
    k, _ = _source("stencil_3d7pt.c", {"M": 30, "N": 50})
    kw = {"warmup_rows": 3, "measure_rows": 2}
    via_session = AnalysisSession(ours_m).analyze(k, "ecm", predictor="SIM",
                                                  sim_kwargs=kw)
    direct = ecm.model(k, ours_m, predictor="SIM", sim_kwargs=kw)
    assert via_session.to_dict() == direct.to_dict()


# ----------------------------------------------------------------------
# compiled sweeps and grid_search refuse SIM
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mach", ["ivy", "h100"])
def test_sim_sweeps_stay_per_point_and_equal_jax(mach):
    """SIM has no closed form: ``auto`` sweeps it point by point (no plan
    compiled) with JAX's results, and ``compiled=True`` raises in both
    packages."""
    ours_m, theirs_m = _machines(mach)
    ours_k, theirs_k = _source("stencil_2d5pt.c", {"M": 40, "N": 60})
    kw = {"warmup_rows": 2, "measure_rows": 1}
    sess = AnalysisSession(ours_m, predictor="SIM", sim_kwargs=kw)
    jsess = JSession(theirs_m, predictor="SIM", sim_kwargs=kw)
    vals = [40, 50, 60, 70, 80]
    out = sess.sweep(ours_k, "N", vals, models=("ecm", "roofline"))
    want = jsess.sweep(theirs_k, "N", vals, models=("ecm", "roofline"))
    assert sess.stats.plan_compiles == 0
    assert {m: [r.to_dict() for r in rs] for m, rs in out.items()} == \
        {m: [r.to_dict() for r in rs] for m, rs in want.items()}
    with pytest.raises(compiled.CompileError) as ours:
        sess.sweep(ours_k, "N", vals[:3], compiled=True)
    with pytest.raises(j_compiled.CompileError) as theirs:
        jsess.sweep(theirs_k, "N", vals[:3], compiled=True)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("mach", ["ivy", "h100"])
def test_grid_search_refuses_sim_as_jax_does(mach):
    """The grid is scored through the compiled plan, so SIM raises
    ``CompileError`` rather than answering with LC."""
    ours_m, theirs_m = _machines(mach)
    ours_k, theirs_k = _source("stencil_3d_long_range.c", {"M": 130})
    with pytest.raises(compiled.CompileError) as ours:
        blocking.grid_search(ours_k, ours_m, [("N", [64, 128])],
                             predictor="SIM")
    with pytest.raises(j_compiled.CompileError) as theirs:
        j_blocking.grid_search(theirs_k, theirs_m, [("N", [64, 128])],
                               predictor="SIM")
    assert str(ours.value) == str(theirs.value)
