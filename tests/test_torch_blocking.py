"""The port's compiled sweeps, sessions and blocking analysis against the
JAX package's, bit for bit.

The same kernels — the paper's three C listings through each package's C
frontend, and the traced 7-point and long-range stencils at 8-byte and
4-byte elements — go through ``api.sweep`` (1-D over N, 2-D over M × N,
and with a cores axis) on the compiled path and the per-point symbolic
path of both packages, on the paper's Ivy Bridge and on the H100 machine
file; every result's ``to_dict`` must agree.  ``grid_search``,
``lc_block_size`` and ``blocking_sweep`` are held to the JAX copies the
same way, and the long-range listing gives the paper's L3 blocking factor
of 546 on Ivy Bridge.
"""
import dataclasses
import math
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import api as j_api  # noqa: E402
from repro.core import blocking as j_blocking  # noqa: E402
from repro.core.machine import Machine as JMachine  # noqa: E402
from repro.core.session import AnalysisSession as JSession  # noqa: E402

from repro_torch.core import api, blocking, compiled  # noqa: E402
from repro_torch.core import machine as t_machine  # noqa: E402
from repro_torch.core.session import AnalysisSession  # noqa: E402
from _torch_machines import H100, IVY, jax_side  # noqa: E402

MACHINES = {"ivy": IVY, "h100": H100}

# name -> (source, element_bytes or None, constants the sweeps keep fixed)
KERNELS = {
    "c-3d7pt": ("stencil_3d7pt.c", None, {"M": 130}),
    "c-longrange": ("stencil_3d_long_range.c", None, {"M": 130}),
    "c-2d5pt": ("stencil_2d5pt.c", None, {}),
    "trace-3d7pt-8": ("trace:stencil3d7pt", 8, {"M": 130}),
    "trace-3d7pt-4": ("trace:stencil3d7pt", 4, {"M": 130}),
    "trace-longrange-8": ("trace:longrange3d", 8, {"M": 130}),
    "trace-longrange-4": ("trace:longrange3d", 4, {"M": 130}),
}
# inner extents spanning the layer-condition regimes of both machines'
# caches (Ivy Bridge L1/L2/L3 and the H100's L1 and L2 split over SMs)
N_1D = [20, 64, 160, 400, 546, 900, 1600, 4000]
MN_2D = {"M": [40, 130], "N": [64, 400, 1015, 3000]}
CORES = {"ivy": [1, 2, 4, 10], "h100": [1, 8, 66, 132]}


def _load(name, unbind=False):
    src, eb, consts = KERNELS[name]
    consts = {} if unbind else consts
    opts = {"element_bytes": eb} if eb else {}
    ours = api.load_kernel(src, consts, **opts)
    theirs = j_api._load_kernel_cached(src, None, None, consts, opts)
    return ours, theirs


#: (param, values, models) per sweep kind; the cores kind adds the axis
SWEEPS = {
    "1d": ("N", N_1D, ("ecm", "roofline", "roofline-iaca")),
    "2d": (MN_2D, None, ("ecm", "roofline-iaca")),
    "cores": ("N", N_1D[1:6], ("ecm", "roofline-iaca")),
}


def _dicts(out):
    return {m: [r.to_dict() for r in rs] for m, rs in out.items()}


@pytest.mark.parametrize("kind", ["1d", "2d", "cores"])
@pytest.mark.parametrize("mach", sorted(MACHINES))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_sweeps_equal_jax_compiled_and_symbolic(name, mach, kind):
    """Compiled and symbolic sweeps of both packages agree result for
    result; the port's compiled sweep lowers one plan and broadcasts."""
    ours_k, theirs_k = _load(name, unbind=kind == "2d")
    path = MACHINES[mach]
    tm, jm = api.resolve_machine(path), JMachine.from_yaml(jax_side(path))
    param, values, models = SWEEPS[kind]
    cores = CORES[mach] if kind == "cores" else 1
    results = {}
    for compiled_flag in (True, False):
        sess, jsess = AnalysisSession(tm), JSession(jm)
        results[("ours", compiled_flag)] = _dicts(sess.sweep(
            ours_k, param, values, models=models, cores=cores,
            compiled=compiled_flag))
        results[("jax", compiled_flag)] = _dicts(jsess.sweep(
            theirs_k, param, values, models=models, cores=cores,
            compiled=compiled_flag))
        assert sess.stats.to_dict() == jsess.stats.to_dict()
        if compiled_flag:
            assert sess.stats.plan_compiles == 1
            assert sess.stats.plan_broadcasts > 0
    first = results[("ours", True)]
    assert all(r == first for r in results.values())


def test_api_sweep_routes_through_the_pooled_session():
    api.clear_sessions()
    out = api.sweep("stencil_3d_long_range.c", IVY, "N", N_1D,
                    constants={"M": 130})
    want = j_api.sweep("stencil_3d_long_range.c", jax_side(IVY), "N",
                       N_1D, constants={"M": 130})
    assert _dicts(out) == _dicts(want)
    sess = api.get_session(IVY)
    assert sess.stats.plan_compiles == 1
    again = api.sweep("stencil_3d_long_range.c", IVY, "N", N_1D,
                      constants={"M": 130})
    assert all(a is b for a, b in zip(out["ecm"], again["ecm"]))
    assert sess.stats.plan_compiles == 1
    with pytest.raises(compiled.CompileError, match="non-integer"):
        api.sweep("stencil_3d_long_range.c", IVY, "N", [64.5, "x"],
                  constants={"M": 130}, compiled=True)


def test_analyze_uses_the_pooled_session():
    api.clear_sessions()
    a = api.analyze("stencil_3d7pt.c", IVY, constants={"M": 130, "N": 100})
    b = api.analyze("stencil_3d7pt.c", IVY, constants={"M": 130, "N": 100})
    assert a is b
    assert api.get_session(IVY).stats.result_hits == 1
    sess = AnalysisSession(api.resolve_machine(H100))
    with pytest.raises(ValueError, match="bound to machine"):
        api.analyze("stencil_3d7pt.c", IVY, session=sess,
                    constants={"M": 130, "N": 100})


@pytest.mark.parametrize("what", ["service", "lint"])
def test_service_and_lint_switches_give_the_plain_results(what):
    """The switches ``service=`` and ``lint='warn'`` give the plain call's
    results, lint adding only its empty ``diagnostics`` key, and with
    ``workers=2`` the sequential sweep's."""
    from repro_torch.service import AnalysisService
    kwargs = ({"service": AnalysisService()} if what == "service"
              else {"lint": "warn"})
    match = {"service": "service=", "lint": "lint='warn'"}[what]
    plain = api.analyze("stencil_3d7pt.c", IVY,
                        constants={"M": 30, "N": 30}).to_dict()
    got = api.analyze("stencil_3d7pt.c", IVY, constants={"M": 30, "N": 30},
                      **kwargs).to_dict()
    assert got.pop("diagnostics", []) == [], match
    assert got == plain, f"analyze({match}...) differs from the plain call"
    seq = api.sweep("stencil_3d7pt.c", IVY, "N", [30, 40],
                    constants={"M": 30})
    pooled = api.sweep("stencil_3d7pt.c", IVY, "N", [30, 40],
                       constants={"M": 30}, workers=2, **kwargs)
    assert [r.to_dict() for r in seq["ecm"]] == [
        {k: v for k, v in r.to_dict().items() if k != "diagnostics"}
        for r in pooled["ecm"]], \
        f"sweep({match}..., workers=2) differs from the sequential sweep"


def test_hlo_roofline_is_registered_as_in_jax():
    """The port's registry holds JAX's four models, ``hlo-roofline``
    consuming HLO programs, and an unknown name draws JAX's error."""
    from repro.core import model_api as j_model_api
    from repro_torch.core import model_api
    assert model_api.resolve_model("hlo-roofline").input_kind == "hlo"
    assert sorted(model_api.MODEL_REGISTRY) == \
        sorted(j_model_api.MODEL_REGISTRY) == \
        ["ecm", "hlo-roofline", "roofline", "roofline-iaca"]
    with pytest.raises(ValueError) as ours:
        model_api.resolve_model("bogus")
    with pytest.raises(ValueError) as theirs:
        j_model_api.resolve_model("bogus")
    assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------------------------
# grid_search
# ----------------------------------------------------------------------

def _gs_pair(name, path, specs, **kw):
    ours_k, theirs_k = _load(name)
    tm, jm = api.resolve_machine(path), JMachine.from_yaml(jax_side(path))
    return (blocking.grid_search(ours_k, tm, specs, **kw),
            j_blocking.grid_search(theirs_k, jm, specs, **kw))


def _assert_gs_equal(ours, theirs):
    assert ours.best == theirs.best and ours.best_score == theirs.best_score
    assert np.array_equal(ours.scores, theirs.scores)
    assert ours.ranking == theirs.ranking
    assert ours.to_dict() == theirs.to_dict()
    if theirs.n_sat is not None:
        assert np.array_equal(ours.n_sat, theirs.n_sat)


@pytest.mark.parametrize("cores", ["scalar", "list"])
@pytest.mark.parametrize("mach", sorted(MACHINES))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_grid_search_equals_jax(name, mach, cores):
    c = 1 if cores == "scalar" else CORES[mach]
    ours, theirs = _gs_pair(name, MACHINES[mach],
                            [("N", range(16, 1201, 24))], cores=c)
    _assert_gs_equal(ours, theirs)
    if cores == "list":
        assert ours.metric == "flops_at_cores"
        assert ours.scores.shape == (len(range(16, 1201, 24)), len(c))


@pytest.mark.parametrize("metric", ["ecm", "roofline"])
def test_grid_search_2d_and_roofline_equal_jax(metric):
    k = api.load_kernel("stencil_3d_long_range.c")
    jk = j_api._load_kernel_cached("stencil_3d_long_range.c", None, None,
                                   None, None)
    specs = [("M", [20, 60, 130]), ("N", range(40, 801, 40))]
    for path in (IVY, H100):
        ours = blocking.grid_search(k, api.resolve_machine(path), specs,
                                    metric=metric)
        theirs = j_blocking.grid_search(
            jk, JMachine.from_yaml(jax_side(path)), specs, metric=metric)
        _assert_gs_equal(ours, theirs)


def test_grid_search_at_every_sm_count_is_quick():
    """The stencil space's search on the card: 132 core counts x the
    block edges, at the float32 the kernels run — equal to JAX's, and
    fast enough to run per tune."""
    vals = list(range(32, 257, 16))
    for name in ("trace-3d7pt-4", "trace-longrange-4"):
        t0 = time.perf_counter()
        ours, theirs = _gs_pair(name, H100, [("N", vals)],
                                cores=list(range(1, 133)))
        assert time.perf_counter() - t0 < 30
        _assert_gs_equal(ours, theirs)


def test_grid_search_refuses_a_calibrated_request():
    k = api.load_kernel("trace:stencil3d7pt", {"M": 16})
    mach = dataclasses.replace(t_machine.load(H100),
                               calibration={"compute": 2.0})
    with pytest.raises(ValueError, match="uncalibrated compiled"):
        blocking.grid_search(k, mach, [("N", [64, 128])], calibrated=True)
    with pytest.raises(ValueError, match="one or two"):
        blocking.grid_search(k, mach, [])
    with pytest.raises(ValueError, match="saturation"):
        blocking.grid_search(k, mach, [("N", [64])], cores=[1, 2],
                             metric="roofline")


# ----------------------------------------------------------------------
# lc_block_size and blocking_sweep
# ----------------------------------------------------------------------

@pytest.mark.parametrize("safety", [0.5, 1.0])
@pytest.mark.parametrize("mach", sorted(MACHINES))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_lc_block_size_equals_jax(name, mach, safety):
    ours_k, theirs_k = _load(name)
    path = MACHINES[mach]
    for lv in api.resolve_machine(path).levels:
        got = blocking.lc_block_size(ours_k, lv.size_bytes, safety=safety)
        want = j_blocking.lc_block_size(theirs_k, lv.size_bytes,
                                        safety=safety)
        assert got == want, lv.name


def test_longrange_listing_blocks_at_546_in_ivy_l3():
    """The paper's blocking prediction from the paper's own input:
    Listing 3, as C, on the Table 2 machine."""
    k = api.load_kernel("stencil_3d_long_range.c", {"M": 130, "N": 1015})
    l3 = api.resolve_machine(IVY).level("L3").size_bytes
    assert blocking.lc_block_size(k, l3, safety=1.0) == 545
    trans = blocking.layer_conditions.transition_points(k, l3, "N")
    assert math.ceil(trans[-1].max_value) == 546
    assert blocking.lc_block_size(k, l3, safety=0.5) < 545


@pytest.mark.parametrize("mach", sorted(MACHINES))
@pytest.mark.parametrize("grid", [None, (64, 640, 64)])
def test_blocking_sweep_equals_jax(mach, grid):
    ours_k, theirs_k = _load("c-longrange")
    path = MACHINES[mach]
    vals, out = blocking.blocking_sweep(
        ours_k, api.resolve_machine(path), models=("ecm", "roofline"),
        grid=grid)
    jvals, jout = j_blocking.blocking_sweep(
        theirs_k, JMachine.from_yaml(jax_side(path)),
        models=("ecm", "roofline"), grid=grid)
    assert vals == jvals and _dicts(out) == _dicts(jout)
