"""The port's in-core subsystem — the op-stream IR, the ``ports`` port
scheduler and the registry — against the JAX package's.

The same kernels lower to the same op streams in both packages, the
vectorized scheduler agrees with the per-op reference, ``incore="ports"``
gives the JAX package's ``InCoreResult`` on the paper machines (held
against JAX's ``incore.analyze``, not only against the pinned classes), and
ECM, Roofline and sessions with ``incore="ports"`` give equal
``to_dict``.  On the H100 file the new ``ports:`` table gives the
``simple`` model's ``T_OL``/``T_nOL`` at SP for both main-path stencils.
"""
import dataclasses
import json

import pytest

pytest.importorskip("jax")

from repro.core import api as j_api  # noqa: E402
from repro.core import ecm as j_ecm  # noqa: E402
from repro.core import incore as j_incore  # noqa: E402
from repro.core import kernel_ir as j_ir  # noqa: E402
from repro.core import roofline as j_roofline  # noqa: E402
from repro.core.machine import Machine as JMachine  # noqa: E402
from repro.core.session import AnalysisSession as JSession  # noqa: E402

from repro_torch.core import api, ecm, incore  # noqa: E402
from repro_torch.core import kernel_ir, roofline  # noqa: E402
from repro_torch.core.incore import (  # noqa: E402
    INCORE_REGISTRY, InCoreResult, lower_kernel, naive_schedule,
    resolve_incore, schedule, synthetic_stream)
from repro_torch.core.machine import Machine  # noqa: E402
from repro_torch.core.session import AnalysisSession  # noqa: E402
import _torch_machines as tm  # noqa: E402

MACHINES = {"ivy": tm.IVY, "ivy122": tm.IVY122, "v5e": tm.V5E,
            "h100": tm.H100}
# (source, constants, T_OL, T_nOL) on Ivy Bridge: the machine-file classes
# JAX's TestPaperPins holds (tests/test_incore.py)
PAPER_KERNELS = {
    "longrange": ("stencil_3d_long_range.c", {"M": 130, "N": 1015}, 52.0,
                  54.0),
    "3d7pt": ("stencil_3d7pt.c", {"M": 500, "N": 1000}, 14.0, 14.0),
    "2d5pt": ("stencil_2d5pt.c", {"M": 4000, "N": 4000}, 6.0, 8.0),
}
# the main-path stencils traced at the float32 the card runs
H100_STENCILS = {"stencil3d7pt": {"M": 512, "N": 512},
                 "longrange3d": {"M": 130, "N": 1015}}
# a machine with an FMA port entry (JAX's TestFMA)
FMA_MACHINE = {
    "model name": "fma-test",
    "FLOPs per cycle": {"DP": {"ADD": 4, "MUL": 4, "FMA": 4, "total": 16}},
    "load bytes per cycle": 32, "store bytes per cycle": 16,
    "ports": {
        "names": ["P0", "P1", "P2", "P3", "P4"],
        "non-overlapping": ["P2", "P3"],
        "instructions": {
            "ADD": {"ports": ["P1"], "rate": 4, "latency": 3},
            "MUL": {"ports": ["P0"], "rate": 4, "latency": 5},
            "FMA": {"ports": ["P0", "P1"], "rate": 4, "latency": 5},
            "LOAD": {"ports": ["P2", "P3"], "bytes per cycle": 16,
                     "latency": 4},
            "STORE": {"ports": ["P4"], "bytes per cycle": 16,
                      "latency": 4}}},
}


def _machines(name):
    if name == "fma":
        return Machine.from_dict(FMA_MACHINE), JMachine.from_dict(FMA_MACHINE)
    path = MACHINES[name]
    return Machine.from_yaml(path), JMachine.from_yaml(tm.jax_side(path))


def _source(src, consts, element_bytes=None):
    opts = {"element_bytes": element_bytes} if element_bytes else {}
    return (api.load_kernel(src, consts, **opts),
            j_api._load_kernel_cached(src, None, None, consts, opts))


def _built(name, arrays, loops, reads, writes, flops, consts):
    return tuple(ir.make_stencil(name, arrays, loops, reads=reads,
                                 writes=writes, flops=ir.FlopCount(**flops),
                                 constants=consts)
                 for ir in (kernel_ir, j_ir))


# builder kernels of JAX's suite: a loop-carried chain, a scalar
# accumulator, and FMA-only and mixed bodies
BUILT = {
    "carried": lambda: _built(
        "carried", {"a": ("N",), "b": ("N",)}, [("i", 1, "N")],
        [("a", "i-1"), ("b", "i")], [("a", "i")], {"add": 1, "mul": 1},
        {"N": 4000}),
    "dot": lambda: _built(
        "dot", {"s": ("1",), "a": ("N",), "b": ("N",)}, [("i", 0, "N")],
        [("s", "0"), ("a", "i"), ("b", "i")], [("s", "0")],
        {"add": 1, "mul": 1}, {"N": 4000}),
    "fma": lambda: _built(
        "fma", {"a": ("N",), "b": ("N",)}, [("i", 0, "N")], [("a", "i")],
        [("b", "i")], {"fma": 4}, {"N": 4000}),
    "fma-mixed": lambda: _built(
        "fma-mixed", {"a": ("N",), "b": ("N",)}, [("i", 0, "N")],
        [("a", "i")], [("b", "i")], {"add": 4, "fma": 4}, {"N": 4000}),
    "div": lambda: _built(
        "div", {"a": ("N",), "b": ("N",)}, [("i", 0, "N")],
        [("a", "i"), ("a", "i+1")], [("b", "i")], {"add": 1, "div": 1},
        {"N": 4000}),
}
KERNELS = {
    **{f"c-{k}": (lambda v=v: _source(v[0], v[1]))
       for k, v in PAPER_KERNELS.items()},
    **{f"trace-{k}-4": (lambda k=k, c=c: _source(f"trace:{k}", c, 4))
       for k, c in H100_STENCILS.items()},
    **{f"built-{k}": v for k, v in BUILT.items()},
}


def _stream_fields(st) -> tuple:
    return (st.key(), st.levels.tolist(), st.counts(), st.name)


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------

def test_registry_contents_and_errors_equal_jax():
    assert sorted(INCORE_REGISTRY) == sorted(j_incore.INCORE_REGISTRY) \
        == ["ports", "simple"]
    assert resolve_incore("Simple") is INCORE_REGISTRY["simple"]
    assert resolve_incore("PORTS") is INCORE_REGISTRY["ports"]
    assert isinstance(INCORE_REGISTRY["ports"], incore.PortSchedulerModel)
    errors = []
    for mod in (incore, j_incore):
        with pytest.raises(ValueError) as e:
            mod.resolve_incore("osaca")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "ports" in errors[0] and "simple" in errors[0]


def test_ports_without_a_table_raises_as_jax_does():
    bare = {"model name": "no-ports"}
    k, jk = BUILT["carried"]()
    errors = []
    for mod, m, kern in ((incore, Machine.from_dict(bare), k),
                         (j_incore, JMachine.from_dict(bare), jk)):
        with pytest.raises(ValueError, match="no 'ports:' table") as e:
            mod.analyze(kern, m, model="ports")
        errors.append(str(e.value))
    assert errors[0].split(";")[0] == errors[1].split(";")[0]


# ----------------------------------------------------------------------
# the op-stream IR and the scheduler
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(KERNELS))
def test_lower_kernel_equals_jax(name):
    """Op kinds, widths, edges, levels and loop-carried dependences are
    the JAX package's; edges point to deeper levels; the lowering reads
    structure only (a rebound kernel lowers alike)."""
    ours_k, theirs_k = KERNELS[name]()
    ours, theirs = lower_kernel(ours_k), j_incore.lower_kernel(theirs_k)
    assert _stream_fields(ours) == _stream_fields(theirs)
    assert [dataclasses.astuple(c) for c in ours.carried] == \
        [dataclasses.astuple(c) for c in theirs.carried]
    assert (ours.levels[ours.edge_src] < ours.levels[ours.edge_dst]).all()
    assert lower_kernel(ours_k.bind(N=17)).key() == ours.key()


def test_lowering_counts_and_carried_dependences():
    """JAX's pins: the long-range listing's counts, no carried dependence
    there, distance 1 for ``a[i] = a[i-1]...`` and for a scalar
    accumulator."""
    lr = lower_kernel(KERNELS["c-longrange"]()[0])
    assert lr.counts() == {"ADD": 26, "MUL": 15, "LOAD": 27, "STORE": 1}
    assert lr.carried == ()
    for name, array in (("carried", "a"), ("dot", "s")):
        st = lower_kernel(BUILT[name]()[0])
        assert [(c.array, c.distance) for c in st.carried] == [(array, 1)]


@pytest.mark.parametrize("n_products, n_iters", [(1, 1), (4, 3), (13, 7)])
def test_synthetic_stream_equals_jax(n_products, n_iters):
    ours = synthetic_stream(n_products, n_iters=n_iters)
    theirs = j_incore.synthetic_stream(n_products, n_iters=n_iters)
    assert _stream_fields(ours) == _stream_fields(theirs)
    with pytest.raises(ValueError, match="must be >= 1"):
        synthetic_stream(0)


def _schedules(stream, table, jstream, jtable):
    return (schedule(stream, table), naive_schedule(stream, table),
            j_incore.schedule(jstream, jtable))


@pytest.mark.parametrize("mach", ["ivy", "ivy122", "v5e", "h100", "fma"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_schedule_equals_naive_and_jax(name, mach):
    """The vectorized scheduler equals the JAX package's exactly and the
    per-op reference to rounding, on every machine with a port table."""
    ours_m, theirs_m = _machines(mach)
    ours_k, theirs_k = KERNELS[name]()
    st, jst = lower_kernel(ours_k), j_incore.lower_kernel(theirs_k)
    if "DIV" in st.counts() and "DIV" not in ours_m.ports.entries:
        with pytest.raises(ValueError, match="no instruction entry.*DIV"):
            schedule(st, ours_m.ports)
        return
    fast, naive, theirs = _schedules(st, ours_m.ports, jst, theirs_m.ports)
    assert fast == theirs
    assert fast["critical_path"] == pytest.approx(naive["critical_path"])
    assert fast["occupation"] == pytest.approx(naive["occupation"])
    assert fast["kind_cycles"].keys() == naive["kind_cycles"].keys()
    assert fast["kind_cycles"] == pytest.approx(naive["kind_cycles"])


def test_synthetic_schedule_equals_naive_and_jax():
    ivy, jivy = _machines("ivy")
    st = synthetic_stream(13, n_iters=7)
    jst = j_incore.synthetic_stream(13, n_iters=7)
    fast, naive, theirs = _schedules(st, ivy.ports, jst, jivy.ports)
    assert fast == theirs
    assert fast["occupation"] == pytest.approx(naive["occupation"])
    assert fast["critical_path"] == pytest.approx(naive["critical_path"])


def test_missing_entry_is_named():
    ivy, _ = _machines("ivy")
    table = dataclasses.replace(
        ivy.ports, entries={k: v for k, v in ivy.ports.entries.items()
                            if k != "STORE"})
    with pytest.raises(ValueError, match=r"no instruction entry.*STORE"):
        schedule(lower_kernel(BUILT["carried"]()[0]), table)


# ----------------------------------------------------------------------
# InCoreResult on the paper machines
# ----------------------------------------------------------------------

@pytest.mark.parametrize("model", ["simple", "ports"])
@pytest.mark.parametrize("mach", ["ivy", "ivy122", "v5e", "fma"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_incore_result_equals_jax(name, mach, model):
    """``incore.analyze`` gives the JAX package's ``InCoreResult`` field
    for field (or the same refusal), and the result round-trips through
    JSON."""
    ours_m, theirs_m = _machines(mach)
    ours_k, theirs_k = KERNELS[name]()
    try:
        want = j_incore.analyze(theirs_k, theirs_m, model=model)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            incore.analyze(ours_k, ours_m, model=model)
        assert str(ours.value) == str(e)
        return
    got = incore.analyze(ours_k, ours_m, model=model)
    assert got.to_dict() == want.to_dict()
    assert InCoreResult.from_dict(json.loads(json.dumps(got.to_dict()))) \
        == got


@pytest.mark.parametrize("name", sorted(PAPER_KERNELS))
def test_paper_pins_against_jax(name):
    """JAX's TestPaperPins on ivybridge_ep.yaml: ``ports`` reproduces the
    machine-file classes, equals ``simple`` there, binds on throughput —
    and is the JAX package's result."""
    src, consts, t_ol, t_nol = PAPER_KERNELS[name]
    ivy, jivy = _machines("ivy")
    k, jk = _source(src, consts)
    p = incore.analyze(k, ivy, model="ports")
    s = incore.analyze(k, ivy, model="simple")
    assert (p.t_ol, p.t_nol) == (t_ol, t_nol) == (s.t_ol, s.t_nol)
    assert p.model == "ports" and s.model == "simple"
    assert p.bound == "throughput"
    assert p.to_dict() == j_incore.analyze(jk, jivy, model="ports").to_dict()
    if name == "longrange":       # 26 adds on P1, 15 muls on P0, 27 loads
        assert {q: p.port_occupation[q] for q in ("P0", "P1", "P2", "P3")} \
            == {"P0": 30.0, "P1": 52.0, "P2": 54.0, "P3": 54.0}


def test_latency_binds_on_a_carried_chain():
    """LOAD(4) -> MUL(5) -> ADD(3) -> STORE(4) = 16 cy per iteration at
    distance 1 on Ivy Bridge: the latency bound binds, and ECM does not
    undercut it."""
    ivy, _ = _machines("ivy")
    k, _ = BUILT["carried"]()
    res = incore.analyze(k, ivy, model="ports")
    assert res.critical_path == 16.0
    assert res.t_latency == 16.0 * res.unit_iterations == res.t_core
    assert res.bound == "latency"
    e = ecm.model(k, ivy, incore="ports")
    assert e.t_incore_latency == 128.0 and e.t_ecm >= e.t_incore_latency


# ----------------------------------------------------------------------
# ECM, Roofline and sessions with incore="ports"
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mach", ["ivy", "ivy122", "v5e", "h100"])
@pytest.mark.parametrize("name", [
    "c-longrange", "c-3d7pt", "trace-longrange3d-4", "trace-stencil3d7pt-4",
    "built-carried"])
def test_models_with_ports_equal_jax(name, mach):
    ours_m, theirs_m = _machines(mach)
    ours_k, theirs_k = KERNELS[name]()
    e = ecm.model(ours_k, ours_m, incore="ports")
    assert e.to_dict() == j_ecm.model(theirs_k, theirs_m,
                                      incore="ports").to_dict()
    assert e.incore_model == "ports" and e.notation().endswith("[ports]")
    for variant in ("classic", "IACA"):
        r = roofline.model(ours_k, ours_m, variant=variant, incore="ports")
        assert r.to_dict() == j_roofline.model(
            theirs_k, theirs_m, variant=variant, incore="ports").to_dict()


@pytest.mark.parametrize("compiled", [True, False])
def test_sweeps_with_ports_equal_jax(compiled):
    """The compiled plan evaluates ``ports`` once per plan and agrees with
    the per-point path and with the JAX package, latency-bound kernel
    included."""
    ivy, jivy = _machines("ivy")
    for name, vals in (("c-longrange", [400, 546, 700, 1015]),
                       ("built-carried", [2000, 4000, 6000, 8000])):
        k, jk = KERNELS[name]()
        sess = AnalysisSession(ivy)
        out = sess.sweep(k, "N", vals, models=("ecm", "roofline-iaca"),
                         incore="ports", compiled=compiled)
        want = JSession(jivy).sweep(jk, "N", vals,
                                    models=("ecm", "roofline-iaca"),
                                    incore="ports", compiled=compiled)
        assert sess.stats.incore_misses == 1
        assert sess.stats.plan_compiles == int(compiled)
        assert {m: [r.to_dict() for r in rs] for m, rs in out.items()} == \
            {m: [r.to_dict() for r in rs] for m, rs in want.items()}


def test_session_keys_incore_separately():
    ivy, _ = _machines("ivy")
    k, _ = KERNELS["c-3d7pt"]()
    sess = AnalysisSession(ivy)
    a = sess.analyze(k, "ecm")
    b = sess.analyze(k, "ecm", incore="ports")
    assert a is not b and sess.stats.incore_misses == 2
    assert sess.analyze(k, "ecm", incore="simple") is a
    assert a.notation().replace("[simple]", "[ports]") == b.notation()


# ----------------------------------------------------------------------
# machine files: the ports: tables
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mach", ["ivy", "ivy122", "v5e", "h100"])
def test_ports_table_parses_as_jax(mach):
    ours, theirs = _machines(mach)
    assert ours.ports is not None
    assert dataclasses.asdict(ours.ports) == dataclasses.asdict(theirs.ports)
    assert set(ours.ports.non_overlapping) <= set(ours.ports.names)
    assert ours.fingerprint == theirs.fingerprint


@pytest.mark.parametrize("name", sorted(H100_STENCILS))
def test_h100_ports_equals_simple_at_sp(name):
    """The H100 table reproduces the file's 'FLOPs per cycle: SP' and load
    and store classes for both main-path stencils at 4 bytes (the
    counterpart of JAX's TestPaperPins); ``simple`` keeps the DP rates
    by default for parity."""
    h100, jh100 = _machines("h100")
    k, jk = _source(f"trace:{name}", H100_STENCILS[name], 4)
    p = incore.analyze(k, h100, model="ports")
    sp = incore.analyze(k, h100, model="simple", precision="SP")
    dp = incore.analyze(k, h100, model="simple")
    assert (p.t_ol, p.t_nol) == (sp.t_ol, sp.t_nol)
    assert dp.t_ol == 2 * sp.t_ol and dp.t_nol == sp.t_nol
    assert p.t_latency == 0.0 and p.bound == "throughput"
    assert p.port_occupation["FP64"] == p.port_occupation["SFU"] == 0.0
    assert p.to_dict() == j_incore.analyze(jk, jh100, model="ports").to_dict()


def test_h100_machine_file_lints_clean_with_its_ports_table():
    """The JAX package's machine lint finds nothing in the H100 file, its
    ports table included (M203 coverage, M204 FMA)."""
    from repro.core.lint import lint_machine
    _, jh100 = _machines("h100")
    report = lint_machine(jh100, filename=str(MACHINES["h100"]))
    assert report.errors == [] and report.warnings == [], report.render()
