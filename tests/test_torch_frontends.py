"""The port's frontend registry and C frontend against the JAX package's.

The paper's three C listings parse to the same ``kernel_key`` in both
packages and give the same Listing 4 ECM line and Listing 5 layer
conditions; detection, ``frontend=`` and ``name=`` behave as the JAX
registry's do for the C, builder, trace and hlo frontends (HLO sources
load to the same ``HLOProgram`` identity, or fail with JAX's error); the
port's copies of the listings are byte for byte the JAX package's.
"""
import dataclasses
import importlib
import pathlib

import pytest

pytest.importorskip("jax")

from repro.core import analyze as j_analyze  # noqa: E402
from repro.core import layer_conditions as j_lc  # noqa: E402
from repro.core.c_parser import parse_kernel as j_parse  # noqa: E402
from repro.core.frontends import FRONTEND_REGISTRY as JFRONTENDS  # noqa: E402,E501
from repro.core.frontends import detect_frontend as jdetect  # noqa: E402
from repro.core.frontends import load_kernel as j_load  # noqa: E402
from repro.core.identity import kernel_key as j_key  # noqa: E402
from repro.core.identity import source_key as j_source_key  # noqa: E402

from repro_torch.core import api, layer_conditions  # noqa: E402
from repro_torch.core.c_parser import ParseError, parse_kernel  # noqa: E402
from repro_torch.core.frontends import (FRONTEND_REGISTRY,  # noqa: E402
                                        HLOProgram, detect_frontend,
                                        load_kernel, resolve_frontend,
                                        resolve_path)
from repro_torch.core.identity import kernel_key, source_key  # noqa: E402
from repro_torch.core.kernel_ir import FlopCount, LoopKernel  # noqa: E402
from repro_torch.kernels import stencil3d7pt  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_STENCILS = REPO / "src" / "repro" / "configs" / "stencils"
PORT_STENCILS = REPO / "src" / "repro_torch" / "configs" / "stencils"
from _torch_machines import H100, IVY, jax_side  # noqa: E402
LISTINGS = sorted(p.name for p in JAX_STENCILS.glob("*.c"))
C_7PT = (PORT_STENCILS / "stencil_3d7pt.c").read_text()
SIZES = {"stencil_2d5pt.c": {"M": 300, "N": 1000},
         "stencil_3d7pt.c": {"M": 130, "N": 100},
         "stencil_3d_long_range.c": {"M": 130, "N": 1015}}


def test_listings_are_the_paper_three():
    assert LISTINGS == ["stencil_2d5pt.c", "stencil_3d7pt.c",
                        "stencil_3d_long_range.c"]


@pytest.mark.parametrize("name", LISTINGS)
def test_port_copies_are_byte_identical(name):
    assert (PORT_STENCILS / name).read_bytes() == \
        (JAX_STENCILS / name).read_bytes()


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("name", LISTINGS)
def test_kernel_key_equals_jax(name, bound):
    consts = SIZES[name] if bound else None
    ours = api.load_kernel(name, consts)
    theirs = j_load(name, constants=consts)
    assert kernel_key(ours) == j_key(theirs)
    assert ours.source_path == str(PORT_STENCILS / name)
    text = (PORT_STENCILS / name).read_text()
    assert kernel_key(parse_kernel(text, name=ours.name, constants=consts)) \
        == kernel_key(ours)


@pytest.mark.parametrize("model", ["ecm", "roofline", "roofline-iaca"])
@pytest.mark.parametrize("machine", [IVY, H100])
@pytest.mark.parametrize("name", LISTINGS)
def test_models_from_c_equal_jax(name, machine, model):
    ours = api.analyze(name, machine, model=model, constants=SIZES[name])
    theirs = j_analyze(name, jax_side(machine), model=model,
                       constants=SIZES[name])
    assert ours.to_dict() == theirs.to_dict()


def test_listing4_ecm_line_from_c():
    """Listing 4: the long-range stencil's ECM notation on the paper's
    machine, from the paper's C source, as the JAX package gives it."""
    consts = SIZES["stencil_3d_long_range.c"]
    ours = api.analyze("stencil_3d_long_range.c", IVY, constants=consts)
    theirs = j_analyze("stencil_3d_long_range.c", jax_side(IVY),
                       constants=consts)
    assert ours.notation() == theirs.notation() == \
        "{ 52.0 || 54.0 | 40.0 | 24.0 | 48.8 } cy/CL [LC] [simple]"
    assert ours.notation_cumulative() == theirs.notation_cumulative()
    traced = api.analyze("trace:longrange3d", IVY, constants=consts)
    assert traced.notation() == ours.notation()


@pytest.mark.parametrize("level", ["L1", "L2", "L3"])
def test_listing5_layer_conditions_from_c(level):
    """Listing 5: the layer-condition transitions of the long-range
    stencil per cache level, from the C source."""
    consts = SIZES["stencil_3d_long_range.c"]
    size = api.resolve_machine(IVY).level(level).size_bytes
    ours = layer_conditions.transition_points(
        api.load_kernel("stencil_3d_long_range.c", consts), size)
    theirs = j_lc.transition_points(
        j_load("stencil_3d_long_range.c", constants=consts), size)
    assert [(str(t.threshold), t.max_value, t.hits, t.misses)
            for t in ours] == [(str(t.threshold), t.max_value, t.hits,
                                t.misses) for t in theirs]


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------

def test_registry_contents_and_lookup():
    # JAX's four, and the port's graph frontend (its own programs), which
    # has no JAX counterpart
    assert set(JFRONTENDS) == {"c", "builder", "trace", "hlo"}
    assert set(FRONTEND_REGISTRY) == set(JFRONTENDS) | {"graph"}
    assert resolve_frontend("C") is FRONTEND_REGISTRY["c"]
    with pytest.raises(ValueError, match=r"unknown kernel frontend.*"
                                         r"builder.*c.*graph.*hlo.*trace"):
        resolve_frontend("fortran")
    # the JAX package's registration order, graph after hlo, and a real
    # hlo frontend
    order = list(JFRONTENDS)
    order.insert(order.index("hlo") + 1, "graph")
    assert list(FRONTEND_REGISTRY) == order
    prog = load_kernel("HloModule m", frontend="hlo")
    assert isinstance(prog, HLOProgram)
    assert prog.cache_key() == j_load("HloModule m",
                                      frontend="hlo").cache_key()


def test_detection():
    assert detect_frontend(C_7PT).name == "c"
    assert detect_frontend("stencil_3d7pt.c").name == "c"
    assert detect_frontend(pathlib.Path("x.c")).name == "c"
    assert detect_frontend(stencil3d7pt.point).name == "trace"
    assert detect_frontend("trace:stencil3d7pt").name == "trace"
    k = parse_kernel(C_7PT, constants={"M": 8, "N": 8})
    assert detect_frontend(k).name == "builder"
    assert detect_frontend({"name": "x"}).name == "builder"
    with pytest.raises(ValueError, match="no registered frontend"):
        detect_frontend(12345)
    # HLO sources detect as JAX detects them and load as JAX loads them:
    # text to the same program, a missing dump to JAX's error
    for src in ("HloModule m\nENTRY %e () -> f32[] {\n}", "dump.hlo",
                pathlib.Path("dump.hlo.gz"), "dump.txt"):
        assert detect_frontend(src).name == jdetect(src).name == "hlo"
        try:
            theirs = j_load(src).cache_key()
        except FileNotFoundError as e:
            with pytest.raises(FileNotFoundError) as ours:
                load_kernel(src)
            assert str(ours.value) == str(e)
        else:
            assert load_kernel(src).cache_key() == theirs


def test_text_path_and_bare_name_agree():
    via_text = load_kernel(C_7PT, name="3d-7pt", constants={"M": 9})
    via_path = load_kernel("configs/stencils/stencil_3d7pt.c",
                           name="3d-7pt", constants={"M": 9})
    via_bare = load_kernel("stencil_3d7pt.c", name="3d-7pt",
                           constants={"M": 9})
    via_api = api.load_kernel(PORT_STENCILS / "stencil_3d7pt.c",
                              {"M": 9}, name="3d-7pt")
    assert kernel_key(via_text) == kernel_key(via_path) \
        == kernel_key(via_bare) == kernel_key(via_api)
    assert resolve_path("stencil_3d7pt.c") == \
        PORT_STENCILS / "stencil_3d7pt.c"
    assert resolve_path("/no/such/file.c") is None
    assert load_kernel("stencil_3d7pt.c").name == "stencil_3d7pt"
    with pytest.raises(FileNotFoundError, match="nosuch.c"):
        load_kernel("nosuch.c", frontend="c")
    with pytest.raises(TypeError, match="unknown options"):
        load_kernel("stencil_3d7pt.c", element_bytes=4)


def test_c_and_trace_parity():
    """The traced point function and the paper's C listing are one
    kernel (7-point: same name given, same accesses and flops)."""
    c = api.load_kernel("stencil_3d7pt.c", {"M": 130, "N": 100},
                        name="3d-7pt")
    t = api.load_kernel(stencil3d7pt.point, {"M": 130, "N": 100})
    assert kernel_key(c)[1:] == kernel_key(t)[1:]
    assert api.analyze(c, IVY).to_dict() == api.analyze(t, IVY).to_dict()


def test_frontend_switch_and_name():
    k = api.load_kernel("trace:stencil3d7pt", {"M": 16}, 4,
                        frontend="trace", name="seven")
    assert k.name == "seven" and k.dtype_bytes == 4
    assert kernel_key(k) == j_key(j_load("trace:stencil3d7pt",
                                         frontend="trace", name="seven",
                                         constants={"M": 16},
                                         element_bytes=4))
    with pytest.raises(TypeError, match="builder frontend"):
        api.load_kernel(k, element_bytes=4)
    with pytest.raises(ValueError, match="unknown kernel frontend"):
        api.load_kernel(C_7PT, frontend="fortran")


def test_builder_frontend():
    k = parse_kernel(C_7PT, name="x")
    out = load_kernel(k, constants={"M": 8, "N": 16}, name="y")
    assert isinstance(out, LoopKernel) and out.name == "y"
    assert out.constants == {"M": 8, "N": 16} and k.constants == {}
    spec = dict(name="copy", arrays={"a": ("N",), "b": ("N",)},
                loop_spec=[("i", 0, "N")], reads=[("a", "i")],
                writes=[("b", "i")], flops=FlopCount(add=1))
    got = load_kernel(spec, constants={"N": 64})
    assert got.name == "copy" and got.constants == {"N": 64}
    assert kernel_key(got) == j_key(j_load(spec, constants={"N": 64}))
    with pytest.raises(TypeError, match="cache_key"):
        source_key(object())


# ----------------------------------------------------------------------
# the C parser's tolerated dialect
# ----------------------------------------------------------------------

DIALECT = {
    "qualifiers": """
        const double a[M][N];
        double restrict b[M][N];
        static const double s = -0.25, t = 1.0;
        for (int j = 1; j < M - 1; j++) {
          for (const unsigned int i = 1; i < N - 1; i++) {
            b[j][i] = -1.5 * a[j][i] + s * (a[j][i-1] + a[j][i+1]) - t;
          }
        }""",
    "unary-minus": """
        double a[N], b[N];
        for (int i = 0; i < N; i++) { b[i] = -2.0 * a[i] / -4.0; }""",
    "le-bound": """
        double a[N], b[N];
        for (int i = 1; i <= N - 2; i++) { b[i] = 2.0 * a[i]; }""",
    "initializers": """
        double a[N], b[N];
        const double s = 2.5e-3, t = 1.0/6.0, u = -1E+2f;
        for (int i = 0; i < N; i++) { b[i] = s * a[i]; }""",
    "flattened": """
        float a[M*N], b[M*N];
        for (int j = 1; j < M - 1; j++) {
          for (int i = 1; i < N - 1; i++) {
            b[j*N + i] += a[(j-1)*N + i] + a[(j+1)*N + i];
          }
        }""",
}


@pytest.mark.parametrize("case", sorted(DIALECT))
def test_dialect_parses_as_jax(case):
    consts = {"M": 64, "N": 32}
    ours = parse_kernel(DIALECT[case], constants=consts)
    theirs = j_parse(DIALECT[case], constants=consts)
    assert kernel_key(ours) == j_key(theirs)


def test_parse_errors():
    with pytest.raises(ParseError, match="initializer"):
        parse_kernel("double s = foo(); for (int i = 0; i < N; i++) "
                     "{ s = 1.0; }")
    assert issubclass(ParseError, ValueError)


# ----------------------------------------------------------------------
# the hlo frontend (tests/test_frontends.py::TestHLOFrontend)
# ----------------------------------------------------------------------

HLO = ("HloModule m\n\nENTRY %main (p: f32[8]) -> f32[8] {\n"
       "  %p = f32[8]{0} parameter(0)\n"
       "  ROOT %o = f32[8]{0} add(%p, %p)\n}\n")


class FakeCompiled:
    def as_text(self):
        return HLO


def test_hlo_text_and_compiled():
    prog = load_kernel(HLO, name="toy")
    assert isinstance(prog, HLOProgram) and prog.name == "toy"
    assert dataclasses.asdict(prog) == dataclasses.asdict(
        j_load(HLO, name="toy"))
    prog2 = load_kernel(FakeCompiled(), name="toy")
    assert prog2.cache_key() == prog.cache_key()
    assert source_key(prog) == j_source_key(j_load(HLO, name="toy"))
    opts = {"default_group": 4, "assume_rs_rewrite": False}
    assert load_kernel(HLO, **opts).cache_key() == \
        j_load(HLO, **opts).cache_key()


@pytest.mark.parametrize("suffix", [".hlo", ".txt", ".hlo.gz"])
def test_hlo_path(tmp_path, suffix):
    import gzip
    p = tmp_path / f"dump{suffix}"
    if suffix == ".hlo.gz":
        p.write_bytes(gzip.compress(HLO.encode()))
    else:
        p.write_text(HLO)
    for src in (str(p), p):
        prog = load_kernel(src)
        assert prog.name == "dump" and prog.text == HLO
        assert prog.cache_key() == j_load(src).cache_key()


def test_hlo_bundled_dump_by_relative_path():
    """``configs/hlo/<config>.hlo.gz`` resolves against each package's
    root, to byte-identical dumps."""
    prog = load_kernel("configs/hlo/granite-8b.hlo.gz")
    assert prog.name == "granite-8b"
    assert prog.cache_key() == j_load(
        "configs/hlo/granite-8b.hlo.gz").cache_key()


@pytest.mark.parametrize("kw, exc", [
    ({"constants": {"N": 4}}, TypeError),
    ({"element_bytes": 4}, TypeError),
], ids=["constants", "unknown-option"])
def test_hlo_options_rejected(kw, exc):
    with pytest.raises(exc) as ours:
        load_kernel(HLO, **kw)
    with pytest.raises(exc) as theirs:
        j_load(HLO, **kw)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError, match="expects HLO text"):
        load_kernel(12345, frontend="hlo")


def test_hlo_model_frontend_mismatch():
    for src, model, match in ((HLO, "ecm", "consumes LoopKernel IR"),
                              (C_7PT, "hlo-roofline",
                               "consumes 'hlo' sources")):
        kw = {} if src is HLO else {"constants": SIZES["stencil_3d7pt.c"]}
        with pytest.raises(TypeError, match=match) as ours:
            api.analyze(src, IVY, model=model, **kw)
        with pytest.raises(TypeError) as theirs:
            j_analyze(src, jax_side(IVY), model=model, **kw)
        assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------------------------
# the flop recount: flops="fx" (make_fx) against JAX's flops="jaxpr"
# ----------------------------------------------------------------------

def _counts(fc) -> tuple:
    return dataclasses.astuple(fc)


@pytest.mark.parametrize("name", ["stencil3d7pt", "longrange3d"])
def test_fx_recount_equals_jaxpr(name):
    from repro.core.frontends.trace import trace_kernel as j_trace
    from repro_torch.core.trace import trace_kernel
    ours = importlib.import_module(f"repro_torch.kernels.{name}").point
    theirs = importlib.import_module(f"repro.kernels.{name}").point
    fx = trace_kernel(ours, flops="fx").flops
    assert _counts(fx) == _counts(j_trace(theirs, flops="jaxpr").flops)
    assert fx == trace_kernel(ours, flops="dag").flops


def test_fx_recount_shared_subexpression_equals_jaxpr():
    from repro.core.frontends.trace import kernel_spec as j_spec
    from repro.core.frontends.trace import trace_kernel as j_trace
    from repro_torch.core.trace import kernel_spec, trace_kernel

    def body(a, b, s, i):
        t = a[i] * 2.0          # one mul, reused twice
        u = -t                  # a sign: counts nothing
        b[i] = (t + t) / s.c - u + 1.0 - a[i + 1]
    geometry = dict(name="shared", arrays={"a": ("N",), "b": ("N",)},
                    loops=[("i", 0, "N-1")])
    fx = trace_kernel(kernel_spec(**geometry)(body), flops="fx").flops
    assert _counts(fx) == _counts(
        j_trace(j_spec(**geometry)(body), flops="jaxpr").flops)
    assert fx == FlopCount(add=4, mul=1, div=1)
