"""The port's analytic core against the JAX package's: the same point
functions trace to the same ``kernel_key``, and ECM, Roofline and
Roofline-IACA results are ``to_dict``-identical, bit for bit, on the
paper's machine at the paper's sizes.  Also the H100 machine file under
the JAX package's machine lint, and the timer helper's parity.
"""
import importlib

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import analyze as j_analyze  # noqa: E402
from repro.core import layer_conditions as j_lc  # noqa: E402
from repro.core.frontends import load_kernel as j_load  # noqa: E402
from repro.core.identity import kernel_key as j_key  # noqa: E402
from repro.core.lint import lint_machine  # noqa: E402
from repro.core.machine import Machine as JMachine  # noqa: E402
from repro.tune.measure import robust_median as j_robust_median  # noqa: E402

from repro_torch.core import api, layer_conditions, machine, trace  # noqa: E402
from repro_torch.core.identity import kernel_key  # noqa: E402
from repro_torch.kernels import longrange3d, stencil3d7pt  # noqa: E402
from repro_torch.tune.measure import robust_median  # noqa: E402

from _torch_machines import H100, IVY, jax_side  # noqa: E402

# (port module, JAX module, paper sizes): the long-range stencil at the
# §3 case-study size (Listing 4), the 7-point stencil at a 3D-LC size
CASES = {
    "longrange3d": (longrange3d, "repro.kernels.longrange3d",
                    {"M": 130, "N": 1015}),
    "stencil3d7pt": (stencil3d7pt, "repro.kernels.stencil3d7pt",
                     {"M": 300, "N": 200}),
}
MODELS = ["ecm", "roofline", "roofline-iaca"]


def _jax_point(name):
    return importlib.import_module(CASES[name][1]).point


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("element_bytes", [None, 4])
def test_traced_kernel_key_matches(name, element_bytes):
    mod, _, consts = CASES[name]
    ours = api.load_kernel(mod.point, consts, element_bytes)
    opts = {"element_bytes": element_bytes} if element_bytes else {}
    theirs = j_load(_jax_point(name), constants=consts, **opts)
    assert kernel_key(ours) == j_key(theirs)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("model", MODELS)
def test_models_bit_identical_on_ivybridge(name, model):
    mod, _, consts = CASES[name]
    ours = api.analyze(mod.point, IVY, model=model, constants=consts)
    theirs = j_analyze(_jax_point(name), jax_side(IVY), model=model,
                       constants=consts)
    assert ours.to_dict() == theirs.to_dict()


def test_listing4_notation():
    """The README's Listing-4 ECM line for the long-range stencil."""
    res = api.analyze("trace:longrange3d", IVY, constants={"M": 130,
                                                            "N": 1015})
    assert res.notation() == \
        "{ 52.0 || 54.0 | 40.0 | 24.0 | 48.8 } cy/CL [LC] [simple]"
    assert res.saturation_cores == 4


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("model", MODELS)
def test_models_bit_identical_on_h100(name, model):
    """At the float32 the kernels run, with the L2 shared by all SMs."""
    mod, _, _ = CASES[name]
    consts = {"M": 130, "N": 1015} if name == "longrange3d" else \
        {"M": 512, "N": 512}
    ours = api.analyze(mod.point, "H100", model=model, constants=consts,
                       cores=132, element_bytes=4)
    theirs = j_analyze(_jax_point(name), H100, model=model, cores=132,
                       constants=consts,
                       frontend_opts={"element_bytes": 4})
    assert ours.to_dict() == theirs.to_dict()
    if model == "ecm":            # the chip-level saturation the port uses
        assert ours.scaling_curve(132) == theirs.scaling_curve(132)
        assert ours.performance_flops(132) == theirs.performance_flops(132)


def test_transition_points_match():
    """Paper Listing 5: the long-range stencil's L3 3D->2D transition."""
    consts = {"M": 130, "N": 1015}
    ours = layer_conditions.transition_points(
        api.load_kernel(longrange3d.point, consts),
        machine.load(IVY).level("L3").size_bytes)
    theirs = j_lc.transition_points(
        j_load(_jax_point("longrange3d"), constants=consts),
        JMachine.from_yaml(jax_side(IVY)).level("L3").size_bytes)
    assert [(str(t.threshold), t.max_value, t.hits, t.misses) for t in ours] \
        == [(str(t.threshold), t.max_value, t.hits, t.misses)
            for t in theirs]


def test_h100_machine_file_lints_clean():
    """Zero M2xx errors under the JAX package's machine lint; the port
    and the JAX loader read the file alike."""
    jm = JMachine.from_yaml(H100)
    report = lint_machine(jm, filename=H100)
    assert report.errors == [], report.render()
    ours = machine.load("H100")
    assert ours.fingerprint == jm.fingerprint
    assert ours.cores_per_socket == 132 and ours.extra["SM count"] == 132
    assert ours.clock_hz == 1.98e9
    assert ours.peak_flops["FP32"] == 6.7e13


def test_unported_options_raise():
    # the jaxpr recount is JAX's; the refusal names the port's, "fx"
    with pytest.raises(ValueError, match="flops='fx'"):
        trace.trace_kernel(stencil3d7pt.point, flops="jaxpr")
    # hlo-roofline on a traced loop kernel: JAX's refusal, in its words
    with pytest.raises(TypeError, match="consumes 'hlo' sources") as ours:
        api.analyze(stencil3d7pt.point, H100, model="hlo-roofline")
    with pytest.raises(TypeError) as theirs:
        j_analyze(_jax_point("stencil3d7pt"), H100, model="hlo-roofline")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(trace.TraceError, match="JAX package"):
        api.load_kernel("trace:repro.kernels.stencil3d7pt")


def test_machine_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown machine-description"):
        machine.Machine.from_dict({"model name": "x", "sm count": 132})


def test_robust_median_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 4, 7, 20, 101):
        xs = list(rng.lognormal(size=n))
        if n > 4:
            xs[0] *= 50               # an outlier for the fences
        assert robust_median(xs) == j_robust_median(xs)
