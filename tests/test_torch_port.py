"""Tests of the port that need no JAX: the shared-memory tile advisor, the
wrappers' operand checks, device resolution, the card timer, and — marked
``gpu`` — the CUDA kernels against their plain PyTorch versions on the
card.  Card tests skip here with a reason; run them on a machine with a
card with ``python -m pytest -m gpu tests/test_torch_*.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # container without hypothesis: deterministic shim
    from _hypothesis_fallback import given, settings, st

from repro_torch import configs, convert, device
from repro_torch.core import blocking
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import longrange3d as t_lr
from repro_torch.kernels import ops
from repro_torch.kernels import stencil3d7pt as t_s7
from repro_torch.models import common
from repro_torch.models.lm import LM
from repro_torch.serve import make_caches
from repro_torch.tune import measure, space, stencil

COEFFS = dict(W=0.1, E=0.2, N=0.3, S=0.15, F=0.25, B=0.05, s=-1.0)
CVEC = [COEFFS[c] for c in "WENSFB"] + [COEFFS["s"]]
LR_C = [0.5, 0.1, 0.05, 0.02, 0.01]
# the reference's tolerances (tests/test_kernels.py); on the card the
# kernel contracts a*b+c into FMAs where the plain version rounds twice
TOL7 = dict(rtol=2e-5, atol=1e-6)
TOL_LR = dict(rtol=2e-4, atol=1e-5)


def _grids(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def test_coefficient_maps_round_trip():
    assert convert.star7_vector(COEFFS) == tuple(CVEC)
    assert convert.star7_dict(CVEC) == COEFFS
    assert convert.longrange_vector(np.array(LR_C)) == tuple(LR_C)
    with pytest.raises(ValueError, match="7 coefficients"):
        convert.star7_vector(CVEC[:6])
    with pytest.raises(ValueError, match="miss"):
        convert.star7_vector({"W": 1.0})


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(4, 8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(4, 8, 9), ValueError),
    (torch.zeros(8, 8), ValueError),
    (torch.zeros(4, 8, 8).transpose(1, 2), ValueError),
])
def test_wrappers_reject_bad_operands(bad, err):
    """Checks are the same on every device: float32, (M, N, N),
    contiguous — a float64 grid raises instead of being converted."""
    with pytest.raises(err):
        t_s7.stencil3d7pt(bad, CVEC, tile=(8, 64, 4, 6, 8))
    with pytest.raises(err):
        t_lr.longrange3d(bad, bad, bad, LR_C, tile=(16, 32, 4, 9, 8))


@pytest.mark.parametrize("tile", [
    (8, 48, 1, 8, 4), (0, 32, 1, 8, 4), (64, 32, 1, 8, 4), (1, 16, 1, 8, 4),
    (8, 64), (8, 32, 1, 8), (8, 32, 3, 8, 4), (6, 32, 4, 8, 4),
    (8, 32, 1, 3, 4), (8, 32, 1, 15, 4), (64, 256, 8, 12, 4),
    (8, 32, 1, 8, 0)])
def test_wrappers_reject_illegal_tiles(tile):
    """Whole warps, a plan of five numbers, instantiated points per thread
    dividing bj, at most 512 threads, 1..8 planes in flight, the stages
    within 227 KiB and a chunk of at least one plane: both kernels refuse
    the rest on the CPU too, before anything launches."""
    a = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="CTA tile"):
        t_s7.stencil3d7pt(a, CVEC, tile=tile)
    with pytest.raises(ValueError, match="CTA tile"):
        t_lr.longrange3d(a, a, a, LR_C, tile=tile)


def test_longrange_tile_needs_radius_rows():
    """The long-range kernel's limits ask for bj >= 4 and stages >= 7
    (4 planes of the output's neighbourhood, the step's slack and one in
    flight)."""
    a = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="bj >= 4"):
        t_lr.longrange3d(a, a, a, LR_C, tile=(3, 32, 1, 7, 4))
    with pytest.raises(ValueError, match="7 <= stages"):
        t_lr.longrange3d(a, a, a, LR_C, tile=(4, 32, 1, 6, 4))
    t_lr.longrange3d(a, a, a, LR_C, tile=(4, 32, 1, 7, 4))


@pytest.mark.parametrize("kernel, plan", [
    (t_s7, (8, 32, 8, 4, 5)), (t_s7, (2, 64, 2, 11, 2)),
    (t_lr, (8, 32, 8, 7, 5)), (t_lr, (4, 32, 4, 14, 1)),
    (t_lr, (32, 64, 8, 8, 3))])
def test_wrappers_take_legal_plans(kernel, plan):
    """A legal plan, as a tuple or as the advisor's StencilPlan, runs the
    plain version on the CPU and gives the same answer as the ops
    wrapper."""
    (a,) = _grids((5, 12, 12), 1, seed=2)
    t = torch.from_numpy(a)
    shape = tuple(t.shape)
    sp = blocking.make_plan(kernel.RADIUS, shape, *plan, own=kernel.OWN)
    assert sp.launch == plan
    for tile in (plan, sp):
        if kernel is t_s7:
            got, want = (t_s7.stencil3d7pt(t, CVEC, tile=tile),
                         ops.stencil3d7pt(t, CVEC))
        else:
            got, want = (t_lr.longrange3d(t, t, t, LR_C, tile=tile),
                         ops.longrange3d(t, t, t, LR_C))
        assert torch.equal(got, want)


def test_cpu_path_counts_no_launch():
    """The plain version runs for CPU tensors; the launch counter counts
    kernel launches only."""
    before = t_s7.stencil3d7pt.launches, t_lr.longrange3d.launches
    a = torch.zeros(4, 10, 10)
    ops.stencil3d7pt(a, CVEC)
    ops.longrange3d(a, a, a, LR_C)
    assert (t_s7.stencil3d7pt.launches, t_lr.longrange3d.launches) == before


def test_h100_ports_table_and_sim_backend():
    """The H100 file's ``ports:`` table parses, and the cache simulator
    runs on it on the vector backend — the route ``chip_smoke.py`` phase
    4c needs on the card machine, which has no JAX."""
    from repro_torch.core import cachesim, incore, machine
    h100 = machine.load("H100")
    assert h100.ports.names == ("FP32_ADD", "FP32_MUL", "FP64", "SFU",
                                "LSU_LD", "LSU_ST")
    assert h100.ports.non_overlapping == ("LSU_LD",)
    assert sorted(h100.ports.entries) == ["ADD", "DIV", "FMA", "LOAD",
                                          "MUL", "STORE"]
    assert cachesim.resolve_backend(h100) == "vector"
    assert cachesim.normalize_sim_kwargs({}, h100)["backend"] == "vector"
    k = stencil.kernel("stencil3d7pt", (8, 32, 32))
    p = incore.analyze(k, h100, "ports")
    sp = incore.analyze(k, h100, "simple", precision="SP")
    assert (p.t_ol, p.t_nol) == (sp.t_ol, sp.t_nol) == (1.75, 7.0)
    res = cachesim.simulate(k, h100, warmup_rows=66)
    assert res.backend == "vector" and res.iterations == 30


def test_device_resolution_never_falls_back():
    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            device.resolve(None)
        with pytest.raises(RuntimeError):
            convert.to_tensor(np.zeros(3), "cuda")


def test_time_cuda_refuses_the_cpu():
    with pytest.raises(ValueError, match="times the card"):
        measure.time_cuda(lambda: None, device="cpu")


def test_make_inputs_are_seeded():
    a = stencil.make_inputs("longrange3d", (5, 9, 9), "cpu", seed=3)
    b = stencil.make_inputs("longrange3d", (5, 9, 9), "cpu", seed=3)
    assert len(a) == 4 and len(a[3]) == 5
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown stencil family"):
        stencil.family("flash_attention")


@pytest.mark.parametrize("name,grids,flops", [("stencil3d7pt", 1, 13),
                                              ("longrange3d", 3, 33)])
def test_bound_seconds(name, grids, flops):
    """Bytes: each grid read once and the output written once at the H100
    file's HBM rate; operations: the kernel's flops per interior point at
    its fp32 peak."""
    shape = (12, 20, 20)
    args = stencil.make_inputs(name, shape, "cpu")
    b = stencil.bound_seconds(name, args, "H100")
    r = stencil.family(name).module.RADIUS
    assert b.bytes == (grids + 1) * 12 * 20 * 20 * 4
    assert b.bytes_s == b.bytes / 3.35e12
    assert b.ops_s == flops * (12 - 2 * r) * (20 - 2 * r) ** 2 / 67e12
    assert b.seconds == max(b.bytes_s, b.ops_s) and b.by == "bytes"


# ----------------------------------------------------------------------
# the shared-memory tile advisor
# ----------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(radius=st.integers(0, 8), n=st.integers(1, 4096),
       own=st.sampled_from([0, 2]))
def test_cta_tile_property(radius, n, own):
    """Every plan's stages fit the per-CTA budget, and the CTAs it counts
    on an SM fit the SM's shared memory and threads; bi is a whole number
    of warps, bj >= radius, c >= 1 one of the instantiated counts dividing
    bj, 1..MAX_AHEAD planes in flight, and the stated bytes in flight."""
    t = blocking.stencil_cta_tile(radius, (16, n, n), own)
    haloed = (t.bj + 2 * radius) * (t.bi + 2 * radius)
    assert t.stage_bytes == 4 * (haloed + own * t.bj * t.bi)
    assert t.halo == radius and t.own == own
    assert t.smem_bytes == 4 * (t.stages * haloed + haloed
                                + (t.stages - radius) * own * t.bj * t.bi)
    assert 1 <= t.chunk <= 16 and t.ctas >= -(-n // t.bi) * -(-n // t.bj)
    assert t.smem_bytes <= blocking.SMEM_PER_CTA <= 227 * 1024
    assert 1 <= t.ctas_per_sm
    assert t.ctas_per_sm * (t.smem_bytes + blocking.SMEM_RESERVED) \
        <= blocking.SMEM_PER_SM
    assert t.ctas_per_sm * t.threads <= blocking.THREADS_PER_SM
    assert t.bi % 32 == 0 and t.threads <= blocking.THREADS <= 512
    assert t.c == blocking.POINTS_PER_THREAD in blocking.POINTS
    assert t.bj % t.c == 0
    assert max(1, radius) <= t.bj <= max(n, radius) + t.c - 1
    assert 1 <= t.ahead == t.stages - radius - 2 <= blocking.MAX_AHEAD
    assert t.in_flight_per_sm == t.ctas_per_sm * t.ahead * t.stage_bytes
    assert t.words_per_point >= 1.0 + own
    assert blocking.plan_limits(radius, own, *t.launch[:4]) == \
        (t.smem_bytes, t.threads)


def test_cta_tile_main_path_shapes():
    """The plans the main path launches with (float32)."""
    t7 = blocking.stencil_cta_tile(1, (512, 512, 512), t_s7.OWN)
    tl = blocking.stencil_cta_tile(4, (130, 1015, 1015), t_lr.OWN)
    assert t7.launch == (32, 64, 4, 5, 103)
    assert tl.launch == (32, 64, 4, 8, 130)
    assert (t7.ctas, t7.ctas_per_sm, tl.ctas, tl.ctas_per_sm) == \
        (640, 4, 512, 1)
    assert t7.in_flight_per_sm >= blocking.IN_FLIGHT_PER_SM
    assert tl.in_flight_per_sm >= blocking.IN_FLIGHT_PER_SM


@pytest.mark.parametrize("radius", [16, 24])
def test_advisor_raises_without_legal_tile(radius):
    """A halo so wide that its fewest stages (radius + 3) of the smallest
    haloed tile exceed the shared memory leaves no plan."""
    with pytest.raises(ValueError, match="no legal CTA tile"):
        blocking.stencil_cta_tile(radius, (40, 64, 64))
    with pytest.raises(ValueError, match="radius must be non-negative"):
        blocking.stencil_cta_tile(-radius, (40, 64, 64))


# ----------------------------------------------------------------------
# on the card: the CUDA kernels against the plain versions
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _boundary(shape, r):
    inner = np.zeros(shape, bool)
    if min(shape) > 2 * r:
        inner[r:-r, r:-r, r:-r] = True
    return ~inner


# shapes at the ring's edges: N not a multiple of 4 and below one tile,
# M <= 2r, M below the stages
EDGE_SHAPES = [(12, 5, 5), (3, 9, 9), (2, 33, 33), (8, 64, 64), (4, 40, 40),
               (12, 37, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 9, 9), (12, 37, 37), (20, 45, 45),
                                   (6, 16, 16), (5, 1, 1), (2, 33, 33),
                                   (12, 5, 5), (8, 64, 64), (4, 40, 40),
                                   (70, 33, 33)])
def test_cuda_stencil7pt_matches_plain(cuda, shape):
    (a,) = _grids(shape, 1, seed=7)
    t = convert.to_tensor(a, cuda)
    n0 = t_s7.stencil3d7pt.launches
    got = ops.stencil3d7pt(t, CVEC)
    assert t_s7.stencil3d7pt.launches == n0 + 1
    want = t_s7.plain(t, CVEC).cpu().numpy()
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, want, **TOL7)
    edge = _boundary(shape, 1)
    np.testing.assert_array_equal(got[edge], a[edge])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 9, 9), (12, 37, 37), (20, 45, 45),
                                   (9, 40, 40), (11, 2, 2), (8, 64, 64),
                                   (12, 5, 5), (2, 33, 33), (6, 40, 40),
                                   (70, 33, 33)])
def test_cuda_longrange_matches_plain(cuda, shape):
    u, v, roc = _grids(shape, 3, seed=11)
    t = [convert.to_tensor(x, cuda) for x in (u, v, roc)]
    n0 = t_lr.longrange3d.launches
    got = ops.longrange3d(*t, LR_C)
    assert t_lr.longrange3d.launches == n0 + 1
    want = t_lr.plain(*t, LR_C).cpu().numpy()
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, want, **TOL_LR)
    edge = _boundary(shape, 4)
    np.testing.assert_array_equal(got[edge], u[edge])


def _edge_plan(radius, c):
    """A two-row-of-threads tile (at least r rows) of one warp's width."""
    return max(2 * c, -(-radius // c) * c), 32, c


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [3, 1000])
@pytest.mark.parametrize("stages", range(4, 12))
@pytest.mark.parametrize("c", blocking.POINTS)
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_cuda_stencil7pt_every_plan(cuda, shape, c, stages, chunk):
    """Every points-per-thread count and every stage count the kernel
    takes, with k in chunks of 3 planes and whole, at the ring's edge
    shapes; boundaries bit-exact."""
    (a,) = _grids(shape, 1, seed=17)
    t = convert.to_tensor(a, cuda)
    got = t_s7.stencil3d7pt(t, CVEC,
                            tile=(*_edge_plan(1, c), stages, chunk))
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, t_s7.plain(t, CVEC).cpu().numpy(),
                               **TOL7)
    edge = _boundary(shape, 1)
    np.testing.assert_array_equal(got[edge], a[edge])


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [3, 1000])
@pytest.mark.parametrize("stages", range(7, 15))
@pytest.mark.parametrize("c", blocking.POINTS)
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_cuda_longrange_every_plan(cuda, shape, c, stages, chunk):
    """The same for the long-range kernel (stages 7..14)."""
    u, v, roc = _grids(shape, 3, seed=19)
    t = [convert.to_tensor(x, cuda) for x in (u, v, roc)]
    got = t_lr.longrange3d(*t, LR_C,
                           tile=(*_edge_plan(4, c), stages, chunk))
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, t_lr.plain(*t, LR_C).cpu().numpy(),
                               **TOL_LR)
    edge = _boundary(shape, 4)
    np.testing.assert_array_equal(got[edge], u[edge])


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(1, 32, 1, 4, 10), (32, 32, 8, 6, 3),
                                  (8, 256, 4, 5, 7), (16, 128, 8, 11, 1)])
def test_cuda_stencil7pt_takes_any_legal_tile(cuda, tile):
    """Results do not depend on the launch plan, from one-row tiles up to
    512-thread CTAs."""
    a = convert.to_tensor(_grids((10, 70, 70), 1, 5)[0], cuda)
    np.testing.assert_allclose(
        t_s7.stencil3d7pt(a, CVEC, tile=tile).cpu().numpy(),
        t_s7.plain(a, CVEC).cpu().numpy(), **TOL7)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(4, 32, 4, 7, 10), (32, 32, 8, 8, 3),
                                  (8, 128, 8, 8, 5), (5, 64, 1, 9, 1)])
def test_cuda_longrange_takes_any_legal_tile(cuda, tile):
    u, v, roc = (convert.to_tensor(x, cuda) for x in _grids((10, 70, 70), 3,
                                                           5))
    np.testing.assert_allclose(
        t_lr.longrange3d(u, v, roc, LR_C, tile=tile).cpu().numpy(),
        t_lr.plain(u, v, roc, LR_C).cpu().numpy(), **TOL_LR)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [t_s7, t_lr])
def test_cuda_stencil_limits_match_the_source(cuda, kernel):
    """The library's repro_<kernel>_limits and blocking.plan_limits state
    one rule: the same bytes and threads, or both refuse."""
    from repro_torch.kernels import _build
    name = kernel.__name__.rsplit(".", 1)[1]
    agreed = refused = 0
    for bj in (1, 3, 4, 8, 32, 64):
        for bi in (16, 32, 64, 96, 256, 512):
            for c in (1, 2, 3, 4, 8):
                for stages in (3, 4, 6, 7, 10, 14, 15):
                    plan = (bj, bi, c, stages)
                    try:
                        want = blocking.plan_limits(kernel.RADIUS,
                                                    kernel.OWN, *plan)
                    except ValueError:
                        with pytest.raises(RuntimeError):
                            _build.compiled_limits(name, plan)
                        refused += 1
                        continue
                    assert _build.compiled_limits(name, plan) == want
                    agreed += 1
    assert agreed and refused


@pytest.mark.gpu
def test_cuda_wrapper_refuses_device_coefficients(cuda):
    a = torch.zeros(4, 8, 8, device=cuda)
    with pytest.raises(TypeError, match="host numbers"):
        ops.stencil3d7pt(a, torch.tensor(CVEC, device=cuda))
    with pytest.raises(TypeError):
        ops.stencil3d7pt(a.double(), CVEC)


@pytest.mark.gpu
def test_cuda_timer_measures_the_kernel(cuda):
    args = stencil.make_inputs("stencil3d7pt", (64, 128, 128), cuda)
    run = measure.time_cuda(lambda: ops.stencil3d7pt(*args), iters=5,
                            reps=4)
    assert run.ok and 0 < run.wall_s < 1.0 and len(run.samples) == 4


STENCIL_TOL = {"stencil3d7pt": TOL7, "longrange3d": TOL_LR}


def _space_runs(family, device):
    """Each stencil tune space's runner at its smallest, default and
    largest block edge on ``device``: (n, repeats, output, plain output,
    the kernel's launches during the run)."""
    sp = space.resolve_space(family, "H100")
    mod = stencil.family(family).module
    wrapper = getattr(mod, family)
    vals = [c.config["n"] for c in sp.candidates()]
    for n in sorted({vals[0], sp.default().config["n"], vals[-1]}):
        run = sp.runner({"n": n}, device)
        n0 = wrapper.launches
        out = run()
        launched = wrapper.launches - n0
        want = mod.plain(*stencil.make_inputs(family, sp.shape(n), device))
        yield n, sp.repeats(n), out, want, launched


@pytest.mark.parametrize("family", ["stencil3d7pt", "longrange3d"])
def test_stencil_space_runner_on_the_cpu_is_the_plain_version(family):
    """On a CPU tensor the runner's wrapper takes the plain version and
    counts no launch; the cutout is the candidate's (m, n, n)."""
    for n, _, out, want, launched in _space_runs(family, "cpu"):
        assert launched == 0 and out.shape == (16, n, n)
        assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["stencil3d7pt", "longrange3d"])
def test_cuda_stencil_space_runner_launches_the_kernel(cuda, family):
    """On the card each stencil space's runner launches its CUDA kernel
    ``repeats(n)`` times per sample, and the output holds against the
    plain version at the reference tolerances."""
    for n, reps, out, want, launched in _space_runs(family, cuda):
        assert launched == reps, n
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   **STENCIL_TOL[family])

# ----------------------------------------------------------------------
# on the card: the flash-attention kernel against its plain version
# ----------------------------------------------------------------------

# the reference's tolerances (tests/test_kernels.py): the kernel sums its
# products in another order than the plain version's matmuls
TOL_FA = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def _qkv(shape_q, skv, dtype, device, seed=0):
    """q, k, v made with numpy from ``seed`` and rounded to ``dtype`` on
    the way in (bfloat16 rounds to nearest even)."""
    b, h, sq, d = shape_q
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in (shape_q, (b, h, skv, d), (b, h, skv, d))]
    return [convert.to_tensor(a, device, dtype) for a in arrs]


def _close(got, want, dtype):
    tol = TOL_FA[dtype]
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 112, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq, skv", [(256, 256), (128, 512)])
def test_cuda_flash_matches_plain(cuda, dtype, d, causal, sq, skv):
    q, k, v = _qkv((2, 2, sq, d), skv, dtype, cuda, seed=d + sq)
    n0 = t_fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert t_fa.flash_attention.launches == n0 + 1
    _close(got, t_fa.plain(q, k, v, causal=causal), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_shape(cuda, dtype):
    """128 queries at the end of a 4096-key prefix (q_offset 3968)."""
    q, k, v = _qkv((1, 32, 128, 128), 4096, dtype, cuda, seed=5)
    got = ops.flash_attention(q, k, v, causal=True)
    _close(got, t_fa.plain(q, k, v, causal=True), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_every_feasible_candidate(cuda, dtype):
    """Every candidate the tune space calls feasible launches and
    matches, and every infeasible one is refused before launch."""
    sp = space.resolve_space("flash_attention", "H100", batch=1, heads=2,
                             seq_q=256, seq_kv=256, head_dim=128,
                             causal=True, dtype=dtype)
    cands = sp.candidates()
    preds = sp.predict(cands)
    tdt = t_fa.torch_dtype(dtype)
    q, k, v = _qkv((1, 2, 256, 128), 256, tdt, cuda, seed=9)
    want = t_fa.plain(q, k, v, causal=True)
    n_ok, routes = 0, set()
    for c, p in zip(cands, preds):
        bq, bkv = c.config["block_q"], c.config["block_kv"]
        if p.feasible:
            route = sp.route(c)
            n0 = t_fa.flash_attention.launches_by_route[route]
            _close(t_fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv),
                   want, tdt)
            assert t_fa.flash_attention.launches_by_route[route] == n0 + 1
            n_ok += 1
            routes.add(route)
        else:
            with pytest.raises(ValueError):
                t_fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    assert n_ok >= 20
    assert routes == ({"simt", "wgmma"} if dtype == "bfloat16"
                      else {"simt", "bf16x3"})


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(100, 64), (64, 100), (2, 64),
                                    (128, 128)])
def test_cuda_flash_refuses_before_launch(cuda, blocks):
    """A block that does not divide the length, misses the granule, or
    needs more shared memory than a CTA has raises ValueError and
    launches nothing."""
    q, k, v = _qkv((1, 1, 512, 128), 512, torch.float32, cuda)
    n0 = t_fa.flash_attention.launches
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, k, v, block_q=blocks[0], block_kv=blocks[1])
    assert t_fa.flash_attention.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("fail", [None, "build", "launch"])
def test_cuda_flash_never_reaches_plain(cuda, monkeypatch, fail):
    """A CUDA tensor goes to the kernel of its route, never to the plain
    version; a wgmma build or launch that fails raises, and neither the
    CUDA-core kernel nor plain runs in its place."""
    def boom(*a, **kw):
        raise AssertionError("plain called for a CUDA tensor")
    monkeypatch.setattr(t_fa, "plain", boom)
    q, k, v = _qkv((1, 2, 128, 64), 128, torch.bfloat16, cuda)
    if fail is None:
        out = t_fa.flash_attention(q, k, v, block_q=32, block_kv=32)
        assert out.is_cuda and torch.isfinite(out.float()).all()
        return
    real = t_fa._build.entry

    def entry(name, argtypes):
        if name != "flash_attention_wgmma":
            return real(name, argtypes)
        if fail == "build":
            raise RuntimeError("nvcc failed for csrc/flash_attention_wgmma.cu")
        return lambda *args: 98     # cudaErrorInvalidDeviceFunction
    monkeypatch.setattr(t_fa._build, "entry", entry)
    n0 = dict(t_fa.flash_attention.launches_by_route)
    with pytest.raises(RuntimeError):
        t_fa.flash_attention(q, k, v, block_q=64, block_kv=64)
    assert t_fa.flash_attention.launches_by_route == n0


# the instantiated head dims and head dims padded to each: a partial
# panel (40, 72, 112, 200), a wholly padded one (136: columns 192-255),
# a box wider than the row (8)
TC_HEAD_DIMS = [8, 32, 40, 64, 72, 96, 112, 128, 136, 160, 200, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("d", TC_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq, skv", [(256, 256), (128, 512)])
def test_cuda_flash_wgmma_matches_plain(cuda, d, causal, sq, skv):
    """bf16 through ops takes the tensor-core route at every instantiated
    head_dim and every multiple of 8 padded to one, and matches the plain
    version at the reference's 2e-2."""
    q, k, v = _qkv((2, 2, sq, d), skv, torch.bfloat16, cuda, seed=d + skv)
    n0 = dict(t_fa.flash_attention.launches_by_route)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert t_fa.flash_attention.launches_by_route == {
        **n0, "wgmma": n0["wgmma"] + 1}
    _close(got, t_fa.plain(q, k, v, causal=causal), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (32, 128),
                                    (16, 64)])
def test_cuda_flash_wgmma_decode_shape(cuda, blocks):
    """128 queries at the end of 4096 keys (q_offset 3968) on the
    tensor cores: the accumulator's (row, col) map meets absolute
    positions off the main diagonal."""
    q, k, v = _qkv((1, 32, 128, 128), 4096, torch.bfloat16, cuda, seed=6)
    assert t_fa.route(*blocks, 128, torch.bfloat16) == "wgmma"
    got = t_fa.flash_attention(q, k, v, causal=True, block_q=blocks[0],
                               block_kv=blocks[1])
    _close(got, t_fa.plain(q, k, v, causal=True), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("bq", [4, 16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_wgmma_padded_q_blocks(cuda, bq, causal):
    """q blocks below 64 rows run in a zero-padded 64-row tile whose
    extra rows are never stored: a stored padding row would overwrite
    the rows of the next q block, which the comparison would catch."""
    q, k, v = _qkv((2, 2, 96, 64), 256, torch.bfloat16, cuda, seed=bq)
    assert t_fa.route(bq, 64, 64, torch.bfloat16) == "wgmma"
    got = t_fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                               block_kv=64)
    _close(got, t_fa.plain(q, k, v, causal=causal), torch.bfloat16)


@pytest.mark.gpu
def test_cuda_flash_counts_launches_per_route(cuda):
    """launches counts every launch; launches_by_route the route's; the
    bf16x3 route also launches its split pass once."""
    n0 = dict(t_fa.flash_attention.launches_by_route)
    total = t_fa.flash_attention.launches
    splits = t_fa.split_bf16x3.launches
    qb = _qkv((1, 2, 128, 64), 128, torch.bfloat16, cuda)
    qf = _qkv((1, 2, 128, 64), 128, torch.float32, cuda)
    t_fa.flash_attention(*qb, block_q=64, block_kv=64)
    t_fa.flash_attention(*qb, block_q=64, block_kv=32)
    t_fa.flash_attention(*qf, block_q=64, block_kv=64)
    t_fa.flash_attention(*qf, block_q=64, block_kv=32)
    assert t_fa.flash_attention.launches == total + 4
    assert t_fa.flash_attention.launches_by_route == {
        "wgmma": n0["wgmma"] + 1, "simt": n0["simt"] + 2,
        "bf16x3": n0["bf16x3"] + 1}
    assert t_fa.split_bf16x3.launches == splits + 1


@pytest.mark.gpu
def test_cuda_wgmma_limits_match_the_source(cuda):
    """launch_limits states what the built library reports for every
    triple of the set, at the instantiated head dims and at 112 (padded
    to 128), and the library refuses the triples off it."""
    for d in t_fa.WGMMA_HEAD_DIMS + (112,):
        for bkv in t_fa.WGMMA_BLOCK_KV:
            for bq in t_fa.WGMMA_BLOCK_Q:
                lim = t_fa.launch_limits(bq, bkv, d, torch.bfloat16)
                if lim.route != "wgmma":
                    with pytest.raises(RuntimeError):
                        t_fa.compiled_wgmma_limits(bq, bkv, d)
                    continue
                assert t_fa.compiled_wgmma_limits(bq, bkv, d) == \
                    (lim.smem_bytes, lim.threads)


# ----------------------------------------------------------------------
# on the card: float32 on the tensor cores as three bf16 passes
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("d", TC_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq, skv", [(256, 256), (128, 512)])
def test_cuda_flash_bf16x3_matches_plain(cuda, d, causal, sq, skv):
    """f32 through ops takes the bf16x3 route at every head_dim of its
    set and every multiple of 8 padded to one, and matches the plain
    version at the reference's 2e-3."""
    q, k, v = _qkv((2, 2, sq, d), skv, torch.float32, cuda, seed=d + sq)
    n0 = dict(t_fa.flash_attention.launches_by_route)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert t_fa.flash_attention.launches_by_route == {
        **n0, "bf16x3": n0["bf16x3"] + 1}
    _close(got, t_fa.plain(q, k, v, causal=causal), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(128, 64), (64, 64), (32, 64),
                                    (16, 64)])
def test_cuda_flash_bf16x3_decode_shape(cuda, blocks):
    """128 f32 queries at the end of 4096 keys (q_offset 3968) on the
    bf16x3 route, padded q blocks included."""
    q, k, v = _qkv((1, 32, 128, 128), 4096, torch.float32, cuda, seed=7)
    assert t_fa.route(*blocks, 128, torch.float32) == "bf16x3"
    got = t_fa.flash_attention(q, k, v, causal=True, block_q=blocks[0],
                               block_kv=blocks[1])
    _close(got, t_fa.plain(q, k, v, causal=True), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("bq, bkv, d", [(4, 64, 64), (32, 128, 96),
                                        (128, 128, 64), (16, 128, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16x3_blocks(cuda, bq, bkv, d, causal):
    """Padded q blocks, block_kv 128 with one warpgroup at d = 96 (the
    largest CTA of the set) and two warpgroups at d = 64."""
    q, k, v = _qkv((2, 2, 128, d), 256, torch.float32, cuda, seed=bq + d)
    assert t_fa.route(bq, bkv, d, torch.float32) == "bf16x3"
    got = t_fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                               block_kv=bkv)
    _close(got, t_fa.plain(q, k, v, causal=causal), torch.float32)


@pytest.mark.gpu
def test_cuda_split_is_the_plain_split(cuda):
    """The split kernel's hi and lo are bit-identical to plain_split's,
    for q and k/v of different sizes and values across many binades."""
    rng = np.random.default_rng(8)
    arrs = [(rng.standard_normal(s) * np.exp2(rng.integers(-20, 20, s))
             ).astype(np.float32)
            for s in ((1, 4, 96, 64), (1, 4, 320, 64), (1, 4, 320, 64))]
    q, k, v = (convert.to_tensor(a, cuda) for a in arrs)
    n0 = t_fa.split_bf16x3.launches
    got = t_fa.split_bf16x3(q, k, v)
    assert t_fa.split_bf16x3.launches == n0 + 1
    for (hi, lo), x in zip(got, (q, k, v)):
        want_hi, want_lo = t_fa.plain_split(x)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi.view(torch.int16), want_hi.view(torch.int16))
        assert torch.equal(lo.view(torch.int16), want_lo.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("fail", ["build", "launch"])
def test_cuda_flash_bf16x3_never_falls_back(cuda, monkeypatch, fail):
    """A bf16x3 build or launch that fails raises; neither the CUDA-core
    kernel nor plain runs in its place."""
    def boom(*a, **kw):
        raise AssertionError("plain called for a CUDA tensor")
    monkeypatch.setattr(t_fa, "plain", boom)
    real = t_fa._build.entry

    def entry(name, argtypes, symbol=""):
        if name != "flash_attention_bf16x3":
            return real(name, argtypes, symbol)
        if fail == "build":
            raise RuntimeError("nvcc failed for csrc/flash_attention_bf16x3"
                               ".cu")
        return lambda *args: 98     # cudaErrorInvalidDeviceFunction
    monkeypatch.setattr(t_fa._build, "entry", entry)
    q, k, v = _qkv((1, 2, 128, 64), 128, torch.float32, cuda)
    n0 = dict(t_fa.flash_attention.launches_by_route)
    with pytest.raises(RuntimeError):
        t_fa.flash_attention(q, k, v, block_q=64, block_kv=64)
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, k, v)
    assert t_fa.flash_attention.launches_by_route == n0


@pytest.mark.gpu
def test_cuda_bf16x3_limits_match_the_source(cuda):
    """launch_limits states what the built library reports for every
    triple of the set, at the instantiated head dims and at 112 (padded
    to 128), and the library refuses the triples off it."""
    for d in t_fa.WGMMA_HEAD_DIMS + (112,):
        for bkv in t_fa.WGMMA_BLOCK_KV:
            for bq in t_fa.WGMMA_BLOCK_Q:
                if (bq, bkv, t_fa.tc_head_dim(d)) not in t_fa.BF16X3_SET:
                    with pytest.raises(RuntimeError):
                        t_fa.compiled_bf16x3_limits(bq, bkv, d)
                    continue
                lim = t_fa.launch_limits(bq, bkv, d, torch.float32)
                assert t_fa.compiled_bf16x3_limits(bq, bkv, d) == \
                    (lim.smem_bytes, lim.threads)


# ----------------------------------------------------------------------
# on the card: gemma-7b's head dim 256 and zamba2-7b's 112 on the tensor
# cores
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [112, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_every_pair_at_the_real_model_head_dims(cuda, dtype, d,
                                                           causal):
    """Every pair of the dtype's tensor-core set at the head dim's
    instantiation launches on that route and matches plain: at 256 the
    instantiations added for it, at 112 the ones of 128 with zero
    columns."""
    q, k, v = _qkv((1, 2, 256, d), 512, dtype, cuda, seed=d)
    want = t_fa.plain(q, k, v, causal=causal)
    tc = "wgmma" if dtype == torch.bfloat16 else "bf16x3"
    pairs = sorted((bq, bkv) for bq, bkv, dd in t_fa.tc_set(dtype)
                   if dd == t_fa.tc_head_dim(d))
    assert pairs
    for bq, bkv in pairs:
        n0 = dict(t_fa.flash_attention.launches_by_route)
        got = t_fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_kv=bkv)
        assert t_fa.flash_attention.launches_by_route == {
            **n0, tc: n0[tc] + 1}
        _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, d, blocks", [
    (torch.float32, 256, (64, 32)), (torch.bfloat16, 112, (64, 64))])
def test_cuda_flash_forced_simt_route(cuda, dtype, d, blocks):
    """force_simt runs the CUDA-core kernel at a pair a tensor-core
    route takes (the pairs gemma-7b and zamba2-7b ran at on the CUDA
    cores before) and counts it there."""
    assert t_fa.route(*blocks, d, dtype) != "simt"
    q, k, v = _qkv((1, 2, 128, d), 256, dtype, cuda, seed=4)
    n0 = dict(t_fa.flash_attention.launches_by_route)
    got = t_fa.flash_attention(q, k, v, block_q=blocks[0],
                               block_kv=blocks[1], force_simt=True)
    assert t_fa.flash_attention.launches_by_route == {
        **n0, "simt": n0["simt"] + 1}
    _close(got, t_fa.plain(q, k, v), dtype)


# ----------------------------------------------------------------------
# the LM stack: the CPU path never launches; on the card, causal prefill
# and the forward go through the flash kernel
# ----------------------------------------------------------------------
def _reduced_granite(act_dtype):
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "granite-8b")), act_dtype=act_dtype)
    model = LM(cfg)
    params = common.materialize(model.param_recs(),
                                torch.Generator().manual_seed(0),
                                default_dtype=getattr(torch, act_dtype))
    toks = torch.randint(0, cfg.vocab, (2, 61),
                         generator=torch.Generator().manual_seed(1))
    return cfg, model, params, toks


def test_lm_on_the_cpu_counts_no_launch():
    _, model, params, toks = _reduced_granite("float32")
    before = dict(t_fa.flash_attention.launches_by_route)
    logits = model.forward(params, {"tokens": toks})
    assert logits.shape == (2, 61, 512) and torch.isfinite(logits).all()
    assert t_fa.flash_attention.launches_by_route == before


#: reduced granite-8b on the card against the CPU from the same parameters:
#: float32 logits within LM_F32_TOL (bf16x3 attention, cuBLAS without
#: TF32); bf16 by chip_smoke.py's 9a rule — no further from the float32 CPU
#: run than 1.5 times the CPU's own bf16 run, plus 0.05
LM_F32_TOL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("act_dtype", ["bfloat16", "float32"])
def test_cuda_lm_forward_and_decode_match_the_cpu(cuda, act_dtype):
    cfg, model, params, toks = _reduced_granite(act_dtype)
    route = "wgmma" if act_dtype == "bfloat16" else "bf16x3"

    def run(p, t, dev):
        out = [model.forward(p, {"tokens": t})]
        caches = make_caches(model, 2, 64, dev)
        lg, caches = model.prefill(p, {"tokens": t[:, :59]}, caches)
        out.append(lg)
        for i in (59, 60):
            lg, caches = model.decode_step(p, caches, t[:, i:i + 1], i)
            out.append(lg)
        return [x.float().cpu() for x in out]
    want = run(params, toks, "cpu")
    n0 = dict(t_fa.flash_attention.launches_by_route)
    got = run(common.tmap(lambda t: t.to(cuda), params), toks.to(cuda), cuda)
    moved = {r: n - n0[r] for r, n in
             t_fa.flash_attention.launches_by_route.items()}
    # forward and prefill: one launch per layer each
    assert moved == {**{r: 0 for r in moved}, route: 2 * cfg.n_layers}
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if act_dtype == "float32":
        assert err <= LM_F32_TOL
    else:
        model32 = LM(dataclasses.replace(cfg, act_dtype="float32"))
        ref = model32.forward(common.tmap(lambda t: t.float(), params),
                              {"tokens": toks})
        err_card = (got[0] - ref).abs().max().item()
        err_cpu = (want[0] - ref).abs().max().item()
        assert err_card <= 1.5 * err_cpu + 0.05
