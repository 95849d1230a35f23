"""The SSD scan (``kernels/ssd_scan.py``, ``csrc/ssd_scan.cu``).

On the CPU: :func:`ssd_backward`, the kernels' backward formulas written
out in PyTorch, against ``torch.autograd.grad`` of the plain chunk loop
in float64; the routes; the plain route bit for bit the loop the port
has always run; B and C in groups against a loop over the groups, and
the model reading each head's group.  Marked ``gpu`` (they skip here):
the kernels, forward and backward, against the plain version on the card
at mamba2-2.7b's training shape and zamba2-7b's state size (one group
and its published two), in bfloat16 and float32, with a deterministic
backward and the route counters.  No JAX here, so the
card tests run on the card machine:
``python -m pytest -q -m gpu tests/test_torch_ssd.py``.
"""
import ast
import pathlib
import types

import pytest
import torch

from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2
from repro_torch.models.common import einsum

#: float64 against float64: the twin and autograd differ only by the
#: order of their sums
TWIN_TOL = 1e-10


def _operands(b, L, h, P, N, dtype=torch.float64, seed=0, decay=1.0,
              device="cpu", G=0):
    """xh, B and C as slices of one conv output (row stride h*P + 2N, as
    ``mamba2_apply`` hands them over; with ``G`` groups h*P + 2GN and B, C
    (b, L, G, N)), positive step sizes, log-decays A*dt (``decay`` scales
    A: 40 sends many pairs below the clamp at -60), D and a non-zero
    initial state."""
    g = torch.Generator().manual_seed(seed)
    gn = max(G, 1) * N
    conv = torch.randn(b, L, h * P + 2 * gn, generator=g, dtype=torch.float64)
    dt = torch.nn.functional.softplus(
        torch.randn(b, L, h, generator=g, dtype=torch.float64)) * 0.5
    A = -(torch.rand(h, generator=g, dtype=torch.float64) * 2 + 0.5) * decay
    Dp = torch.randn(h, 1, generator=g, dtype=torch.float64)
    state = torch.randn(b, h, P, N, generator=g, dtype=torch.float64)
    conv = conv.to(device=device, dtype=dtype)
    xh = conv[..., :h * P].reshape(b, L, h, P)
    B, C = conv[..., h * P:h * P + gn], conv[..., h * P + gn:]
    if G:
        B, C = B.reshape(b, L, G, N), C.reshape(b, L, G, N)
    f = dict(device=device, dtype=torch.float64 if dtype == torch.float64
             else torch.float32)
    return [xh, B, C, dt.to(**f), (A * dt).to(**f), Dp.to(**f),
            state.to(**f)]


def _grads_of_plain(ins, Q, dy, dstate):
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    y, fin = ss.plain(*ins, Q)
    outs, grads = (y, fin), (dy, dstate)
    if dstate is None:
        outs, grads = (y,), (dy,)
    return torch.autograd.grad(outs, ins, grads)


@pytest.mark.parametrize("N, decay, final_grad", [
    (64, 1.0, True), (128, 1.0, True), (64, 40.0, True), (128, 1.0, False)])
def test_ssd_backward_matches_autograd_of_the_loop(N, decay, final_grad):
    """Three chunks, three heads, a non-zero initial state, a gradient on
    the final state (or none), strided xh, B and C, and (decay 40) pairs
    beyond the clamp: every gradient equal to autograd's in float64."""
    b, Q, h, P = 2, 8, 3, 4
    ins = _operands(b, 3 * Q, h, P, N, decay=decay)
    assert ins[0].stride(1) == h * P + 2 * N
    g = torch.Generator().manual_seed(1)
    dy = torch.randn(b, 3 * Q, h, P, generator=g, dtype=torch.float64)
    dstate = torch.randn(b, h, P, N, generator=g, dtype=torch.float64) \
        if final_grad else None
    want = _grads_of_plain(ins, Q, dy, dstate)
    got = ss.ssd_backward(*ins, dy, dstate, Q)
    for name, a, w in zip(("xh", "B", "C", "dt", "l_t", "Dp", "state"),
                          got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        err = (a - w).abs().max().item()
        assert err <= TWIN_TOL * max(1.0, w.abs().max().item()), (name, err)


def test_the_clamp_stops_gradients_beyond_sixty():
    """At decay 40 some pairs of a chunk lie below -60: the twin's
    log-decay gradient there matches autograd's, whose clamp passes no
    gradient through them."""
    Q = 8
    ins = _operands(1, 2 * Q, 2, 4, 64, decay=40.0)
    Lc = ins[4].reshape(1, 2, Q, 2).cumsum(2)
    assert (Lc[:, :, :, None] - Lc[:, :, None]).min() < -60.0
    dy = torch.ones(1, 2 * Q, 2, 4, dtype=torch.float64)
    want = _grads_of_plain(ins, Q, dy, None)[4]
    got = ss.ssd_backward(*ins, dy, None, Q)[4]
    assert torch.allclose(got, want, rtol=0, atol=TWIN_TOL)


def _loop(xh, B, C, dt, l_t, Dp, state, Q):
    """The chunk loop as ``mamba2._ssd`` ran it before the kernels, kept
    here word for word as the yardstick of the plain route."""
    wide = torch.promote_types(xh.dtype, torch.float32)
    b, L, h, P = xh.shape
    N = B.shape[-1]
    nc = L // Q
    xc = xh.reshape(b, nc, Q, h, P)
    Bc = B.reshape(b, nc, Q, N)
    Cc = C.reshape(b, nc, Q, N)
    dtc = dt.reshape(b, nc, Q, h)
    Lcum = l_t.reshape(b, nc, Q, h).cumsum(dim=2)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        xq, Bq, Cq = xc[:, c], Bc[:, c], Cc[:, c]
        dtq, Lq = dtc[:, c], Lcum[:, c]
        scores = einsum("bln,bmn->blm", Cq, Bq).to(wide)
        gamma = torch.exp(torch.clamp(
            Lq[:, :, None, :] - Lq[:, None, :, :], -60.0, 0.0))
        gamma = torch.where(mask[None, :, :, None], gamma, 0.0)
        M = scores[..., None] * gamma * dtq[:, None, :, :]
        xf = xq.to(wide)
        y_intra = einsum("blmh,bmhp->blhp", M, xf)
        y_inter = einsum("blh,bln,bhpn->blhp", torch.exp(Lq),
                         Cq.to(wide), state)
        w = dtq * torch.exp(Lq[:, -1:, :] - Lq)
        s_chunk = einsum("blh,blhp,bln->bhpn", w, xf, Bq.to(wide))
        state = state * torch.exp(Lq[:, -1])[..., None, None] + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, L, h, P)
    return y + Dp * xh.to(wide), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cpu_takes_the_plain_loop_bit_for_bit(dtype):
    ins = _operands(2, 24, 3, 4, 16, dtype=dtype)
    got = mamba2._ssd(*ins, 8)
    want = _loop(*ins, 8)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


def test_routes_follow_device_and_type():
    like = types.SimpleNamespace
    cuda = torch.device("cuda")
    assert ss.route(like(device=cuda, dtype=torch.bfloat16)) == "kernel"
    assert ss.route(like(device=cuda, dtype=torch.float32)) == "kernel"
    assert ss.route(like(device=cuda, dtype=torch.float64)) == "plain"
    assert ss.route(torch.zeros(1, dtype=torch.float32)) == "plain"
    assert ss.route(torch.zeros(1, dtype=torch.bfloat16)) == "plain"
    assert ss.route(torch.zeros(1, device="meta")) == "plain"


def test_plain_route_counts_its_forward_and_backward():
    ins = _operands(1, 16, 2, 4, 8, dtype=torch.float32)
    ins[0] = ins[0].detach().clone().requires_grad_(True)
    fwd = dict(ss.ssd_scan.launches_by_route)
    bwd = dict(ss.ssd_scan.backward_calls_by_route)
    launches = ss.ssd_scan.launches
    y, _ = mamba2._ssd(*ins, 8)
    y.sum().backward()
    assert ss.ssd_scan.launches_by_route["plain"] == fwd["plain"] + 1
    assert ss.ssd_scan.backward_calls_by_route["plain"] == bwd["plain"] + 1
    assert ss.ssd_scan.launches_by_route["kernel"] == fwd["kernel"]
    assert ss.ssd_scan.backward_calls_by_route["kernel"] == bwd["kernel"]
    assert ss.ssd_scan.launches == launches


@pytest.mark.parametrize("bad, err", [
    (dict(Q=300), ValueError), (dict(Q=7), ValueError),
    (dict(P=80), ValueError), (dict(dtype=torch.float16), TypeError),
    (dict(transposed=True), ValueError), (dict(G=3), ValueError)])
def test_kernel_checks_refuse_what_they_cannot_launch(bad, err):
    """The kernel route's checks, on shapes alone (nothing launches)."""
    b, L, h, P, N = 1, 600, 2, bad.get("P", 64), 128
    xh = torch.zeros(b, L, h, P, dtype=bad.get("dtype", torch.bfloat16))
    B = torch.zeros(b, L, N, dtype=xh.dtype)
    if "G" in bad:                      # 3 groups do not split 2 heads
        B = torch.zeros(b, L, bad["G"], N, dtype=xh.dtype)
    if bad.get("transposed"):
        B = torch.zeros(b, N, L, dtype=xh.dtype).transpose(1, 2)
    with pytest.raises(err):
        ss._check(xh, B, B, bad.get("Q", 200))


def test_a_refused_kernel_call_counts_nothing():
    """The kernel route counts in :func:`forward` and :func:`backward`
    once their launches succeed: calls that their checks refuse (on
    shapes alone, so nothing launches) leave every counter as it was."""
    def counters():
        return (ss.ssd_scan.launches, dict(ss.ssd_scan.launches_by_route),
                dict(ss.ssd_scan.backward_calls_by_route))
    before = counters()
    xh = torch.zeros(1, 14, 2, 4, dtype=torch.bfloat16)
    B = torch.zeros(1, 14, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ss.forward(xh, B, B, None, None, None, None, 4)
    with pytest.raises(ValueError):
        ss.backward(xh, B, B, None, None, None, None, None, None, None, 4)
    assert counters() == before


def _group_loop(ins, Q):
    """The scan of each group's heads with the group's B and C, one
    group at a time, the results put back in head order."""
    xh, B, C, dt, l_t, Dp, state = ins
    G = B.shape[2]
    hg = xh.shape[2] // G
    parts = [ss.plain(xh[:, :, g * hg:(g + 1) * hg], B[:, :, g], C[:, :, g],
                      dt[..., g * hg:(g + 1) * hg],
                      l_t[..., g * hg:(g + 1) * hg], Dp[g * hg:(g + 1) * hg],
                      state[:, g * hg:(g + 1) * hg], Q) for g in range(G)]
    return (torch.cat([p[0] for p in parts], dim=2),
            torch.cat([p[1] for p in parts], dim=1))


@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_groups_match_a_loop_over_groups(G, dtype):
    """B and C (b, L, G, N): each head scans with its own group's B and
    C (head h reads group h // (h_total / G)), the loop over groups to
    the rounding of a float32 sum's order (to 1e-12 in float64)."""
    ins = _operands(2, 24, 6, 4, 5, dtype=dtype, G=G)
    got = ss.plain(*ins, 8)
    want = _group_loop(ins, 8)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert (a - w).abs().max().item() <= tol * w.abs().max().item()


def test_one_group_in_four_dims_is_the_shared_b_and_c():
    ins = _operands(2, 24, 3, 4, 16)
    grouped = list(ins)
    grouped[1], grouped[2] = ins[1][:, :, None], ins[2][:, :, None]
    for a, w in zip(ss.plain(*grouped, 8), ss.plain(*ins, 8)):
        assert (a - w).abs().max().item() <= TWIN_TOL * w.abs().max().item()


@pytest.mark.parametrize("final_grad", [True, False])
def test_ssd_backward_in_groups_matches_autograd_of_the_loop(final_grad):
    """The kernels' backward formulas with B and C in two groups: each
    group's dB and dC sum its own heads' parts only."""
    b, Q, h, P, N = 2, 8, 4, 4, 6
    ins = _operands(b, 3 * Q, h, P, N, G=2)
    g = torch.Generator().manual_seed(2)
    dy = torch.randn(b, 3 * Q, h, P, generator=g, dtype=torch.float64)
    dstate = torch.randn(b, h, P, N, generator=g, dtype=torch.float64) \
        if final_grad else None
    want = _grads_of_plain(ins, Q, dy, dstate)
    got = ss.ssd_backward(*ins, dy, dstate, Q)
    for name, a, w in zip(("xh", "B", "C", "dt", "l_t", "Dp", "state"),
                          got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        err = (a - w).abs().max().item()
        assert err <= TWIN_TOL * max(1.0, w.abs().max().item()), (name, err)


def _mamba_cfg(G: int):
    s = mamba2.SSMConfig(d_state=4, headdim=4, expand=2, chunk=8,
                         conv_width=4, n_groups=G)
    return types.SimpleNamespace(d_model=8, ssm=s, norm_eps=1e-5)


def _mamba_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(r.shape, generator=g, dtype=torch.float64)
                * (0.3 if r.init != "ones" else 0.0)
                + (1.0 if r.init == "ones" else 0.0))
            for k, r in mamba2.mamba2_recs(cfg).items()}


def test_the_model_reads_each_heads_group():
    """Two groups: changing the second group's B and C columns of the
    projection changes only the second half of the heads' scan (group 0
    is no longer read for every head)."""
    cfg = _mamba_cfg(2)
    p = _mamba_params(cfg)
    x = torch.randn(1, 16, 8, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    seen = []

    def spy(xh, B, C, *rest):
        seen.append(ss.plain(xh, B, C, *rest)[0])
        return ss.plain(xh, B, C, *rest)
    real = mamba2._ssd
    mamba2._ssd = spy
    try:
        mamba2.mamba2_apply(p, x, cfg)
        q = dict(p)
        w = q["w_in_bc"].clone()        # columns: B g0, B g1, C g0, C g1
        w[:, 4:8] += 1.0
        w[:, 12:16] -= 1.0
        q["w_in_bc"] = w
        mamba2.mamba2_apply(q, x, cfg)
    finally:
        mamba2._ssd = real
    a, b = seen
    h = a.shape[2]
    assert torch.equal(a[:, :, :h // 2], b[:, :, :h // 2])
    assert not torch.allclose(a[:, :, h // 2:], b[:, :, h // 2:])


@pytest.mark.parametrize("G", [1, 2])
def test_grouped_decode_follows_the_chunked_forward(G):
    """Decoding one position at a time through the recurrence, with one
    group or two, gives the chunked forward's outputs: to 1e-6 of the
    largest, since the recurrence carries dt, its state and its products
    in float32 whatever the input's type (1e-7 seen; a head reading the
    other group's B and C is off by its whole size)."""
    cfg = _mamba_cfg(G)
    p = _mamba_params(cfg, 3)
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    full, _ = mamba2.mamba2_apply(p, x, cfg)
    shapes = mamba2.mamba2_cache_shape(cfg, 2)
    cache = {k: torch.zeros(s, dtype=torch.float64)
             for k, (s, _) in shapes.items()}
    outs = []
    for t in range(16):
        y, cache = mamba2.mamba2_apply(p, x[:, t:t + 1], cfg, cache=cache,
                                       pos=t)
        outs.append(y)
    err = (torch.cat(outs, 1) - full).abs().max().item()
    assert err <= 1e-6 * full.abs().max().item()


def test_the_kernels_module_imports_no_model():
    """``kernels/ssd_scan.py`` rests on ``obs`` and ``_build`` alone: the
    model calls the kernels, never the other way round."""
    tree = ast.parse(pathlib.Path(ss.__file__).read_text())
    names = [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names]
    assert names and not [m for m in names if "models" in m], names


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


NAMES = ("y", "final", "xh", "B", "C", "dt", "l_t", "Dp", "state")
#: the largest |kernel - plain| allowed, as a share of the plain value's
#: largest entry, per output.  Float32 operands: both sides exact fp32,
#: sums of up to Q + P·h terms taken in other orders (at most 4.5e-6 seen
#: on the card; the log-decay gradient, a difference of row and column
#: sums, 7.9e-7).  Bfloat16 operands: S = C·Bᵀ is rounded to bf16 on both
#: sides after fp32 sums in other orders, so an entry near a rounding
#: boundary rounds to the other neighbour, one bf16 ulp away, moving terms
#: of y, dt's and l_t's gradients by that much (300-336 such entries of
#: 4.2 M at mamba2-2.7b's shape; 1.8e-4 to 2.3e-3 of the largest entry
#: over five draws of the operands; with B and C in {-1, 0, 1}, S exact
#: on both sides, within 1.1e-6: chip_smoke.py's phase 3b; the float32
#: cases hold the arithmetic itself); dx, dB and dC are
#: stored in bf16, where one ulp is up to 2^-7 of the largest entry, after
#: the plain version's autograd rounded their parts to bf16 on the way (at
#: most 7.1e-3 seen): 4 ulps of the largest entry.
TOL = {torch.float32: dict(y=1e-5, final=1e-5, xh=1e-5, B=3e-5, C=3e-5,
                           dt=1e-5, l_t=1e-5, Dp=1e-5, state=1e-5),
       torch.bfloat16: dict(y=4e-3, final=1e-5, xh=3e-2, B=3e-2, C=3e-2,
                            dt=4e-3, l_t=4e-3, Dp=1e-4, state=1e-5)}
#: (b, L, h, P, N, Q[, G]): mamba2-2.7b's training cell, zamba2-7b's state
#: size at the same chunk, and shapes off the tile: the reduced configs'
#: (P 16, N 16, Q 16), a chunk of 100 (a ragged last tile), one of 37, and
#: a state of 3 x 5 (the state passing's scalar path); with B and C in G
#: groups: zamba2-7b's training cell as published (2 groups), the reduced
#: shape in two, and three groups of two heads off the tile
SHAPES = {"mamba2-2.7b": (8, 4096, 80, 64, 128, 256),
          "zamba2-7b": (2, 4096, 112, 64, 64, 256),
          "reduced": (2, 48, 4, 16, 16, 16),
          "ragged": (2, 300, 5, 64, 96, 100),
          "short": (1, 37, 3, 40, 128, 37),
          "odd": (2, 24, 3, 3, 5, 8),
          "zamba2-7b-g2": (4, 4096, 112, 64, 64, 256, 2),
          "reduced-g2": (2, 48, 4, 16, 16, 16, 2),
          "odd-g3": (2, 24, 6, 3, 5, 8, 3)}


def _run(ins, Q, dy, dstate, kernel: bool):
    """y, the final state and the gradients of every operand, through the
    kernels or the plain loop; xh, B and C are slices of one leaf, so the
    kernels read them through its row stride."""
    xh, B, C, *rest = ins
    b, L, h, P = xh.shape
    shape = B.shape
    gn = B[0, 0].numel()
    conv = torch.cat([xh.reshape(b, L, h * P), B.reshape(b, L, gn),
                      C.reshape(b, L, gn)], -1).requires_grad_()
    rest = [t.detach().clone().requires_grad_(True) for t in rest]
    fn = ss.SSDScanFn.apply if kernel else ss.plain
    y, fin = fn(conv[..., :h * P].reshape(b, L, h, P),
                conv[..., h * P:h * P + gn].reshape(shape),
                conv[..., h * P + gn:].reshape(shape), *rest, Q)
    gconv, *grads = torch.autograd.grad((y, fin), [conv, *rest],
                                        (dy, dstate))
    return [y.detach(), fin.detach(),
            gconv[..., :h * P].reshape(b, L, h, P),
            gconv[..., h * P:h * P + gn].reshape(shape),
            gconv[..., h * P + gn:].reshape(shape), *grads]


def _case(cuda, shape, dtype, seed=0):
    b, L, h, P, N, Q, *G = shape
    ins = _operands(b, L, h, P, N, dtype=dtype, seed=seed, device=cuda,
                    G=G[0] if G else 0)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(b, L, h, P, generator=g, device=cuda)
    dstate = torch.randn(b, h, P, N, generator=g, device=cuda)
    return ins, Q, dy, dstate


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_ssd_matches_plain(cuda, name, dtype):
    ins, Q, dy, dstate = _case(cuda, SHAPES[name], dtype)
    got = _run(ins, Q, dy, dstate, kernel=True)
    want = _run(ins, Q, dy, dstate, kernel=False)
    for n, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, n
        err = (a.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= TOL[dtype][n] * scale, (n, err, scale)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_ssd_backward_is_deterministic(cuda):
    ins, Q, dy, dstate = _case(cuda, SHAPES["mamba2-2.7b"], torch.bfloat16)
    first = _run(ins, Q, dy, dstate, kernel=True)
    again = _run(ins, Q, dy, dstate, kernel=True)
    for n, a, w in zip(NAMES, first, again):
        assert torch.equal(a, w), n


@pytest.mark.gpu
def test_cuda_bf16_takes_the_kernels_and_no_plain(cuda):
    ins, Q, dy, _ = _case(cuda, SHAPES["reduced"], torch.bfloat16)
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    fwd = dict(ss.ssd_scan.launches_by_route)
    bwd = dict(ss.ssd_scan.backward_calls_by_route)
    y, _ = mamba2._ssd(*ins, Q)
    y.backward(dy)
    assert ss.ssd_scan.launches_by_route == {
        "kernel": fwd["kernel"] + 1, "plain": fwd["plain"]}
    assert ss.ssd_scan.backward_calls_by_route == {
        "kernel": bwd["kernel"] + 1, "plain": bwd["plain"]}


@pytest.mark.gpu
def test_cuda_ssd_spans_record_under_a_profile(cuda):
    """The kernel route's forward and backward are the spans
    ``kernel.ssd_fwd`` (phase fwd) and ``kernel.ssd_bwd`` (bwd) while a
    profile records."""
    from repro_torch import obs
    ins, Q, dy, _ = _case(cuda, SHAPES["reduced"], torch.bfloat16)
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    obs.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        y, _ = mamba2._ssd(*ins, Q)
        y.backward(dy)
    counts = obs.counts()
    assert counts.get(("kernel.ssd_fwd", "fwd")) == 1
    assert counts.get(("kernel.ssd_bwd", "bwd")) == 1
