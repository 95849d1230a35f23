"""The flash kernel's backward (``csrc/flash_attention_bwd.cu``) against
``jax.grad`` of the JAX package's reference attention.

The CUDA kernel runs only on the card; here :func:`_emulate_backward`
writes its arithmetic out in PyTorch — the rows pass (64 q rows a CTA,
fp32 scores of the bf16 operands in the base-2 domain, LSE and D =
rowsum(P ⊙ dP) from one online sweep over the fp32 P and dP tiles), the
fused pass (64 kv rows a consumer, the q blocks that see them from the
last to the first, P and dS rounded to bf16 before their products, dK
and dV summed in that order) and dQ's fp32 shares, one per 64-row kv
block, added in ascending kv-block order — and holds it, and the plain
version ``attention_backward``, within the reference's bf16 tolerance
(2e-2 of each gradient's largest entry) of ``jax.grad`` through
``repro.kernels.ref.attention`` in float32 on the same bf16-rounded
operands.  Inputs are made with numpy from a seed.  The kernel itself is
held against ``attention_backward`` on the card by ``chip_smoke.py``'s
flash phase and ``tests/test_torch_port.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

from test_torch_flash import _emulate_wgmma  # noqa: E402

LOG2E = 1.4426950408889634
ROWS = fa.BACKWARD_ROWS
#: the reference's bf16 tolerance, of each gradient's largest entry
TOL = 2e-2
#: q and k scaled so that scores reach the hundreds, as this init's do
#: (ROADMAP, Reference caveats): the softmax is nearly one-hot
SHARP = 10.0


def _emulate_backward(q, k, v, do, causal=True, q_offset=None,
                      d_rows=None):
    """The backward kernel's arithmetic on bf16 (b, h, s, d) operands;
    returns bf16 (dq, dk, dv).  ``d_rows`` replaces the kernel's D by the
    given (b, h, sq) rows (to show what another D does)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    scale = float(np.float32(1.0 / np.sqrt(d)))
    c = float(np.float32(np.float32(scale) * np.float32(LOG2E)))
    Q, K, V, O = (t.float().reshape(b * h, -1, d) for t in (q, k, v, do))
    qpos, kpos = torch.arange(sq) + q_offset, torch.arange(skv)

    def visited(i0, j0):
        return not causal or j0 <= i0 + ROWS - 1 + q_offset

    def tile(i0, j0):
        rows, cols = slice(i0, i0 + ROWS), slice(j0, j0 + ROWS)
        s = Q[:, rows] @ K[:, cols].transpose(-1, -2)
        dp = O[:, rows] @ V[:, cols].transpose(-1, -2)
        mask = causal & (qpos[rows, None] < kpos[None, cols])
        return s, dp, mask

    lse = torch.empty(b * h, sq)
    dsum = torch.empty(b * h, sq)
    for i0 in range(0, sq, ROWS):          # (a) rows pass: a CTA per q block
        m = torch.full((b * h, ROWS), fa.NEG_INF)
        l = torch.zeros(b * h, ROWS)
        acc = torch.zeros(b * h, ROWS)
        for j0 in range(0, skv, ROWS):     # LSE and D in one sweep
            if not visited(i0, j0):
                continue
            s, dp, mask = tile(i0, j0)
            x = torch.where(mask, fa.NEG_INF, s * c)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha + (p * dp).sum(-1)
            m = mx
        lse[:, i0:i0 + ROWS] = m + torch.log2(l)
        dsum[:, i0:i0 + ROWS] = acc / l
    if d_rows is not None:
        dsum = d_rows.reshape(b * h, sq).float()
    # (b) fused pass: a consumer per 64 kv rows, q blocks from the last
    dk = torch.zeros(b * h, skv, d)
    dv = torch.zeros(b * h, skv, d)
    dss = {}                     # (q block, kv block) -> bf16 dS
    for j0 in range(0, skv, ROWS):
        for i0 in reversed(range(0, sq, ROWS)):
            if not visited(i0, j0):
                continue
            s, dp, mask = tile(i0, j0)
            p = torch.where(mask, 0.0,
                            torch.exp2(s * c - lse[:, i0:i0 + ROWS, None]))
            ds = (p * (dp - dsum[:, i0:i0 + ROWS, None])).bfloat16().float()
            dv[:, j0:j0 + ROWS] += p.bfloat16().float().transpose(-1, -2) \
                @ O[:, i0:i0 + ROWS]
            dk[:, j0:j0 + ROWS] += ds.transpose(-1, -2) @ Q[:, i0:i0 + ROWS]
            dss[i0, j0] = ds
    # dQ's shares — at head dim 128 one per 128 kv rows (a fused-pass
    # item: both its consumers' dS in one product), else one per 64 — and
    # their fp32 sums in ascending kv order
    group = 2 * ROWS if fa.tc_head_dim(d) == 128 else ROWS
    dq = torch.zeros(b * h, sq, d)
    for i0 in range(0, sq, ROWS):
        acc = None
        for g0 in range(0, skv, group):
            parts = [j0 for j0 in range(g0, g0 + group, ROWS)
                     if (i0, j0) in dss]
            if not parts:
                continue
            share = torch.cat([dss[i0, j0] for j0 in parts], -1) \
                @ torch.cat([K[:, j0:j0 + ROWS] for j0 in parts], 1)
            acc = share if acc is None else acc + share
        dq[:, i0:i0 + ROWS] = acc
    return tuple(g.reshape(t.shape).bfloat16() for g, t in
                 ((dq * scale, q), (dk * scale, k), (dv, v)))


def _operands(b, h, sq, skv, d, seed, sharp=1.0):
    """bf16 q, k, v and dO from numpy normals; q and k times ``sharp``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in
            ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d))]
    arrs[0] *= sharp
    arrs[1] *= sharp
    return [torch.from_numpy(a).bfloat16() for a in arrs]


def _jax_grads(q, k, v, do, causal=True):
    """jax.grad of sum(ref.attention(q, k, v) * dO) in float32 on the
    bf16-rounded operands (``ref.attention``'s mask puts q at
    ``skv - sq``)."""
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in
                       (q, k, v, do))
    grads = jax.grad(lambda a, b_, c: jnp.sum(
        j_ref.attention(a, b_, c, causal=causal) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    return [torch.from_numpy(np.array(g)) for g in grads]


def _within(got, want, tol=TOL) -> list[float]:
    """Each gradient's max abs error over its reference's largest entry;
    asserts each within ``tol``."""
    rel = []
    for name, g, w in zip("qkv", got, want):
        top = w.float().abs().max().item()
        rel.append((g.float() - w.float()).abs().max().item() / top)
        assert torch.isfinite(g.float()).all()
        assert rel[-1] <= tol, (f"d{name}", rel[-1])
    return rel


@pytest.mark.parametrize("sharp", [1.0, SHARP], ids=["normal", "sharp"])
@pytest.mark.parametrize("b,h,sq,skv,d,causal", [
    (2, 2, 128, 128, 32, True), (1, 2, 128, 128, 64, True),
    (1, 2, 128, 128, 96, True), (1, 2, 128, 128, 112, True),
    (1, 1, 128, 128, 128, True), (1, 2, 64, 192, 64, True),
    (1, 2, 128, 128, 64, False), (1, 2, 192, 192, 32, True),
    (1, 1, 128, 320, 64, False)],
    ids=["d32", "d64", "d96", "d112", "d128", "q_offset128", "full",
         "odd_kv_blocks", "odd_kv_blocks_full"])
def test_emulated_kernel_and_plain_match_jax_grad(b, h, sq, skv, d, causal,
                                                  sharp):
    """The kernel's arithmetic and the plain version within 2e-2 of
    jax.grad at each head dim the kernel takes (112 at 128 with zero
    columns, which change nothing here), causal at q_offset 0 and
    skv - sq > 0, and full attention, and at an odd number of 64-row kv
    blocks (the last fused-pass item's second consumer idle); at
    unit-normal scores and at scores in the hundreds."""
    q, k, v, do = _operands(b, h, sq, skv, d, seed=sq + skv + d, sharp=sharp)
    assert fa.backward_route(q, k) == "kernel"
    want = _jax_grads(q, k, v, do, causal)
    _within(_emulate_backward(q, k, v, do, causal), want)
    _within(fa.attention_backward(q, k, v, do, causal=causal), want)


def test_any_q_offset_matches_the_plain_version():
    """A causal call whose q_offset is not skv - sq (the model's padded
    kv rows): the kernel's arithmetic against the plain version, which
    takes the same mask."""
    q, k, v, do = _operands(1, 2, 128, 320, 64, seed=5)
    got = _emulate_backward(q, k, v, do, True, 70)
    _within(got, fa.attention_backward(q, k, v, do, causal=True,
                                       q_offset=70))
    # keys past every query's position get no gradient
    assert torch.count_nonzero(got[1][:, :, 70 + 128:]) == 0
    assert torch.count_nonzero(got[2][:, :, 70 + 128:]) == 0


def test_d_from_the_output_misses_the_tolerance_at_a_sharp_softmax():
    """D = rowsum(dO ⊙ O), FlashAttention's usual form, from the forward
    kernel's bf16 O (p rounded to bf16 for p·v, O stored in bf16), moves
    the gradients past 2e-2 at a sharp softmax whose keys share a large
    common component (scores in the thousands): the true dQ = scale·Σ_j
    dS_ij·k_j cancels that component exactly (Σ_j dS_ij = 0), and an
    error δ in D leaves -δ·scale·Σ_j P_ij·k_j, the component included.  D
    from the kernel's own fp32 P and dP keeps the sum at zero up to
    dS's bf16 rounding and stays within 2e-2.  (At unit-normal keys
    scaled to scores in the hundreds, and at the reduced configs' own
    init, the O-based D stands at 0.4-1.5 % of the largest gradient,
    about twice the kernel's, within the tolerance.)"""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((2, 2, 128, 32), dtype=np.float32)
                   for _ in range(4))
    q, k = 7.0 * q, 7.0 * (k + 12.0)
    q, k, v, do = (torch.from_numpy(t).bfloat16() for t in (q, k, v, do))
    want = _jax_grads(q, k, v, do)
    o = _emulate_wgmma(q, k, v, True, 64, 64)
    d_out = (do.float() * o.float()).sum(-1)
    from_o = _emulate_backward(q, k, v, do, d_rows=d_out)
    errs = [(g.float() - w).abs().max().item() / w.abs().max().item()
            for g, w in zip(from_o, want)]
    assert max(errs) > TOL, errs
    _within(_emulate_backward(q, k, v, do), want)


def test_padded_q_rows_and_the_keys_only_they_see_get_no_gradient():
    """``attention.flash`` pads q to 64 rows with zero output gradient on
    the padding: with the kernel's arithmetic in place of the plain
    version, dQ of the padding is zero, and so are dK and dV of the keys
    (positions 13..63) only the padding sees."""
    q, k, v, do = _operands(1, 2, 64, 64, 32, seed=3)
    do[:, :, 13:] = 0
    dq, dk, dv = _emulate_backward(q, k, v, do)
    for g in (dq, dk, dv):
        assert torch.count_nonzero(g[:, :, 13:]) == 0
        assert torch.count_nonzero(g[:, :, :13]) > 0


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_gqa_through_flash_with_the_kernels_arithmetic(groups, monkeypatch):
    """Causal GQA through ``models/attention.flash`` (kv heads
    ``repeat_interleave``d, q padded from 40 to 64 rows) with the
    Function's backward running the kernel's arithmetic: the gradients
    of q, k and v (kv head n // g summing its g query heads') within 2e-2
    of jax.grad through the reference with the kv heads repeated."""
    rng = np.random.default_rng(groups)
    b, s, h, d = 2, 40, 4, 32
    arrs = [rng.standard_normal(sh, dtype=np.float32) for sh in
            ((b, s, h, d), (b, s, h // groups, d), (b, s, h // groups, d),
             (b, s, h, d))]
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_()
               for a in arrs[:3])
    w = torch.from_numpy(arrs[3]).bfloat16()
    monkeypatch.setattr(fa, "attention_backward",
                        lambda q_, k_, v_, g_, causal, q_offset:
                        _emulate_backward(q_, k_, v_, g_, causal, q_offset))
    (tattn.flash(q, k, v, 0).float() * w.float()).sum().backward()

    def ref(a, b_, c):
        heads = [jnp.repeat(t, groups, axis=2).transpose(0, 2, 1, 3)
                 for t in (b_, c)]
        o = j_ref.attention(a.transpose(0, 2, 1, 3), *heads)
        return jnp.sum(o.transpose(0, 2, 1, 3) * jnp.asarray(
            w.float().numpy()))
    want = jax.grad(ref, argnums=(0, 1, 2))(
        *(jnp.asarray(t.detach().float().numpy()) for t in (q, k, v)))
    _within([t.grad for t in (q, k, v)],
            [torch.from_numpy(np.array(g)) for g in want])


@pytest.mark.parametrize("dtype,d,sq,skv,q_offset,route", [
    (torch.bfloat16, 32, 64, 64, 0, "kernel"),
    (torch.bfloat16, 64, 128, 256, 128, "kernel"),
    (torch.bfloat16, 96, 64, 64, 0, "kernel"),
    (torch.bfloat16, 112, 64, 64, 0, "kernel"),
    (torch.bfloat16, 128, 4096, 4096, 0, "kernel"),
    (torch.bfloat16, 40, 64, 64, 0, "kernel"),
    (torch.float32, 128, 64, 64, 0, "plain"),
    (torch.bfloat16, 256, 64, 64, 0, "plain"),
    (torch.bfloat16, 136, 64, 64, 0, "plain"),
    (torch.bfloat16, 100, 64, 64, 0, "plain"),
    (torch.bfloat16, 64, 96, 96, 0, "plain"),
    (torch.bfloat16, 64, 64, 128, -1, "plain")])
def test_backward_route_and_launch_limits(dtype, d, sq, skv, q_offset,
                                          route):
    """One rule, from shapes and type: bf16 at a tc_head_dim up to 128
    (40 at 64, 112 at 128), lengths multiples of 64 and q_offset >= 0 take
    the kernel; float32, head dim 256 (and 136, which runs at 256), a
    head dim off tc_head_dim, lengths off 64 and a negative q_offset take
    the plain version, with a reason."""
    lim = fa.backward_launch_limits(sq, skv, d, dtype, q_offset)
    assert lim.route == route and lim.ok == (route == "kernel")
    assert fa.BACKWARD_THREADS == (160, 384)
    assert lim.threads == 384
    q = torch.empty(1, 1, sq, d, dtype=dtype)
    k = torch.empty(1, 1, skv, d, dtype=dtype)
    assert fa.backward_route(q, k, q_offset) == route
    if route == "kernel":
        D = fa.tc_head_dim(d)
        rows_cta, fused_cta = fa.backward_smem_bytes(d)
        assert rows_cta == 1024 + 64 + 2 * D * (2 * 64 + 2 * 2 * 64)
        assert fused_cta == (1024 + 2 * D * (4 * 64 + 2 * 2 * 64)
                             + 4 * 64 * 64 * 2
                             + 4 * 64 * (64 if D == 128 else D) * 4
                             + 8 * 2 * 64 + 128)
        assert lim.smem_bytes == max(rows_cta, fused_cta) <= fa.SMEM_PER_CTA
        rows, sums, counters = fa.backward_scratch(3, sq, d, "meta")
        assert rows.shape == (2, 3 * sq) and rows.dtype == torch.float32
        assert sums.shape == (3 * sq * D,) and sums.dtype == torch.float32
        assert counters.shape == (3 * sq // 64,)
        assert counters.dtype == torch.int32
    else:
        assert lim.reason


@pytest.mark.parametrize("b,h,sq,skv,d,q_offset", [
    (1, 32, 4096, 4096, 128, 0), (1, 32, 1024, 1024, 112, 0),
    (1, 32, 1024, 1024, 96, 0), (4, 4, 64, 64, 32, 0),
    (2, 8, 256, 1024, 128, 700), (1, 2, 192, 192, 64, 0),
    (2, 2, 128, 320, 64, 192)],
    ids=["granite-8b", "zamba2-7b-d112", "phi3-d96", "10a-d32",
         "sq<skv-q_offset700", "odd-kv-192", "odd-kv-320"])
def test_backward_route_keeps_every_kernel_shape(b, h, sq, skv, d,
                                                 q_offset):
    """Every shape the kernel took before its fused redesign still takes
    it: the smoke's training shapes (granite-8b, zamba2-7b's 112 padded to
    128, phi-3's 96, the reduced configs' 32), a causal call with sq < skv
    at q_offset 700, and odd numbers of 64-row kv blocks (3 and 5)."""
    q = torch.empty(b, h, sq, d, dtype=torch.bfloat16)
    k = torch.empty(b, h, skv, d, dtype=torch.bfloat16)
    assert fa.backward_route(q, k, q_offset) == "kernel"
    assert fa.backward_launch_limits(sq, skv, d, torch.bfloat16,
                                     q_offset).ok


def test_dry_run_counts_the_kernels_scratch():
    """The dry run's memory (a Recorder over fake tensors) holds the
    kernel backward's scratch — LSE and D rows, dQ's fp32 sums and the
    counters — beside its results while the op runs; the plain route's
    op holds none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import graph_analysis as ga
    with FakeTensorMode(allow_non_fake_inputs=True):
        for dtype, extra in ((torch.bfloat16, True), (torch.float32, False)):
            q = torch.empty(1, 4, 256, 128, dtype=dtype)
            _, cap = ga.capture(
                lambda a, g: fa.backward_op(a, a, a, g, True, 0), q,
                torch.empty_like(q))
            scratch = sum(t.untyped_storage().nbytes() for t in
                          fa.backward_scratch(4, 256, 128, "meta"))
            outs = 3 * q.numel() * q.element_size()
            assert cap.argument_bytes == 2 * q.numel() * q.element_size()
            assert cap.peak_bytes == (cap.argument_bytes + outs
                                      + (scratch if extra else 0))


def test_function_backward_on_the_cpu_is_the_plain_version():
    """On the CPU the Function's backward, on the kernel's route, is
    ``attention_backward`` bit for bit, counted as one ``"plain"`` call;
    the wrapper checks ``grad_out``."""
    q, k, v, do = _operands(1, 2, 64, 64, 32, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.flash_attention.backward_calls_by_route)
    calls = fa.flash_attention.backward_calls
    out = ops.flash_attention(*leaves, causal=True, q_offset=0)
    out.backward(do)
    assert fa.flash_attention.backward_calls_by_route == {
        "kernel": before["kernel"], "plain": before["plain"] + 1}
    assert fa.flash_attention.backward_calls == calls + 1
    want = fa.attention_backward(q, k, v, do, causal=True, q_offset=0)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    got = fa.flash_attention_backward(q, k, v, do, causal=True, q_offset=0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="grad_out"):
        fa.flash_attention_backward(q, k, v, do.float())
