"""The port's flash attention against the JAX package's.

Inputs are made once with numpy from a seed and go to both packages,
rounded to bfloat16 on both sides where the case asks for it (both round
to nearest even, so the inputs are bit-identical).  The JAX kernel runs
in interpret mode, as ``tests/test_kernels.py`` runs it; the port runs
its plain PyTorch version, which its wrappers take for tensors on the
CPU.  Tolerances are the reference's own (``tests/test_kernels.py``):
2e-3 in float32, 2e-2 in bfloat16.  The CUDA kernel itself is held
against the plain version on the card in ``test_torch_port.py``.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # container without hypothesis: deterministic shim
    from _hypothesis_fallback import given, settings, st

from repro.kernels import ref as j_ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

# the package exports the function under the module's name
j_fa = importlib.import_module("repro.kernels.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


def _both(arrs, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [convert.to_tensor(a, "cpu", tdt) for a in arrs], tol)


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# the shapes of tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("b,h,sq,skv,d", [
    (2, 4, 256, 256, 64), (1, 2, 128, 512, 64),
    (1, 1, 512, 512, 128), (2, 2, 256, 256, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax(b, h, sq, skv, d, causal, dtype):
    arrs = _inputs(b, h, sq, skv, d, seed=sq + skv + d)
    jq, tq, tol = _both(arrs, dtype)
    for a, t in zip(jq, tq):            # bit-identical inputs
        np.testing.assert_array_equal(_np(a), _np(t))
    bq, bkv = t_fa.default_config(sq, skv, d)
    want = j_fa.flash_attention(*jq, causal=causal, block_q=bq,
                                block_kv=bkv)
    oracle = j_ref.attention(*jq, causal=causal)
    got = ops.flash_attention(*tq, causal=causal)
    explicit = t_fa.flash_attention(*tq, causal=causal, block_q=bq,
                                    block_kv=bkv)
    assert got.dtype == tq[0].dtype and got.shape == tq[0].shape
    for mine in (got, explicit, t_ref.attention(*tq, causal=causal)):
        np.testing.assert_allclose(_np(mine), _np(want), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(mine), _np(oracle), rtol=tol,
                                   atol=tol)


def test_flash_decode_offset_matches_jax():
    """decode: 8 queries at the end of a 512-key prefix (q_offset 504)."""
    arrs = _inputs(1, 2, 8, 512, 64, seed=3)
    jq, tq, tol = _both(arrs, "float32")
    bq, bkv = t_fa.default_config(8, 512, 64)
    assert (bq, bkv) == (8, 64)
    want = j_fa.flash_attention(*jq, causal=True, block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(_np(ops.flash_attention(*tq, causal=True)),
                               _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(t_fa.plain(*tq, causal=True, q_offset=504)),
        _np(j_ref.attention(*jq, causal=True)), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq, skv, bq, bkv", [
    (256, 256, 96, 128), (256, 256, 128, 192), (256, 256, 0, 128),
    (256, 256, 128, -1), (100, 64, 8, 64), (64, 100, 64, 64),
    (256, 256, 128, 128)])
def test_validate_blocks_raises_where_jax_raises(sq, skv, bq, bkv):
    try:
        j_fa.validate_blocks(sq, skv, bq, bkv)
        j_msg = None
    except ValueError as e:
        j_msg = str(e)
    try:
        t_fa.validate_blocks(sq, skv, bq, bkv)
        t_msg = None
    except ValueError as e:
        t_msg = str(e)
    assert t_msg == j_msg


@pytest.mark.parametrize("d", [96, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_blocks_match_jax(d, dtype):
    """Called without blocks, the port fits the JAX defaults (128, 128) to
    what launches and returns the JAX kernel's result with its defaults."""
    arrs = _inputs(1, 1, 128, 128, d, seed=d)
    jq, tq, tol = _both(arrs, dtype)
    want = j_fa.flash_attention(*jq)
    got = t_fa.flash_attention(*tq)
    assert got.dtype == tq[0].dtype and got.shape == tq[0].shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq, skv", [(100, 128), (128, 192)])
def test_default_blocks_raise_where_jax_raises(sq, skv):
    """Where 128 does not divide a length the JAX defaults raise, and the
    port raises with the same message."""
    jq = [jnp.zeros(s, jnp.float32) for s in ((1, 1, sq, 32),
                                              (1, 1, skv, 32),
                                              (1, 1, skv, 32))]
    tq = [torch.zeros(s) for s in ((1, 1, sq, 32), (1, 1, skv, 32),
                                   (1, 1, skv, 32))]
    with pytest.raises(ValueError) as j_err:
        j_fa.flash_attention(*jq)
    with pytest.raises(ValueError) as t_err:
        t_fa.flash_attention(*tq)
    assert str(t_err.value) == str(j_err.value)


def test_causal_negative_offset_raises():
    """Rows that see no key have no agreed answer in the JAX package
    (ROADMAP Queue 3): the kernel path and the plain version refuse."""
    tq = [torch.zeros(1, 1, 16, 8) for _ in range(3)]
    short = [tq[0], torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8, 8)]
    for call in (
            lambda: t_fa.flash_attention(*tq, block_q=8, block_kv=8,
                                         q_offset=-1),
            lambda: t_fa.flash_attention(*short, block_q=8, block_kv=8),
            lambda: t_fa.plain(*short, causal=True),
            lambda: ops.flash_attention(*short)):
        with pytest.raises(ValueError, match="ROADMAP Queue 3"):
            call()
    # without the mask, the offset is unused and the call is fine
    out = t_fa.flash_attention(*short, causal=False, block_q=8, block_kv=8)
    assert out.shape == (1, 1, 16, 8)


@pytest.mark.parametrize("blocks, match", [
    ((6, 8), "multiples of 4"), ((128, 128), "shared memory"),
    ((100, 64), "does not divide")])
def test_launch_limits_checked_on_the_cpu_too(blocks, match):
    """A call the card would refuse is refused on the CPU as well."""
    tq = [torch.zeros(1, 1, 384, 128) for _ in range(3)]
    if blocks == (128, 128):
        tq = [torch.zeros(1, 1, 256, 128) for _ in range(3)]
    with pytest.raises(ValueError, match=match):
        t_fa.flash_attention(*tq, block_q=blocks[0], block_kv=blocks[1])


def test_operand_checks():
    q = torch.zeros(1, 1, 16, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_fa.flash_attention(q.double(), q.double(), q.double(),
                             block_q=8, block_kv=8)
    with pytest.raises(ValueError, match="share dtype"):
        t_fa.flash_attention(q, q.bfloat16(), q, block_q=8, block_kv=8)
    with pytest.raises(ValueError, match=r"\(b, h, skv, d\)"):
        t_fa.flash_attention(q, torch.zeros(1, 1, 16, 4), q, block_q=8,
                             block_kv=8)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 1, 8, 16).transpose(2, 3)
        t_fa.flash_attention(t, t, t, block_q=8, block_kv=8)


def test_cpu_path_counts_no_launch():
    n0 = t_fa.flash_attention.launches
    tq = [torch.zeros(1, 2, 32, 16) for _ in range(3)]
    ops.flash_attention(*tq)
    assert t_fa.flash_attention.launches == n0


def test_launch_limits_shared_memory():
    """Per route.  wgmma (csrc/flash_attention_wgmma.cu): the bf16 q tiles
    (64 rows per warpgroup), two stages of bf16 k and v tiles, 1024 bytes
    of alignment slack and 64 of mbarriers; 128 threads per warpgroup and
    a producer warp.  bf16x3 (csrc/flash_attention_bf16x3.cu): the same
    layout with a hi and a lo tile for each.  simt
    (csrc/flash_attention.cu), 256 threads: at a triple of the tiled set,
    the fp32 q tile and two stages of fp32 k and v tiles in rows of d + 4
    floats, each of the 8 warps' P rows (its q rows by its kv slice,
    padded to a stride of c mod 2c floats for its c lanes along S's
    columns) and alpha, and a bf16 staging tile; elsewhere (the general
    kernel) q and k transposed, v, the score tile and the accumulator in
    fp32, plus m, l, alpha."""
    lim = t_fa.launch_limits(64, 64, 128, "bfloat16")
    assert lim.ok and lim.route == "wgmma" and lim.threads == 160
    assert lim.smem_bytes == 1024 + 64 + 2 * 128 * (64 + 2 * 2 * 64)
    big = t_fa.launch_limits(128, 128, 128, torch.bfloat16)
    assert big.ok and big.route == "wgmma" and big.threads == 288
    assert big.smem_bytes == 1024 + 64 + 2 * 128 * (128 + 2 * 2 * 128)
    x3 = t_fa.launch_limits(64, 64, 128, torch.float32)
    assert x3.ok and x3.route == "bf16x3" and x3.threads == 160
    assert x3.smem_bytes == 1024 + 64 + 4 * 128 * (64 + 2 * 2 * 64)
    f32 = t_fa.launch_limits(64, 32, 128, torch.float32)
    assert f32.ok and f32.route == "simt" and f32.threads == 256
    # q rows 16 a warp, 2 warps along the 32 kv columns: 16 columns a
    # warp over 8 lanes, P rows of 24 floats
    assert f32.smem_bytes == (4 * ((64 + 4 * 32) * 132 + 8 * 16 * (24 + 1))
                              + 2 * 32 * 128) == 122368
    assert f32.ctas_per_sm == 1
    gen = t_fa.launch_limits(32, 32, 128, torch.float32)
    assert gen.ok and gen.route == "simt" and gen.threads == 256
    assert gen.smem_bytes == 4 * (2 * 128 * 32 + 2 * 128 * 32 + 32 * 32
                                  + 3 * 32)
    assert not t_fa.launch_limits(128, 128, 128).ok
    # a padded head dim takes the CTA of its instantiation: 112 runs at 128
    assert t_fa.launch_limits(128, 64, 112, "float32") == t_fa.LaunchLimits(
        smem_bytes=t_fa.bf16x3_smem_bytes(128, 64, 128), threads=288,
        route="bf16x3")
    assert t_fa.launch_limits(64, 64, 112, "bfloat16") == lim
    # d 256, one warpgroup: block_kv 64 in bf16, 32 in f32
    assert t_fa.launch_limits(64, 64, 256, "bfloat16").smem_bytes == \
        1024 + 64 + 2 * 256 * (64 + 2 * 2 * 64) == 164928
    assert t_fa.launch_limits(64, 32, 256, "float32").smem_bytes == \
        1024 + 64 + 4 * 256 * (64 + 2 * 2 * 32) == 197696
    # bf16 outside the instantiated set takes the simt formula
    assert t_fa.launch_limits(64, 32, 128, "bfloat16") == \
        t_fa.launch_limits(64, 32, 128, "float32")
    with pytest.raises(TypeError):
        t_fa.launch_limits(64, 64, 128, torch.float16)


@pytest.mark.parametrize("blocks, d, dtype, want", [
    ((64, 64), 128, "bfloat16", "wgmma"),
    ((128, 128), 32, "bfloat16", "wgmma"),
    ((16, 64), 96, "bfloat16", "wgmma"),
    ((4, 128), 64, "bfloat16", "wgmma"),
    ((64, 64), 128, "float32", "bf16x3"),
    ((128, 128), 64, "float32", "bf16x3"),
    ((128, 64), 128, "float32", "bf16x3"),
    ((4, 128), 96, "float32", "bf16x3"),
    ((128, 128), 128, "float32", "simt"),
    ((64, 128), 128, "float32", "simt"),
    ((128, 128), 96, "float32", "simt"),
    ((64, 32), 128, "float32", "simt"),
    ((64, 64), 160, "float32", "simt"),
    ((48, 64), 64, "float32", "simt"),
    ((64, 64), 4, "bfloat16", "simt"),
    ((64, 64), 160, "bfloat16", "wgmma"),
    ((64, 64), 256, "bfloat16", "wgmma"),
    ((128, 128), 112, "bfloat16", "wgmma"),
    ((16, 64), 112, "bfloat16", "wgmma"),
    ((128, 64), 112, "float32", "bf16x3"),
    ((4, 64), 112, "float32", "bf16x3"),
    ((4, 128), 112, "float32", "simt"),
    ((128, 128), 112, "float32", "simt"),
    ((64, 32), 112, "bfloat16", "simt"),
    ((4, 64), 256, "bfloat16", "wgmma"),
    ((128, 64), 256, "bfloat16", "simt"),
    ((64, 32), 256, "bfloat16", "simt"),
    ((64, 128), 256, "bfloat16", "simt"),
    ((64, 32), 256, "float32", "bf16x3"),
    ((8, 32), 256, "float32", "bf16x3"),
    ((128, 32), 256, "float32", "simt"),
    ((64, 64), 256, "float32", "simt"),
    ((64, 64), 8, "bfloat16", "wgmma"),
    ((64, 64), 200, "float32", "simt"),
    ((64, 32), 200, "float32", "bf16x3"),
    ((64, 64), 100, "bfloat16", "simt"),
    ((64, 64), 100, "float32", "simt"),
    ((64, 32), 264, "bfloat16", "simt"),
    ((64, 32), 128, "bfloat16", "simt"),
    ((64, 256), 128, "bfloat16", "simt"),
    ((96, 64), 128, "bfloat16", "simt"),
    ((48, 64), 128, "bfloat16", "simt"),
    ((256, 64), 64, "bfloat16", "simt")])
def test_route(blocks, d, dtype, want):
    """bf16 at an instantiated (head_dim, block_kv) and a block_q that
    divides or fills the 64-row tiles takes the wgmma kernel, f32 at such
    a triple whose hi and lo tiles fit a CTA the bf16x3 kernel; a head
    dim between instantiations (a multiple of 8 up to 256: zamba2-7b's
    112, gemma-7b's 256 itself) takes the triple of the next one; all
    else — head dims off that rule (100, 264) and pairs off the sets —
    takes the CUDA-core kernel."""
    assert t_fa.route(*blocks, d, dtype) == want
    assert t_fa.launch_limits(*blocks, d, dtype).route == want
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_fa.route(*blocks, d, torch.float16)


def test_simt_reach_does_not_shrink():
    """Every (block_q, block_kv, head_dim) of positive multiples of 4 (the
    blocks up to 256, the head dim up to 264) whose CUDA-core CTA fit
    before the tiled kernel — shared memory 4·(2·d·bq + 2·d·bkv + bq·bkv
    + 3·bq) bytes within 232,448, 104,615 triples — still launches on the
    simt route, 80 of them on the tiled kernel, the rest on the general
    one; and a length with an odd factor still fits a pair."""
    n = tiled = 0
    for d in range(4, 265, 4):
        for bq in range(4, 257, 4):
            for bkv in range(4, 257, 4):
                if 4 * (2 * d * bq + 2 * d * bkv + bq * bkv + 3 * bq) \
                        > 232448:
                    continue
                lim = t_fa._simt_limits(bq, bkv, d)
                assert lim.ok and lim.route == "simt" \
                    and lim.threads == 256, (bq, bkv, d, lim.reason)
                n += 1
                D = t_fa.simt_head_dim(bq, bkv, d)
                if (bq, bkv, D) in t_fa.SIMT_TILED_SET:
                    tiled += 1
                    assert lim.smem_bytes == t_fa.simt_tiled_smem_bytes(
                        bq, bkv, D)
    assert (n, tiled) == (104615, 80)
    assert t_fa.fit_blocks(116, 116, 128, 128, 128, "float32") == (116, 4)
    assert t_fa.launch_limits(116, 4, 128, "float32").ok


def test_simt_tiled_set():
    """The tiled kernel's triples, each fitting one CTA an SM; a head dim
    between instantiations (a multiple of 4 above 64) runs at the next
    one, anything else — head dims of 64 or less, above 256 or off the
    granule, pairs off the set — on the general kernel at its own d."""
    assert t_fa.SIMT_TILED_SET == {(64, 32, 128), (64, 64, 128),
                                   (128, 32, 128), (64, 32, 256)}
    for t in t_fa.SIMT_TILED_SET:
        lim = t_fa._simt_limits(*t)
        assert lim.ok and lim.ctas_per_sm == 1
        assert lim.smem_bytes == t_fa.simt_tiled_smem_bytes(*t)
        assert t_fa.SMEM_PER_SM // 2 < lim.smem_bytes <= t_fa.SMEM_PER_CTA
    assert [t_fa.simt_head_dim(64, 32, d) for d in (4, 64, 68, 100, 112,
                                                    128, 132, 136, 256,
                                                    264)] == \
        [4, 64, 128, 128, 128, 128, 256, 256, 256, 264]
    assert t_fa.simt_head_dim(128, 32, 200) == 200     # (128, 32, 256): off
    assert t_fa.simt_head_dim(64, 64, 100) == 128
    assert t_fa.simt_head_dim(32, 32, 128) == 128       # general, at d
    assert (32, 32, 128) not in t_fa.SIMT_TILED_SET
    # a padded head dim takes the CTA of its instantiation
    assert t_fa._simt_limits(64, 32, 100) == t_fa._simt_limits(64, 32, 128)
    assert t_fa._simt_limits(64, 32, 136) == t_fa._simt_limits(64, 32, 256)


def test_simt_issue_factor():
    """The tune model's FFMA slots per FMA on the simt route, from the
    designs: the tiled kernel's loads per FMA of S (TM + TN per 4·TM·TN)
    and of P·V (TM + TD per 4·TM·TD), each load at SIMT_LOAD_SLOTS; the
    general kernel's fixed SIMT_GENERAL_FACTOR."""
    slots = t_fa.SIMT_LOAD_SLOTS
    # (128, 32, 128): S 4 x 4 a thread, the output 8 x 8
    assert t_fa.simt_issue_factor(128, 32, 128) == pytest.approx(
        1 + slots * (8 / 64 + 16 / 256) / 2)
    # (64, 32, 128): two warps along the kv block, S 4 x 2 a thread
    assert t_fa.simt_issue_factor(64, 32, 128) == pytest.approx(
        1 + slots * (6 / 32 + 16 / 256) / 2)
    # (64, 32, 256): 8 rows a warp, S 4 x 2, the output 4 x 16
    assert t_fa.simt_issue_factor(64, 32, 200) == pytest.approx(
        1 + slots * (6 / 32 + 20 / 256) / 2)
    assert t_fa.simt_issue_factor(32, 32, 128) == t_fa.SIMT_GENERAL_FACTOR
    assert t_fa.simt_issue_factor(64, 32, 264) == t_fa.SIMT_GENERAL_FACTOR


def test_launch_limits_wgmma_instantiated_set():
    """A triple of the instantiation grid is in the set when the kernel
    was built for it — block_kv 64 and 128 up to head_dim 128, at 256
    block_kv 64 with one warpgroup — and then launches, at the formula of
    the source, with 160 or 288 threads; CTAs per SM follow from shared
    memory and threads."""
    for d in t_fa.WGMMA_HEAD_DIMS:
        for bkv in t_fa.WGMMA_BLOCK_KV:
            for bq in t_fa.WGMMA_BLOCK_Q:
                nwg = 2 if bq == 128 else 1
                smem = t_fa.wgmma_smem_bytes(bq, bkv, d)
                assert smem == 1088 + 2 * d * (64 * nwg + 4 * bkv)
                built = (bkv == 64 and nwg == 1 if d == 256
                         else bkv in (64, 128))
                assert not built or smem <= t_fa.SMEM_PER_CTA
                assert ((bq, bkv, d) in t_fa.WGMMA_SET) == built
                lim = t_fa.launch_limits(bq, bkv, d, torch.bfloat16)
                assert (lim.route == "wgmma") == built
                if built:
                    assert lim.ok and lim.threads == 128 * nwg + 32
                    assert lim.smem_bytes == smem
    # block_kv 128 at d 256 does not fit: 296,000 bytes with one warpgroup
    assert t_fa.wgmma_smem_bytes(64, 128, 256) == 296000
    assert len(t_fa.WGMMA_SET) == 4 * 2 * 6 + 5
    ctas = {pair: t_fa.launch_limits(*pair, 128, "bfloat16").ctas_per_sm
            for pair in ((64, 64), (128, 64), (64, 128), (128, 128))}
    assert ctas == {(64, 64): 2, (128, 64): 2, (64, 128): 1,
                    (128, 128): 1}
    assert t_fa.launch_limits(64, 64, 32, "bfloat16").ctas_per_sm == 10
    assert t_fa.launch_limits(64, 128, 128, "float32").ctas_per_sm == 1


def test_default_configs_launch_at_head_dim_128():
    for _, (bq, bkv) in t_fa.DEFAULT_CONFIGS:
        assert t_fa.launch_limits(bq, bkv, 128, torch.float32).ok


def test_advisor_shrinks_kv_first():
    """The JAX advisor's order on the simt route: bkv halves before bq
    does.  In bf16 at a tensor-core head_dim the first pair is a wgmma
    pair and fits as it is; in f32 the blocks shrink to a bf16x3 pair
    first."""
    t = blocking.attention_cta_tiles(4096, 4096, 128, "float32")
    assert (t.bq, t.bkv) == (128, 64)
    assert t.smem_bytes == t_fa.launch_limits(128, 64, 128).smem_bytes
    t = blocking.attention_cta_tiles(4096, 4096, 64, "float32")
    assert (t.bq, t.bkv) == (128, 128)
    t = blocking.attention_cta_tiles(4096, 4096, 256, "float32")
    assert (t.bq, t.bkv) == (64, 4)
    t = blocking.attention_cta_tiles(4096, 4096, 128, "bfloat16")
    assert (t.bq, t.bkv) == (128, 128)
    assert t.smem_bytes == t_fa.wgmma_smem_bytes(128, 128, 128)
    t = blocking.attention_cta_tiles(4096, 4096, 256, "bfloat16")
    assert (t.bq, t.bkv) == (64, 4)
    # the tensor-core pairs at d 256, (64, 64) in bf16 and (64, 32) in
    # f32, lie past the shrinking above; fit_blocks, which ops applies to
    # the advisor's pair, reaches them
    assert t_fa.fit_blocks(4096, 4096, 64, 4, 256, "bfloat16") == (64, 64)
    assert t_fa.fit_blocks(4096, 4096, 64, 4, 256, "float32") == (64, 32)
    # f32 reaches the bf16x3 pair before a simt pair that would fit
    t = blocking.attention_cta_tiles(8, 4096, 128, "float32")
    assert (t.bq, t.bkv) == (8, 64)
    assert t_fa.launch_limits(8, 128, 128, "float32").ok
    with pytest.raises(ValueError, match="no flash-attention CTA tile"):
        blocking.attention_cta_tiles(64, 64, 4096, "float32")


@settings(max_examples=40, deadline=None)
@given(sq=st.integers(1, 512), skv=st.integers(1, 1024),
       d=st.sampled_from([4, 32, 64, 96, 100, 112, 128, 160, 256]),
       dtype=st.sampled_from(["float32", "bfloat16"]))
def test_default_and_advisor_blocks_launch(sq, skv, d, dtype):
    """For every length that is a multiple of the granule, the default
    pair and the advisor's pair (clamped as ops does) divide the lengths
    and pass the launch limits."""
    sq, skv = 4 * sq, 4 * skv
    t = blocking.attention_cta_tiles(sq, skv, d, dtype)
    for bq, bkv in (t_fa.default_config(sq, skv, d, dtype),
                    t_fa.fit_blocks(sq, skv, t.bq, t.bkv, d, dtype)):
        assert sq % bq == 0 and skv % bkv == 0
        assert t_fa.launch_limits(bq, bkv, d, dtype).ok


@pytest.mark.parametrize("sq, skv, d, dtype", [
    (116, 260, 256, "float32"), (116, 260, 256, "bfloat16"),
    (348, 116, 256, "float32"), (92, 4 * 97, 256, "float32")])
def test_fit_blocks_steps_past_a_block_that_cannot_halve(sq, skv, d,
                                                         dtype):
    """A length with an odd factor (116 = 4 * 29) leaves a block equal to
    the length that cannot halve; fit_blocks steps it down to a smaller
    divisor instead of refusing, and the pair launches."""
    for want in ((128, 128), (256, 64), (64, 256)):
        bq, bkv = t_fa.fit_blocks(sq, skv, *want, d, dtype)
        assert sq % bq == 0 and skv % bkv == 0
        lim = t_fa.launch_limits(bq, bkv, d, dtype)
        assert lim.ok, lim.reason


@settings(max_examples=60, deadline=None)
@given(sq=st.integers(1, 512), skv=st.integers(1, 1024),
       d=st.sampled_from([4, 32, 64, 96, 100, 112, 128, 256]),
       dtype=st.sampled_from(["float32", "bfloat16"]))
def test_blocks_launch_on_their_route(sq, skv, d, dtype):
    """default_config, fit_blocks and the advisor (as ops uses it) give a
    pair that divides the lengths and launches; at a head_dim the tensor
    cores take (112 at the triples of 128) it is a pair of the dtype's
    tensor-core route (wgmma in bf16, bf16x3 in f32) wherever one divides
    the lengths."""
    sq, skv = 4 * sq, 4 * skv
    t = blocking.attention_cta_tiles(sq, skv, d, dtype)
    tc_divides = any(sq % bq == 0 and skv % bkv == 0
                     for bq, bkv, dd in t_fa.tc_set(dtype)
                     if dd == t_fa.tc_head_dim(d))
    tc_route = "wgmma" if dtype == "bfloat16" else "bf16x3"
    for bq, bkv in (t_fa.default_config(sq, skv, d, dtype),
                    t_fa.fit_blocks(sq, skv, t.bq, t.bkv, d, dtype)):
        assert sq % bq == 0 and skv % bkv == 0
        lim = t_fa.launch_limits(bq, bkv, d, dtype)
        assert lim.ok, lim.reason
        assert lim.route in ("simt", tc_route)
        assert (lim.route == tc_route) == tc_divides, (bq, bkv)


@pytest.mark.parametrize("d, want", [
    (8, 32), (32, 32), (40, 64), (64, 64), (72, 96), (96, 96), (104, 128),
    (112, 128), (128, 128), (136, 256), (160, 256), (256, 256), (0, None),
    (4, None), (100, None), (252, None), (264, None)])
def test_tc_head_dim(d, want):
    """A multiple of 8 up to 256 runs at the smallest instantiated head
    dim at least it; any other head dim has none (the simt route)."""
    assert t_fa.tc_head_dim(d) == want


def test_force_simt_runs_the_cuda_core_route_within_its_limits():
    """force_simt takes the CUDA-core kernel at a pair a tensor-core route
    takes, within the CUDA-core kernel's own launch limits; on the CPU
    the plain version runs."""
    tq = [torch.from_numpy(a).bfloat16()
          for a in _inputs(1, 2, 64, 64, 256, seed=2)]
    assert t_fa.route(64, 32, 256, "float32") == "bf16x3"
    assert t_fa.route(64, 64, 256, "bfloat16") == "wgmma"
    out = t_fa.flash_attention(*tq, block_q=64, block_kv=32,
                               force_simt=True)
    assert torch.equal(out, t_fa.plain(*tq))
    # (64, 64) at d 256 launches on wgmma, but its fp32-staged CTA does not
    # fit on the CUDA cores
    assert t_fa.launch_limits(64, 64, 256, "bfloat16").ok
    with pytest.raises(ValueError, match="shared memory"):
        t_fa.flash_attention(*tq, block_q=64, block_kv=64, force_simt=True)


LOG2E = 1.4426950408889634


def _pad(x, D):
    """x with zero columns up to the instantiated head dim D, as TMA fills
    the kernels' tiles past the real head dim."""
    return torch.nn.functional.pad(x, (0, D - x.shape[-1]))


def _emulate_wgmma(q, k, v, causal, block_q, block_kv):
    """The tensor-core kernel's arithmetic, written out in torch on the
    CPU: q, k and v padded with zero columns to the instantiated head dim
    (the scale stays 1/sqrt(d) of the real d); per q block, fp32 scores of
    the bf16 inputs in the base-2 domain, the causal mask, the online
    softmax over the visited kv blocks, l summing the fp32 p, and p
    rounded to bf16 for p·v (the one departure from the reference, which
    multiplies p·v in fp32); the first d output columns stored."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    q_offset = skv - sq
    scale = np.float32(np.float32(1.0 / np.sqrt(d)) * np.float32(LOG2E))
    d_real, d = d, t_fa.tc_head_dim(d)
    q, k, v = (_pad(t, d) for t in (q, k, v))
    nk = skv // block_kv
    out = torch.empty(b, h, sq, d)
    kf, vf = k.float(), v.float()
    for qi in range(sq // block_q):
        r0 = qi * block_q
        qt = q[:, :, r0:r0 + block_q].float()
        m = torch.full((b, h, block_q), t_fa.NEG_INF)
        l = torch.zeros(b, h, block_q)
        acc = torch.zeros(b, h, block_q, d)
        visit = (min(nk, (r0 + q_offset + block_q - 1) // block_kv + 1)
                 if causal else nk)
        for ki in range(visit):
            k0 = ki * block_kv
            s = qt @ kf[:, :, k0:k0 + block_kv].transpose(-1, -2) \
                * float(scale)
            if causal:
                qpos = torch.arange(block_q)[:, None] + r0 + q_offset
                kpos = torch.arange(block_kv)[None] + k0
                s = torch.where(qpos >= kpos, s, t_fa.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + \
                p.bfloat16().float() @ vf[:, :, k0:k0 + block_kv]
            m = mx
        out[:, :, r0:r0 + block_q] = acc / l.clamp_min(1e-30)[..., None]
    return out[..., :d_real].bfloat16()


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (2, 4, 256, 256, 64), (1, 2, 128, 512, 64),
    (1, 1, 512, 512, 128), (2, 2, 256, 256, 32),
    (1, 2, 128, 256, 112), (1, 1, 256, 256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_numerics_within_the_reference_tolerance(b, h, sq, skv, d,
                                                       causal):
    """The tensor-core kernel's one numerical departure — p rounded to
    bf16 before p·v — stays within the reference's bf16 tolerance (2e-2)
    of the JAX kernel (interpret mode) and its oracle, at the shapes of
    test_flash_matches_jax, zamba2-7b's head dim 112 (padded to 128) and
    gemma-7b's 256, and the route's default blocks."""
    arrs = _inputs(b, h, sq, skv, d, seed=sq + skv + d)
    jq, tq, tol = _both(arrs, "bfloat16")
    bq, bkv = t_fa.default_config(sq, skv, d, torch.bfloat16)
    assert t_fa.route(bq, bkv, d, torch.bfloat16) == "wgmma"
    got = _emulate_wgmma(*tq, causal, bq, bkv)
    want = j_fa.flash_attention(*jq, causal=causal, block_q=bq,
                                block_kv=bkv)
    oracle = j_ref.attention(*jq, causal=causal)
    for ref in (want, oracle):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    # the rounding of p is a real departure, not a no-op
    assert not torch.equal(got, t_fa.plain(*tq, causal=causal))


def test_bfloat16_inputs_are_bit_identical():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    j = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    t = convert.to_tensor(x, "cpu", torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(j, t.numpy().view(np.uint16))


def test_launch_limits_bf16x3_shared_memory():
    """The f32 tensor-core CTA takes 1024 + 64 + 4·d·(64·warpgroups +
    2·stages·block_kv) bytes: at d = 128 (64, 64) and (128, 64) fit, while
    (64, 128) and (128, 128) exceed the 232,448 bytes a CTA can use and
    are off the set: they take the simt route, where (64, 128) fits and
    (128, 128) does not.  At d = 128 one CTA fills an SM."""
    want = {(64, 64): 164928, (128, 64): 197696, (128, 128): 328768,
            (64, 128): 296000}
    for (bq, bkv), smem in want.items():
        assert t_fa.bf16x3_smem_bytes(bq, bkv, 128) == smem
        fits = smem <= t_fa.SMEM_PER_CTA
        assert ((bq, bkv, 128) in t_fa.BF16X3_SET) == fits
        lim = t_fa.launch_limits(bq, bkv, 128, torch.float32)
        assert lim.route == ("bf16x3" if fits else "simt")
        assert lim.ok == ((bq, bkv) != (128, 128))
        if fits:
            assert lim.smem_bytes == smem and lim.ctas_per_sm == 1
            assert lim.threads == (288 if bq == 128 else 160)
    # up to head_dim 128 the set is every bf16 triple that fits, and
    # nothing else
    for bq, bkv, d in t_fa.WGMMA_SET:
        if d <= 128:
            fits = t_fa.bf16x3_smem_bytes(bq, bkv, d) <= t_fa.SMEM_PER_CTA
            assert ((bq, bkv, d) in t_fa.BF16X3_SET) == fits
    assert all(t in t_fa.WGMMA_SET for t in t_fa.BF16X3_SET if t[2] <= 128)
    assert (64, 128, 96) in t_fa.BF16X3_SET
    assert (128, 128, 96) not in t_fa.BF16X3_SET
    # at d 256 only block_kv 32 with one warpgroup fits: 197,696 bytes
    assert {t for t in t_fa.BF16X3_SET if t[2] == 256} == {
        (bq, 32, 256) for bq in (4, 8, 16, 32, 64)}
    assert len(t_fa.BF16X3_SET) == 41 + 5


def _split(x):
    """hi and lo of the split pass, as fp32 values."""
    hi, lo = t_fa.plain_split(x)
    return hi.float(), lo.float()


def _mm3(a, b):
    """a @ b as the bf16x3 kernel takes it: three products of bf16 halves,
    each exact in fp32, summed in fp32 (lo · lo dropped)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _emulate_bf16x3(q, k, v, causal, block_q, block_kv):
    """The f32 tensor-core kernel's arithmetic, written out in torch on the
    CPU: q, k and v split into bf16 hi and lo; per q block, scores as
    three products in the base-2 domain, the causal mask, the online
    softmax over the visited kv blocks, l summing the unrounded fp32 p,
    p split the same way for p·v, and an fp32 output.  Head dims are
    padded with zero columns as in :func:`_emulate_wgmma`."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    q_offset = skv - sq
    scale = np.float32(np.float32(1.0 / np.sqrt(d)) * np.float32(LOG2E))
    d_real, d = d, t_fa.tc_head_dim(d)
    q, k, v = (_pad(t, d) for t in (q, k, v))
    nk = skv // block_kv
    out = torch.empty(b, h, sq, d)
    for qi in range(sq // block_q):
        r0 = qi * block_q
        qt = q[:, :, r0:r0 + block_q]
        m = torch.full((b, h, block_q), t_fa.NEG_INF)
        l = torch.zeros(b, h, block_q)
        acc = torch.zeros(b, h, block_q, d)
        visit = (min(nk, (r0 + q_offset + block_q - 1) // block_kv + 1)
                 if causal else nk)
        for ki in range(visit):
            k0 = ki * block_kv
            s = _mm3(qt, k[:, :, k0:k0 + block_kv].transpose(-1, -2)) \
                * float(scale)
            if causal:
                qpos = torch.arange(block_q)[:, None] + r0 + q_offset
                kpos = torch.arange(block_kv)[None] + k0
                s = torch.where(qpos >= kpos, s, t_fa.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _mm3(p, v[:, :, k0:k0 + block_kv])
            m = mx
        out[:, :, r0:r0 + block_q] = acc / l.clamp_min(1e-30)[..., None]
    return out[..., :d_real]


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (2, 4, 256, 256, 64, 1.0), (1, 2, 128, 512, 64, 1.0),
    (1, 1, 512, 512, 128, 1.0), (2, 2, 256, 256, 32, 1.0),
    (1, 1, 512, 512, 128, 4.0), (1, 2, 128, 256, 112, 1.0),
    (1, 2, 128, 256, 112, 4.0), (1, 1, 256, 256, 256, 1.0),
    (1, 1, 256, 256, 256, 4.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16x3_numerics_within_the_reference_tolerance(b, h, sq, skv, d,
                                                        gain, causal):
    """The f32 tensor-core kernel's arithmetic — operands and p split into
    bf16 hi and lo, three products each — stays within the reference's
    f32 tolerance (2e-3) of the JAX kernel (interpret mode) and its
    oracle, at the shapes of test_flash_matches_jax, zamba2-7b's head dim
    112 (padded to 128) and gemma-7b's 256, and the route's default
    blocks, and with inputs scaled ×4 (logits ×16), where one TF32 pass
    would not."""
    arrs = [a * np.float32(gain)
            for a in _inputs(b, h, sq, skv, d, seed=sq + skv + d)]
    jq, tq, tol = _both(arrs, "float32")
    bq, bkv = t_fa.default_config(sq, skv, d, torch.float32)
    assert t_fa.route(bq, bkv, d, torch.float32) == "bf16x3"
    got = _emulate_bf16x3(*tq, causal, bq, bkv)
    assert got.dtype == torch.float32
    want = j_fa.flash_attention(*jq, causal=causal, block_q=bq,
                                block_kv=bkv)
    oracle = j_ref.attention(*jq, causal=causal)
    for ref in (want, oracle):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    # the split is a real departure from the fp32 products, not a no-op
    assert not torch.equal(got, t_fa.plain(*tq, causal=causal))


def test_plain_split_matches_jax_rounding():
    """hi is JAX's bf16 rounding of x bit for bit, lo JAX's rounding of
    x - hi, and hi + lo holds x to within 2^-16 relative (over normals
    spread across many binades)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(8192)
         * np.exp2(rng.integers(-30, 30, 8192))).astype(np.float32)
    hi, lo = t_fa.plain_split(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    j_hi = jnp.asarray(x, jnp.bfloat16)
    j_lo = jnp.asarray(jnp.asarray(x) - j_hi.astype(jnp.float32),
                       jnp.bfloat16)
    for t, j in ((hi, j_hi), (lo, j_lo)):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))
    back = hi.double() + lo.double()
    err = (back - torch.from_numpy(x).double()).abs()
    assert (err.numpy() <= 2.0 ** -16 * np.abs(x)).all()
    assert (lo != 0).any()


def test_split_on_the_cpu_is_the_plain_split():
    """On the CPU the split wrapper runs plain_split and counts no
    launch; it takes only contiguous f32 of sizes the kernel takes."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 16, 32, 8, 1))
    n0 = t_fa.split_bf16x3.launches
    got = t_fa.split_bf16x3(q, k, v)
    assert t_fa.split_bf16x3.launches == n0
    for (hi, lo), x in zip(got, (q, k, v)):
        want = t_fa.plain_split(x)
        assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    with pytest.raises(ValueError, match="float32"):
        t_fa.split_bf16x3(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="one size"):
        t_fa.split_bf16x3(q, k, v[:, :, :8].contiguous())
