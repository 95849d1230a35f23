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
    """The formula of csrc/flash_attention.cu: q and k transposed, v, the
    score tile and the accumulator in fp32, plus m, l, alpha."""
    lim = t_fa.launch_limits(64, 64, 128, "bfloat16")
    assert lim.ok and lim.threads == 256
    assert lim.smem_bytes == 4 * (2 * 128 * 64 * 2 + 64 * 64 + 3 * 64)
    assert t_fa.launch_limits(64, 64, 128, torch.float32) == lim
    assert not t_fa.launch_limits(128, 128, 128).ok
    with pytest.raises(TypeError):
        t_fa.launch_limits(64, 64, 128, torch.float16)


def test_default_configs_launch_at_head_dim_128():
    for _, (bq, bkv) in t_fa.DEFAULT_CONFIGS:
        assert t_fa.launch_limits(bq, bkv, 128, torch.float32).ok


def test_advisor_shrinks_kv_first():
    """The JAX advisor's order: bkv halves before bq does."""
    t = blocking.attention_cta_tiles(4096, 4096, 128, "bfloat16")
    assert (t.bq, t.bkv) == (128, 64)
    assert t.smem_bytes == t_fa.launch_limits(128, 64, 128).smem_bytes
    t = blocking.attention_cta_tiles(4096, 4096, 64, "float32")
    assert (t.bq, t.bkv) == (128, 128)
    t = blocking.attention_cta_tiles(4096, 4096, 256, "float32")
    assert (t.bq, t.bkv) == (64, 4)
    with pytest.raises(ValueError, match="no flash-attention CTA tile"):
        blocking.attention_cta_tiles(64, 64, 4096, "float32")


@settings(max_examples=40, deadline=None)
@given(sq=st.integers(1, 512), skv=st.integers(1, 1024),
       d=st.sampled_from([4, 32, 64, 96, 128, 160, 256]))
def test_default_and_advisor_blocks_launch(sq, skv, d):
    """For every length that is a multiple of the granule, the default
    pair and the advisor's pair (clamped as ops does) divide the lengths
    and pass the launch limits."""
    sq, skv = 4 * sq, 4 * skv
    t = blocking.attention_cta_tiles(sq, skv, d)
    for bq, bkv in (t_fa.default_config(sq, skv, d),
                    t_fa.fit_blocks(sq, skv, t.bq, t.bkv, d)):
        assert sq % bq == 0 and skv % bkv == 0
        assert t_fa.launch_limits(bq, bkv, d).ok


def test_bfloat16_inputs_are_bit_identical():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    j = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    t = convert.to_tensor(x, "cpu", torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(j, t.numpy().view(np.uint16))
