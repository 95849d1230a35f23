"""The flash kernels' softmax scale argument (``kernels/flash_attention.py``).

Left out, the scale is 1/sqrt(d) as it has always been: the forward and
the backward give the bits they gave before the argument existed (the
formula kept here word for word).  Given, it reaches the scores of the
forward and of both backward routes: against softmax(q·kᵀ·scale)·v and
its autograd in float64.  Marked ``gpu`` (they skip here): the same on
the card at Zamba2's shared attention, 32 heads of 224 (the d-256
tensor-core forward with zero columns, the plain backward) and at 128
(the backward kernel), where the kernels take the scale in the launch.
No JAX here: ``python -m pytest -q -m gpu tests/test_torch_flash_scale.py``.
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

NEG = -2.0 ** 30


def _qkv(shape, dtype=torch.float32, device="cpu", seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    out = [torch.randn(shape, generator=g, dtype=torch.float64)
           .to(device=device, dtype=dtype) for _ in range(3)]
    return [t.requires_grad_() for t in out] if grad else out


def _old_plain(q, k, v):
    """The causal plain version as it was before the scale argument."""
    sq, d, skv = q.shape[2], q.shape[3], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * \
        float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))
    rows = torch.arange(sq)[:, None] + (skv - sq)
    s = torch.where(rows >= torch.arange(skv)[None], s, NEG)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _exact(q, k, v, scale):
    """softmax(q·kᵀ·scale, causal)·v in float64."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    sq = q.shape[2]
    mask = torch.ones(sq, sq, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(s.masked_fill(~mask, -math.inf), -1) @ v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_default_scale_is_the_one_it_always_was(dtype):
    q, k, v = _qkv((1, 2, 64, 40), dtype)
    assert torch.equal(ops.flash_attention(q, k, v), _old_plain(q, k, v))
    assert torch.equal(fa.flash_attention(q, k, v, block_q=64, block_kv=64),
                       fa.flash_attention(q, k, v, block_q=64, block_kv=64,
                                          scale=1.0 / math.sqrt(40)))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    want = fa.attention_backward(q, k, v, g)
    for a, b in zip(fa.attention_backward(q, k, v, g,
                                          scale=1.0 / math.sqrt(40)), want):
        assert torch.equal(a, b)


def test_a_given_scale_reaches_the_forward_and_the_gradients():
    """Zamba2's (d/2)^-1/2 at d 32: forward and all three gradients
    through ``ops.flash_attention`` (the autograd Function) against the
    float64 formula, to float32's rounding."""
    scale = 16 ** -0.5
    q, k, v = _qkv((2, 3, 64, 32), grad=True)
    out = ops.flash_attention(q, k, v, scale=scale)
    ref = _exact(q, k, v, scale)
    assert (out.double() - ref).abs().max().item() <= 1e-5
    assert (ops.flash_attention(q, k, v).double() - ref).abs().max().item() \
        > 1e-3
    go = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(out, (q, k, v), go)
    want = torch.autograd.grad(ref, (q, k, v), go.double())
    for a, w in zip(got, want):
        assert (a.double() - w).abs().max().item() <= 1e-5 * max(
            1.0, w.abs().max().item())


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,route", [(224, "plain"), (128, "kernel")])
def test_cuda_scale_through_forward_and_backward(cuda, d, route):
    """bf16 at seq 512: the tensor-core forward and the backward route of
    the head dim, both with the given scale, within the bf16 routes' 2e-2
    of the largest entry against the float64 formula; without the scale
    the forward is off by more than that."""
    scale = (d / 2) ** -0.5
    q, k, v = _qkv((1, 4, 512, d), torch.bfloat16, cuda, grad=True)
    assert fa.backward_route(q, k) == route
    out = ops.flash_attention(q, k, v, scale=scale)
    ref = _exact(q, k, v, scale)
    top = ref.abs().max().item()
    assert (out.double() - ref).abs().max().item() <= 2e-2 * top
    plainer = ops.flash_attention(q.detach(), k.detach(), v.detach())
    assert (plainer.double() - ref).abs().max().item() > 2e-2 * top
    go = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                     ).to(device=cuda, dtype=torch.bfloat16)
    n0 = dict(fa.flash_attention.backward_calls_by_route)
    got = torch.autograd.grad(out, (q, k, v), go)
    assert fa.flash_attention.backward_calls_by_route[route] == n0[route] + 1
    want = torch.autograd.grad(ref, (q, k, v), go.double())
    for a, w in zip(got, want):
        assert (a.double() - w).abs().max().item() <= \
            2e-2 * w.abs().max().item()
