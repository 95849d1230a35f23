"""The port's stencil kernels against the JAX package's Pallas kernels.

Inputs are made once with numpy from a seed and go through both packages:
the JAX kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them; the port runs its plain PyTorch versions, which its wrappers take
for tensors on the CPU.  Tolerances are the reference's own
(``tests/test_kernels.py``).  The CUDA kernels themselves are held
against the plain versions on the card in ``test_torch_port.py``.
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

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import longrange3d as t_lr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import stencil3d7pt as t_s7  # noqa: E402

j_s7 = importlib.import_module("repro.kernels.stencil3d7pt")
j_lr = importlib.import_module("repro.kernels.longrange3d")

COEFFS = dict(W=0.1, E=0.2, N=0.3, S=0.15, F=0.25, B=0.05, s=-1.0)
CVEC = [COEFFS[c] for c in "WENSFB"] + [COEFFS["s"]]
LR_C = [0.5, 0.1, 0.05, 0.02, 0.01]
TOL7 = dict(rtol=2e-5, atol=1e-6)
TOL_LR = dict(rtol=2e-4, atol=1e-5)


def _grids(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_7pt(a):
    return np.asarray(j_s7.stencil3d7pt(jnp.asarray(a),
                                        jnp.asarray(CVEC, jnp.float32)))


def _jax_lr(u, v, roc):
    return np.asarray(j_lr.longrange3d(jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(roc),
                                       jnp.asarray(LR_C, jnp.float32)))


@pytest.mark.parametrize("shape", [(6, 16, 16), (12, 40, 40), (3, 9, 9),
                                   (20, 8, 8)])
def test_stencil7pt_matches_jax(shape):
    (a,) = _grids(shape, 1, seed=sum(shape))
    got = ops.stencil3d7pt(convert.to_tensor(a, "cpu"), CVEC)
    np.testing.assert_allclose(convert.to_numpy(got), _jax_7pt(a), **TOL7)


@pytest.mark.parametrize("shape", [(10, 16, 16), (14, 24, 24), (9, 40, 40),
                                   (3, 9, 9)])
def test_longrange_matches_jax(shape):
    u, v, roc = _grids(shape, 3, seed=sum(shape))
    roc *= 0.1
    t = [convert.to_tensor(x, "cpu") for x in (u, v, roc)]
    got = ops.longrange3d(*t, LR_C)
    np.testing.assert_allclose(convert.to_numpy(got), _jax_lr(u, v, roc),
                               **TOL_LR)


@settings(max_examples=10, deadline=None)
@given(m=st.integers(3, 10), n=st.integers(3, 24))
def test_stencil7pt_boundary_property(m, n):
    """Kernel == JAX kernel on arbitrary (M, N, N); the width-1 boundary is
    a bit-exact copy of the input."""
    (a,) = _grids((m, n, n), 1, seed=m * 31 + n)
    got = convert.to_numpy(ops.stencil3d7pt(convert.to_tensor(a, "cpu"),
                                            CVEC))
    np.testing.assert_allclose(got, _jax_7pt(a), **TOL7)
    inner = np.zeros(a.shape, bool)
    inner[1:-1, 1:-1, 1:-1] = True
    np.testing.assert_array_equal(got[~inner], a[~inner])


@settings(max_examples=5, deadline=None)
@given(m=st.integers(3, 12),
       n=st.sampled_from([3, 4, 8, 9, 10, 13, 16, 20]))
def test_longrange_boundary_property(m, n):
    """The width-4 boundary copies u, bit for bit, down to grids that are
    all boundary (M or N <= 8).  N = 5..7 is left out here: the JAX
    kernel raises there (see test_longrange_small_grids_are_boundary)."""
    u, v, roc = _grids((m, n, n), 3, seed=m * 37 + n)
    got = convert.to_numpy(ops.longrange3d(
        *(convert.to_tensor(x, "cpu") for x in (u, v, roc)), LR_C))
    np.testing.assert_allclose(got, _jax_lr(u, v, roc), **TOL_LR)
    inner = np.zeros(u.shape, bool)
    inner[4:-4, 4:-4, 4:-4] = True
    np.testing.assert_array_equal(got[~inner], u[~inner])


@pytest.mark.parametrize("n", [5, 6, 7])
def test_longrange_small_grids_are_boundary(n):
    """Grids with an extent of 5..7 are all boundary: the port returns u.
    (The JAX kernel's negative slice stops wrap there and it raises a
    broadcasting error; ROADMAP.md Queue 3.)"""
    u, v, roc = _grids((12, n, n), 3, seed=n)
    got = ops.longrange3d(*(convert.to_tensor(x, "cpu") for x in (u, v, roc)),
                          LR_C)
    np.testing.assert_array_equal(convert.to_numpy(got), u)
