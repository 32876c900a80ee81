"""Shared helpers of the operator-pack parity tests: one construction function runs
through both packages (``J``: jets_tpu, ``T``: jets_tpu_torch on the CPU),
and :func:`hold` holds the pair's forward and adjoint against each other on
the same numpy draws and the port's operator to its own gates."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jets_tpu as jt
import jets_tpu.ops as jops
import jets_tpu_torch as tt
import jets_tpu_torch.ops as tops

CPU = torch.device("cpu")  # the tests build on the CPU, as a caller asks

J = SimpleNamespace(ops=jops, space=lambda shape, dt=jnp.float64: jt.Space(shape, dt),
                    f64=jnp.float64, c128=jnp.complex128, kw={})
T = SimpleNamespace(ops=tops, space=lambda shape, dt=torch.float64: tt.Space(shape, dt, CPU),
                    f64=torch.float64, c128=torch.complex128, kw={"device": CPU})


def draw(sp, seed, shift=0.0):
    """A numpy draw of a member of the port's space ``sp`` (plus ``shift``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(sp.shape) + shift
    if sp.dtype.is_complex:
        x = x + 1j * rng.standard_normal(sp.shape)
    return x.astype(torch.empty((), dtype=sp.dtype).numpy().dtype)


def close(a, b, rtol):
    """``a`` within ``rtol`` of ``b`` relative to ``b``'s largest entry;
    ``rtol=0``: the same bits."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if rtol == 0:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def gates(ta, m, d, seed=0, gate=1e-12):
    """The port's dot-product gate at ``gate`` and its linearity gate."""
    lhs, rhs = tt.dot_product_test(ta, torch.from_numpy(m), torch.from_numpy(d))
    assert complex(lhs) == pytest.approx(complex(rhs), rel=gate, abs=1e-12)
    a, b = tt.linearity_test(ta, torch.Generator().manual_seed(seed))
    close(a.numpy(), b.numpy(), 1e-12 if ta.rng.dtype in (torch.float64,
                                                          torch.complex128) else 1e-5)


def hold(build, seed=0, rtol=1e-12, gate=1e-12):
    """``build(P)`` through both packages: forward and adjoint agree on one
    draw each, the outputs are contiguous tensors of the spaces' dtypes,
    and the port passes its gates. Returns the port's operator."""
    ja, ta = build(J), build(T)
    assert ta.dom.shape == tuple(ja.dom.shape) and ta.rng.shape == tuple(ja.rng.shape)
    m, d = draw(ta.dom, seed), draw(ta.rng, seed + 1)
    y = ta(torch.from_numpy(m))
    assert y.dtype == ta.rng.dtype and y.is_contiguous()
    # JAX jitted: one compile per program instead of one per operation
    close(y.numpy(), jax.jit(ja)(jnp.asarray(m)), rtol)
    x = ta.H(torch.from_numpy(d))
    assert x.dtype == ta.dom.dtype and x.is_contiguous()
    close(x.numpy(), jax.jit(ja.H)(jnp.asarray(d)), rtol)
    gates(ta, m, d, seed, gate)
    return ta
