"""repro_torch.core.decomposition against repro.core.decomposition.

Inputs are made with numpy from a seed and handed to both packages; the
outputs are compared in float32.  Tolerances: the two frameworks sum in
another order, so float32 sums agree to a few units in the last place of
the largest term — rtol 1e-5 on sums of non-negative terms, and an atol
scaled by the magnitude of the terms where signs cancel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decomposition as ref
from repro_torch.core import decomposition as port

P_VALUES = (4, 6, 8)


def _rows(seed, n, d, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, d)).astype(np.float32)


@pytest.mark.parametrize("p", P_VALUES)
def test_lp_coefficients(p):
    assert port.lp_coefficients(p) == ref.lp_coefficients(p)


@pytest.mark.parametrize("p", P_VALUES)
def test_interaction_orders(p):
    assert port.interaction_orders(p) == ref.interaction_orders(p)


@pytest.mark.parametrize("p", [3, 5, 0, 2.5])
def test_odd_or_fractional_p_raises_the_same_error(p):
    with pytest.raises(ValueError) as want:
        ref.lp_coefficients(p)
    with pytest.raises(ValueError) as got:
        port.lp_coefficients(p)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("p", P_VALUES)
def test_power_moments_and_marginal_norm(p):
    X = _rows(p, 9, 300)
    want = np.asarray(ref.power_moments(jnp.asarray(X), p))
    got = port.power_moments(torch.from_numpy(X), p)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # sums of non-negative terms: float32 rounding of the sum order only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(port.marginal_norm(got, p).numpy(),
                               np.asarray(ref.marginal_norm(jnp.asarray(want), p)),
                               rtol=1e-5)


@pytest.mark.parametrize("p", P_VALUES)
def test_exact_lp_distance(p):
    x, y = _rows(10 + p, 7, 200), _rows(20 + p, 7, 200)
    want = np.asarray(ref.exact_lp_distance(jnp.asarray(x), jnp.asarray(y), p))
    got = port.exact_lp_distance(torch.from_numpy(x), torch.from_numpy(y), p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("p", P_VALUES)
def test_exact_pairwise_lp(p):
    A, B = _rows(30 + p, 11, 128), _rows(40 + p, 13, 128)
    want = np.asarray(ref.exact_pairwise_lp(jnp.asarray(A), jnp.asarray(B), p))
    got = port.exact_pairwise_lp(torch.from_numpy(A), torch.from_numpy(B), p)
    assert tuple(got.shape) == (11, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("a,c", [(3, 1), (2, 2), (5, 3), (1, 7)])
def test_mixed_moment(a, c):
    x, y = _rows(50 + a, 5, 256), _rows(60 + c, 5, 256)
    want = np.asarray(ref.mixed_moment(jnp.asarray(x), jnp.asarray(y), a, c))
    got = port.mixed_moment(torch.from_numpy(x), torch.from_numpy(y), a, c)
    # signed terms cancel: bound the error by the sum of |terms|
    scale = np.sum(np.abs(x.astype(np.float64)) ** a * np.abs(y) ** c, axis=-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale.max())


@pytest.mark.parametrize("p", P_VALUES)
def test_decomposition_identity_holds_in_the_port(p):
    """d_(p) = ||x||^p + ||y||^p + sum_m c_m <x^{p-m}, y^m>, the identity the
    sketches estimate, checked against the reference's exact distance."""
    x, y = _rows(70 + p, 4, 64), _rows(80 + p, 4, 64)
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    total = port.exact_lp_distance(xt, torch.zeros_like(xt), p)
    total = total + port.exact_lp_distance(yt, torch.zeros_like(yt), p)
    for a, c, coef in port.interaction_orders(p):
        total = total + coef * port.mixed_moment(xt, yt, a, c)
    want = np.asarray(ref.exact_lp_distance(jnp.asarray(x), jnp.asarray(y), p))
    np.testing.assert_allclose(total.numpy(), want, rtol=1e-4)
