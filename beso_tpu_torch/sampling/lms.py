"""Linear-multistep (Adams-Bashforth over the sigma grid) coefficients
(numpy port of `beso_tpu/sampling/lms.py`).

Functional parity target: `linear_multistep_coeff`
(`beso/agents/diffusion_agents/k_diffusion/gc_sampling.py:416-429`), which
integrates the Lagrange basis polynomial over [sigma_i, sigma_{i+1}] with
scipy.integrate.quad. The coefficients depend only on the host sigma grid,
so they are computed on the host once per schedule. The integrand is a
polynomial of degree <= order-1, so fixed-order Gauss-Legendre quadrature
is exact.
"""

from __future__ import annotations

import numpy as np

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(8)


def linear_multistep_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    """Integral over [t_i, t_{i+1}] of the j-th Lagrange basis polynomial
    anchored at nodes t_{i}, t_{i-1}, ..., t_{i-order+1}."""
    if order - 1 > i:
        raise ValueError(f"Order {order} too high for step {i}")

    def fn(tau):
        prod = np.ones_like(tau)
        for k in range(order):
            if j == k:
                continue
            prod = prod * (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    a, b = t[i], t[i + 1]
    # map the Gauss-Legendre nodes from [-1, 1] to [a, b]
    tau = 0.5 * (b - a) * _GL_NODES + 0.5 * (b + a)
    return float(0.5 * (b - a) * np.sum(_GL_WEIGHTS * fn(tau)))


def lms_coefficient_matrix(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Dense [n, order] coefficient matrix for an n-step LMS sampler.

    Row i holds the coefficients of the derivatives [d_i, d_{i-1}, ...]
    (newest first, as the reference's `zip(coeffs, reversed(ds))`,
    gc_sampling.py:463-465); unused higher-order slots are zero.
    """
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(sigmas) - 1
    coeffs = np.zeros((n, order))
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            coeffs[i, j] = linear_multistep_coeff(cur_order, sigmas, i, j)
    return coeffs
