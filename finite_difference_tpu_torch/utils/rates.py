"""Rate-compounding conversions and discount-factor conventions.

The port's own copy of ``finite_difference_tpu.utils.rates`` (host numpy),
so the port imports nothing of the JAX package. Semantics match the
reference's ``utils.py`` (nacc_to_naca / naca_to_nacc) and
``discount.py:130-189`` (method-dispatching discount_factor). All functions
accept scalars or numpy arrays.
"""
from __future__ import annotations

import numpy as np


def nacc_to_naca(nacc_rate):
    """Continuous (NACC) -> annually compounded (NACA): exp(r) - 1."""
    return np.exp(nacc_rate) - 1.0


def naca_to_nacc(naca_rate):
    """Annually compounded (NACA) -> continuous (NACC): ln(1 + r)."""
    return np.log1p(naca_rate)


def discount_factor(rate, tau, method: str = "continuous", frequency: int = 1):
    """Discount factor for a rate quoted under the given compounding method.

    Methods (reference discount.py:130-189):
    - "continuous":  exp(-r * tau)
    - "simple":      1 / (1 + r * tau)
    - "compounded":  (1 + r / m)^(-m * tau)  with m = frequency
    - "discount":    1 - r * tau   (bank-discount convention)
    """
    rate = np.asarray(rate, dtype=np.float64)
    tau = np.asarray(tau, dtype=np.float64)
    m = method.lower()
    if m == "continuous":
        return np.exp(-rate * tau)
    if m == "simple":
        return 1.0 / (1.0 + rate * tau)
    if m == "compounded":
        f = float(frequency)
        return (1.0 + rate / f) ** (-f * tau)
    if m == "discount":
        return 1.0 - rate * tau
    raise ValueError(f"Unknown discounting method: {method!r}")
