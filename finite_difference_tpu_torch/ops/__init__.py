"""Batched numerical primitives on torch tensors (counterpart of ``finite_difference_tpu.ops``).

JAX's ``df64`` (double-float arithmetic for a chip without float64) has no
counterpart: the card computes float64 natively.
"""
from .special import norm_cdf, norm_pdf, norm_icdf, bivariate_norm_cdf
from .tridiag import (
    thomas_solve,
    thomas_solve_const,
    thomas_solve_assoc,
    thomas_solve_pscan,
    tridiag_matvec,
)

__all__ = [
    "norm_cdf",
    "norm_pdf",
    "norm_icdf",
    "bivariate_norm_cdf",
    "thomas_solve",
    "thomas_solve_const",
    "thomas_solve_assoc",
    "thomas_solve_pscan",
    "tridiag_matvec",
]
