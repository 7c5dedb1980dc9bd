"""Random-number generation for the MC layer (counterpart of
``finite_difference_tpu.models.mc.rng``).

- ``threefry_normals``: JAX's counter-based threefry2x32 generator written
  in torch, so a seed draws the same normals as ``jax.random.normal(
  jax.random.PRNGKey(seed), shape, dtype)`` on either package. It follows
  JAX's partitionable counter scheme (``jax_threefry_partitionable``, the
  default since jax 0.5): element i of the output hashes the counter
  (i >> 32, i & 0xFFFFFFFF) of its flat row-major index, 32-bit bits are
  the two output words XORed, 64-bit bits are (hi << 32) | lo. The bits
  equal ``jax.random.bits`` exactly and the uniforms bit for bit; the
  normals are ``sqrt(2) * erfinv(u)`` as in JAX, and differ from JAX's only
  where ``torch.erfinv`` and XLA's ``erf_inv`` round differently (up to
  about 4e-14 relative at float64, 2e-5 absolute at float32 near |z| = 4).
- ``SobolNormalRng``: scrambled Sobol -> U(0,1) -> N(0,1) on the host
  (scipy's ``qmc.Sobol``, or ``torch.quasirandom.SobolEngine`` for
  RiskFlow parity), with the RiskFlow epsilon-shift away from {0, 1}.
- ``sobol1d_uniforms`` / ``sobol_uniforms``: unscrambled Sobol points on
  the device by the Gray-code construction, counter-based like threefry.

Unsigned 32-bit words are held in int64 tensors, masked with 0xFFFFFFFF
after every operation that can carry out of 32 bits (torch's uint32
arithmetic and shifts are incomplete, and its int64 ``>>`` is arithmetic:
every word here is non-negative, so it is the logical shift). A key is
``prng_key(seed)``, a numpy uint32 pair equal to ``jax.random.PRNGKey(seed)``;
``threefry_fold_in(key, d)`` is ``jax.random.fold_in(key, d)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.special import norm_icdf

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# the bit pattern of 1.0 and the mantissa width, per float dtype
_ONE_BITS = {torch.float64: (0x3FF0000000000000, 52), torch.float32: (0x3F800000, 23)}


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's 64 bits as a (high, low)
    uint32 pair (``[0, seed]`` for a seed below 2^32)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _M32], dtype=np.uint32)



def threefry_fold_in(key, data: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.fold_in(key, data))``: the threefry
    hash under ``key`` of the one counter (0, data & 0xFFFFFFFF), whose two
    output words are the new key (a numpy uint32 pair, on the host)."""
    b1, b2 = _threefry2x32(key, torch.tensor([int(data) & _M32], dtype=torch.int64))
    return np.array([int(b1[0]), int(b2[0])], dtype=np.uint32)

def _key_words(key):
    k = np.asarray(key).astype(np.uint64).ravel()
    if k.shape != (2,):
        raise ValueError(f"a threefry key is a pair of uint32 words, got shape {k.shape}")
    return int(k[0]), int(k[1])


def _counts(shape, device) -> torch.Tensor:
    n = math.prod(shape)
    return torch.arange(n, dtype=torch.int64, device=resolve_device(device)).view(tuple(shape))


def _threefry2x32(key, counts: torch.Tensor):
    """The threefry2x32 hash (20 rounds, JAX's key schedule) of the 64-bit
    counters ``counts`` (int64), as two int64 tensors of uint32 words."""
    k1, k2 = _key_words(key)
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (counts >> 32).add_(ks[0]).bitwise_and_(_M32)
    x1 = (counts & _M32).add_(ks[1]).bitwise_and_(_M32)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_and_(_M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def threefry_bits(key, shape, bit_width: int = 32, device=DEFAULT_DEVICE) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 | uint64)`` as an int64 tensor:
    32-bit words as they are, 64-bit words as their two's-complement bit
    pattern (``np.asarray(jax_bits).view(np.int64)``)."""
    b1, b2 = _threefry2x32(key, _counts(shape, device))
    if bit_width == 32:
        return b1.bitwise_xor_(b2)
    if bit_width == 64:
        return b1.bitwise_left_shift_(32).bitwise_or_(b2)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _uniforms(key, counts: torch.Tensor, dtype, minval: float, maxval: float) -> torch.Tensor:
    """JAX's ``_uniform`` at the counters ``counts`` (``jax.random.uniform(
    key, shape, dtype, minval, maxval)`` bit for bit): the top mantissa bits
    of the random word under the exponent of 1.0, minus 1, scaled to
    [minval, maxval), floored at minval."""
    if dtype not in _ONE_BITS:
        raise ValueError(f"threefry uniforms are float32 or float64, got {dtype}")
    one_bits, n_mant = _ONE_BITS[dtype]
    b1, b2 = _threefry2x32(key, counts)
    if dtype == torch.float64:
        # the top 52 of the 64 bits (b1 << 32 | b2) >> 12, formed without
        # leaving the int64 range
        mant = b1.bitwise_left_shift_(32 - (64 - n_mant)).bitwise_or_(b2.bitwise_right_shift_(64 - n_mant))
        floats = mant.bitwise_or_(one_bits).view(torch.float64)
    else:
        # 32-bit word b1 ^ b2; the float32 pattern fits in 31 bits
        mant = b1.bitwise_xor_(b2).bitwise_right_shift_(32 - n_mant)
        floats = mant.bitwise_or_(one_bits).to(torch.int32).view(torch.float32)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    lo, hi = np_dtype(minval), np_dtype(maxval)
    u = (floats - 1.0).mul_(float(hi - lo)).add_(float(lo))
    return u.clamp_min_(float(lo))


def _normals(key, counts: torch.Tensor, dtype) -> torch.Tensor:
    """JAX's ``_normal_real`` at the counters ``counts``: a uniform on
    [nextafter(-1, 0), 1), then sqrt(2) * erfinv."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = _uniforms(key, counts, dtype, lo, 1.0)
    return u.erfinv_().mul_(float(np_dtype(np.sqrt(2.0))))


def threefry_normals(key, shape, dtype=torch.float64, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Counter-based standard normals on the device: ``jax.random.normal(
    key, shape, dtype)`` for ``key = prng_key(seed)``, up to erfinv's
    rounding."""
    return _normals(key, _counts(shape, device), dtype)


@dataclass
class SobolNormalRng:
    """Scrambled Sobol -> N(0,1); returns (dimension, n) like the reference.

    The points come from the host (scipy, or torch's CPU ``SobolEngine``);
    the inverse CDF runs on ``device`` and the normals come back as numpy.
    """

    seed: int
    fast_forward: int = 0
    backend: str = "scipy"  # "scipy" | "torch" (RiskFlow parity)
    dtype: type = np.float64
    device: str = DEFAULT_DEVICE

    def draw_uniforms(self, dimension: int, n: int) -> np.ndarray:
        if self.backend == "torch":
            engine = torch.quasirandom.SobolEngine(dimension=dimension, scramble=True, seed=self.seed)
            if self.fast_forward > 0:
                engine.fast_forward(self.fast_forward)
            return engine.draw(n, dtype=torch.float64).numpy().astype(self.dtype)
        from scipy.stats import qmc

        engine = qmc.Sobol(d=dimension, scramble=True, seed=self.seed)
        if self.fast_forward > 0:
            engine.fast_forward(self.fast_forward)
        return engine.random(n).astype(self.dtype)

    def draw_normals(self, dimension: int, n: int) -> np.ndarray:
        """(dimension, n) standard normals (rng.py:26-44)."""
        dev = resolve_device(self.device)
        sobol = self.draw_uniforms(dimension, n)  # (n, dimension)
        eps = np.finfo(self.dtype).eps
        u = 0.5 + (1.0 - eps) * (sobol - 0.5)
        z = norm_icdf(torch.as_tensor(u, device=dev)).cpu().numpy()
        return np.ascontiguousarray(z.T)


def _bit_reverse_u32(x: torch.Tensor) -> torch.Tensor:
    """Bitwise reversal of uint32 words held in int64 (5 masked swaps)."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def _gray_codes(n: int, fast_forward: int, device) -> torch.Tensor:
    idx = torch.arange(fast_forward, fast_forward + n, dtype=torch.int64,
                       device=resolve_device(device)) & _M32
    return idx ^ (idx >> 1)


def sobol1d_uniforms(n: int, fast_forward: int = 0, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Dimension-1 Sobol (= van der Corput base 2) points on the device.

    Unscrambled: point i is the radical inverse of gray(i), a uint32 bit
    reversal, so ``fast_forward`` is an offset of the counter.
    """
    return _bit_reverse_u32(_gray_codes(n, fast_forward, device)).to(torch.float64) * (0.5 ** 32)


def _eps_shifted_ndtri(u: torch.Tensor) -> torch.Tensor:
    eps = torch.finfo(torch.float64).eps
    return torch.special.ndtri(0.5 + (1.0 - eps) * (u - 0.5))


def sobol1d_normals(n: int, fast_forward: int = 0, device=DEFAULT_DEVICE) -> torch.Tensor:
    """N(0,1) from :func:`sobol1d_uniforms` with the RiskFlow eps-shift
    away from {0, 1} before the inverse CDF."""
    return _eps_shifted_ndtri(sobol1d_uniforms(n, fast_forward, device))


def sobol_direction_matrix(dimension: int) -> np.ndarray:
    """(dimension, n_bits) uint32 Sobol direction integers.

    Seeded from scipy's Joe-Kuo table; falls back to a tiny built-in d=1
    table if the private attribute moves in a future scipy.
    """
    try:
        from scipy.stats import qmc

        sv = np.asarray(qmc.Sobol(d=dimension, scramble=False)._sv)
        return sv.astype(np.uint32)
    except Exception:
        if dimension != 1:
            raise
        bits = 30
        return (np.uint32(1) << (bits - 1 - np.arange(bits, dtype=np.uint32)))[None, :]


def sobol_uniforms(n: int, dimension: int, fast_forward: int = 0, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(n, dimension) unscrambled Sobol points on the device.

    Gray-code construction: point k is the XOR of the direction integers
    selected by the bits of gray(k), one XOR step per bit of the direction
    matrix. Matches scipy's ``qmc.Sobol(scramble=False)``; ``fast_forward``
    is a counter offset.
    """
    gray = _gray_codes(n, fast_forward, device)
    sv = torch.as_tensor(sobol_direction_matrix(dimension).astype(np.int64), device=gray.device)
    n_bits = sv.shape[1]
    acc = torch.zeros((n, dimension), dtype=torch.int64, device=gray.device)
    for j in range(n_bits):
        bit = (gray >> j) & 1
        acc ^= bit[:, None] * sv[None, :, j]
    # scipy scales points by 2^-bits with bits == sv.shape[1]
    return acc.to(torch.float64) * (0.5 ** int(n_bits))


def sobol_normals(n: int, dimension: int, fast_forward: int = 0, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(n, dimension) N(0,1) via the RiskFlow eps-shift + inverse CDF."""
    return _eps_shifted_ndtri(sobol_uniforms(n, dimension, fast_forward, device))
