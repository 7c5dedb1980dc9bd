"""Native (C++) host batch canonicaliser of the port.

Counterpart of ``finite_difference_tpu.native``: ``fd_native.cpp`` (a copy
of the JAX package's source) builds per-trade grids and time schedules for
large scenario batches. On first use it is compiled by the system ``g++``,
with the JAX package's flags, into ``build/native/`` at the root of the
checkout, under a name keyed by the source and flags, and bound with
ctypes. When no compiler is found, ``available()`` is False and the
callers take their pure-Python loop, as the JAX package does. This is host
code: no device kernel runs here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fd_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build() -> Optional[Path]:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    lib_path = BUILD_DIR / f"libfdnative_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, lib_path)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None

        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8ptr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64ptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

        lib.barrier_log_grids.argtypes = [
            dptr, dptr, dptr, dptr, dptr, dptr, u8ptr, u8ptr,
            ctypes.c_int64, ctypes.c_int64, dptr, dptr,
        ]
        lib.barrier_log_grids.restype = None
        lib.uniform_schedules.argtypes = [
            dptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            dptr, i64ptr, dptr, dptr, dptr, u8ptr,
        ]
        lib.uniform_schedules.restype = None
        lib.american_grids.argtypes = [
            dptr, dptr, dptr, dptr, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_uint8, dptr, dptr, dptr, dptr,
        ]
        lib.american_grids.restype = None
        lib.american_schedules.argtypes = [
            dptr, u8ptr, dptr, dptr, i64ptr,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            dptr, dptr, dptr, dptr, u8ptr, i64ptr,
        ]
        lib.american_schedules.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the C++ library is built and loaded (``g++`` was found)."""
    return _load() is not None


def barrier_log_grids(
    spot_eff, strike, sigma, t_expiry, lower, upper, has_lower, has_upper,
    num_space_nodes: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Vectorised native barrier grid policy: (x_min, dx); None when the
    native library is absent."""
    lib = _load()
    if lib is None:
        return None
    c = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    cu = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.uint8))
    spot_eff = c(spot_eff)
    B = spot_eff.shape[0]
    x_min = np.empty(B)
    dx = np.empty(B)
    lib.barrier_log_grids(
        spot_eff, c(strike), c(sigma), c(t_expiry), c(lower), c(upper),
        cu(has_lower), cu(has_upper), B, int(num_space_nodes), x_min, dx,
    )
    return x_min, dx


def _ragged(rows, width: int):
    """Flatten per-trade sequences: (offsets (B+1,), columns (total,) each)."""
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    for i, row in enumerate(rows):
        offsets[i + 1] = offsets[i] + len(row)
    cols = np.empty((int(offsets[-1]), width), dtype=np.float64)
    for i, row in enumerate(rows):
        if len(row):
            cols[offsets[i] : offsets[i + 1]] = np.asarray(row, dtype=np.float64).reshape(-1, width)
    return offsets, [np.ascontiguousarray(cols[:, k]) for k in range(width)]


def uniform_schedules(
    t_expiry, n_steps: int, rannacher: int, monitor_times_ragged,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Vectorised native uniform schedules; None when the native library is
    absent. ``monitor_times_ragged``: per trade, a sequence of monitor
    times. Returns (dt, theta, tau_next, monitor), each (B, n_steps)."""
    lib = _load()
    if lib is None:
        return None
    t_expiry = np.ascontiguousarray(np.asarray(t_expiry, dtype=np.float64))
    B = t_expiry.shape[0]
    offsets, (flat,) = _ragged(monitor_times_ragged, 1)
    dt = np.empty((B, n_steps))
    theta = np.empty((B, n_steps))
    tau_next = np.empty((B, n_steps))
    monitor = np.empty((B, n_steps), dtype=np.uint8)
    lib.uniform_schedules(
        t_expiry, B, int(n_steps), int(rannacher), flat, offsets,
        dt, theta, tau_next, monitor,
    )
    return dt, theta, tau_next, monitor


def american_batches(
    spot, strike, sigma, t_expiry, restart_at_div, dividends_ragged,
    n_steps: int, rannacher: int, num_space_nodes: int, s_max_mult: float,
    snap: bool,
):
    """Vectorised native American grids and segmented dividend schedules;
    None when the native library is absent.

    ``dividends_ragged``: per trade, a sequence of (tau_from_expiry, amount)
    pairs. ``restart_at_div``: per trade, whether Rannacher restarts after
    each dividend (the American pricer's call-leg policy). Returns a dict of
    arrays bit-identical to the per-trade loop of
    ``models.pde.batch.build_american_batch``. Raises ValueError when a
    trade's segment steps exceed ``n_steps``, as the loop does.
    """
    grids = american_grids(spot, strike, sigma, t_expiry, num_space_nodes, s_max_mult, snap)
    if grids is None:
        return None
    out = dict(grids, **american_schedules(t_expiry, restart_at_div, dividends_ragged, n_steps, rannacher))
    bad = np.nonzero(out.pop("status"))[0]
    if bad.size:
        raise ValueError(f"segment steps exceeded n_time_steps (trade {int(bad[0])})")
    return out


def american_grids(spot, strike, sigma, t_expiry, num_space_nodes: int, s_max_mult: float, snap: bool):
    """The grid half of :func:`american_batches` (the same C++ expressions):
    a dict of ``x_min``, ``dx``, ``spot`` and ``strike`` (snapped onto the
    grid when ``snap``), each (B,); None when the native library is absent."""
    lib = _load()
    if lib is None:
        return None
    c = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    cols = [c(a) for a in (spot, strike, sigma, t_expiry)]
    B = cols[0].shape[0]
    if any(a.shape != (B,) for a in cols):
        raise ValueError("american_grids: spot, strike, sigma and t_expiry need one value per trade")
    out = {k: np.empty(B) for k in ("x_min", "dx", "spot", "strike")}
    lib.american_grids(
        *cols, B, int(num_space_nodes), float(s_max_mult),
        ctypes.c_uint8(1 if snap else 0), out["x_min"], out["dx"], out["spot"], out["strike"],
    )
    return out


def american_schedules(t_expiry, restart_at_div, dividends_ragged, n_steps: int, rannacher: int):
    """The schedule half of :func:`american_batches` (the same C++
    expressions): a dict of ``dt``, ``theta``, ``tau_next``, ``div_amount``
    and ``reset_lambda``, each (B, n_steps), and ``status`` (B,), nonzero
    where a trade's segment steps exceed ``n_steps`` (its rows are then
    zeros; the caller raises). None when the native library is absent."""
    lib = _load()
    if lib is None:
        return None
    t_expiry = np.ascontiguousarray(np.asarray(t_expiry, dtype=np.float64))
    restart_at_div = np.ascontiguousarray(np.asarray(restart_at_div, dtype=np.uint8))
    B = t_expiry.shape[0]
    if t_expiry.shape != (B,) or restart_at_div.shape != (B,) or len(dividends_ragged) != B:
        raise ValueError("american_schedules: t_expiry, restart_at_div and the dividends need one entry per trade")
    offsets, (div_tau, div_amt) = _ragged(dividends_ragged, 2)
    n = int(n_steps)
    dt, theta, tau_next, div_amount = (np.empty((B, n)) for _ in range(4))
    reset = np.empty((B, n), dtype=np.uint8)
    status = np.empty(B, dtype=np.int64)
    lib.american_schedules(
        t_expiry, restart_at_div, div_tau, div_amt, offsets, B, n, int(rannacher),
        dt, theta, tau_next, div_amount, reset, status,
    )
    return {
        "dt": dt, "theta": theta, "tau_next": tau_next, "div_amount": div_amount,
        "reset_lambda": reset.astype(bool), "status": status,
    }
