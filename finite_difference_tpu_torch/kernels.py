"""Build, load and launch the port's hand-written CUDA kernel.

The source ``csrc/spike_march.cu`` exposes a plain C interface. On first
use it is compiled by ``nvcc`` (no PyTorch headers, so a build takes
seconds) into ``build/torch_kernels/`` at the root of the checkout, under a
name keyed by the source and flags, and loaded with ``ctypes``. Pointers
and the stream go over as ``c_void_p``. Nothing here runs at import time:
the CPU tests import this module on machines with no ``nvcc`` and no card.

The source holds one kernel in two branches, European and American
(Ikonen–Toivanen), each instantiated in float and double. The launch
wrappers check device, dtype, shape and contiguity, launch on PyTorch's
current stream, raise when the C function reports a CUDA error, and add one
to :data:`launch_counts` under ``spike_march[_american]_{f32,f64}``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "spike_march.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: Dict[str, int] = {
    f"spike_march{branch}_{dt}": 0 for branch in ("", "_american") for dt in ("f32", "f64")
}
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel is built on first use")
    return nvcc


def library_path() -> Path:
    """Where the shared library of ``csrc/spike_march.cu`` is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libspike_march_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernel unless it is built already. Returns the compiler's
    output (register and shared-memory use from ``-Xptxas -v``), empty when
    there was nothing to build; raises on failure."""
    out = library_path()
    if out.exists():
        return ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            head = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            for name in launch_counts:
                fn = getattr(lib, name)
                fn.argtypes = head + ([ctypes.c_void_p] * 3 if "american" in name else [])
                fn.restype = ctypes.c_int
            lib.spike_march_error_string.argtypes = [ctypes.c_int]
            lib.spike_march_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(name: str, x: torch.Tensor, shape: tuple, like: torch.Tensor) -> None:
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(
            f"spike_march: {name} is {x.dtype} on {x.device}, "
            f"expected {like.dtype} on {like.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"spike_march: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"spike_march: {name} must be contiguous")


def _launch(prep, t: int, v: torch.Tensor, edges: torch.Tensor, k0: int, k1: int, lam=None):
    """Check the operands of one segment's march and launch the kernel of
    the prep's branch; returns (v, edges[, lam]) new tensors."""
    if v.device.type != "cuda":
        raise ValueError(f"spike_march_cuda needs CUDA tensors, got {v.device}")
    if v.dtype not in _DTYPE_TAG:
        raise TypeError(f"spike_march_cuda supports float32 and float64, got {v.dtype}")
    B, n_pad = v.shape
    m, P = prep.m, prep.P
    n_sched = prep.tau.shape[1]
    if not (1 <= P <= 32 and n_pad == m * P and 0 <= k0 < k1 <= n_sched):
        raise ValueError(f"spike_march_cuda: bad shape P={P} m={m} n_pad={n_pad} steps=[{k0}, {k1})")
    args = {
        "trade": (prep.trade, (B, 11)),
        "coef": (prep.coef[t], (B, 7)),
        "fields": (prep.fields[t], (5, B, n_pad)),
        "rinv": (prep.rinv[t], (B, 2 * P, 2 * P)),
        "omask": (prep.omask, (B, n_pad)),
        "tau": (prep.tau, (B, n_sched)),
        "mon": (prep.mon, (B, n_sched)),
        "v": (v, (B, n_pad)),
        "edges": (edges, (B, 2)),
    }
    tail = {}
    if prep.american:
        tail = {"payoff": (prep.v0, (B, n_pad)), "lam": (lam, (B, n_pad))}
    for name, (x, shape) in {**args, **tail}.items():
        _check(name, x, shape, v)
    v_out = torch.empty_like(v)
    e_out = torch.empty_like(edges)
    outs = (v_out, e_out)
    extra = ()
    if prep.american:
        lam_out = torch.empty_like(lam)
        outs += (lam_out,)
        extra = (prep.v0.data_ptr(), lam.data_ptr(), lam_out.data_ptr())
    if B == 0:
        return outs
    name = f"spike_march{'_american' if prep.american else ''}_{_DTYPE_TAG[v.dtype]}"
    lib = _lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = getattr(lib, name)(
            *(x.data_ptr() for x, _ in args.values()),
            v_out.data_ptr(), e_out.data_ptr(),
            B, n_pad, m, P, prep.il, k0, k1 - k0, n_sched, stream, *extra,
        )
    if rc != 0:
        msg = lib.spike_march_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {rc})")
    launch_counts[name] += 1
    return outs


def spike_march_cuda(prep, t: int, v: torch.Tensor, edges: torch.Tensor, k0: int, k1: int):
    """Launch the European SPIKE march (``csrc/spike_march.cu``) for steps
    [k0, k1) with solver set ``t`` of ``prep`` (a ``models.pde.spike.SpikePrep``).

    Returns new (v, edges) tensors; the kernel reads ``v``/``edges`` and
    allocates nothing itself.
    """
    if prep.american:
        raise ValueError("spike_march_cuda: an American prep takes spike_march_american_cuda")
    return _launch(prep, t, v, edges, k0, k1)


def spike_march_american_cuda(
    prep, t: int, v: torch.Tensor, edges: torch.Tensor, lam: torch.Tensor, k0: int, k1: int
):
    """Launch the American (Ikonen–Toivanen) SPIKE march for steps [k0, k1)
    with solver set ``t`` of an American ``prep``, from the multiplier
    ``lam`` (B, n_pad). The exercise target is ``prep.v0``, the payoff.

    Returns new (v, edges, lam) tensors.
    """
    if not prep.american:
        raise ValueError("spike_march_american_cuda needs an American prep")
    return _launch(prep, t, v, edges, k0, k1, lam)
