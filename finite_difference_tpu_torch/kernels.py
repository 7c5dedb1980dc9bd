"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` exposes a plain C interface:

- ``spike_march.cu``, the SPIKE march (K1, K1a, K2): one kernel in two
  branches, European and American (Ikonen–Toivanen), each in float and
  double (``spike_march[_american]_{f32,f64}``), at one warp per trade for
  P <= 32 and P/32 warps for P = 64 and 128, and its occupancy query
  (:func:`spike_resident_trades`);
- ``hs_march.cu``, the fused march with Hillis–Steele scans (K3,
  ``hs_march_{f32,f64}``, one warp per trade up to 1024 nodes, one block
  per trade above: :func:`hs_block`), and its occupancy query
  (:func:`hs_resident_trades`);
- ``cr_march.cu``, the fused march with cyclic reduction (K4,
  ``cr_march_{f32,f64}``, one warp per trade), and its occupancy query
  (:func:`cr_resident_trades`);
- ``ki_parity.cu``, a barrier request's knock-in parity
  (``ki_parity_f64``, one thread per knock-in row: :func:`ki_parity_cuda`).

On first use of any of them, every source not built yet is compiled by
``nvcc`` (no PyTorch headers, so a build takes seconds) into
``build/torch_kernels/`` at the root of the checkout, under a name keyed
by the source and flags, and loaded with ``ctypes``: :func:`build`
compiles the missing sources at once, one ``nvcc`` each, all started
together, so a fresh checkout pays the longest build and not their sum.
Pointers and the stream go over as ``c_void_p``. Nothing here runs at
import time: the CPU tests import this module on machines with no ``nvcc``
and no card.

The launch wrappers check device, dtype, shape and contiguity, launch on
PyTorch's current stream, raise when the C function reports a CUDA error,
and add one to :data:`launch_counts` under the C function's name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {name: CSRC / f"{name}.cu" for name in ("spike_march", "hs_march", "cr_march", "ki_parity")}
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
# the C functions of each library, with the argument types after their pointers
_SPIKE_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_FUNCTIONS = {
    "spike_march": {
        f"spike_march{branch}_{dt}": _SPIKE_ARGS + ([ctypes.c_void_p] * 3 if branch else [])
        for branch in ("", "_american") for dt in _DTYPE_TAG.values()
    },
    "hs_march": {
        f"hs_march_{dt}": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for dt in _DTYPE_TAG.values()
    },
    "cr_march": {
        f"cr_march_{dt}": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        for dt in _DTYPE_TAG.values()
    },
    "ki_parity": {"ki_parity_f64": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]},
}

# C functions that launch nothing (not counted)
_QUERIES = {
    "spike_march": {"spike_march_occupancy": [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]},
    "hs_march": {"hs_march_occupancy": [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]},
    "cr_march": {"cr_march_occupancy": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]},
}

launch_counts: Dict[str, int] = {name: 0 for fns in _FUNCTIONS.values() for name in fns}

MAX_SMEM = 232448  # 227 KB, the most shared memory one block may use

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")
    return nvcc


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (or will be) built."""
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> str:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, all started together. Returns the compilers' output
    (register and shared-memory use from ``-Xptxas -v``), empty when there
    was nothing to build; raises on failure, after every compiler ended."""
    todo = [n for n in (SOURCES if names is None else names) if not library_path(n).exists()]
    if not todo:
        return ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, out, tmp, proc))
    logs, failed = [], []
    for name, out, tmp, proc in jobs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {SOURCES[name].name}:\n{text}")
            continue
        os.replace(tmp, out)
        logs.append(f"{SOURCES[name].name}:\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "\n".join(logs)


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            build()
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes in {**_FUNCTIONS[name], **_QUERIES.get(name, {})}.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def _raise_on(kind: str, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(_LIBS[kind], f"{kind}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {rc})")


def _check(kind: str, name: str, x: torch.Tensor, shape: tuple, like: torch.Tensor) -> None:
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(
            f"{kind}: {name} is {x.dtype} on {x.device}, "
            f"expected {like.dtype} on {like.device}"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"{kind}: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{kind}: {name} must be contiguous")


def _check_device(kind: str, v: torch.Tensor) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"{kind}_cuda needs CUDA tensors, got {v.device}")
    if v.dtype not in _DTYPE_TAG:
        raise TypeError(f"{kind}_cuda supports float32 and float64, got {v.dtype}")


def _launch(prep, t: int, v: torch.Tensor, edges: torch.Tensor, k0: int, k1: int, lam=None):
    """Check the operands of one segment's march and launch the kernel of
    the prep's branch; returns (v, edges[, lam]) new tensors."""
    _check_device("spike_march", v)
    B, n_pad = v.shape
    m, P = prep.m, prep.P
    n_sched = prep.tau.shape[1]
    if not ((1 <= P <= 32 or P in (64, 128)) and n_pad == m * P and 0 <= k0 < k1 <= n_sched):
        raise ValueError(f"spike_march_cuda: bad shape P={P} m={m} n_pad={n_pad} steps=[{k0}, {k1})")
    args = {
        "trade": (prep.trade, (B, 13)),
        "coef": (prep.coef[t], (B, 7)),
        "fields": (prep.fields[t], (B, 5, 2, m)),
        "iface": (prep.iface[t], (B, 8, P)),
        "tau": (prep.tau, (B, n_sched)),
        "mon": (prep.mon, (B, n_sched)),
        "v": (v, (B, n_pad)),
        "edges": (edges, (B, 2)),
    }
    tail = {}
    if prep.american:
        tail = {"payoff": (prep.v0, (B, n_pad)), "lam": (lam, (B, n_pad))}
    for name, (x, shape) in {**args, **tail}.items():
        _check("spike_march", name, x, shape, v)
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
    lib = _lib("spike_march")
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = getattr(lib, name)(
            *(x.data_ptr() for x, _ in args.values()),
            v_out.data_ptr(), e_out.data_ptr(),
            B, n_pad, m, P, prep.il, k0, k1 - k0, n_sched, stream, *extra,
        )
    _raise_on("spike_march", name, rc)
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


def spike_resident_trades(prep) -> int:
    """Trades of ``prep``'s march resident per SM on the current card at the
    prep's P (one warp per trade for P <= 32, else P/32 warps), from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (registers, shared
    memory and threads of the kernel as built)."""
    _check_device("spike_march", prep.v0)
    lib = _lib("spike_march")
    out = ctypes.c_int(0)
    n_pad = prep.m * prep.P
    with torch.cuda.device(prep.v0.device):
        rc = lib.spike_march_occupancy(
            int(prep.american), int(prep.v0.dtype == torch.float64), n_pad, prep.m, prep.P,
            ctypes.byref(out),
        )
    _raise_on("spike_march", "spike_march_occupancy", rc)
    return out.value


def _fused_launch(kind: str, prep, solver_shape: tuple, shape_args: tuple) -> torch.Tensor:
    """Check the operands of one fused march (a ``models.pde.fused.FusedPrep``)
    and launch ``<kind>_{f32,f64}`` over all its steps; returns V (B, N)."""
    v0 = prep.v0
    _check_device(kind, v0)
    B, N = v0.shape
    n_steps = prep.tau.shape[1]
    if not 0 <= prep.n_rann <= n_steps:
        raise ValueError(f"{kind}_cuda: n_rann={prep.n_rann} outside [0, {n_steps}]")
    args = {
        "trade": (prep.trade, (B, 9)),
        "coef": (prep.coef, (2, B, 5)),
        "solver": (prep.solver, solver_shape),
        "omask": (prep.omask, (B, N)),
        "tau": (prep.tau, (B, n_steps)),
        "mon": (prep.mon, (B, n_steps)),
        "v0": (v0, (B, N)),
    }
    for name, (x, shape) in args.items():
        _check(kind, name, x, shape, v0)
    v_out = torch.empty_like(v0)
    if B == 0:
        return v_out
    name = f"{kind}_{_DTYPE_TAG[v0.dtype]}"
    lib = _lib(kind)
    with torch.cuda.device(v0.device):
        stream = torch.cuda.current_stream(v0.device).cuda_stream
        rc = getattr(lib, name)(
            *(x.data_ptr() for x, _ in args.values()), v_out.data_ptr(),
            B, N, *shape_args, n_steps, prep.n_rann, stream,
        )
    _raise_on(kind, name, rc)
    launch_counts[name] += 1
    return v_out


HS_WARP_MAX_NODES = 1024
HS_TRADES_PER_BLOCK = 4


def hs_block(n_nodes: int):
    """(design, rows per thread, threads per block) of the scan march, as
    ``csrc/hs_march.cu``'s launch rule chooses them from N alone:

    - ``"warp"`` for N <= :data:`HS_WARP_MAX_NODES`: one warp per trade,
      :data:`HS_TRADES_PER_BLOCK` trades per block, each lane owning R rows,
      the least power of two with 32 R >= N (1 ... 32);
    - ``"block"`` above: one block per trade, the fewest rows (1, 2 or 4)
      that keep a block at <= 256 threads, else 4 rows; at most 1024
      threads, so N <= 4096.
    """
    if n_nodes <= HS_WARP_MAX_NODES:
        rows = 1
        while 32 * rows < n_nodes:
            rows *= 2
        return "warp", rows, 32 * HS_TRADES_PER_BLOCK
    per_rows = lambda rows: -(-n_nodes // rows)  # threads that own a row
    rows = 1
    while rows < 4 and per_rows(rows) > 256:
        rows *= 2
    return "block", rows, (per_rows(rows) + 31) // 32 * 32


def hs_march_cuda(prep) -> torch.Tensor:
    """Launch the fused march with Hillis–Steele scans (``csrc/hs_march.cu``)
    over all steps of ``prep`` (``models.pde.fused.prepare_fused``): one
    warp per trade up to 1024 nodes, one block per trade above
    (:func:`hs_block`). Returns V (B, N), a new tensor; 3 <= N <= 4096."""
    B, N = prep.v0.shape
    if N < 3 or hs_block(N)[2] > 1024:
        raise ValueError(f"hs_march_cuda takes 3 <= N <= 4096 nodes, got {N}")
    return _fused_launch("hs_march", prep, (2, 3, B, N), ())


def hs_resident_trades(prep) -> int:
    """Trades of ``prep``'s scan march resident per SM on the current card
    in the one-warp design (N <= 1024), from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (registers, shared
    memory and threads of the kernel as built)."""
    _check_device("hs_march", prep.v0)
    if hs_block(prep.v0.shape[1])[0] != "warp":
        raise ValueError(f"hs_resident_trades: the one-warp design takes N <= {HS_WARP_MAX_NODES}")
    lib = _lib("hs_march")
    out = ctypes.c_int(0)
    with torch.cuda.device(prep.v0.device):
        rc = lib.hs_march_occupancy(int(prep.v0.dtype == torch.float64), prep.v0.shape[1],
                                    ctypes.byref(out))
    _raise_on("hs_march", "hs_march_occupancy", rc)
    return out.value


CR_TRADES_PER_BLOCK = 4


def cr_smem_bytes(n_nodes: int, element_size: int) -> int:
    """Shared memory of one trade of the CR march (``csrc/cr_march.cu``):
    the interior value row (n = N-2 values), the reduced buffers of the
    levels of more than 32 rows after the first (n - 64 values; none for
    n <= 64, whose levels all run in registers), both theta sets' level
    scalars (32 per level) and per set the reciprocals of each level's
    three be classes and of b_final."""
    n = n_nodes - 2
    n_levels = n.bit_length() - 1
    l_deep = max(0, n_levels - 6)
    return (2 * n - (n >> l_deep) + 2 * n_levels * 16 + 2 * (3 * n_levels + 1)) * element_size


def cr_block(n_nodes: int, element_size: int):
    """(trades per block, shared bytes per block) of the CR march, as
    ``csrc/cr_march.cu`` chooses them: one warp per trade, 4 trades per
    block, halved while the block's shared memory passes 227 KB; None when
    even one trade does not fit."""
    per_trade = cr_smem_bytes(n_nodes, element_size)
    t = CR_TRADES_PER_BLOCK
    while t > 1 and t * per_trade > MAX_SMEM:
        t //= 2
    return (t, t * per_trade) if t * per_trade <= MAX_SMEM else None


def _cr_levels(n_nodes: int) -> int:
    """log2 (N-2), raising unless N-2 is a power of two >= 2 whose march
    fits one block's shared memory."""
    n = n_nodes - 2
    if n < 2 or n & (n - 1):
        raise ValueError(f"cr_march_cuda: n_nodes - 2 must be a power of two (at least 2), got {n}")
    return n.bit_length() - 1


def cr_march_cuda(prep) -> torch.Tensor:
    """Launch the fused march with cyclic reduction (``csrc/cr_march.cu``)
    over all steps of ``prep`` (``models.pde.cr.prepare_cr``): one warp per
    trade. Returns V (B, N), a new tensor; N - 2 must be a power of two
    >= 2 and one trade's shared memory (:func:`cr_smem_bytes`) at most 227 KB."""
    B, N = prep.v0.shape
    n_levels = _cr_levels(N)
    if cr_block(N, prep.v0.element_size()) is None:
        raise ValueError(f"cr_march_cuda: N={N} needs more than 227 KB of shared memory per trade")
    return _fused_launch("cr_march", prep, (2, B, n_levels, 16), (n_levels,))


def cr_resident_trades(prep) -> int:
    """Trades of ``prep``'s CR march resident per SM on the current card,
    from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (registers,
    shared memory and threads of the kernel as built)."""
    _check_device("cr_march", prep.v0)
    N = prep.v0.shape[1]
    n_levels = _cr_levels(N)
    lib = _lib("cr_march")
    out = ctypes.c_int(0)
    with torch.cuda.device(prep.v0.device):
        rc = lib.cr_march_occupancy(int(prep.v0.dtype == torch.float64), N, n_levels,
                                    ctypes.byref(out))
    _raise_on("cr_march", "cr_march_occupancy", rc)
    return out.value


KI_OUTPUTS = ("price", "delta", "gamma", "vega", "theta")


def ki_parity_cuda(stack: torch.Tensor, keys, rows: torch.Tensor, fields: torch.Tensor) -> None:
    """Launch the knock-in parity (``csrc/ki_parity.cu``) over a request's
    (K, B) float64 ``stack`` of outputs, whose row i is output ``keys[i]``
    (of :data:`KI_OUTPUTS`; ``price`` among them): the columns ``rows``
    ((n,) int64, distinct, in [0, B)) hold knock-out legs and are overwritten with
    the knock-in trades' price and greeks from the (8, n) float64 vanilla
    fields (``serving.service.KI_FIELDS``). One launch on the stack's
    card, none for n = 0; nothing is copied and nothing waits."""
    if stack.device.type != "cuda" or stack.dtype != torch.float64 or stack.dim() != 2:
        raise ValueError(f"ki_parity_cuda: the stack must be a 2-D float64 CUDA tensor, "
                         f"got {stack.dtype} {tuple(stack.shape)} on {stack.device}")
    K, B = stack.shape
    n = rows.shape[0]
    keys = list(keys)
    at = [keys.index(k) if k in keys else -1 for k in KI_OUTPUTS]
    if at[0] < 0 or sorted(i for i in at if i >= 0) != list(range(K)):
        raise ValueError(f"ki_parity_cuda: keys {keys!r} do not name the {K} rows of the stack")
    if rows.dtype != torch.int64 or rows.device != stack.device or tuple(rows.shape) != (n,):
        raise ValueError(f"ki_parity_cuda: rows must be (n,) int64 on {stack.device}")
    _check("ki_parity", "fields", fields, (8, n), stack)
    for x in (stack, rows):
        if not x.is_contiguous():
            raise ValueError("ki_parity: the stack and the rows must be contiguous")
    if n == 0:
        return
    lib = _lib("ki_parity")
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        rc = lib.ki_parity_f64(fields.data_ptr(), rows.data_ptr(), stack.data_ptr(), n, B, *at,
                               stream)
    _raise_on("ki_parity", "ki_parity_f64", rc)
    launch_counts["ki_parity_f64"] += 1
