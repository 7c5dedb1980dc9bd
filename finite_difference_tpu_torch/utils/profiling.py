"""Profiling and throughput harness (counterpart of
``finite_difference_tpu.utils.profiling``).

- ``trace(logdir)``: context manager around ``torch.profiler`` that writes
  the host and CUDA activity of its body into ``logdir`` (a Chrome /
  TensorBoard trace; the JAX package wraps ``jax.profiler.trace``);
- ``throughput``: items/sec of a call with the device's work forced to
  complete after each call, warm-up (builds, graph captures) excluded.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Trace the body with ``torch.profiler`` (CPU, and CUDA where the
    machine has a card) into ``logdir`` (default: ``torch-trace`` in the
    temporary directory); yields ``logdir``. View with TensorBoard's
    profile plugin or ``chrome://tracing``. The services' and batch
    drivers' spans (:mod:`finite_difference_tpu_torch.tracing`) record
    inside it, as ranges of the trace; their records are cleared on entry
    and kept after the body."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from .. import tracing

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracing.clear()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor leaf of a tensor, a dict, a list or a tuple of them."""
    if torch.is_tensor(out):
        return out
    leaves = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    for leaf in leaves:
        found = _first_tensor(leaf)
        if found is not None:
            return found
    return None


def throughput(
    fn: Callable[[], object],
    items_per_call: int,
    iters: int = 5,
    warmup: int = 1,
) -> Dict[str, float]:
    """items/sec with each call's work forced to completion.

    ``fn`` returns a tensor (or a dict, list or tuple of them). After each
    call the first tensor leaf is waited for: by ``torch.cuda.synchronize()``
    when it lies on the card, else by a host copy (``np.asarray``).
    """

    def _materialize(out):
        leaf = _first_tensor(out)
        if leaf is not None:
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            else:
                np.asarray(leaf.detach())
        return out

    for _ in range(max(warmup, 0)):
        _materialize(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        _materialize(fn())
    elapsed = time.perf_counter() - t0
    per_call = elapsed / iters
    return {
        "seconds_per_call": per_call,
        "items_per_sec": items_per_call / per_call,
        "iters": float(iters),
    }
