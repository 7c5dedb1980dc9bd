"""PyTorch/CUDA port of ``finite_difference_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``models/pde/``, ``ops/``) so each module has an obvious counterpart, and
imports neither ``jax`` nor anything of ``finite_difference_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card, the default device raises instead of falling back to the CPU.
The TPU kernels on the ported paths (the SPIKE march, European and
American, and its double-float twin) are one hand-written CUDA kernel,
``csrc/spike_march.cu``, in float and double, built on first use by
:mod:`finite_difference_tpu_torch.kernels`. The host batch builder's C++
library (:mod:`finite_difference_tpu_torch.native`) is built by ``g++`` on
first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
