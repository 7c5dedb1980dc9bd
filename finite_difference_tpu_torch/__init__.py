"""PyTorch/CUDA port of ``finite_difference_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``models/pde/``, ``models/analytic/``, ``ops/``, ``serving/``) so each
module has an obvious counterpart, and imports neither ``jax`` nor
anything of ``finite_difference_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card, the default device raises instead of falling back to the CPU.
Every TPU kernel of the JAX package has a hand-written CUDA counterpart,
in float and double, built on first use by
:mod:`finite_difference_tpu_torch.kernels`: the SPIKE march, European and
American, and its double-float twin (``csrc/spike_march.cu``), the fused
march with Hillis–Steele scans (``csrc/hs_march.cu``) and the fused march
with cyclic reduction (``csrc/cr_march.cu``). The host batch builder's C++
library (:mod:`finite_difference_tpu_torch.native`) is built by ``g++`` on
first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
