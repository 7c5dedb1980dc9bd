"""PyTorch/CUDA port of ``finite_difference_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``models/pde/``, ``ops/``) so each module has an obvious counterpart, and
imports neither ``jax`` nor anything of ``finite_difference_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card, the default device raises instead of falling back to the CPU.
The one TPU kernel on the ported path (the SPIKE march) is a hand-written
CUDA kernel, ``csrc/spike_march.cu``, built on first use by
:mod:`finite_difference_tpu_torch.kernels`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
