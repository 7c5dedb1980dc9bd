"""Batched numerical primitives on torch tensors (counterpart of ``finite_difference_tpu.ops``)."""
