"""Pricing models (counterpart of ``finite_difference_tpu.models``)."""
