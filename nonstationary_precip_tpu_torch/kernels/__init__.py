"""Counterpart of nonstationary_precip_tpu.kernels."""
