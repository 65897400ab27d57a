"""Derivative streams, residuals and their kernels (port of ``pinns_tpu.ops``)."""
