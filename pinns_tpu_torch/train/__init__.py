"""Prediction and metrics (port of ``pinns_tpu.train``; the trainer comes later)."""
