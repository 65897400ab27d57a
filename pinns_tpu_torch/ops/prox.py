"""Proximal operators (port of ``pinns_tpu/ops/prox.py``)."""

from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, threshold) -> torch.Tensor:
    """prox of threshold * ||.||_1: sign(v) * max(|v| - threshold, 0)."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - threshold, min=0.0)
