"""Bits proxy for the in-chain rate adaptation (port of
``vlog_tpu/ops/bitproxy.py``): nnz + sum log2(1+|l|) in float32.

The host calibrates one bytes-per-proxy-unit scalar per rung from
realized chain bytes, so device cost and calibration share this formula.
"""

from __future__ import annotations

import torch


def cost_proxy(*level_arrays: torch.Tensor, batch_ndim: int = 0):
    """Reduce every axis except the leading ``batch_ndim``; float32."""
    tot = 0.0
    for a in level_arrays:
        af = a.to(torch.float32).abs()
        dims = tuple(range(batch_ndim, a.dim()))
        tot = tot + torch.sum((af > 0).to(torch.float32) + torch.log2(1.0 + af),
                              dim=dims)
    return tot
