"""Int8 error-feedback compression, the counterpart of
``repro.optim.compress``: symmetric per-tensor int8 codes whose
quantization error is carried into the next step.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
equal the reference's bit for bit.  The reference's ``compressed_psum``
all-gathers the codes over a pod axis inside ``shard_map``; one card has
no pod axis, so it has no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def init_compression_state(grads_template):
    """Zero float32 residuals shaped like ``grads_template``."""
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads_template)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (codes int8, scale float32)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """Returns (codes, scale, new residual): ``g + err`` is
    ``dequantize_int8(codes, scale)`` plus the new residual."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)
