"""Decode attention (one token against a cache): the wrapper of the CUDA
kernel ``csrc/decode_attention.cu``, the counterpart of
``repro.kernels.decode_attention``.

q (B, H, hd); k_cache, v_cache (B, KV, T, hd), H a multiple of KV; float32
or bfloat16, all three alike; length (B,) integers, the valid prefix of
each row's cache (past T means T).  Returns (B, H, hd) in q's dtype; a row
with ``length <= 0`` is zeros, as the Pallas kernel gives.

Dispatch is by the tensors' device: on the CPU the plain version
``ref.decode_attention_ref`` runs; on a CUDA tensor the kernel launches
(hd of 32, 64 or 128, at most ``MAX_GROUP`` q heads per kv head) or the
wrapper raises.  The kernel splits the cache into chunks of ``CHUNK`` keys
and writes one float32 partial (max, sum, accumulator) per (row, head,
chunk) to a workspace the wrapper allocates; a second pass in the same
launcher combines them.  ``LAUNCHES`` counts the launcher's calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import check_heads

#: head widths the kernel is built for (a template parameter each)
HEAD_DIMS = (32, 64, 128)
#: keys per block of the first pass
CHUNK = 256
#: q heads per kv head: one warp each, at most 1,024 threads a block
MAX_GROUP = 32

#: launcher calls since the last reset
LAUNCHES = 0


def decode_attention(q, k_cache, v_cache, length):
    """One-token attention over a cache (see the module docstring)."""
    global LAUNCHES
    check_heads(q, k_cache, v_cache, 3)
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    if not isinstance(length, torch.Tensor) or length.shape != (B,) or \
            length.dtype.is_floating_point or length.dtype == torch.bool:
        raise TypeError(f"length must be a ({B},) integer tensor")
    if length.device != q.device:
        raise ValueError(f"length is on {length.device}, q on {q.device}")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, length)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"hd={hd}: the kernel is built for {HEAD_DIMS}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{H // KV} q heads per kv head exceed the "
                         f"kernel's {MAX_GROUP}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build

    length = length.to(torch.int32).contiguous()
    n_chunks = -(-T // CHUNK)
    ws = torch.empty((B, H, n_chunks, 2 + hd), dtype=torch.float32,
                     device=q.device)
    fn = build.launcher("decode_attention", "decode_attention",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8
                        + (ctypes.c_void_p,))
    build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   length.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H,
                   KV, T, hd, int(q.dtype == torch.bfloat16), CHUNK,
                   *build.device_and_stream(q)), "decode_attention")
    LAUNCHES += 1
    return out
