"""Prefill attention: the wrapper of the CUDA kernel
``csrc/flash_attention.cu``, the counterpart of
``repro.kernels.flash_attention``.

q (B, H, S, hd); k, v (B, KV, T, hd), H a multiple of KV, q head h reading
kv head h // (H / KV); float32 or bfloat16, all three alike.  Softmax in
float32 with scale hd**-0.5; ``causal`` lets query position i see key
positions j <= i (both counted from 0, so S may differ from T).  Returns
(B, H, S, hd) in q's dtype.

Dispatch is by the tensors' device: on the CPU the plain version
``ref.flash_attention_ref`` runs; on a CUDA tensor the kernel launches
(hd of 32, 64 or 128) or the wrapper raises.  ``LAUNCHES`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: head widths the kernel is built for (a template parameter each)
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last reset
LAUNCHES = 0


def check_heads(q, k, v, q_ndim: int) -> None:
    """The checks shared with ``decode_attention``: tensors of one dtype
    (float32 or bfloat16) on one device, contiguous, ``k`` and ``v`` of
    one shape (B, KV, T, hd), q's batch and width matching, H a multiple
    of KV."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; q, k and v must share "
                            f"one dtype of {DTYPES}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.ndim != q_ndim or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not q {q_ndim}-d and k, v "
                         f"(B, KV, T, hd)")
    B, H, hd = q.shape[0], q.shape[1], q.shape[-1]
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head width")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")


def flash_attention(q, k, v, *, causal: bool = True):
    """Prefill attention (see the module docstring)."""
    global LAUNCHES
    check_heads(q, k, v, 4)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"hd={hd}: the kernel is built for {HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build

    fn = build.launcher("flash_attention", "flash_attention",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9
                        + (ctypes.c_void_p,))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, H, KV, S, T, hd, int(q.dtype == torch.bfloat16),
                   int(causal), *build.device_and_stream(q)),
                "flash_attention")
    LAUNCHES += 1
    return out
