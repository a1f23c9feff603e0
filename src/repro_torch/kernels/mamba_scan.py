"""Mamba1 selective scan: the wrapper of the CUDA kernel
``csrc/mamba_scan.cu``, the counterpart of ``repro.kernels.mamba_scan``.

u, dt (B, L, D); Bm, Cm (B, L, N); A (D, N), any float dtype (scanned in
float32).  From h_0 = 0: ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) *
B_t`` and ``y_t = h_t . C_t``.  Returns y (B, L, D) float32.

Dispatch is by the tensors' device: on the CPU the plain version
``ref.mamba_scan_ref`` runs; on a CUDA tensor the kernel launches (N of 4,
8 or 16) or the wrapper raises.  ``LAUNCHES`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: state sizes the kernel is built for (a template parameter each)
STATE_SIZES = (4, 8, 16)

#: kernel launches since the last reset
LAUNCHES = 0


def mamba_scan(u, dt, Bm, Cm, A):
    """The selective scan from a zero state (see the module docstring)."""
    global LAUNCHES
    for name, t in (("u", u), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if u.ndim != 3 or dt.shape != u.shape or Bm.ndim != 3 or \
            Cm.shape != Bm.shape or Bm.shape[:2] != u.shape[:2] or \
            A.shape != (u.shape[2], Bm.shape[2]):
        raise ValueError(f"shapes u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, A "
                         f"{tuple(A.shape)} are not (B, L, D) x2, (B, L, N) "
                         f"x2, (D, N)")
    B, L, D = u.shape
    N = Bm.shape[2]
    if u.device.type == "cpu":
        h0 = torch.zeros((B, D, N), dtype=torch.float32)
        return ref.mamba_scan_ref(u, dt, Bm, Cm, A, h0)[0]
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    if N not in STATE_SIZES:
        raise ValueError(f"N={N}: the kernel is built for {STATE_SIZES}")
    u, dt, Bm, Cm, A = (t.to(torch.float32).contiguous()
                        for t in (u, dt, Bm, Cm, A))
    y = torch.empty((B, L, D), dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y
    from repro_torch.kernels import build

    fn = build.launcher("mamba_scan", "mamba_scan",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5
                        + (ctypes.c_void_p,))
    build.check(fn(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   A.data_ptr(), y.data_ptr(), B, L, D, N,
                   *build.device_and_stream(u)), "mamba_scan")
    LAUNCHES += 1
    return y
