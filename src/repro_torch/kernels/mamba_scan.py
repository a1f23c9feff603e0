"""Mamba1 selective scan: the wrapper of the CUDA kernel
``csrc/mamba_scan.cu``, the counterpart of ``repro.kernels.mamba_scan``.

u, dt (B, L, D); Bm, Cm (B, L, N); A (D, N), any float dtype (scanned in
float32).  From h_0 = 0: ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) *
B_t`` and ``y_t = h_t . C_t``.  Returns y (B, L, D) float32, and with
``final_state=True`` also the end state h_L (B, D, N) float32, which the
kernel writes in the pass that writes y (a model's prefill keeps it).

Dispatch is by the tensors' device: on the CPU the plain version
``ref.mamba_scan_ref`` runs; on a CUDA tensor the kernel launches, for any
B, L, D and N, or the wrapper raises.  ``LAUNCHES`` counts the calls that
launched, one a call whatever the plan's passes.

``scan_plan`` chooses the kernel's geometry from the shape and the
card's SM count: how many lanes share a channel's state entries, the
block, the chunk of steps staged at once, the tiles of the state axis,
and whether L is cut into segments across blocks (three passes) or
scanned in one.  With segments, or with several tiles, the wrapper
allocates the workspace the passes share.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ref

#: an H100 block's shared memory at most, 227 KB
MAX_SMEM = 232448
#: the plan keeps a block's shared memory within this, so two blocks fit
#: an SM (228 KB, 1 KB of it reserved a block)
SMEM_BUDGET = 112 * 1024
#: resident warps an SM the plan aims at
WARPS_PER_SM = 16
#: warps a block at most
MAX_WARPS = 8
#: steps a chunk stages at most
MAX_CHUNK = 64
#: steps the kernel scans as a group; a chunk is whole groups
GROUP = 8
#: steps a segment holds at least
MIN_SEGMENT = 16
#: the largest size a launcher's ``int`` argument holds
INT_MAX = 2 ** 31 - 1

#: calls that launched the kernel since the last reset
LAUNCHES = 0


class ScanPlan(NamedTuple):
    """One launch geometry of ``csrc/mamba_scan.cu``."""
    nl: int          # lanes a channel shares (32 / nl channels a warp)
    eg: int          # state entries a lane holds; nl * eg a tile
    warps: int       # warps a block
    chunk: int       # steps staged at once
    tiles: int       # tiles of nl * eg entries that cover N
    segments: int    # blocks along L; 1: one pass, else three
    seg_len: int     # steps of a segment, whole chunks
    passes: int
    smem: int        # bytes of shared memory a block
    blocks: int
    threads: int

    def __str__(self):
        return (f"{self.blocks}x{self.threads} lanes{self.nl}x{self.eg} "
                f"T{self.chunk} S{self.segments}"
                + (f" tiles{self.tiles}" if self.tiles > 1 else "")
                + f" {self.passes}-pass {self.smem} B")


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def smem_bytes(nl: int, eg: int, warps: int, chunk: int) -> int:
    """Shared memory of a block, as the kernel lays it out: dt and u, B and
    C double-buffered, y once: 5 chunk DB + 4 chunk nl eg words, DB =
    warps 32 / nl the block's channels."""
    return 4 * (5 * chunk * warps * (32 // nl) + 4 * chunk * nl * eg)


def make_plan(B: int, L: int, D: int, N: int, *, nl: int, eg: int,
              warps: int, chunk: int, segments: int = 1) -> ScanPlan:
    """The plan of a given geometry, with segments of whole chunks (as few
    chunks a segment as ``segments`` allows)."""
    chunks = -(-L // chunk)
    seg_len = -(-chunks // max(1, min(segments, chunks))) * chunk
    segments = -(-L // seg_len)
    return ScanPlan(nl=nl, eg=eg, warps=warps, chunk=chunk,
                    tiles=-(-N // (nl * eg)), segments=segments,
                    seg_len=seg_len, passes=1 if segments == 1 else 3,
                    smem=smem_bytes(nl, eg, warps, chunk),
                    blocks=B * segments * -(-D // (warps * (32 // nl))),
                    threads=32 * warps)


def scan_plan(B: int, L: int, D: int, N: int, n_sms: int) -> ScanPlan:
    """The launch plan of a (B, L, D, N) scan on a card of ``n_sms`` SMs.

    The state entries of a channel are spread over ``nl`` lanes, ``eg``
    each (4 up to N = 16, 8 above, a tile of at most 256 entries; a larger
    N takes several tiles); y sums them by shuffles.  A block holds 32
    channels (at most ``MAX_WARPS`` warps).  Each thread scans its entries
    serially over a segment of L, staged ``chunk`` steps at a time.  One
    segment reads every input once and takes one exp per (b, t, d, n);
    where that gives fewer than a quarter of the ``WARPS_PER_SM`` warps an
    SM the card wants, L is cut into segments (of ``MIN_SEGMENT`` steps at
    least) across blocks: three passes that read u, dt and B twice and
    take each exp twice, but fill the card."""
    eg = 1 if N <= 4 else 4 if N <= 16 else 8
    nl = min(32, _pow2(-(-max(N, 1) // eg)))
    warps = min(MAX_WARPS, max(1, nl))
    warps_one = B * -(-D // (warps * (32 // nl))) * warps
    target = WARPS_PER_SM * n_sms
    segments = 1
    if 4 * warps_one < target:
        segments = min(-(-target // (2 * warps_one)), -(-L // MIN_SEGMENT))
    chunk = min(MAX_CHUNK, GROUP * -(-L // (GROUP * segments)))
    while chunk > GROUP and smem_bytes(nl, eg, warps, chunk) > SMEM_BUDGET:
        chunk = GROUP * -(-chunk // (2 * GROUP))
    return make_plan(B, L, D, N, nl=nl, eg=eg, warps=warps, chunk=chunk,
                     segments=segments)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mamba_scan(u, dt, Bm, Cm, A, *, final_state: bool = False):
    """The selective scan from a zero state (see the module docstring):
    y, or (y, h_L) with ``final_state``."""
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
        y, h = ref.mamba_scan_ref(u, dt, Bm, Cm, A, h0)
        return (y, h) if final_state else y
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    if max(B, L, D, N) > INT_MAX:
        raise ValueError(f"B={B}, L={L}, D={D}, N={N}: each must fit the "
                         f"launcher's int")
    u, dt, Bm, Cm, A = (t.to(torch.float32).contiguous()
                        for t in (u, dt, Bm, Cm, A))
    y = torch.empty((B, L, D), dtype=torch.float32, device=u.device)
    h = None
    if final_state:
        h = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        # no step: the state stays zero
        return (y, h.zero_()) if final_state else y
    index = u.device.index
    if index is None:
        index = torch.cuda.current_device()
    launch(u, dt, Bm, Cm, A, y, scan_plan(B, L, D, N, _sm_count(index)),
           h=h)
    LAUNCHES += 1
    return (y, h) if final_state else y


def launch(u, dt, Bm, Cm, A, y, plan: ScanPlan, *, h=None) -> None:
    """Run ``plan`` on contiguous float32 CUDA tensors into ``y`` and,
    where ``h`` (B, D, N) is given, the end state into ``h``: the
    workspace where the plan needs one, every launch on the current
    stream.  Counts nothing (``mamba_scan`` does)."""
    from repro_torch.kernels import build

    B, L, D = u.shape
    N = Bm.shape[2]
    ws_h = ws_p = None
    if plan.segments > 1 or plan.tiles > 1:
        ws_h = torch.empty((B, plan.segments, N, D), dtype=torch.float32,
                           device=u.device)
    if plan.segments > 1:
        ws_p = torch.empty_like(ws_h)
    if h is not None and (h.shape != (B, D, N) or h.dtype != torch.float32
                          or not h.is_contiguous() or h.device != u.device):
        raise ValueError(f"h must be a contiguous float32 ({B}, {D}, {N}) "
                         f"tensor on {u.device}")
    fn = build.launcher("mamba_scan", "mamba_scan",
                        (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 11
                        + (ctypes.c_void_p,))
    build.check(fn(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   A.data_ptr(), y.data_ptr(),
                   None if h is None else h.data_ptr(),
                   None if ws_h is None else ws_h.data_ptr(),
                   None if ws_p is None else ws_p.data_ptr(), B, L, D, N,
                   plan.nl, plan.eg, plan.warps, plan.chunk,
                   plan.segments, plan.seg_len,
                   *build.device_and_stream(u)), "mamba_scan")
