"""Fused gallery ranking: similarity GEMM + masked running top-k.

The wrappers of the CUDA kernels ``csrc/reid_topk.cu`` (camera-masked:
``reid_topk_masked``, ``reid_topk_segments``) and ``csrc/reid_topk_tiles.cu``
(camera x tile masked: ``reid_topk_tiles``), the counterparts of
``repro.kernels.reid_topk``'s entry points.  Query q scores gallery row g
only when ``admit[q, gal_cam[g]]`` (or ``admit_ct[q, gal_ct[g]]``) and the
tags agree (frames for ``reid_topk_masked``, round-scoped segment ids for
the others); rows whose camera or cell is out of range are never
eligible.  Returns (scores (Q, k) float32, idx (Q, k) int32), best first
in the order (score descending, index ascending), with fully masked slots
and slots past G as (NEG_INF, -1).

Dispatch is by the tensors' device: on the CPU the plain version in
``ref.py`` runs; on a CUDA tensor the kernel launches or the wrapper
raises.  ``LAUNCHES`` counts the camera kernel's launches,
``TILE_LAUNCHES`` the tile kernel's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import NEG_INF

MAX_K = 16
MAX_CAMS = 4096
#: the widest cell axis C*T*T of the tile kernel: its packed admit rows
#: (32 x ceil(CT/32) words) beside 13,696 bytes of static shared memory in
#: the 232,448 bytes a block may opt into on an H100 (``csrc/topk.cuh``)
MAX_CELLS = (232448 - 13696) // (4 * 32) * 32

#: camera kernel launches since the last reset (a plain count, never
#: decremented)
LAUNCHES = 0
#: tile kernel launches since the last reset
TILE_LAUNCHES = 0


def _empty(Q: int, k: int, device):
    return (torch.full((Q, k), NEG_INF, dtype=torch.float32, device=device),
            torch.full((Q, k), -1, dtype=torch.int32, device=device))


def _check(queries, q_tag, admit, gallery, gal_cam, gal_tag, k: int,
           names=("admit", "gal_cam")):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    want = {"queries": (queries, torch.float32, 2),
            "q_tag": (q_tag, torch.int32, 1),
            names[0]: (admit, torch.bool, 2),
            "gallery": (gallery, torch.float32, 2),
            names[1]: (gal_cam, torch.int32, 1),
            "gal_tag": (gal_tag, torch.int32, 1)}
    dev = queries.device
    for name, (t, dtype, ndim) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != dtype or t.ndim != ndim:
            raise TypeError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                            f"{t.ndim}-d {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Q, D = queries.shape
    G = gallery.shape[0]
    if q_tag.shape[0] != Q or admit.shape[0] != Q:
        raise ValueError(f"q_tag {tuple(q_tag.shape)} / {names[0]} "
                         f"{tuple(admit.shape)} do not match Q={Q}")
    if gallery.shape[1] != D:
        raise ValueError(f"gallery depth {gallery.shape[1]} != query depth {D}")
    if gal_cam.shape[0] != G or gal_tag.shape[0] != G:
        raise ValueError(f"{names[1]} {tuple(gal_cam.shape)} / gal_tag "
                         f"{tuple(gal_tag.shape)} do not match G={G}")


@functools.cache
def _kernel(source: str, symbol: str):
    """The launcher ``symbol`` of ``csrc/<source>.cu``, built on first use
    (never at import)."""
    from repro_torch.kernels import build

    fn = getattr(build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(source: str, symbol: str, queries, q_tag, admit, gallery,
            gal_cam, gal_tag, k: int):
    """Launch ``symbol`` of ``csrc/<source>.cu`` on the tensors' card and
    stream; the caller counts the launch."""
    Q, D = queries.shape
    G = gallery.shape[0]
    fn = _kernel(source, symbol)
    out_v = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    device = queries.device.index
    if device is None:
        device = torch.cuda.current_device()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = fn(queries.data_ptr(), q_tag.data_ptr(), admit.data_ptr(),
             gallery.data_ptr(), gal_cam.data_ptr(), gal_tag.data_ptr(),
             out_v.data_ptr(), out_i.data_ptr(), Q, G, D, admit.shape[1], k,
             device, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    return out_v, out_i


def _segment_masked_call(queries, q_tag, admit, gallery, gal_cam, gal_tag,
                         k: int):
    global LAUNCHES
    _check(queries, q_tag, admit, gallery, gal_cam, gal_tag, k)
    Q, G = queries.shape[0], gallery.shape[0]
    if Q == 0 or G == 0:
        return _empty(Q, k, queries.device)
    if queries.device.type == "cpu":
        return ref.reid_topk_segments_ref(queries, q_tag, admit, gallery,
                                          gal_cam, gal_tag, k)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    if admit.shape[1] > MAX_CAMS:
        raise ValueError(f"C={admit.shape[1]} cameras exceeds the kernel's "
                         f"{MAX_CAMS}")
    out = _launch("reid_topk", "reid_topk_segment_masked", queries, q_tag,
                  admit, gallery, gal_cam, gal_tag, k)
    LAUNCHES += 1
    return out


def reid_topk_masked(queries, q_frame, admit, gallery, gal_cam, gal_frame,
                     k: int):
    """Segment-masked gallery ranking over one deduplicated embedding batch.

    queries (Q, D) float32; q_frame (Q,) int32 — the content frame each
    query's cursor is on; admit (Q, C) bool; gallery (G, D) float32;
    gal_cam / gal_frame (G,) int32.  Query q scores row g only when
    ``admit[q, gal_cam[g]]`` and ``gal_frame[g] == q_frame[q]``."""
    return _segment_masked_call(queries, q_frame, admit, gallery, gal_cam,
                                gal_frame, k)


def reid_topk_segments(queries, q_seg, admit, gallery, gal_cam, gal_seg,
                       k: int):
    """Consolidated-round ranking: frame tags replaced by round-scoped
    segment ids (an injective per-round relabeling), so the result is
    bit-identical to ``reid_topk_masked`` on the underlying frames."""
    return _segment_masked_call(queries, q_seg, admit, gallery, gal_cam,
                                gal_seg, k)


def reid_topk_tiles(queries, q_tag, admit_ct, gallery, gal_ct, gal_tag,
                    k: int):
    """Tile-granular ranking: camera admission refined to fused (camera,
    tile) cells.  queries (Q, D) float32; q_tag (Q,) int32 segment ids;
    admit_ct (Q, C*T*T) bool; gallery (G, D) float32; gal_ct (G,) int32,
    each row's cell ``cam*T*T + tile`` (-1: unlabeled, never eligible);
    gal_tag (G,) int32.  Query q scores row g only when
    ``admit_ct[q, gal_ct[g]]`` and ``gal_tag[g] == q_tag[q]``.  With every
    tile of each admitted camera admitted, the result is bit-identical to
    ``reid_topk_segments``."""
    global TILE_LAUNCHES
    _check(queries, q_tag, admit_ct, gallery, gal_ct, gal_tag, k,
           names=("admit_ct", "gal_ct"))
    Q, G = queries.shape[0], gallery.shape[0]
    if Q == 0 or G == 0:
        return _empty(Q, k, queries.device)
    if queries.device.type == "cpu":
        return ref.reid_topk_tiles_ref(queries, q_tag, admit_ct, gallery,
                                       gal_ct, gal_tag, k)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    if admit_ct.shape[1] > MAX_CELLS:
        raise ValueError(f"CT={admit_ct.shape[1]} cells exceeds the tile "
                         f"kernel's {MAX_CELLS}: its packed admit rows "
                         f"would not fit in a block's shared memory")
    out = _launch("reid_topk_tiles", "reid_topk_tiles", queries, q_tag,
                  admit_ct, gallery, gal_ct, gal_tag, k)
    TILE_LAUNCHES += 1
    return out
