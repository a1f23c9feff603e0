"""Fused gallery ranking: similarity GEMM + masked running top-k.

The wrappers of the CUDA kernel ``csrc/reid_topk.cu``, the counterpart of
``repro.kernels.reid_topk``'s segment-masked entry points.  Query q scores
gallery row g only when ``admit[q, gal_cam[g]]`` and the tags agree
(frames for ``reid_topk_masked``, round-scoped segment ids for
``reid_topk_segments``); rows with ``gal_cam`` outside [0, C) are never
eligible.  Returns (scores (Q, k) float32, idx (Q, k) int32), best first
in the order (score descending, index ascending), with fully masked slots
and slots past G as (NEG_INF, -1).

Dispatch is by the tensors' device: on the CPU the plain version in
``ref.py`` runs; on a CUDA tensor the kernel launches or the wrapper
raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import NEG_INF

MAX_K = 16
MAX_CAMS = 4096

#: kernel launches since the last reset (a plain count, never decremented)
LAUNCHES = 0


def _empty(Q: int, k: int, device):
    return (torch.full((Q, k), NEG_INF, dtype=torch.float32, device=device),
            torch.full((Q, k), -1, dtype=torch.int32, device=device))


def _check(queries, q_tag, admit, gallery, gal_cam, gal_tag, k: int):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    want = dict(queries=(queries, torch.float32, 2),
                q_tag=(q_tag, torch.int32, 1),
                admit=(admit, torch.bool, 2),
                gallery=(gallery, torch.float32, 2),
                gal_cam=(gal_cam, torch.int32, 1),
                gal_tag=(gal_tag, torch.int32, 1))
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
        raise ValueError(f"q_tag {tuple(q_tag.shape)} / admit "
                         f"{tuple(admit.shape)} do not match Q={Q}")
    if gallery.shape[1] != D:
        raise ValueError(f"gallery depth {gallery.shape[1]} != query depth {D}")
    if gal_cam.shape[0] != G or gal_tag.shape[0] != G:
        raise ValueError(f"gal_cam {tuple(gal_cam.shape)} / gal_tag "
                         f"{tuple(gal_tag.shape)} do not match G={G}")


@functools.cache
def _kernel():
    """The built launcher, built on first use (never at import)."""
    from repro_torch.kernels import build

    fn = build.load("reid_topk").reid_topk_segment_masked
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(queries, q_tag, admit, gallery, gal_cam, gal_tag, k: int):
    global LAUNCHES
    Q, D = queries.shape
    G = gallery.shape[0]
    C = admit.shape[1]
    if C > MAX_CAMS:
        raise ValueError(f"C={C} cameras exceeds the kernel's {MAX_CAMS}")
    fn = _kernel()
    out_v = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    device = queries.device.index
    if device is None:
        device = torch.cuda.current_device()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = fn(queries.data_ptr(), q_tag.data_ptr(), admit.data_ptr(),
             gallery.data_ptr(), gal_cam.data_ptr(), gal_tag.data_ptr(),
             out_v.data_ptr(), out_i.data_ptr(), Q, G, D, C, k, device,
             stream)
    if err != 0:
        raise RuntimeError(f"reid_topk_segment_masked launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out_v, out_i


def _segment_masked_call(queries, q_tag, admit, gallery, gal_cam, gal_tag,
                         k: int):
    _check(queries, q_tag, admit, gallery, gal_cam, gal_tag, k)
    Q, G = queries.shape[0], gallery.shape[0]
    if Q == 0 or G == 0:
        return _empty(Q, k, queries.device)
    if queries.device.type == "cpu":
        return ref.reid_topk_segments_ref(queries, q_tag, admit, gallery,
                                          gal_cam, gal_tag, k)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    return _launch(queries, q_tag, admit, gallery, gal_cam, gal_tag, k)


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
