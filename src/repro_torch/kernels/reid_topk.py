"""Fused gallery ranking: similarity GEMM + masked running top-k.

The wrappers of the CUDA kernels ``csrc/reid_topk.cu`` (camera-masked:
``reid_topk_masked``, ``reid_topk_segments``), ``csrc/reid_topk_tiles.cu``
(camera x tile masked: ``reid_topk_tiles``) and ``csrc/reid_topk_plain.cu``
(unmasked: ``reid_topk``), the counterparts of
``repro.kernels.reid_topk``'s entry points.  Query q scores gallery row g
only when ``admit[q, gal_cam[g]]`` (or ``admit_ct[q, gal_ct[g]]``) and the
tags agree (frames for ``reid_topk_masked``, round-scoped segment ids for
the others); rows whose camera or cell is out of range are never
eligible.  Returns (scores (Q, k) float32, idx (Q, k) int32), best first
in the order (score descending, index ascending), with fully masked slots
and slots past G as (NEG_INF, -1).

Dispatch is by the tensors' device: on the CPU the plain version in
``ref.py`` runs; on a CUDA tensor the kernel launches or the wrapper
raises.  ``LAUNCHES`` counts the camera kernel's calls, ``TILE_LAUNCHES``
the tile kernel's, ``UNMASKED_LAUNCHES`` the unmasked kernel's: one per
call, the merge launch of a split call included.  A camera-masked call
with more than ``MAX_CAMS`` cameras runs on the tile kernel, whose
admission takes any cell axis, and still counts in ``LAUNCHES``.

The three kernels split the gallery across blocks
(``csrc/reid_split.cuh``): ``split_plan`` chooses the number of slices
from the shape and the card's SM count, the same for each kernel, and
with more than one slice the wrapper allocates the (Q, S, K) workspace
the merge reads.  The tile kernel gathers admission per (64-row, 64-row)
tile and skips tiles with no eligible pair, so it takes any cell axis
whose size fits the launchers' ``int``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import NEG_INF

MAX_K = 16
#: cameras the camera kernel packs in shared memory; wider calls go to the
#: tile kernel
MAX_CAMS = 4096
#: the largest size a launcher's ``int`` argument holds
INT_MAX = 2 ** 31 - 1

#: the split kernels' (query, gallery) tile (``csrc/reid_split.cuh``)
SPLIT_QB = SPLIT_GB = 64
#: split-kernel blocks an SM holds at once (46-47 KB of shared memory each):
#: the plan aims at filling every SM to that
BLOCKS_PER_SM = 4
#: a gallery of fewer tiles is not split: one block, no workspace, no merge
MIN_SPLIT_TILES = 4

#: camera kernel calls since the last reset (a plain count, never
#: decremented)
LAUNCHES = 0
#: tile kernel launches since the last reset
TILE_LAUNCHES = 0
#: unmasked kernel (``reid_topk``) launches since the last reset
UNMASKED_LAUNCHES = 0


def split_plan(Q: int, G: int, n_sms: int) -> tuple[int, int]:
    """(q-blocks, gallery slices S) of a split-kernel launch: the grid is
    their product.  S = 1 where the gallery has fewer than
    ``MIN_SPLIT_TILES`` tiles or the q-blocks alone fill every SM;
    otherwise as many slices as fill ``BLOCKS_PER_SM`` blocks on each of
    ``n_sms`` SMs, at most one a tile."""
    nq, ng = -(-Q // SPLIT_QB), -(-G // SPLIT_GB)
    target = BLOCKS_PER_SM * n_sms
    if ng < MIN_SPLIT_TILES or nq >= target:
        return nq, 1
    return nq, min(ng, -(-target // nq))


def slices(G: int, S: int) -> list[tuple[int, int]]:
    """The gallery rows [start, stop) of each of S slices, as the kernels
    cut them: slice s holds tiles [s ng / S, (s + 1) ng / S)."""
    ng = -(-G // SPLIT_GB)
    return [(s * ng // S * SPLIT_GB, min((s + 1) * ng // S * SPLIT_GB, G))
            for s in range(S)]


def round_k(k: int) -> int:
    """The kernels' list length: k rounded up to a power of two."""
    return 1 << (k - 1).bit_length()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_args(queries, G: int, k: int):
    """(workspace values, workspace indices, S) of a split launch on
    ``queries``' card: the workspace is None when S = 1."""
    Q = queries.shape[0]
    index = queries.device.index
    if index is None:
        index = torch.cuda.current_device()
    S = split_plan(Q, G, _sm_count(index))[1]
    if S == 1:
        return None, None, 1
    K = round_k(k)
    return (torch.empty((Q, S, K), dtype=torch.float32,
                        device=queries.device),
            torch.empty((Q, S, K), dtype=torch.int32, device=queries.device),
            S)


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _launch(source: str, symbol: str, queries, q_tag, admit, gallery,
            gal_cam, gal_tag, k: int):
    """Launch the masked kernel ``symbol`` of ``csrc/<source>.cu`` on the
    tensors' card and stream, with its split plan and workspace; the
    caller counts the launch."""
    from repro_torch.kernels import build

    Q, D = queries.shape
    G = gallery.shape[0]
    sizes = (Q, G, D, admit.shape[1], k)
    if max(sizes) > INT_MAX:
        raise ValueError(f"{symbol}: a size of (Q, G, D, width, k) = "
                         f"{sizes} exceeds the launcher's int")
    fn = build.launcher(source, symbol, (ctypes.c_void_p,) * 10
                        + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
    out_v = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    ws_v, ws_i, S = _split_args(queries, G, k)
    build.check(fn(queries.data_ptr(), q_tag.data_ptr(), admit.data_ptr(),
                   gallery.data_ptr(), gal_cam.data_ptr(), gal_tag.data_ptr(),
                   out_v.data_ptr(), out_i.data_ptr(), _ptr(ws_v),
                   _ptr(ws_i), *sizes, S,
                   *build.device_and_stream(queries)), symbol)
    return out_v, out_i


def camera_route(C: int) -> tuple[str, str]:
    """(source, symbol) of the launcher a camera-masked call over ``C``
    cameras goes to.  Past ``MAX_CAMS`` the camera kernel's packed
    admission bits no longer fit its shared memory; the tile kernel applies
    the same rule over any cell axis (admit[q, cell[g]], equal tags,
    out-of-range never eligible), with the same plan, product and merge."""
    return ("reid_topk", "reid_topk_segment_masked") if C <= MAX_CAMS \
        else ("reid_topk_tiles", "reid_topk_tiles")


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
    from repro_torch.kernels import build

    build.refuse_grad("reid_topk_segment_masked", queries, gallery)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    out = _launch(*camera_route(admit.shape[1]), queries, q_tag, admit,
                  gallery, gal_cam, gal_tag, k)
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
    from repro_torch.kernels import build

    build.refuse_grad("reid_topk_tiles", queries, gallery)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    out = _launch("reid_topk_tiles", "reid_topk_tiles", queries, q_tag,
                  admit_ct, gallery, gal_ct, gal_tag, k)
    TILE_LAUNCHES += 1
    return out


def reid_topk(queries, gallery, k: int):
    """Plain gallery ranking, the counterpart of ``repro.kernels.reid_topk``:
    the k best rows of ``queries @ gallery.T`` with only the padding
    masked.  queries (Q, D) and gallery (G, D) of any float dtype (scored
    in float32).  Returns (scores (Q, k) float32, idx (Q, k) int32) in the
    order (score descending, index ascending); slots past G, and every
    slot when Q == 0 or G == 0, are (NEG_INF, -1)."""
    global UNMASKED_LAUNCHES
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    for name, t in (("queries", queries), ("gallery", gallery)):
        if not isinstance(t, torch.Tensor) or t.ndim != 2 or \
                not t.is_floating_point():
            raise TypeError(f"{name} must be a 2-d float tensor")
    if gallery.device != queries.device:
        raise ValueError(f"gallery is on {gallery.device}, queries on "
                         f"{queries.device}")
    if gallery.shape[1] != queries.shape[1]:
        raise ValueError(f"gallery depth {gallery.shape[1]} != query depth "
                         f"{queries.shape[1]}")
    Q, D = queries.shape
    G = gallery.shape[0]
    if Q == 0 or G == 0:
        return _empty(Q, k, queries.device)
    if queries.device.type == "cpu":
        return ref.reid_topk_ref(queries, gallery, k)
    from repro_torch.kernels import build

    build.refuse_grad("reid_topk", queries, gallery)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    queries = queries.to(torch.float32).contiguous()
    gallery = gallery.to(torch.float32).contiguous()
    fn = build.launcher("reid_topk_plain", "reid_topk_unmasked",
                        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                        + (ctypes.c_void_p,))
    out_v = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    ws_v, ws_i, S = _split_args(queries, G, k)
    build.check(fn(queries.data_ptr(), gallery.data_ptr(), out_v.data_ptr(),
                   out_i.data_ptr(), _ptr(ws_v), _ptr(ws_i), Q, G, D, k, S,
                   *build.device_and_stream(queries)), "reid_topk_unmasked")
    UNMASKED_LAUNCHES += 1
    return out_v, out_i
