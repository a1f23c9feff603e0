"""Plain PyTorch versions of the hand-written kernels.

The CPU tests hold the port to the JAX reference through these, the
engine runs them when its tensors lie on the CPU, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

Ranking order is the total order (score descending, gallery index
ascending): a stable descending sort keeps the lower index first among
equal scores, as ``jax.lax.top_k`` does.  ``torch.topk`` promises no
order among ties, so it is not used.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _segment_masked_ref(queries, q_tag, admit, gallery, gal_cam, gal_tag,
                        k: int):
    Q, C = admit.shape
    G = gallery.shape[0]
    dev = queries.device
    s = queries.to(torch.float32) @ gallery.to(torch.float32).T
    # cam outside [0, C) (padded rows carry -1) is "no camera": ineligible
    cam_ok = (gal_cam >= 0) & (gal_cam < C)
    cams = torch.where(cam_ok, gal_cam, 0).to(torch.int64)
    valid = admit.gather(1, cams[None, :].expand(Q, G)) & cam_ok[None, :] & \
        (gal_tag[None, :] == q_tag[:, None])
    masked = torch.where(valid, s, torch.full_like(s, NEG_INF))
    if G < k:
        masked = torch.cat([masked, torch.full((Q, k - G), NEG_INF,
                                               dtype=torch.float32,
                                               device=dev)], dim=1)
    sv, si = torch.sort(masked, dim=1, descending=True, stable=True)
    sv, si = sv[:, :k].contiguous(), si[:, :k].to(torch.int32)
    return sv, torch.where(sv > NEG_INF / 2, si, torch.full_like(si, -1))


def reid_topk_masked_ref(queries, q_frame, admit, gallery, gal_cam,
                         gal_frame, k: int):
    """Query q may only score gallery row g when ``admit[q, gal_cam[g]]``
    and ``gal_frame[g] == q_frame[q]``.  Returns (scores (Q, k) float32,
    idx (Q, k) int32); fully masked slots (and slots past G) come back as
    (NEG_INF, -1)."""
    return _segment_masked_ref(queries, q_frame, admit, gallery, gal_cam,
                               gal_frame, k)


def reid_topk_segments_ref(queries, q_seg, admit, gallery, gal_cam,
                           gal_seg, k: int):
    """The consolidated variant: identical math to ``reid_topk_masked_ref``
    with the frame tags swapped for round-scoped segment ids."""
    return _segment_masked_ref(queries, q_seg, admit, gallery, gal_cam,
                               gal_seg, k)


def reid_topk_tiles_ref(queries, q_tag, admit_ct, gallery, gal_ct, gal_tag,
                        k: int):
    """The tile-granular variant: query q may only score gallery row g when
    ``admit_ct[q, gal_ct[g]]`` (the fused (camera, tile) cell is admitted)
    and ``gal_tag[g] == q_tag[q]``.  A cell outside [0, C*T*T) (unlabeled
    or padded rows carry -1) is never admitted, as in the Pallas kernel's
    one-hot.  The segment version's math with the camera axis widened to
    C*T*T cells."""
    return _segment_masked_ref(queries, q_tag, admit_ct, gallery, gal_ct,
                               gal_tag, k)
