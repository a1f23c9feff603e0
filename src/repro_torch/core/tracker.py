"""Cross-camera identity tracking — the paper's Algorithm 1 + replay (§5.2-5.3).

The PyTorch counterpart of ``repro.core.tracker``.  The whole query set
runs as one batched loop of vectorized steps whose state lives on the
device (tensors (Q, ...)): each step every live query

  1. asks the shared control plane (``repro_torch.core.policy.admit``)
     which cameras to search at its cursor (phase 1 windows, relaxed
     phase-2 replay, or the exhaustive phase 3),
  2. pays compute cost = number of admitted camera-frames,
  3. ranks the admitted galleries by feature distance to its query
     representation (plain tensor ops: no hand kernel is owed here),
  4. hands the match outcome to ``policy.advance``, the phase machine the
     serving engine runs.

The distances and the representation's norm are summed through
``repro_torch.core.fporder`` (the reference's order, the same bits on the
card and the host): a one-ulp difference in ``d`` can flip
``d < match_thresh`` or the argmin, and the winner feeds every later step
of that query.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fporder
from repro_torch.core.correlation import SpatioTemporalModel
from repro_torch.core.policy import (PhaseState, SearchPolicy, admit, advance,
                                     phase_windows)
from repro_torch.core.simulate import Visits
from repro_torch.device import resolve_device

BIG = 1e9

# Legacy alias: the batched tracker's parameters ARE the shared SearchPolicy.
TrackerParams = SearchPolicy

#: ``track_queries`` asks the device whether any query is still live once
#: every this many steps (each ask is a host sync).  A step in which every
#: query is done changes nothing: ``admit`` admits nothing for a done query,
#: the tracker ands ``matched`` with ``~done`` and ``advance`` freezes
#: ``f_curr``, ``phase`` and ``live_f`` of done queries.  So the steps run
#: past the last live one leave the result as it was.
CHECK_EVERY = 64

#: the keys of ``trace_queries``'s dict, the reference's
TRACE_KEYS = ("f_curr", "phase", "live", "mask", "matched", "match_cam")


@dataclasses.dataclass
class TrackResult:
    cost: np.ndarray          # (Q,) camera-frames processed
    n_match: np.ndarray       # (Q,) matches flagged
    n_correct: np.ndarray     # (Q,) matches that were the true entity
    visit_hits: np.ndarray    # (Q, Vmax) GT visits retrieved
    gt_count: np.ndarray      # (Q,) GT visits available
    delay: np.ndarray         # (Q,) final lag (steps)
    rescued: np.ndarray       # (Q,) matches recovered by replay (phase>=2)
    rescue_pairs: np.ndarray  # (C, C) replay-rescue counts (drift detection §6)
    steps: int = 0            # loop steps run (the last ones may be no-ops)

    @property
    def total_cost(self) -> float:
        return float(self.cost.sum())

    @property
    def recall(self) -> float:
        return float(self.visit_hits.sum() / max(self.gt_count.sum(), 1))

    @property
    def precision(self) -> float:
        return float(self.n_correct.sum() / max(self.n_match.sum(), 1))

    @property
    def mean_delay(self) -> float:
        return float(self.delay.mean())

    def summary(self) -> dict:
        return {"cost": self.total_cost, "recall": self.recall,
                "precision": self.precision, "delay": self.mean_delay,
                "rescued": int(self.rescued.sum())}


@dataclasses.dataclass
class TrackState:
    """The batched loop's state, all on one device."""

    ps: PhaseState
    q_feat: torch.Tensor        # (Q, D) float32 query representation
    cost: torch.Tensor          # (Q,) float32
    n_match: torch.Tensor       # (Q,) int32
    n_correct: torch.Tensor     # (Q,) int32
    visit_hits: torch.Tensor    # (Q, Vmax) bool
    rescued: torch.Tensor       # (Q,) int32
    rescue_pairs: torch.Tensor  # (C, C) int32


@dataclasses.dataclass(frozen=True)
class _World:
    """What every step reads: the model, the live world as tensors on the
    device, the policy and its float32 constants."""

    model: SpatioTemporalModel
    gallery: torch.Tensor       # (C, T, K) int32 visit ids, -1 empty
    feats: torch.Tensor         # (V, D) float32
    visit_ent: torch.Tensor     # (V,) int32
    q_ent: torch.Tensor         # (Q,) int32
    gt_vids: torch.Tensor       # (Q, Vmax) int32
    geo_adj: torch.Tensor       # (C, C) bool
    policy: SearchPolicy
    horizon: int
    thresh: torch.Tensor        # float32 match_thresh
    keep: torch.Tensor          # float32 1 - feat_alpha
    alpha: torch.Tensor         # float32 feat_alpha
    eps: torch.Tensor           # float32 1e-9


def _rank_galleries(gallery, feats, q_feat, f_curr, mask, thresh):
    """The re-id step: best (distance, camera, vid) per query over the
    admitted camera-frames at each query's content cursor.  Only the
    admitted rows are scored (each row's distance is its own sum, so
    leaving the others out changes no bit); a query with none gets
    ``BIG`` at row 0, as the reference's argmin does.  Returns
    (matched, best_cam, best_vid, best_d)."""
    Q = q_feat.shape[0]
    C, T, K = gallery.shape
    R = C * K
    f_idx = torch.clamp(f_curr, 0, T - 1).long()
    vids = gallery[:, f_idx].permute(1, 0, 2).reshape(Q, R)     # (Q, C*K)
    valid = (vids >= 0) & mask.repeat_interleave(K, dim=1)
    d = torch.full((Q, R), BIG, dtype=torch.float32, device=q_feat.device)
    rows = valid.view(-1).nonzero().squeeze(1)
    if rows.numel():
        q_of, r_of = rows // R, rows % R
        dist = 1.0 - fporder.dot8(feats[vids.view(-1)[rows].long()],
                                  q_feat[q_of], r_of >= R - R % 8)
        d.view(-1)[rows] = dist
    best = torch.argmin(d, dim=1)
    best_d = d.gather(1, best[:, None])[:, 0]
    best_cam = (best // K).to(torch.int32)
    best_vid = vids.gather(1, best[:, None])[:, 0]
    return best_d < thresh, best_cam, best_vid, best_d


def _track_step(st: TrackState, w: _World, windows):
    """One batched Alg.-1 step shared by the tracking loop and the trace."""
    p, ps = w.policy, st.ps
    mask = admit(w.model, p, ps, w.geo_adj)                     # (Q, C)
    matched, best_cam, best_vid, best_d = _rank_galleries(
        w.gallery, w.feats, st.q_feat, ps.f_curr, mask, w.thresh)
    matched = matched & ~ps.done

    # --- match bookkeeping ---
    best = torch.clamp(best_vid, min=0).long()
    correct = matched & (w.visit_ent[best] == w.q_ent)
    hits = st.visit_hits | (correct[:, None] & (w.gt_vids == best_vid[:, None]))
    # (1 - a) * q + a * fb, the first product fused into the add as the
    # reference's compiled program does; the norm in its reduce order
    new_feat = fporder.fma(st.q_feat, w.keep, w.alpha * w.feats[best])
    norm = fporder.sqrt(fporder.seq_sum(new_feat * new_feat))
    new_feat = fporder.div(new_feat, torch.maximum(norm, w.eps)[:, None])
    was_replay = matched & (ps.phase >= 2)
    rp = st.rescue_pairs.index_put(
        (ps.c_q.long(), best_cam.long()), was_replay.to(torch.int32),
        accumulate=True)

    st = TrackState(
        ps=advance(p, windows, ps, matched, best_cam, w.horizon),
        q_feat=torch.where(matched[:, None], new_feat, st.q_feat),
        cost=st.cost + mask.sum(1).to(torch.float32),
        n_match=st.n_match + matched.to(torch.int32),
        n_correct=st.n_correct + correct.to(torch.int32),
        visit_hits=hits,
        rescued=st.rescued + was_replay.to(torch.int32),
        rescue_pairs=rp,
    )
    trace = dict(f_curr=ps.f_curr, phase=ps.phase, live=~ps.done, mask=mask,
                 matched=matched, match_cam=best_cam, best_d=best_d)
    return st, trace


def _setup(model, visits: Visits, gallery, feats, q_vids, gt_vids,
           p: SearchPolicy, geo_adj, device):
    """(world, initial state) on ``device``."""
    dev = resolve_device(device)
    C = visits.n_cams
    if geo_adj is None:
        geo_adj = np.ones((C, C), bool)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    feats_t = put(feats, torch.float32)
    visit_ent = put(visits.ent, torch.int32)
    q = put(q_vids, torch.long)
    gt = put(gt_vids, torch.int32)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    w = _World(model=model.to(dev), gallery=put(gallery, torch.int32),
               feats=feats_t, visit_ent=visit_ent, q_ent=visit_ent[q],
               gt_vids=gt, geo_adj=put(geo_adj, torch.bool), policy=p,
               horizon=visits.horizon, thresh=f32(p.match_thresh),
               keep=f32(1 - p.feat_alpha), alpha=f32(p.feat_alpha),
               eps=f32(1e-9))
    Q = len(q_vids)
    st = TrackState(
        ps=PhaseState.init(put(visits.cam, torch.int32)[q],
                           put(visits.t_out, torch.int32)[q], device=dev),
        q_feat=feats_t[q],
        cost=torch.zeros(Q, dtype=torch.float32, device=dev),
        n_match=torch.zeros(Q, dtype=torch.int32, device=dev),
        n_correct=torch.zeros(Q, dtype=torch.int32, device=dev),
        visit_hits=torch.zeros(gt.shape, dtype=torch.bool, device=dev),
        rescued=torch.zeros(Q, dtype=torch.int32, device=dev),
        rescue_pairs=torch.zeros((C, C), dtype=torch.int32, device=dev),
    )
    return w, st


def _track(model, visits, gallery, feats, q_vids, gt_vids, p, geo_adj,
           device, max_steps: int, check_every: int = CHECK_EVERY):
    """Run steps until no query is live or ``max_steps`` have run, asking
    the device once every ``check_every`` steps.  Returns (final state,
    steps run)."""
    w, st = _setup(model, visits, gallery, feats, q_vids, gt_vids, p,
                   geo_adj, device)
    windows = phase_windows(w.model, p)
    steps = 0
    while steps < max_steps:
        if steps % check_every == 0 and not bool((~st.ps.done).any()):
            break
        st, _ = _track_step(st, w, windows)
        steps += 1
    return st, steps


def track_queries(model: SpatioTemporalModel, visits: Visits, gallery,
                  feats, q_vids, gt_vids, p: SearchPolicy, geo_adj=None, *,
                  device="cuda") -> TrackResult:
    """Batched Algorithm-1 tracking of every query under ``p`` on
    ``device``, until no query is live or 4 x the horizon steps have run
    (the reference's cap; each query's phase machine concludes well before
    it, so the cap only guards the loop)."""
    st, steps = _track(model, visits, gallery, feats, q_vids, gt_vids, p,
                       geo_adj, device, 4 * visits.horizon)
    ps = st.ps
    delay = torch.clamp(ps.live_f - ps.f_curr.to(torch.float32), min=0.0)
    return TrackResult(
        cost=st.cost.cpu().numpy(),
        n_match=st.n_match.cpu().numpy(),
        n_correct=st.n_correct.cpu().numpy(),
        visit_hits=st.visit_hits.cpu().numpy(),
        gt_count=(np.asarray(gt_vids) >= 0).sum(1),
        delay=delay.cpu().numpy(),
        rescued=st.rescued.cpu().numpy(),
        rescue_pairs=st.rescue_pairs.cpu().numpy(),
        steps=steps,
    )


def trace_queries(model: SpatioTemporalModel, visits: Visits, gallery,
                  feats, q_vids, gt_vids, p: SearchPolicy, geo_adj=None,
                  n_steps: int | None = None, *, device="cuda",
                  with_dist: bool = False) -> dict:
    """Run the tracker for a fixed number of steps (default 4 x the
    horizon), returning the per-step trace: f_curr/phase/live (n_steps,
    Q), mask (n_steps, Q, C), matched and match_cam (n_steps, Q), as host
    numpy arrays.  Steps where ``live`` is False are padding past a
    query's termination.  ``with_dist`` adds ``best_d`` (n_steps, Q), each
    step's winning distance (``BIG`` where nothing was admitted), from
    which a near-threshold parting's margin is read."""
    if n_steps is None:
        n_steps = 4 * visits.horizon
    w, st = _setup(model, visits, gallery, feats, q_vids, gt_vids, p,
                   geo_adj, device)
    windows = phase_windows(w.model, p)
    keys = TRACE_KEYS + (("best_d",) if with_dist else ())
    rows = {k: [] for k in keys}
    for _ in range(n_steps):
        st, trace = _track_step(st, w, windows)
        for k in keys:
            rows[k].append(trace[k])
    return {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}


def make_queries(visits: Visits, n_queries: int, seed: int = 0,
                 min_future_visits: int = 1, vmax: int = 32):
    """Sample query identities (paper §8.1C: drawn from the test partition).

    Returns (q_vids (Q,), gt_vids (Q, vmax) padded -1)."""
    rng = np.random.default_rng(seed)
    by_ent: dict[int, list[int]] = {}
    order = np.lexsort((visits.t_in, visits.ent))
    for vid in order:
        by_ent.setdefault(int(visits.ent[vid]), []).append(int(vid))
    candidates = [vs[0] for vs in by_ent.values() if len(vs) >= 1 + min_future_visits]
    rng.shuffle(candidates)
    chosen = candidates[:n_queries]
    q_vids = np.array(chosen, np.int32)
    gt = np.full((len(chosen), vmax), -1, np.int32)
    for i, v0 in enumerate(chosen):
        e = int(visits.ent[v0])
        future = [v for v in by_ent[e] if visits.t_in[v] > visits.t_out[v0]]
        gt[i, :min(len(future), vmax)] = future[:vmax]
    return q_vids, gt
