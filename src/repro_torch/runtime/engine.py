"""The serving engine: ReXCam admission control over the inference plane.

The PyTorch counterpart of ``repro.runtime.engine``.  Per tick (one wall
step over all live camera streams):

  1. all active queries are gathered into one batched ``PhaseState`` on the
     engine's device and one ``policy.admit`` call produces the (Q, C)
     admission mask,
  2. admitted (camera, frame) pairs are deduplicated across queries on the
     host (``RoundPlan``), with replay re-reads served from the
     ``FrameStore`` embedding cache,
  3. the deduplicated embedding batch is ranked on the device: one
     ``reid_topk_segments`` call over the whole round (``consolidate=True``,
     the default) or ``reid_topk_masked`` with frame tags (the per-frame
     reference path) scores every query against exactly its admitted
     galleries, camera-major, so the lower gallery index wins a tie;
     with ``tile_grid=T > 0`` one ``reid_topk_tiles`` call ranks the round
     over the fused (camera, tile) admission of ``policy.admit_tiles``,
  4. match outcomes feed ``policy.advance``; a query whose phase-1 windows
     exhaust rewinds to f_q + 1 and replays retained frames with relaxed
     thresholds (§5.3); frames evicted past retention surface as
     ``replay_misses``.

Each round copies the admission mask to the host once and the round's
outcome once; the bookkeeping (``RoundPlan``, ``_scatter``, the
``feat_alpha`` update) stays host numpy, as in the reference.  Replay
pacing, the host short-circuit of sampled-out skip-mode rounds, both cost
conventions (``admitted_steps`` per query camera-step, ``unique_frames``
per deduplicated pair) and the trace records are the reference's.

Not ported yet (they raise): ``prefetch`` and ``transport`` (the fleet).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.correlation import SpatioTemporalModel
from repro_torch.core.policy import (PhaseState, SearchPolicy, admit,
                                     admit_tiles, advance, phase_windows,
                                     replay_sampled_out)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.reid_topk import NEG_INF
from repro_torch.runtime.gallery import (GalleryStore, LocalGalleryStore,
                                         assemble_round_gallery, l2_normalize)
from repro_torch.runtime.stream_store import FrameStore

# effectively "never": the live engine terminates queries via exit_t /
# window exhaustion, not a simulation horizon
_NO_HORIZON = 2 ** 30


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-plane settings; all *search* semantics live in ``policy``."""

    policy: SearchPolicy = SearchPolicy()
    max_batch: int = 256
    retention: int = 600
    embed_cache: bool = True          # gallery-plane embedding cache (§5.3)
    short_circuit_skips: bool = True  # host fast path for sampled-out rounds
    # top-k candidate bands surfaced per query round in the trace records;
    # the argmax match path is always band 0
    topk: int = 1
    transport: Any = None             # fleet only: not ported yet
    prefetch: bool = False            # fleet only: not ported yet
    # rank the whole round in one segment-ID kernel call; False keeps the
    # per-frame reference path (trace-identical)
    consolidate: bool = True
    # sub-frame spatial admission: T > 0 ranks each round through the
    # tile-masked kernel over a T x T tile grid; a model without tile data
    # serves all tiles admitted, trace-identical to the camera path
    tile_grid: int = 0
    # §5.2 top-k confidence re-ranking (bit-identical to argmax at topk=1)
    topk_rerank: bool = False


@dataclasses.dataclass
class QueryState:
    qid: int
    feat: np.ndarray
    c_q: int
    f_q: int
    f_curr: int            # content frame the search cursor is on
    phase: int = 1
    done: bool = False
    matches: list = dataclasses.field(default_factory=list)
    rescued: int = 0       # matches made during replay (phase >= 2)
    replay_credit: float = 0.0  # fractional replay-round carry (ff pacing)
    submit_t: int = 0      # engine wall tick the query was submitted at
    first_match_t: int = -1  # wall tick of the first confirmed match (delay)
    # tile mode only: the tile of the last confirmed match (-1 before the
    # first); a learned tile model narrows the self-camera follow window
    # to its 3x3 neighbourhood (policy.tile_follow_mask)
    tile_q: int = -1


def _rank_outcome(sv, si, gallery, gal_cam, gal_frame, match_thresh,
                  n_cams: int = 0, topk_rerank: bool = False):
    """Convert the (Q, k) score/index bands into the control plane's match
    outcome: band 0's score converts back to the cosine distance the
    threshold is applied to; unmatched rows carry cam 0; padded or fully
    masked slots are (NEG_INF, -1, -1, -1) in the bands.

    ``topk_rerank`` (§5.2): the bands that pass the threshold vote by summed
    score per camera and the match re-anchors to the winning camera's best
    band; at k=1 this is the argmax path bit for bit.

    With an empty gallery (G == 0) there is nothing to gather: every row is
    unmatched, band 0 is (NEG_INF, -1) and the embedding is zero."""
    Q = sv.shape[0]
    dev = sv.device
    thresh = torch.tensor(match_thresh, dtype=torch.float32, device=dev)
    valid = si >= 0
    if gallery.shape[0] == 0:
        none = torch.full_like(si, -1)
        return (torch.zeros(Q, dtype=torch.bool, device=dev),
                torch.zeros(Q, dtype=torch.int32, device=dev),
                gallery.new_zeros((Q, gallery.shape[1])), sv, si, none,
                none.clone())
    idx = si.clamp(min=0).to(torch.int64)
    topk_cam = torch.where(valid, gal_cam[idx], -1).to(torch.int32)
    topk_frame = torch.where(valid, gal_frame[idx], -1).to(torch.int32)
    if topk_rerank:
        passing = valid & ((1.0 - sv) < thresh)
        matched = passing.any(dim=1)
        # per-camera summed passing score; a band with cam -1 (invalid)
        # matches no camera column, so it contributes nothing
        cams = torch.arange(n_cams, dtype=torch.int32, device=dev)
        oh = (topk_cam[:, :, None] == cams).to(torch.float32)
        votes = (torch.where(passing, sv, 0.0)[:, :, None] * oh).sum(dim=1)
        # torch.argmax returns the first maximum on ties, as jnp.argmax
        rerank_cam = torch.argmax(votes, dim=1).to(torch.int32)
        # the winning camera's best (lowest) passing band supplies the
        # matched embedding
        j = torch.argmax((passing & (topk_cam == rerank_cam[:, None]))
                         .to(torch.uint8), dim=1)
        best_idx = si.gather(1, j[:, None])[:, 0]
        match_cam = torch.where(matched, rerank_cam, 0).to(torch.int32)
    else:
        best_val, best_idx = sv[:, 0], si[:, 0]
        matched = (1.0 - best_val) < thresh
        match_cam = torch.where(
            matched, gal_cam[best_idx.clamp(min=0).to(torch.int64)],
            0).to(torch.int32)
    idx0 = best_idx.clamp(min=0).to(torch.int64)
    return matched, match_cam, gallery[idx0], sv, si, topk_cam, topk_frame


def rank_round(q_feat, q_frame, mask, gallery, gal_cam, gal_frame,
               match_thresh: float, k: int = 1, topk_rerank: bool = False):
    """One device pass over the round's deduplicated embedding batch through
    ``reid_topk_masked``.  Returns (matched (Q,), match_cam (Q,),
    match_emb (Q, D), topk_val (Q, k), topk_idx (Q, k), topk_cam (Q, k),
    topk_frame (Q, k))."""
    sv, si = kernel_ops.reid_topk_masked(q_feat, q_frame, mask, gallery,
                                         gal_cam, gal_frame, k)
    return _rank_outcome(sv, si, gallery, gal_cam, gal_frame, match_thresh,
                         mask.shape[1], topk_rerank)


def rank_round_seg(q_feat, q_seg, mask, gallery, gal_cam, gal_frame, gal_seg,
                   match_thresh: float, k: int = 1,
                   topk_rerank: bool = False):
    """Consolidated ``rank_round``: frame tags replaced by the
    ``RoundPlan``'s compact per-round segment ids; ``gal_frame`` still rides
    along so the top-k bands surface real frame ids."""
    sv, si = kernel_ops.reid_topk_segments(q_feat, q_seg, mask, gallery,
                                           gal_cam, gal_seg, k)
    return _rank_outcome(sv, si, gallery, gal_cam, gal_frame, match_thresh,
                         mask.shape[1], topk_rerank)


def rank_round_tiles(q_feat, q_seg, mask_ct, gallery, gal_ct, gal_cam,
                     gal_frame, gal_seg, match_thresh: float, k: int = 1,
                     n_cams: int = 0, topk_rerank: bool = False):
    """Tile-granular ``rank_round_seg``: the fused (camera, tile) mask
    ``mask_ct`` (Q, C*T*T) and per-row cells ``gal_ct`` (G,) ranked through
    ``reid_topk_tiles``; ``gal_cam`` / ``gal_frame`` ride along for the
    outcome and the bands."""
    sv, si = kernel_ops.reid_topk_tiles(q_feat, q_seg, mask_ct, gallery,
                                        gal_ct, gal_seg, k)
    return _rank_outcome(sv, si, gallery, gal_cam, gal_frame, match_thresh,
                         n_cams, topk_rerank)


def rank_advance_round(policy: SearchPolicy, windows, state: PhaseState,
                       q_feat, mask, gallery, gal_cam, gal_frame, k: int = 1,
                       topk_rerank: bool = False):
    """Rank the round's gallery with frame tags (``state.f_curr``), then run
    the phase machine."""
    (matched, match_cam, match_emb, topk_val, topk_idx, topk_cam,
     topk_frame) = rank_round(q_feat, state.f_curr, mask, gallery, gal_cam,
                              gal_frame, policy.match_thresh, k, topk_rerank)
    nxt = advance(policy, windows, state, matched, match_cam, _NO_HORIZON)
    return (nxt, matched, match_cam, match_emb, topk_val, topk_idx,
            topk_cam, topk_frame)


def rank_advance_round_seg(policy: SearchPolicy, windows, state: PhaseState,
                           q_feat, q_seg, mask, gallery, gal_cam, gal_frame,
                           gal_seg, k: int = 1, topk_rerank: bool = False):
    """Consolidated step body: one segment-ID kernel call, then the phase
    machine."""
    (matched, match_cam, match_emb, topk_val, topk_idx, topk_cam,
     topk_frame) = rank_round_seg(q_feat, q_seg, mask, gallery, gal_cam,
                                  gal_frame, gal_seg, policy.match_thresh, k,
                                  topk_rerank)
    nxt = advance(policy, windows, state, matched, match_cam, _NO_HORIZON)
    return (nxt, matched, match_cam, match_emb, topk_val, topk_idx,
            topk_cam, topk_frame)


def rank_advance_round_tiles(policy: SearchPolicy, windows,
                             state: PhaseState, q_feat, q_seg, mask_ct,
                             gallery, gal_ct, gal_cam, gal_frame, gal_seg,
                             k: int = 1, n_cams: int = 0,
                             topk_rerank: bool = False):
    """Tile-granular step body: one tile-masked kernel call, then the phase
    machine."""
    (matched, match_cam, match_emb, topk_val, topk_idx, topk_cam,
     topk_frame) = rank_round_tiles(q_feat, q_seg, mask_ct, gallery, gal_ct,
                                    gal_cam, gal_frame, gal_seg,
                                    policy.match_thresh, k, n_cams,
                                    topk_rerank)
    nxt = advance(policy, windows, state, matched, match_cam, _NO_HORIZON)
    return (nxt, matched, match_cam, match_emb, topk_val, topk_idx,
            topk_cam, topk_frame)


def advance_round(policy: SearchPolicy, windows, state: PhaseState):
    """The no-gallery step body: the phase machine alone, matched=False."""
    Q = state.f_q.shape[0]
    dev = state.f_q.device
    return advance(policy, windows, state,
                   torch.zeros(Q, dtype=torch.bool, device=dev),
                   torch.zeros(Q, dtype=torch.int32, device=dev), _NO_HORIZON)


def _to_host(*tensors) -> list[np.ndarray]:
    """Copy a round's device tensors to the host behind ONE synchronise."""
    out = [t.to("cpu", non_blocking=True) for t in tensors]
    if tensors and tensors[0].is_cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return [t.numpy() for t in out]


@dataclasses.dataclass
class RoundPlan:
    """One round's work queue, keyed by unique admitted (camera, frame).

    ``work`` is the camera-major sorted unique (cam, frame) demand (the
    order that keeps the kernel's tie-breaks on the lowest gallery index);
    ``want_count`` records how many (query, camera) admission steps each
    key serves (``replay_miss_steps`` reads it on eviction);
    ``seg_of_frame``/``q_seg`` carry the round's injective content-frame ->
    compact-segment relabeling for the consolidated ranking pass.
    """

    qs: list
    ps: PhaseState
    mask: np.ndarray                        # (N, C) admission, host copy
    admitted: int                           # per-(query, camera) steps
    cams_by_q: list
    work: list                              # sorted unique (cam, frame)
    want_count: dict                        # key -> wanting (q, cam) pairs
    seg_of_frame: dict                      # content frame -> segment id
    q_seg: np.ndarray                       # (N,) int32
    # tile mode only: the fused (camera, tile) admission (N, C*T*T)
    mask_ct: np.ndarray | None = None

    def gallery_segments(self, batch_keys: list, key_emb: dict,
                         rows: int) -> np.ndarray:
        """Per-row segment tags for the assembled round gallery, in
        ``batch_keys`` order; padding rows carry -1."""
        gal_seg = np.full(rows, -1, np.int32)
        pos = 0
        for key in batch_keys:
            cnt = len(key_emb[key])
            gal_seg[pos:pos + cnt] = self.seg_of_frame[key[1]]
            pos += cnt
        return gal_seg


class ServingEngine:
    def __init__(self, model: SpatioTemporalModel, embed_fn: Callable,
                 cfg: EngineConfig, geo_adj=None, device="cuda"):
        if cfg.topk < 1:
            raise ValueError(f"topk={cfg.topk} must be >= 1 (band 0 is the "
                             f"argmax match path)")
        if cfg.prefetch or cfg.transport is not None:
            raise NotImplementedError(
                "prefetch= and transport= are not ported yet (ROADMAP.md, "
                "Queue 1: the fleet, gallery and transport plane)")
        self.device = resolve_device(device)
        self.tile_grid = int(cfg.tile_grid)
        self.model = model.to(self.device)
        if self.tile_grid > 0:
            self.model = self._resolve_tiles(self.model)
        self.embed_fn = embed_fn
        self.cfg = cfg
        self.policy = cfg.policy
        self.C = model.n_cams
        self.model_epoch = int(model.epoch)  # host mirror for trace records
        self.model_swaps: list[tuple[int, int]] = []  # (tick, new epoch)
        # the geo baseline's proximity mask; all-ones when not provided
        self._geo_adj = torch.as_tensor(
            geo_adj if geo_adj is not None else np.ones((self.C, self.C), bool),
            dtype=torch.bool, device=self.device)
        self.gallery: GalleryStore = LocalGalleryStore(self.C, cfg.retention)
        self.store = FrameStore(self.C, cfg.retention, gallery=self.gallery)
        self.queries: dict[int, QueryState] = {}
        self.t = 0
        self.frames_processed = 0    # (cam, frame) batches actually embedded
        self.cache_hits = 0          # embed calls avoided by the cache
        self.replay_embeds = 0       # replay re-reads the cache missed
        self.admitted_steps = 0      # per-query camera-steps (tracker scale)
        self.unique_frames = 0       # deduplicated (cam, frame) pairs
        # tile mode only: per-(query, camera, tile) admission steps, and the
        # per-key unions of admitted tiles (camera-granular serving would
        # charge T*T per admitted step / unique key)
        self.admitted_tiles = 0
        self.unique_tiles = 0
        self.content_steps = 0       # per-query content rounds charged
        self.replay_steps = 0        # content rounds behind the frontier
        self.skipped_steps = 0       # short-circuited sampled-out rounds
        self.replay_misses = 0       # replay reads past the retention window
        # the same misses per wanting (query, camera) step
        self.replay_miss_steps = 0
        self.ticks = 0
        # (C, C) replay-rescue attribution (phase >= 2 matches, keyed by the
        # anchor camera at match time): the §6 drift-detection signal
        self.rescue_pairs = np.zeros((self.C, self.C), np.int64)
        # (qid, cam, frame) confirmed-sighting log, pruned each tick past
        # twice the retention window
        self.sightings: collections.deque[tuple[int, int, int]] = \
            collections.deque()
        self._in_round = False       # swap_model atomicity guard
        self._set_windows()

    def _set_windows(self) -> None:
        self._windows = phase_windows(self.model, self.policy)
        # host copies of the exhaustion windows for the skip fast path
        self._w1, self._w2 = _to_host(self._windows.w_end1,
                                      self._windows.w_end2)

    def _resolve_tiles(self, model: SpatioTemporalModel) -> SpatioTemporalModel:
        """Reconcile a model (on the engine's device) with ``cfg.tile_grid``:
        a model without tile data gets the all-tiles-admitted tensor
        (trace-identical to camera-granular serving); a model profiled at
        another grid raises."""
        if model.tile_grid not in (0, self.tile_grid):
            raise ValueError(
                f"tile_grid mismatch: engine serves T={self.tile_grid} but "
                f"the model was profiled at T={model.tile_grid}; re-profile "
                f"with profile(..., tile_grid={self.tile_grid})")
        if model.tile_admit is None or model.tile_grid == 0:
            C, TT = model.n_cams, self.tile_grid * self.tile_grid
            model = dataclasses.replace(
                model, tile_admit=torch.ones((C, C, TT), dtype=torch.bool,
                                             device=self.device),
                tile_grid=self.tile_grid, tile_learned=False)
        return model

    def swap_model(self, model: SpatioTemporalModel) -> int:
        """Hot-swap M between rounds without dropping in-flight queries: the
        next round admits and ranks under the new model, the exhaustion
        windows are rebuilt and the epoch bumps.  Shapes must match.
        Returns the new epoch."""
        if self._in_round:
            raise RuntimeError(
                "swap_model called mid-round: the model must stay constant "
                "within a round (admit and rank see one M)")
        if model.n_cams != self.C or model.n_bins != self.model.n_bins \
                or model.bin_width != self.model.bin_width:
            raise ValueError(
                f"swap_model shape mismatch: engine serves C={self.C}, "
                f"NB={self.model.n_bins}, bin_width={self.model.bin_width}; "
                f"got C={model.n_cams}, NB={model.n_bins}, "
                f"bin_width={model.bin_width}")
        model = model.to(self.device)
        if self.tile_grid > 0:
            # a model re-profiled without tile data keeps serving the
            # incumbent masks; one with tile data at the serving grid
            # swaps them like every other field
            if model.tile_admit is None or model.tile_grid == 0:
                model = dataclasses.replace(
                    model, tile_admit=self.model.tile_admit,
                    tile_grid=self.tile_grid,
                    tile_learned=self.model.tile_learned)
            else:
                model = self._resolve_tiles(model)
        self.model_epoch += 1
        self.model = dataclasses.replace(model, epoch=self.model_epoch)
        self._set_windows()
        self.model_swaps.append((self.t, self.model_epoch))
        return self.model_epoch

    # -- the gallery plane -------------------------------------------------
    def gallery_report(self) -> dict:
        """The embedding plane's accounting, with rescue-failure cost in both
        conventions."""
        return dict(kind=self.gallery.kind,
                    replay_misses=self.replay_misses,
                    replay_miss_steps=self.replay_miss_steps,
                    **self.gallery.counters())

    # -- query lifecycle --------------------------------------------------
    def submit_query(self, qid: int, feat: np.ndarray, cam: int, frame: int):
        self.queries[qid] = QueryState(
            qid, l2_normalize(feat), cam, frame, f_curr=frame + 1,
            submit_t=self.t)
        self.sightings.append((qid, cam, frame))

    # -- batched state marshalling ---------------------------------------
    def _gather(self, qs: list[QueryState]) -> PhaseState:
        """Engine QueryStates -> one batched PhaseState on the device, row i
        for ``qs[i]`` (no padding rows: eager PyTorch has no shapes to
        hold fixed).  The live frontier is the engine wall clock."""
        def col(vals, dtype):
            return torch.from_numpy(np.asarray(vals, dtype)).to(self.device)

        return PhaseState(
            f_q=col([q.f_q for q in qs], np.int32),
            c_q=col([q.c_q for q in qs], np.int32),
            f_curr=col([q.f_curr for q in qs], np.int32),
            phase=col([q.phase for q in qs], np.int32),
            live_f=col([float(self.t)] * len(qs), np.float32),
            done=col([False] * len(qs), np.bool_),
        )

    def _scatter(self, qs: list[QueryState], state: dict,
                 matched: np.ndarray, match_cam: np.ndarray,
                 match_emb: np.ndarray | None):
        """Write the advanced state (host arrays) back into the queries."""
        a = self.policy.feat_alpha
        for j, q in enumerate(qs):
            if matched[j]:
                emb = match_emb[j]
                q.feat = l2_normalize((1 - a) * q.feat + a * emb)
                if q.first_match_t < 0:   # detection delay (Fig. 15 metric)
                    q.first_match_t = self.t
                if q.phase >= 2:
                    q.rescued += 1
                    self.rescue_pairs[q.c_q, int(match_cam[j])] += 1
                q.matches.append((int(match_cam[j]), int(q.f_curr)))
                self.sightings.append((q.qid, int(match_cam[j]),
                                       int(q.f_curr)))
            q.f_q, q.c_q = int(state["f_q"][j]), int(state["c_q"][j])
            q.f_curr, q.phase = int(state["f_curr"][j]), int(state["phase"][j])
            q.done = bool(state["done"][j])

    def _plan_round(self, qs: list[QueryState]) -> RoundPlan:
        """Gather + admit, then build the round's work queue: the
        deduplicated (cam, frame) demand with per-key want counts, and the
        injective content-frame -> segment relabeling."""
        ps = self._gather(qs)
        mask_ct = None
        if self.tile_grid > 0:
            # the (N, C) camera mask and the (N, C*T*T) tile-refined
            # admission in one pass; tile_q -1 admits every self tile
            tile_q = torch.tensor([q.tile_q for q in qs], dtype=torch.int32,
                                  device=self.device)
            mask, mask_ct = _to_host(*admit_tiles(
                self.model, self.policy, ps, self._geo_adj, tile_q))
        else:
            (mask,) = _to_host(admit(self.model, self.policy, ps,
                                     self._geo_adj))
        cams_by_q = [np.flatnonzero(row) for row in mask]
        want_count: dict[tuple[int, int], int] = {}
        for i, q in enumerate(qs):
            for cam in cams_by_q[i]:
                key = (int(cam), q.f_curr)
                want_count[key] = want_count.get(key, 0) + 1
        seg_of_frame = {f: s for s, f in
                        enumerate(sorted({q.f_curr for q in qs}))}
        q_seg = np.array([seg_of_frame[q.f_curr] for q in qs], np.int32)
        return RoundPlan(qs=qs, ps=ps, mask=mask,
                         admitted=int(mask.sum()), cams_by_q=cams_by_q,
                         work=sorted(want_count), want_count=want_count,
                         seg_of_frame=seg_of_frame, q_seg=q_seg,
                         mask_ct=mask_ct)

    # -- per-tick ----------------------------------------------------------
    def ingest(self, frames_by_cam: dict[int, Any],
               tiles_by_cam: dict[int, Any] | None = None):
        """New live frames at the current step (frame = detector crops).

        Tile mode (``cfg.tile_grid > 0``) requires per-camera flat tile ids,
        one per crop (``ty * T + tx``; ``core.simulate.tile_index`` maps
        normalized positions to them); a missing or mismatched label set
        raises."""
        for cam, frame in frames_by_cam.items():
            tile = None
            if self.tile_grid > 0:
                tile = None if tiles_by_cam is None else tiles_by_cam.get(cam)
                if tile is None:
                    raise ValueError(
                        f"tile_grid={self.tile_grid} serving requires per-"
                        f"detection tile labels: ingest(frames_by_cam, "
                        f"tiles_by_cam) got none for camera {cam}")
                if len(tile) != len(frame):
                    raise ValueError(
                        f"camera {cam}: {len(tile)} tile labels for "
                        f"{len(frame)} detections at t={self.t}")
                tile = np.asarray(tile, np.int32)
            self.store.append(cam, self.t, frame, tile=tile)

    def tick(self, record_trace: list | None = None) -> dict:
        """One admission+inference round over all live queries at once.

        A caught-up query consumes one content step; a replaying query
        consumes up to ``policy.replay_rate`` content steps (extra rounds),
        with the fractional remainder carried across ticks.  Returns stats;
        pass a list as ``record_trace`` to collect one record per query
        round (qid, f_curr, phase, mask, match outcome, top-k bands).
        """
        stats = {"t": self.t, "admitted_steps": 0, "unique_frames": 0,
                 "batched": 0, "embedded": 0, "cache_hits": 0,
                 "replay_embeds": 0, "matches": 0, "replay_misses": 0,
                 "replay_miss_steps": 0, "content_steps": 0,
                 "replay_steps": 0, "skipped_rounds": 0,
                 "admitted_tiles": 0, "unique_tiles": 0}
        budget = {}
        for q in self.queries.values():
            if q.done:
                continue
            if q.f_curr >= self.t:
                q.replay_credit = 0.0
                budget[q.qid] = 1
            else:
                q.replay_credit += self.policy.replay_rate
                rounds = int(q.replay_credit)
                q.replay_credit -= rounds
                budget[q.qid] = rounds
        while True:
            qs = [q for q in self.queries.values()
                  if not q.done and budget.get(q.qid, 0) > 0
                  and q.f_curr <= self.t]
            if not qs:
                break
            for q in qs:
                if q.f_curr < self.t:
                    budget[q.qid] -= 1
                else:
                    # a replayer that caught up mid-tick banks its unspent
                    # budget back into replay_credit
                    q.replay_credit += budget[q.qid] - 1
                    budget[q.qid] = 0
            self._round(qs, stats, record_trace)
        self.t += 1
        self.ticks += 1
        cutoff = self.t - 2 * self.cfg.retention
        while self.sightings and self.sightings[0][2] < cutoff:
            self.sightings.popleft()
        return stats

    def _round(self, qs: list[QueryState], stats: dict,
               trace: list | None) -> None:
        self._in_round = True
        try:
            self._round_body(qs, stats, trace)
        finally:
            self._in_round = False

    def _round_body(self, qs: list[QueryState], stats: dict,
                    trace: list | None) -> None:
        stats["content_steps"] += len(qs)
        self.content_steps += len(qs)
        replaying = sum(q.f_curr < self.t for q in qs)
        stats["replay_steps"] += replaying
        self.replay_steps += replaying

        # §5.3 skip mode: a sampled-out replay cursor admits nothing by
        # construction — advance it on the host.  Trace records are
        # buffered per qid and emitted in the original round order.
        all_qs = qs
        records: dict[int, dict] = {}
        if self.cfg.short_circuit_skips and self.policy.replay_skip > 1:
            gated = [q for q in qs
                     if replay_sampled_out(self.policy, q.f_q, q.f_curr,
                                           q.f_curr < self.t)]
            if gated:
                self._skip_round(gated, stats,
                                 records if trace is not None else None)
                gated_ids = {q.qid for q in gated}
                qs = [q for q in qs if q.qid not in gated_ids]
                if not qs:
                    if trace is not None:
                        trace.extend(records[q.qid] for q in all_qs)
                    return

        plan = self._plan_round(qs)
        ps, mask = plan.ps, plan.mask
        stats["admitted_steps"] += plan.admitted
        self.admitted_steps += plan.admitted
        stats["unique_frames"] += len(plan.work)
        self.unique_frames += len(plan.work)
        if self.tile_grid > 0:
            self._account_tiles(plan, stats)

        # camera-major key order (plan.work is sorted): ascending gallery
        # index gives the lower row the tie within every query's admitted set
        batch_keys: list[tuple[int, int]] = []
        frames: dict[tuple[int, int], Any] = {}
        key_emb: dict[tuple[int, int], np.ndarray] = {}
        for key in plan.work:
            if self.cfg.embed_cache:
                emb = self.store.get_emb(*key)
                if emb is not None:     # replay re-read: skip re-embedding
                    key_emb[key] = emb
                    batch_keys.append(key)
                    stats["cache_hits"] += 1
                    self.cache_hits += 1
                    continue
            try:
                frame = self.store.get(*key)
            except KeyError:            # evicted: cold-storage miss (§5.3)
                self.replay_misses += 1
                stats["replay_misses"] += 1
                self.replay_miss_steps += plan.want_count[key]
                stats["replay_miss_steps"] += plan.want_count[key]
                continue
            if frame is not None and len(frame):
                batch_keys.append(key)
                frames[key] = frame
        stats["batched"] += len(batch_keys)

        to_embed = [k for k in batch_keys if k not in key_emb]
        for start in range(0, len(to_embed), self.cfg.max_batch):
            keys = to_embed[start:start + self.cfg.max_batch]
            counts = [len(frames[key]) for key in keys]
            crops = [c for key in keys for c in frames[key]]
            emb = l2_normalize(self.embed_fn(np.stack(crops)))  # (n, D)
            self.frames_processed += len(keys)
            stats["embedded"] += len(keys)
            replay_embeds = sum(key[1] < self.t for key in keys)
            stats["replay_embeds"] += replay_embeds
            self.replay_embeds += replay_embeds
            pos = 0
            for key, cnt in zip(keys, counts):
                key_emb[key] = emb[pos:pos + cnt]
                if self.cfg.embed_cache:
                    # the frame was just read out of the store, so it IS
                    # retained — a refused write is a bookkeeping bug
                    if not self.store.put_emb(*key, key_emb[key]):
                        raise RuntimeError(
                            f"engine tried to cache un-retained frame {key}")
                pos += cnt

        # one rank+advance pass over the whole round
        N = mask.shape[0]
        K = self.cfg.topk
        matched = np.zeros(N, bool)
        match_cam = np.zeros(N, np.int32)
        topk_val = np.full((N, K), NEG_INF, np.float32)
        topk_idx = np.full((N, K), -1, np.int32)
        topk_cam = np.full((N, K), -1, np.int32)
        topk_frame = np.full((N, K), -1, np.int32)
        match_emb = None
        dev = self.device
        if batch_keys:
            gal, gal_cam, gal_frame = assemble_round_gallery(batch_keys,
                                                             key_emb)
            q_feat = np.stack([q.feat for q in qs]).astype(np.float32)

            def dev_t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            if self.tile_grid > 0:
                # one tile-masked call whatever cfg.consolidate says (the
                # relabeling is injective, so it changes nothing)
                gal_ct = self._gallery_cells(batch_keys, key_emb,
                                             gal.shape[0])
                gal_seg = plan.gallery_segments(batch_keys, key_emb,
                                                gal.shape[0])
                out = rank_advance_round_tiles(
                    self.policy, self._windows, ps, dev_t(q_feat),
                    dev_t(plan.q_seg), dev_t(plan.mask_ct), dev_t(gal),
                    dev_t(gal_ct), dev_t(gal_cam), dev_t(gal_frame),
                    dev_t(gal_seg), k=K, n_cams=self.C,
                    topk_rerank=self.cfg.topk_rerank)
            elif self.cfg.consolidate:
                gal_seg = plan.gallery_segments(batch_keys, key_emb,
                                                gal.shape[0])
                out = rank_advance_round_seg(
                    self.policy, self._windows, ps, dev_t(q_feat),
                    dev_t(plan.q_seg), dev_t(mask), dev_t(gal),
                    dev_t(gal_cam), dev_t(gal_frame), dev_t(gal_seg),
                    k=K, topk_rerank=self.cfg.topk_rerank)
            else:
                out = rank_advance_round(
                    self.policy, self._windows, ps, dev_t(q_feat),
                    dev_t(mask), dev_t(gal), dev_t(gal_cam), dev_t(gal_frame),
                    k=K, topk_rerank=self.cfg.topk_rerank)
            ps_next = out[0]
            (f_q, c_q, f_curr, phase, done, matched, match_cam, match_emb,
             topk_val, topk_idx, topk_cam, topk_frame) = _to_host(
                ps_next.f_q, ps_next.c_q, ps_next.f_curr, ps_next.phase,
                ps_next.done, *out[1:])
            stats["matches"] += int(matched.sum())
            if self.tile_grid > 0:
                self._follow_tiles(qs, matched, match_cam, topk_idx,
                                   topk_cam, gal_ct)
        else:
            ps_next = advance_round(self.policy, self._windows, ps)
            f_q, c_q, f_curr, phase, done = _to_host(
                ps_next.f_q, ps_next.c_q, ps_next.f_curr, ps_next.phase,
                ps_next.done)

        if trace is not None:
            for j, q in enumerate(qs):
                records[q.qid] = dict(
                    qid=q.qid, f_curr=q.f_curr, phase=q.phase,
                    epoch=self.model_epoch,
                    mask=mask[j].copy(), matched=bool(matched[j]),
                    match_cam=int(match_cam[j]),
                    match_val=float(topk_val[j, 0]),
                    match_idx=int(topk_idx[j, 0]),
                    topk=tuple((float(topk_val[j, b]), int(topk_cam[j, b]),
                                int(topk_frame[j, b])) for b in range(K)))
            trace.extend(records[q.qid] for q in all_qs)

        self._scatter(qs, dict(f_q=f_q, c_q=c_q, f_curr=f_curr, phase=phase,
                               done=done),
                      matched, match_cam, match_emb)

    def _account_tiles(self, plan: RoundPlan, stats: dict) -> None:
        """Both cost conventions, tile-refined: ``admitted_tiles`` counts
        (query, camera, tile) steps; ``unique_tiles`` the per-key union of
        admitted tiles."""
        TT = self.tile_grid * self.tile_grid
        adm_tiles = int(plan.mask_ct.sum())
        stats["admitted_tiles"] += adm_tiles
        self.admitted_tiles += adm_tiles
        tiles_by_key: dict[tuple[int, int], np.ndarray] = {}
        for i, q in enumerate(plan.qs):
            row = plan.mask_ct[i]
            for cam in plan.cams_by_q[i]:
                key = (int(cam), q.f_curr)
                seg = row[key[0] * TT:(key[0] + 1) * TT]
                if key in tiles_by_key:
                    tiles_by_key[key] |= seg
                else:
                    tiles_by_key[key] = seg.copy()
        uniq_tiles = sum(int(v.sum()) for v in tiles_by_key.values())
        stats["unique_tiles"] += uniq_tiles
        self.unique_tiles += uniq_tiles

    def _gallery_cells(self, batch_keys: list, key_emb: dict,
                       rows: int) -> np.ndarray:
        """Per-row fused cells ``cam * T*T + tile`` of the round gallery in
        ``batch_keys`` order, from the ingest-time labels; padding rows
        carry -1."""
        TT = self.tile_grid * self.tile_grid
        gal_ct = np.full(rows, -1, np.int32)
        pos = 0
        for key in batch_keys:
            cnt = len(key_emb[key])
            tiles_k = self.store.get_tile(*key)
            if tiles_k is None or len(tiles_k) != cnt:
                # ingest enforces labels: this is a bookkeeping bug
                raise RuntimeError(
                    f"tile labels missing/mismatched for {key}: got "
                    f"{None if tiles_k is None else len(tiles_k)} for {cnt} "
                    f"gallery rows")
            gal_ct[pos:pos + cnt] = key[0] * TT + np.asarray(tiles_k,
                                                             np.int32)
            pos += cnt
        return gal_ct

    def _follow_tiles(self, qs, matched, match_cam, topk_idx, topk_cam,
                      gal_ct) -> None:
        """A confirmed match pins the query to the matched row's tile; a
        re-ranked match takes the first band of the winning camera."""
        TT = self.tile_grid * self.tile_grid
        for j, q in enumerate(qs):
            if not matched[j]:
                continue
            mi = int(topk_idx[j, 0])
            if self.cfg.topk_rerank:
                for b in range(topk_idx.shape[1]):
                    if topk_cam[j, b] == match_cam[j]:
                        mi = int(topk_idx[j, b])
                        break
            if mi >= 0 and gal_ct[mi] >= 0:
                q.tile_q = int(gal_ct[mi]) % TT

    def _skip_round(self, qs: list[QueryState], stats: dict,
                    records: dict | None) -> None:
        """Host mirror of one no-match ``policy.advance`` step for
        sampled-out replay rounds (their admission mask is all-False)."""
        stats["skipped_rounds"] += len(qs)
        self.skipped_steps += len(qs)
        if records is not None:
            empty_topk = ((float(NEG_INF), -1, -1),) * self.cfg.topk
            for q in qs:
                records[q.qid] = dict(qid=q.qid, f_curr=q.f_curr,
                                      phase=q.phase, epoch=self.model_epoch,
                                      mask=np.zeros(self.C, bool),
                                      matched=False, match_cam=0,
                                      match_val=float(NEG_INF), match_idx=-1,
                                      topk=empty_topk)
        p = self.policy
        for q in qs:
            f_next = q.f_curr + 1
            el_next = f_next - q.f_q
            if p.scheme in ("all", "geo") or not p.use_replay:
                done = el_next > p.exit_t or f_next >= _NO_HORIZON
                f_new, phase_new = f_next, q.phase
            else:
                nothing_relaxed = self._w2[q.c_q] <= p.self_window
                exh1 = q.phase == 1 and el_next > self._w1[q.c_q]
                exh2 = q.phase == 2 and el_next > self._w2[q.c_q]
                exh3 = q.phase >= 3 and el_next > p.exit_t
                if p.exhaustive_final:
                    esc = exh1 or exh2
                    done = exh3 or f_next >= _NO_HORIZON
                else:
                    esc = exh1 and not nothing_relaxed
                    done = ((exh1 and nothing_relaxed) or exh2 or exh3
                            or f_next >= _NO_HORIZON)
                phase_new = q.phase + 1 if esc else q.phase
                f_new = q.f_q + 1 if esc else f_next
            q.f_curr, q.phase, q.done = f_new, phase_new, bool(done)
