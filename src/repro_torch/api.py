"""rexcam facade for the PyTorch/CUDA port.

    from repro_torch import api as rexcam

    model  = rexcam.profile(history_visits)                 # offline §6
    result = rexcam.track(model, visits, gallery, feats,    # batched Alg. 1
                          q_vids, gt_vids,
                          policy=rexcam.SearchPolicy(s_thresh=.05))
    engine = rexcam.serve(model, embed_fn,                  # live engine
                          policy=rexcam.SearchPolicy())

All three default to ``device="cuda"`` and raise when no card is present;
``device="cpu"`` runs the plain PyTorch path.  ``serve(recalibrate=...)``
attaches the §6 drift loop (``RecalibrationController``);
``serve(shards=k)`` (or ``devices=``) builds the sharded fleet
(``ShardedServingEngine``: k workers, on one card by default, a sharded
gallery, optional transports and prefetch).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.correlation import SpatioTemporalModel
from repro_torch.core.policy import (PhaseState, SearchPolicy, admit,  # noqa: F401
                                     advance, phase_windows)
from repro_torch.core.profiler import build_model
from repro_torch.core.simulate import Visits
from repro_torch.core.tracker import (TrackResult, make_queries,  # noqa: F401
                                      trace_queries, track_queries)
from repro_torch.runtime.engine import EngineConfig, ServingEngine
from repro_torch.runtime.fleet import ShardedServingEngine
from repro_torch.runtime.recal import (RecalibrationController,  # noqa: F401
                                       RecalibrationPolicy, match_log_source,
                                       visits_window_source)
from repro_torch.runtime.transport import (FakeRpcTransport,  # noqa: F401
                                           FaultProfile, InProcTransport,
                                           Transport, manual_clock)


def profile(visits: Visits, *, time_limit: int | None = None,
            n_bins: int = 256, bin_width: int = 1, sample_every: int = 1,
            epoch: int = 0, tile_grid: int = 0, tile_keep: float = 1.0,
            device="cuda") -> SpatioTemporalModel:
    """Offline profiling (paper §6): historical visits -> model M on
    ``device``.  ``time_limit`` profiles only visits starting before it
    (§8.4's prefix partition); ``sample_every`` emulates frame-sampled
    labeling; ``tile_grid=T > 0`` also learns the per camera-pair
    entry-region tile masks from ``visits.tile_xy`` (``tile_keep`` is the
    mass each mask covers before its 3x3 halo)."""
    return build_model(visits.ent, visits.cam, visits.t_in, visits.t_out,
                       visits.n_cams, n_bins=n_bins, bin_width=bin_width,
                       sample_every=sample_every, time_limit=time_limit,
                       epoch=epoch, tile_xy=visits.tile_xy,
                       tile_grid=tile_grid, tile_keep=tile_keep,
                       device=device)


def track(model: SpatioTemporalModel, visits: Visits, gallery, feats,
          q_vids, gt_vids, policy: SearchPolicy = SearchPolicy(),
          geo_adj=None, *, device="cuda") -> TrackResult:
    """Batched Algorithm-1 tracking of all queries under one policy on
    ``device`` (see ``repro.api.track`` for the arguments): the profiled
    model M, the live ``Visits`` table, the dense per-(camera, step)
    detection ``gallery`` (``build_gallery``), per-visit re-id features,
    the query / ground-truth visit ids (``make_queries``), the shared
    ``SearchPolicy`` and, for the geo scheme, a (C, C) bool proximity
    mask (None degrades geo to all-camera)."""
    return track_queries(model, visits, gallery, feats, q_vids, gt_vids,
                         policy, geo_adj=geo_adj, device=device)


def serve(model: SpatioTemporalModel, embed_fn: Callable,
          policy: SearchPolicy = SearchPolicy(), *, max_batch: int = 256,
          retention: int = 600, geo_adj=None, shards: int | None = None,
          devices=None, gallery: str = "auto", topk: int = 1,
          transport=None, prefetch: bool = False, consolidate: bool = True,
          tile_grid: int = 0, topk_rerank: bool = False, recalibrate=None,
          visit_source=None, device="cuda") -> ServingEngine:
    """The serving engine on ``device`` (see ``repro.api.serve`` for the
    keywords).  ``consolidate`` ranks each round in one segment-ID kernel
    call (default) or per frame tag; ``topk`` surfaces k candidate bands;
    ``topk_rerank`` turns on the §5.2 confidence vote; ``tile_grid=T > 0``
    ranks each round through the tile-masked kernel over the model's
    learned tile masks (all tiles for a tile-less model) and makes tile
    labels mandatory at ``engine.ingest(frames, tiles)``.

    ``shards=k`` or ``devices=[...]`` builds a ``ShardedServingEngine``:
    the query axis partitioned over k workers (by default all on
    ``device``; ``devices`` maps worker i to ``devices[i]``), each worker's
    rows ranked in its own kernel launch, trace-identical to the single
    engine.  ``gallery`` picks the embedding plane: "auto" (local for one
    engine, the fleet-shared ``ShardedGalleryStore`` for the fleet),
    "local" or "sharded" (fleet only).  ``transport`` (fleet only): None,
    "inproc" or a ``Transport`` such as ``FakeRpcTransport`` routes every
    owner-shard block fetch through the fetch plane; ``prefetch=True``
    issues the next round's cached reads at the end of each round.

    ``recalibrate=True`` (default knobs) or a ``RecalibrationPolicy``
    attaches a ``RecalibrationController`` that re-profiles from
    ``visit_source`` (``(lo, hi) -> (ent, cam, t_in, t_out)``, e.g.
    ``visits_window_source(visits)``; None: the engine's own sighting log)
    and hot-swaps M (on every worker of a fleet) when drift trips its
    trigger; ``visit_source`` without ``recalibrate`` raises."""
    if transport == "inproc":
        transport = InProcTransport()
    elif isinstance(transport, str):
        raise ValueError(f"unknown transport {transport!r} (expected None, "
                         f"'inproc' or a runtime.transport.Transport)")
    if transport is not None and shards is None and devices is None:
        raise ValueError("transport= requires the sharded fleet "
                         "(serve(..., shards=k)): the single engine's local "
                         "gallery has no remote owners to fetch from")
    cfg = EngineConfig(policy=policy, max_batch=max_batch,
                       retention=retention, gallery=gallery, topk=topk,
                       transport=transport, prefetch=prefetch,
                       consolidate=consolidate, tile_grid=tile_grid,
                       topk_rerank=topk_rerank)
    if shards is not None or devices is not None:
        eng = ShardedServingEngine(model, embed_fn, cfg, geo_adj=geo_adj,
                                   shards=shards, devices=devices,
                                   device=device)
    else:
        eng = ServingEngine(model, embed_fn, cfg, geo_adj=geo_adj,
                            device=device)
    if recalibrate is not None and recalibrate is not False:
        rp = RecalibrationPolicy() if recalibrate is True else recalibrate
        if not isinstance(rp, RecalibrationPolicy):
            raise TypeError(f"recalibrate= takes True or a "
                            f"RecalibrationPolicy, got {recalibrate!r}")
        eng.recal = RecalibrationController(eng, visit_source, rp)
    elif visit_source is not None:
        raise ValueError("visit_source= given without recalibrate=: pass "
                         "recalibrate=True (or a RecalibrationPolicy) to "
                         "attach the recalibration loop")
    return eng
