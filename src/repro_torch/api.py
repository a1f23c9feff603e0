"""rexcam facade for the PyTorch/CUDA port.

    from repro_torch import api as rexcam

    model  = rexcam.profile(history_visits)                 # offline §6
    engine = rexcam.serve(model, embed_fn,                  # live engine
                          policy=rexcam.SearchPolicy())

Both default to ``device="cuda"`` and raise when no card is present;
``device="cpu"`` runs the plain PyTorch path.  ``track`` (the batched
tracker), the fleet and recalibration are not ported yet (ROADMAP.md,
Queue 1): their keywords are accepted here and raise.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.correlation import SpatioTemporalModel
from repro_torch.core.policy import (PhaseState, SearchPolicy, admit,  # noqa: F401
                                     advance, phase_windows)
from repro_torch.core.profiler import build_model
from repro_torch.core.simulate import Visits
from repro_torch.core.tracker import make_queries  # noqa: F401
from repro_torch.runtime.engine import EngineConfig, ServingEngine


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


def serve(model: SpatioTemporalModel, embed_fn: Callable,
          policy: SearchPolicy = SearchPolicy(), *, max_batch: int = 256,
          retention: int = 600, geo_adj=None, shards: int | None = None,
          devices=None, gallery: str = "auto", topk: int = 1,
          transport=None, prefetch: bool = False, consolidate: bool = True,
          tile_grid: int = 0, topk_rerank: bool = False, recalibrate=None,
          visit_source=None, device="cuda") -> ServingEngine:
    """The single serving engine on ``device`` (see ``repro.api.serve`` for
    the keywords).  ``consolidate`` ranks each round in one segment-ID
    kernel call (default) or per frame tag; ``topk`` surfaces k candidate
    bands; ``topk_rerank`` turns on the §5.2 confidence vote;
    ``tile_grid=T > 0`` ranks each round through the tile-masked kernel
    over the model's learned tile masks (all tiles for a tile-less model)
    and makes tile labels mandatory at ``engine.ingest(frames, tiles)``.
    ``shards``, ``devices``, ``transport``, ``prefetch``, ``recalibrate``
    and ``visit_source`` are not ported yet and raise."""
    unported = dict(shards=shards is not None, devices=devices is not None,
                    transport=transport is not None, prefetch=prefetch,
                    recalibrate=recalibrate not in (None, False),
                    visit_source=visit_source is not None)
    named = [k for k, v in unported.items() if v]
    if named:
        raise NotImplementedError(
            f"serve({', '.join(named)}=...) is not ported yet (ROADMAP.md, "
            f"Queue 1): the port serves one engine")
    if gallery not in ("auto", "local"):
        raise ValueError(f"gallery={gallery!r}: the single engine keeps a "
                         f"local gallery ('auto' or 'local')")
    cfg = EngineConfig(policy=policy, max_batch=max_batch,
                       retention=retention, topk=topk,
                       consolidate=consolidate, tile_grid=tile_grid,
                       topk_rerank=topk_rerank)
    return ServingEngine(model, embed_fn, cfg, geo_adj=geo_adj, device=device)
