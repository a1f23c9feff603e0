"""Offline profiling of spatio-temporal correlations (paper §6).

Input is the output of an MTMC tracker over historical video, consolidated
into *visits* (entity, camera, t_in, t_out).  The profiler orders each
entity's visits in time, extracts consecutive-visit transitions
(c_s -> c_d, dt), accumulates counts, travel-time histograms, first-arrival
times and the entry distribution in float64 numpy, and casts once to the
model's float32 tensors — the same accumulation and the same single cast
as ``repro.core.profiler.build_model``, so every field is exactly equal.

Frame-sampled profiling (paper §8.4): ``sample_every=k`` keeps only visits
some multiple of k intersects and quantizes their timestamps.

``tile_grid=T`` also learns the CrossRoI-style (C, C, T*T) entry-region
admit tensor from the visits' normalized positions, as
``repro.core.profiler.tile_admit_from_visits`` does.

Recalibration (§6) reads ``drift_score`` and re-profiles either the whole
model or, row-targeted, only the drifted source rows
(``merge_reprofiled_rows``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.convert import model_from_numpy
from repro_torch.core.correlation import (INF_TIME, SpatioTemporalModel,
                                          splice_rows)
from repro_torch.core.simulate import tile_index
from repro_torch.device import resolve_device


def subsample_visits(ent, cam, t_in, t_out, sample_every: int):
    """Emulate frame-sampled MTMC labeling (returns filtered+quantized visits)."""
    if sample_every <= 1:
        return ent, cam, t_in, t_out
    k = sample_every
    first_tick = ((t_in + k - 1) // k) * k          # first labeled frame >= t_in
    seen = first_tick <= t_out
    q_in = first_tick
    q_out = (t_out // k) * k
    return ent[seen], cam[seen], q_in[seen], q_out[seen]


def transitions_from_visits(ent, cam, t_in, t_out):
    """Consecutive-visit transitions per entity.

    Returns (src_cam, dst_cam, dt, exit_cams, entry_cams): the first three
    per *transition*, the last two the camera of each entity's last and
    first visit (exit/entry statistics).
    """
    order = np.lexsort((np.asarray(t_in), np.asarray(ent)))
    e = np.asarray(ent)[order]
    c = np.asarray(cam)[order]
    ti = np.asarray(t_in)[order]
    to = np.asarray(t_out)[order]
    same = e[1:] == e[:-1]
    src = c[:-1][same]
    dst = c[1:][same]
    dt = (ti[1:] - to[:-1])[same]
    dt = np.maximum(dt, 0)
    is_last = np.ones(len(e), bool)
    is_last[:-1] = ~same
    is_first = np.ones(len(e), bool)
    is_first[1:] = ~same
    return src, dst, dt, c[is_last], c[is_first]


def tile_admit_from_visits(ent, cam, t_in, tile_xy, n_cams: int,
                           tile_grid: int, tile_keep: float = 1.0,
                           rows=None) -> np.ndarray:
    """Per directed camera-pair entry-region masks on a T x T grid.

    For every consecutive-visit transition (c_s -> c_d) the destination
    visit's tile is histogrammed into ``hist[c_s, c_d, tile]``; each pair's
    histogram keeps the smallest tile set covering ``tile_keep`` of its
    mass, dilated by one tile in every direction (a 3x3 halo).  Pairs with
    no profiled transition admit every tile.

    Returns a (C, C, T*T) bool ndarray, or with ``rows=`` (sorted source
    camera ids) only those source rows as a (len(rows), C, T*T) block."""
    C, T = n_cams, tile_grid
    order = np.lexsort((np.asarray(t_in), np.asarray(ent)))
    e = np.asarray(ent)[order]
    c = np.asarray(cam)[order]
    same = e[1:] == e[:-1]
    src = c[:-1][same]
    dst = c[1:][same]
    dst_tile = tile_index(np.asarray(tile_xy)[order][1:][same], T)

    if rows is None:
        n_rows, row_of = C, np.arange(C)
    else:
        rows = np.asarray(rows, np.int64)
        n_rows = len(rows)
        row_of = np.full(C, -1, np.int64)        # source cam -> block row
        row_of[rows] = np.arange(n_rows)
        keep = row_of[src] >= 0
        src, dst, dst_tile = src[keep], dst[keep], dst_tile[keep]

    hist = np.zeros((n_rows, C, T * T), np.float64)
    np.add.at(hist, (row_of[src], dst, dst_tile), 1.0)

    total = hist.sum(-1)                         # per-pair transition counts
    admit = np.ones((n_rows, C, T * T), bool)    # unobserved pairs: admit all
    for s, d in np.argwhere(total > 0):
        h = hist[s, d]
        ranked = np.argsort(-h, kind="stable")
        cum = np.cumsum(h[ranked])
        n_keep = int(np.searchsorted(cum, tile_keep * total[s, d] - 1e-9)) + 1
        core = np.zeros(T * T, bool)
        core[ranked[:n_keep]] = h[ranked[:n_keep]] > 0
        g = core.reshape(T, T)
        out = g.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ys = slice(max(dy, 0), T + min(dy, 0))
                yd = slice(max(-dy, 0), T + min(-dy, 0))
                xs = slice(max(dx, 0), T + min(dx, 0))
                xd = slice(max(-dx, 0), T + min(-dx, 0))
                out[yd, xd] |= g[ys, xs]
        admit[s, d] = out.reshape(T * T)
    return admit


def build_model(ent, cam, t_in, t_out, n_cams: int, *, n_bins: int = 256,
                bin_width: int = 1, sample_every: int = 1,
                time_limit: int | None = None, epoch: int = 0,
                tile_xy=None, tile_grid: int = 0, tile_keep: float = 1.0,
                device="cuda") -> SpatioTemporalModel:
    """Profile a visit table into a SpatioTemporalModel on ``device``.

    ``time_limit`` restricts profiling to visits starting before it (paper
    §8.4 profiles on a prefix partition).  ``epoch`` stamps the model
    version.  ``tile_grid=T`` with per-visit normalized positions
    ``tile_xy`` also learns the (C, C, T*T) entry-region admit tensor
    (``tile_admit_from_visits``, mass threshold ``tile_keep``).
    """
    device = resolve_device(device)
    ent, cam, t_in, t_out = map(np.asarray, (ent, cam, t_in, t_out))
    if tile_xy is not None:
        tile_xy = np.asarray(tile_xy)
    if time_limit is not None:
        keep = t_in < time_limit
        ent, cam, t_in, t_out = ent[keep], cam[keep], t_in[keep], t_out[keep]
        if tile_xy is not None:
            tile_xy = tile_xy[keep]
    if sample_every > 1 and tile_xy is not None:
        # the tile labels follow subsample_visits' `seen` filter
        k = sample_every
        tile_xy = tile_xy[((t_in + k - 1) // k) * k <= t_out]
    ent, cam, t_in, t_out = subsample_visits(ent, cam, t_in, t_out,
                                             sample_every)

    src, dst, dt, exit_cams, entry_cams = transitions_from_visits(
        ent, cam, t_in, t_out)

    tile_admit = None
    if tile_grid > 0:
        if tile_xy is None:
            raise ValueError("tile_grid > 0 requires per-visit tile_xy "
                             "positions (Visits.tile_xy)")
        tile_admit = tile_admit_from_visits(ent, cam, t_in, tile_xy, n_cams,
                                            tile_grid, tile_keep)

    return model_from_numpy(
        _profile_rows(src, dst, dt, exit_cams, entry_cams, n_cams, n_bins,
                      bin_width),
        bin_width=bin_width, epoch=epoch, tile_admit=tile_admit,
        tile_grid=tile_grid, tile_learned=tile_admit is not None,
        device=device)


def _profile_rows(src, dst, dt, exit_cams, entry_cams, n_cams: int,
                  n_bins: int, bin_width: int, rows=None) -> dict:
    """The model's statistics in float64 from the transitions: ``S``,
    ``exit_frac``, ``cdf``, ``f0`` and ``counts`` of the source-camera
    ``rows`` (sorted camera ids; every camera when None) as (R, C[, NB])
    blocks, and the global ``entry`` over every camera.  Each row depends
    only on the transitions departing it and the exits at it."""
    C, NB = n_cams, n_bins
    if rows is None:
        R = C
    else:
        R = len(rows)
        row_of = np.full(C, -1, np.int64)       # source cam -> block row
        row_of[rows] = np.arange(R)
        keep = row_of[src] >= 0
        src, dst, dt = row_of[src[keep]], dst[keep], dt[keep]
        exit_cams = row_of[exit_cams[row_of[exit_cams] >= 0]]

    counts = np.zeros((R, C), np.float64)
    np.add.at(counts, (src, dst), 1.0)

    hist = np.zeros((R, C, NB), np.float64)
    b = np.clip(dt // bin_width, 0, NB - 1)
    np.add.at(hist, (src, dst, b), 1.0)

    f0 = np.full((R, C), int(INF_TIME), np.int64)
    np.minimum.at(f0, (src, dst), dt)

    exits = np.zeros((R,), np.float64)
    np.add.at(exits, exit_cams, 1.0)
    entry = np.zeros((C,), np.float64)
    np.add.at(entry, entry_cams, 1.0)

    out_total = counts.sum(1) + exits                # all traffic leaving each camera
    denom = np.maximum(out_total, 1.0)
    S = counts / denom[:, None]
    exit_frac = exits / denom

    cdf = np.cumsum(hist, axis=-1)
    cdf = cdf / np.maximum(cdf[..., -1:], 1.0)

    entry = entry / max(entry.sum(), 1.0)
    return dict(S=S, exit_frac=exit_frac, cdf=cdf,
                f0=np.minimum(f0, int(INF_TIME)), entry=entry, counts=counts)


def merge_reprofiled_rows(old: SpatioTemporalModel, ent, cam, t_in, t_out,
                          rows, *, tile_xy=None, tile_keep: float = 1.0,
                          epoch: int | None = None) -> SpatioTemporalModel:
    """Row-targeted re-profile (§6 at 130-camera scale): recompute only the
    drifted source-camera ``rows`` from a fresh visit window and carry
    every other row of ``old`` bit for bit.

    Every per-pair statistic is row-local in the source camera
    (``correlation.ROW_LOCAL_FIELDS``), so a recomputed row is what a full
    ``build_model`` over the same window would put there: the same float64
    accumulation and the same numpy cast to float32.  ``entry``, the one
    global field, is always recomputed from the whole window.  With
    ``tile_xy`` and a tile-learned ``old`` the drifted rows' entry-region
    masks are re-learned from the window; without window positions the
    incumbent masks ride forward on every row.

    Shapes, ``n_bins`` and ``bin_width`` come from ``old`` and the merged
    model lands on ``old``'s device.  ``rows`` is deduplicated and sorted;
    ``epoch`` defaults to ``old.epoch`` (``engine.swap_model`` stamps the
    bump either way)."""
    ent, cam, t_in, t_out = map(np.asarray, (ent, cam, t_in, t_out))
    rows = np.unique(np.asarray(rows, np.int64))
    C = old.n_cams
    if len(rows) == 0 or rows[0] < 0 or rows[-1] >= C:
        raise ValueError(f"merge_reprofiled_rows: rows {rows} outside the "
                         f"model's [0, {C}) camera range (or empty)")
    updates = _profile_rows(*transitions_from_visits(ent, cam, t_in, t_out),
                            C, old.n_bins, old.bin_width, rows=rows)
    entry = updates.pop("entry")             # global: the whole window
    if old.tile_admit is not None and tile_xy is not None \
            and old.tile_grid > 0:
        updates["tile_admit"] = tile_admit_from_visits(
            ent, cam, t_in, np.asarray(tile_xy), C, old.tile_grid,
            tile_keep, rows=rows)
    return splice_rows(old, rows, updates, entry=entry,
                       epoch=old.epoch if epoch is None else epoch)


def profiling_cost(ent, cam, t_in, t_out, sample_every: int = 1,
                   time_limit: int | None = None) -> int:
    """Frames the MTMC tracker must label for this profile (paper §8.4
    x-axis): one frame per camera per labeled tick in the profile window."""
    t_out = np.asarray(t_out)
    horizon = int(t_out.max()) + 1 if time_limit is None else time_limit
    n_cams = int(np.asarray(cam).max()) + 1
    ticks = horizon // max(sample_every, 1)
    return int(ticks * n_cams)


def drift_score(model: SpatioTemporalModel, replay_rescues,
                smoothing: float = 3.0) -> np.ndarray:
    """Paper §6 drift detection: rescue events per (c_s, c_d) normalised by
    the profile's transition counts (additively smoothed so single rescues
    on near-empty pairs don't dominate), as a (C, C) float64 host array.

    An all-zero rescue matrix scores exactly zero without touching the
    division or the model.  Otherwise the counts come from
    ``model.host_counts``, copied off the device once per model."""
    rescues = np.asarray(replay_rescues, np.float64)
    if not rescues.any():
        return np.zeros_like(rescues)
    counts = model.host_counts + smoothing
    with np.errstate(divide="ignore", invalid="ignore"):
        score = rescues / counts
    # smoothing=0 on a never-profiled pair: a rescue there is infinite
    # surprise; keep it finite but dominant
    return np.nan_to_num(score, nan=0.0, posinf=np.float64(1e18))
