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
"""
from __future__ import annotations

import numpy as np

from repro_torch.convert import model_from_numpy
from repro_torch.core.correlation import INF_TIME, SpatioTemporalModel
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

    C, NB = n_cams, n_bins
    counts = np.zeros((C, C), np.float64)
    np.add.at(counts, (src, dst), 1.0)

    hist = np.zeros((C, C, NB), np.float64)
    b = np.clip(dt // bin_width, 0, NB - 1)
    np.add.at(hist, (src, dst, b), 1.0)

    f0 = np.full((C, C), int(INF_TIME), np.int64)
    np.minimum.at(f0, (src, dst), dt)

    exits = np.zeros((C,), np.float64)
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

    return model_from_numpy(
        dict(S=S, exit_frac=exit_frac, cdf=cdf,
             f0=np.minimum(f0, int(INF_TIME)), entry=entry, counts=counts),
        bin_width=bin_width, epoch=epoch, tile_admit=tile_admit,
        tile_grid=tile_grid, tile_learned=tile_admit is not None,
        device=device)
