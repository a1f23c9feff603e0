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
"""
from __future__ import annotations

import numpy as np

from repro_torch.convert import model_from_numpy
from repro_torch.core.correlation import INF_TIME, SpatioTemporalModel
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


def build_model(ent, cam, t_in, t_out, n_cams: int, *, n_bins: int = 256,
                bin_width: int = 1, sample_every: int = 1,
                time_limit: int | None = None, epoch: int = 0,
                tile_grid: int = 0, device="cuda") -> SpatioTemporalModel:
    """Profile a visit table into a SpatioTemporalModel on ``device``.

    ``time_limit`` restricts profiling to visits starting before it (paper
    §8.4 profiles on a prefix partition).  ``epoch`` stamps the model
    version.  ``tile_grid > 0`` (sub-frame entry-region masks) is not
    ported yet and raises.
    """
    if tile_grid > 0:
        raise NotImplementedError(
            "tile_grid > 0 is not ported yet (ROADMAP.md, Queue 1: the tile "
            "plane)")
    device = resolve_device(device)
    ent, cam, t_in, t_out = map(np.asarray, (ent, cam, t_in, t_out))
    if time_limit is not None:
        keep = t_in < time_limit
        ent, cam, t_in, t_out = ent[keep], cam[keep], t_in[keep], t_out[keep]
    ent, cam, t_in, t_out = subsample_visits(ent, cam, t_in, t_out,
                                             sample_every)

    src, dst, dt, exit_cams, entry_cams = transitions_from_visits(
        ent, cam, t_in, t_out)

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
        bin_width=bin_width, epoch=epoch, device=device)
