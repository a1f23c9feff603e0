"""One function per paper table or figure (§3, §8), the counterpart of
``benchmarks/tables.py``.

Each runs the batched tracker (``core/tracker.py``) or identity detection
(``core/detect.py``) on ``device`` over the worlds of
``repro_torch.benchmarks.scenarios`` and returns ``(name, us_per_call,
derived)`` rows with the reference's names and count columns;
``us_per_call`` is this run's host-clock wall a query.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig11_duke \\
        [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.benchmarks import scenarios
from repro_torch.core.detect import (DetectorParams, identity_detection,
                                     make_detection_queries)
from repro_torch.core.profiler import (build_model, profiling_cost,
                                       transitions_from_visits)
from repro_torch.core.tracker import TrackerParams, track_queries
from repro_torch.device import resolve_device


def _track(sc, p: TrackerParams, device):
    """(TrackResult, host-clock microseconds a query) of one tracker run."""
    t0 = time.perf_counter()
    r = track_queries(sc["model"], sc["vis"], sc["gal"], sc["feats"],
                      sc["q_vids"], sc["gt_vids"], p,
                      geo_adj=sc["net"].geo_adjacent, device=device)
    wall = (time.perf_counter() - t0) * 1e6 / max(len(sc["q_vids"]), 1)
    return r, wall


def _row(name, wall_us, **derived):
    """One CSV row: (name, us_per_call, "k=v;..." with floats to 4
    significant digits)."""
    d = ";".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in derived.items())
    return (name, wall_us, d)


def fig10_anoncampus(*, device="cuda"):
    """Fig. 10: 5-camera AnonCampus, the baseline against ReXCam's
    versions."""
    device = resolve_device(device)
    sc = scenarios.anoncampus()
    rows = []
    base, wall = _track(sc, TrackerParams(scheme="all"), device)
    rows.append(_row("fig10/anoncampus/all", wall, cost=base.total_cost,
                     recall=base.recall, precision=base.precision, savings=1.0))
    for tag, p in [
        ("S20", TrackerParams(scheme="spatial_only", s_thresh=.20)),
        ("S30-T1", TrackerParams(scheme="rexcam", s_thresh=.30, t_thresh=.01)),
        ("S30-T5", TrackerParams(scheme="rexcam", s_thresh=.30, t_thresh=.05)),
        ("S40-T10", TrackerParams(scheme="rexcam", s_thresh=.40, t_thresh=.10)),
    ]:
        r, wall = _track(sc, p, device)
        rows.append(_row(f"fig10/anoncampus/{tag}", wall, cost=r.total_cost,
                         recall=r.recall, precision=r.precision,
                         savings=base.total_cost / max(r.total_cost, 1),
                         delay=r.mean_delay))
    rows.append(_row("fig10/paper-ref", 0.0, savings=3.4, note="ReXCam-O 3.4x"))
    return rows


def fig11_duke(*, device="cuda"):
    """Fig. 11: 8-camera Duke, the paper's headline table."""
    device = resolve_device(device)
    sc = scenarios.duke()
    rows = []
    base, wall = _track(sc, TrackerParams(scheme="all"), device)
    rows.append(_row("fig11/duke/all", wall, cost=base.total_cost,
                     recall=base.recall, precision=base.precision, savings=1.0))
    geo, wall = _track(sc, TrackerParams(scheme="geo"), device)
    rows.append(_row("fig11/duke/geo", wall, cost=geo.total_cost,
                     recall=geo.recall, precision=geo.precision,
                     savings=base.total_cost / max(geo.total_cost, 1)))
    for tag, p in [
        ("S5", TrackerParams(scheme="spatial_only", s_thresh=.05)),
        ("S5-T1", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.01)),
        ("S5-T2", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.02)),
        ("S5-T10", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.10)),
        ("S10-T10", TrackerParams(scheme="rexcam", s_thresh=.10, t_thresh=.10)),
    ]:
        r, wall = _track(sc, p, device)
        rows.append(_row(f"fig11/duke/{tag}", wall, cost=r.total_cost,
                         recall=r.recall, precision=r.precision,
                         savings=base.total_cost / max(r.total_cost, 1),
                         delay=r.mean_delay, rescued=int(r.rescued.sum())))
    rows.append(_row("fig11/paper-ref", 0.0, savings=8.3,
                     note="ReXCam-O 8.3x; precision 51->90; recall -1.6"))
    return rows


def fig12_porto(*, device="cuda"):
    """Fig. 12: 130-camera Porto."""
    device = resolve_device(device)
    sc = scenarios.porto(130)
    rows = []
    base, wall = _track(sc, TrackerParams(scheme="all"), device)
    rows.append(_row("fig12/porto/all", wall, cost=base.total_cost,
                     recall=base.recall, precision=base.precision, savings=1.0))
    geo, wall = _track(sc, TrackerParams(scheme="geo"), device)
    rows.append(_row("fig12/porto/geo", wall, cost=geo.total_cost,
                     recall=geo.recall, precision=geo.precision,
                     savings=base.total_cost / max(geo.total_cost, 1)))
    for tag, p in [
        ("S1-T1", TrackerParams(scheme="rexcam", s_thresh=.01, t_thresh=.01)),
        ("S5-T2", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.02)),
        ("S12-T12", TrackerParams(scheme="rexcam", s_thresh=.12, t_thresh=.12)),
    ]:
        r, wall = _track(sc, p, device)
        rows.append(_row(f"fig12/porto/{tag}", wall, cost=r.total_cost,
                         recall=r.recall, precision=r.precision,
                         savings=base.total_cost / max(r.total_cost, 1),
                         delay=r.mean_delay))
    rows.append(_row("fig12/paper-ref", 0.0, savings=23.0,
                     note="ReXCam-O 23x at 130 cams"))
    return rows


def fig13_camera_scaling(*, device="cuda"):
    """Fig. 13: savings grow with the number of cameras."""
    device = resolve_device(device)
    rows = []
    for n in (30, 60, 90, 130):
        sc = scenarios.porto(n)
        base, _ = _track(sc, TrackerParams(scheme="all"), device)
        rex, wall = _track(sc, TrackerParams(scheme="rexcam", s_thresh=.01,
                                             t_thresh=.01), device)
        rows.append(_row(f"fig13/porto{n}", wall,
                         savings=base.total_cost / max(rex.total_cost, 1),
                         recall=rex.recall, precision=rex.precision,
                         base_precision=base.precision))
    rows.append(_row("fig13/paper-ref", 0.0, savings=38.0,
                     note="up to 38x at 130 cams (S12-T12)"))
    return rows


def fig14_frame_skipping(*, device="cuda"):
    """Fig. 14: uniform frame skipping is orthogonal to ReXCam's savings.
    Skipping 1 in k frames is the tracker stepping on a decimated
    timeline, emulated by masking those steps out of a copy of the
    gallery."""
    device = resolve_device(device)
    sc = scenarios.duke()
    rows = []
    for skip, tag in [(1, "none"), (3, "skip1in3"), (4, "skip1in4")]:
        gal = sc["gal"].copy()
        if skip > 1:
            gal[:, ::skip] = -1          # the skipped frames are never examined
        sub = dict(sc, gal=gal)
        base, _ = _track(sub, TrackerParams(scheme="all"), device)
        rex, wall = _track(sub, TrackerParams(scheme="rexcam", s_thresh=.05,
                                              t_thresh=.02), device)
        rows.append(_row(f"fig14/{tag}", wall,
                         base_cost=base.total_cost, rex_cost=rex.total_cost,
                         savings=base.total_cost / max(rex.total_cost, 1),
                         recall=rex.recall))
    rows.append(_row("fig14/paper-ref", 0.0,
                     note="8.6x and 8.4x with skipping vs 8.3x without"))
    return rows


def fig15_replay(*, device="cuda"):
    """Fig. 15: replay modes, cost against delay."""
    device = resolve_device(device)
    sc = scenarios.duke()
    rows = []
    base, _ = _track(sc, TrackerParams(scheme="all"), device)
    for tag, p in [
        ("normal", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.02)),
        ("2xskip", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.02,
                                 replay_skip=2)),
        ("2xff", TrackerParams(scheme="rexcam", s_thresh=.05, t_thresh=.02,
                               replay_speed=2.0)),
    ]:
        r, wall = _track(sc, p, device)
        rows.append(_row(f"fig15/{tag}", wall, cost=r.total_cost,
                         savings=base.total_cost / max(r.total_cost, 1),
                         recall=r.recall, precision=r.precision,
                         delay=r.mean_delay))
    rows.append(_row("fig15/paper-ref", 0.0,
                     note="delay 2.6->1.8 (2xskip) / 1.3 (2xff); "
                          "savings 8.30->8.68 / 8.27"))
    return rows


def fig16_profiling(*, device="cuda"):
    """Fig. 16: profiling cost (frame sampling) against live-tracking
    recall, and the break-even query count."""
    device = resolve_device(device)
    sc = scenarios.duke()
    vis = sc["vis"]
    rows = []
    base, _ = _track(sc, TrackerParams(scheme="all"), device)
    for k in (1, 2, 4, 6, 8):
        model = build_model(vis.ent, vis.cam, vis.t_in, vis.t_out,
                            sc["net"].n_cams, time_limit=3000, sample_every=k,
                            device=device)
        sub = dict(sc, model=model)
        rex, wall = _track(sub, TrackerParams(scheme="rexcam", s_thresh=.05,
                                              t_thresh=.02), device)
        cost = profiling_cost(vis.ent, vis.cam, vis.t_in, vis.t_out,
                              sample_every=k, time_limit=3000)
        rows.append(_row(f"fig16/sample{k}x", wall, profile_frames=cost,
                         recall=rex.recall, precision=rex.precision,
                         savings=base.total_cost / max(rex.total_cost, 1)))
    # break-even: profiling frames over the per-query saving
    full_cost = profiling_cost(vis.ent, vis.cam, vis.t_in, vis.t_out, 1, 3000)
    rex, _ = _track(sc, TrackerParams(scheme="rexcam", s_thresh=.05,
                                      t_thresh=.02), device)
    per_query_saving = (base.total_cost - rex.total_cost) / len(sc["q_vids"])
    rows.append(_row("fig16/break-even-queries", 0.0,
                     queries=float(np.ceil(full_cost
                                           / max(per_query_saving, 1))),
                     note="paper: 34 queries"))
    return rows


#: fig17's lost identities and search start
DETECT_QUERIES, DETECT_START = 40, 3200


def fig17_identity_detection(*, device="cuda", summaries=None):
    """Fig. 17: identity detection (§5.4), the lost-identity scenario: the
    query enters the network at an unknown time and camera after the
    search starts.  The baseline, then theta 0.95, 0.85 and 0.75.  Pass a
    list as ``summaries`` to collect each run's full ``identity_detection``
    summary, as (row name, summary) pairs."""
    device = resolve_device(device)
    sc = scenarios.duke()
    t_start = DETECT_START
    q = make_detection_queries(sc["vis"], DETECT_QUERIES,
                               search_start=t_start, seed=1)
    rows = []
    t0 = time.perf_counter()
    base = identity_detection(sc["model"], sc["vis"], sc["feats"], q,
                              DetectorParams(theta=0.95), baseline=True,
                              t_refs=t_start, device=device)
    wall = (time.perf_counter() - t0) * 1e6 / max(len(q), 1)
    rows.append(_row("fig17/baseline", wall, cost=base["cost"],
                     recall=base["recall"], precision=base["precision"]))
    if summaries is not None:
        summaries.append(("fig17/baseline", base))
    for theta in (0.95, 0.85, 0.75):
        t0 = time.perf_counter()
        r = identity_detection(sc["model"], sc["vis"], sc["feats"], q,
                               DetectorParams(theta=theta), t_refs=t_start,
                               device=device)
        wall = (time.perf_counter() - t0) * 1e6 / max(len(q), 1)
        rows.append(_row(f"fig17/theta{theta}", wall, cost=r["cost"],
                         savings=base["cost"] / max(r["cost"], 1),
                         recall=r["recall"], precision=r["precision"],
                         rounds=r["rounds"]))
        if summaries is not None:
            summaries.append((f"fig17/theta{theta}", r))
    rows.append(_row("fig17/paper-ref", 0.0,
                     note="7.6x at theta=.95; 6.6x at .75 w/ no recall drop"))
    return rows


def sec3_potential(*, device="cuda"):
    """§3: the analytic potential of spatial, temporal and combined
    filtering, from the profiled model (``device`` holds the model's
    query tensors)."""
    device = resolve_device(device)
    sc = scenarios.duke()
    m = sc["model"].to(device)
    S = m.S.cpu().numpy()
    peers = (S >= 0.05).sum(1)
    rows = [
        _row("sec3/peers_ge_5pct", 0.0, mean=float(peers.mean()),
             note="paper: 1.9 of 7"),
        _row("sec3/spatial_only_potential", 0.0,
             savings=m.potential_savings(0.05, 0.0), note="paper: 3.7x"),
        _row("sec3/temporal_only_potential", 0.0,
             savings=m.potential_savings(0.0, 0.02), note="paper: 7.5x"),
        _row("sec3/combined_potential", 0.0,
             savings=m.potential_savings(0.05, 0.02), note="paper: 9.4x"),
    ]
    vis = sc["vis"]
    _, _, dt, _, _ = transitions_from_visits(vis.ent, vis.cam, vis.t_in,
                                             vis.t_out)
    rows.append(_row("sec3/travel_stats", 0.0, mean_s=float(dt.mean()),
                     std_s=float(dt.std()), note="paper: 44.2 / 10.3"))
    return rows
