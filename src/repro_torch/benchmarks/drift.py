"""Paper §6 end to end on the batched tracker: correlation drift ->
detection -> re-profiling (``sec6_drift``), the counterpart of
``benchmarks/drift.py``.

A road closure reroutes c1's outbound traffic.  The stale model misses the
new transitions; the misses surface as replay rescues concentrated on the
changed camera pairs (``rescue_pairs``), the paper's re-profiling trigger,
and re-profiling on the post-change window restores the operating point.

    PYTHONPATH=src python -m repro_torch.benchmarks.drift [--device cpu]

prints ``name,us_per_call,derived`` CSV rows, as ``benchmarks/run.py
--only sec6_drift`` does.  ``--device cuda`` (the default) tracks on the
card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.benchmarks.tables import _row
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.policy import SearchPolicy
from repro_torch.core.profiler import build_model, drift_score
from repro_torch.core.simulate import (CameraNetwork, build_gallery,
                                       duke_like_network, simulate_network)
from repro_torch.core.tracker import make_queries, track_queries
from repro_torch.device import resolve_device


def _rerouted(net: CameraNetwork) -> CameraNetwork:
    """Road closure: c1->c2 traffic (the strongest pair) reroutes to c1->c5,
    a pair the profile calls uncorrelated (S = 0.005 < s_thresh), so the
    stale model prunes exactly the frames the traffic now uses."""
    T = net.trans.copy()
    moved = T[0, 1] * 0.9
    T[0, 1] -= moved
    T[0, 4] += moved
    return dataclasses.replace(net, trans=T)


def run(device="cuda", reference: bool = True):
    """The three rows of ``sec6_drift``: the unchanged world under the
    original profile, the changed world under the stale profile (with the
    hot pair its rescues point at), and under a re-profile of the changed
    world.  Every model and every tracker loop lives on ``device``.  With
    ``reference=False`` the first row, the one run that does not see the
    drift, is left out (its tracker loop is a third of the time)."""
    device = resolve_device(device)
    net = duke_like_network()
    changed = _rerouted(net)

    # history (pre-change) -> profile
    hist = simulate_network(net, 2000, 4000, seed=21)
    model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out, net.n_cams,
                        device=device)

    # live traffic after the road closure
    vis = simulate_network(changed, 2000, 4000, seed=22)
    gal, _ = build_gallery(vis, 24)
    feats, _ = make_features(vis, 2000, FeatureParams(seed=22))
    q_vids, gt_vids = make_queries(vis, 60, seed=23)
    p = SearchPolicy(scheme="rexcam", s_thresh=.05, t_thresh=.02)

    base = track_queries(model, vis, gal, feats, q_vids, gt_vids, p,
                         geo_adj=net.geo_adjacent, device=device)

    # drift detection: rescue spike normalised by historical counts
    score = drift_score(model, base.rescue_pairs)
    hot = np.unravel_index(np.argmax(score), score.shape)

    # re-profile on the (changed) recent window and re-track
    model2 = build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, net.n_cams,
                         time_limit=2500, device=device)
    fresh = track_queries(model2, vis, gal, feats, q_vids, gt_vids, p,
                          geo_adj=net.geo_adjacent, device=device)

    rows = [
        _row("sec6_drift/stale-profile", 0.0, recall=base.recall,
             rescued=int(base.rescued.sum()), cost=base.total_cost,
             hot_pair=f"c{hot[0]+1}->c{hot[1]+1}",
             note="rescue spike localizes the changed pair (paper trigger)"),
        _row("sec6_drift/re-profiled", 0.0, recall=fresh.recall,
             rescued=int(fresh.rescued.sum()), cost=fresh.total_cost,
             note="re-profiling restores the operating point"),
    ]
    if not reference:
        return rows
    # reference: tracking the unchanged world with the original profile
    vis0 = simulate_network(net, 2000, 4000, seed=22)
    gal0, _ = build_gallery(vis0, 24)
    feats0, _ = make_features(vis0, 2000, FeatureParams(seed=22))
    q0, g0 = make_queries(vis0, 60, seed=23)
    ref = track_queries(model, vis0, gal0, feats0, q0, g0, p,
                        geo_adj=net.geo_adjacent, device=device)
    return [_row("sec6_drift/no-drift-reference", 0.0, recall=ref.recall,
                 rescued=int(ref.rescued.sum()), cost=ref.total_cost)] + rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
