"""fig11's and sec3's count columns on the full duke world: the JAX
reference against the PyTorch port, both on the CPU.

The duke deployment of ``benchmarks/scenarios.py::duke`` (8 cameras,
2,700 entities, 5,100 steps, profiled on the first 3,000, K = 24, 100
queries), made by each package's own world function (the reference's
``benchmarks.scenarios.duke`` and the port's
``repro_torch.benchmarks.scenarios.duke``, whose arrays must be equal).
For each of fig11's policies (``benchmarks/tables.py``: all, geo, S5,
S5-T1, S5-T2, S5-T10, S10-T10) it tracks the queries with
``repro.core.tracker.track_queries`` and ``repro_torch.api.track(...,
device="cpu")`` and prints cost, recall, precision, savings, mean delay
and rescues for each; then sec3's analytic potentials
(``potential_savings``) and peer and travel-time statistics from both
packages.  Exits non-zero if any count differs.

    PYTHONPATH=src python scripts/torch_track_counts.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

POLICIES = [
    ("all", dict(scheme="all")),
    ("geo", dict(scheme="geo")),
    ("S5", dict(scheme="spatial_only", s_thresh=.05)),
    ("S5-T1", dict(scheme="rexcam", s_thresh=.05, t_thresh=.01)),
    ("S5-T2", dict(scheme="rexcam", s_thresh=.05, t_thresh=.02)),
    ("S5-T10", dict(scheme="rexcam", s_thresh=.05, t_thresh=.10)),
    ("S10-T10", dict(scheme="rexcam", s_thresh=.10, t_thresh=.10)),
]


def columns(r, base_cost):
    return dict(cost=r.total_cost, recall=r.recall, precision=r.precision,
                savings=base_cost / max(r.total_cost, 1),
                delay=r.mean_delay, rescued=int(r.rescued.sum()))


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks import scenarios as j_scen
    from repro.core.policy import SearchPolicy as JPolicy
    from repro.core.profiler import \
        transitions_from_visits as j_transitions
    from repro.core.tracker import track_queries
    from repro_torch import api
    from repro_torch.benchmarks import scenarios as t_scen
    from repro_torch.core.profiler import \
        transitions_from_visits as t_transitions

    # each package's own world function for the tables' duke world
    j_sc, t_sc = j_scen.duke(), t_scen.duke()
    for k in ("gal", "feats", "q_vids", "gt_vids"):
        assert np.array_equal(j_sc[k], t_sc[k]), k
    net, vis, gal, feats = (t_sc[k] for k in ("net", "vis", "gal", "feats"))
    q, gt = t_sc["q_vids"], t_sc["gt_vids"]
    jm, tm = j_sc["model"], t_sc["model"]
    geo = net.geo_adjacent
    ok = True
    base = {}
    print("fig11/duke         cost    recall  precision  savings    delay"
          "  rescued  (jax | port, host clock)")
    for name, pol in POLICIES:
        row = {}
        for side in ("jax", "port"):
            t0 = time.perf_counter()
            if side == "jax":
                r = track_queries(jm, j_sc["vis"], gal, feats, q, gt,
                                  JPolicy(**pol), geo_adj=geo)
            else:
                r = api.track(tm, vis, gal, feats, q, gt,
                              api.SearchPolicy(**pol), geo_adj=geo,
                              device="cpu")
            base.setdefault(side, r.total_cost)
            row[side] = (columns(r, base[side]), time.perf_counter() - t0)
        for side, (c, wall) in row.items():
            print(f"{name:8s} {side:4s} {c['cost']:9.0f} {c['recall']:9.4f} "
                  f"{c['precision']:10.4f} {c['savings']:8.3f} "
                  f"{c['delay']:8.3f} {c['rescued']:8d}  {wall:.1f} s",
                  flush=True)
        same = row["jax"][0] == row["port"][0]
        ok &= same
        print(f"{name:8s} port {'equal' if same else 'DIFFERS'}")

    print("sec3                    jax         port")
    S = {"jax": np.asarray(jm.S), "port": tm.S.numpy()}
    stats = {"peers_ge_5pct": {k: float((v >= 0.05).sum(1).mean())
                               for k, v in S.items()}}
    for label, (s, t) in (("spatial_only_potential", (0.05, 0.0)),
                          ("temporal_only_potential", (0.0, 0.02)),
                          ("combined_potential", (0.05, 0.02))):
        stats[label] = {"jax": jm.potential_savings(s, t),
                        "port": tm.potential_savings(s, t)}
    dts = {"jax": j_transitions(vis.ent, vis.cam, vis.t_in, vis.t_out)[2],
           "port": t_transitions(vis.ent, vis.cam, vis.t_in, vis.t_out)[2]}
    stats["travel_mean_s"] = {k: float(v.mean()) for k, v in dts.items()}
    stats["travel_std_s"] = {k: float(v.std()) for k, v in dts.items()}
    for label, v in stats.items():
        same = v["jax"] == v["port"]
        ok &= same
        print(f"{label:24s} {v['jax']!r:>12} {v['port']!r:>12}  "
              f"{'equal' if same else 'DIFFERS'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
