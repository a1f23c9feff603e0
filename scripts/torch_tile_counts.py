"""Tile-plane cost counters of the duke world at T = 8: the JAX reference
against the PyTorch port, both on the CPU.

Serves the duke deployment (8 cameras, 2,700 entities, 5,100 steps,
profiled with ``tile_grid=8`` on the first 3,000 steps) through
``repro.api.serve(tile_grid=8)`` (the Pallas kernels in interpret mode) and
``repro_torch.api.serve(tile_grid=8, device="cpu")`` with one driving loop,
and prints admitted_steps, unique_frames, admitted_tiles, unique_tiles and
matches for each; exits non-zero if they differ.  Two runs:

  readme  the README's tile figure: the first 16 queries of
          ``make_queries(vis, 60, seed=1)``, 400 ticks from the earliest
          anchor, topk=1 (``benchmarks/scenarios.py::tile_sweep``'s learned
          leg);
  smoke   ``chip_smoke.py``'s tile phase: 100 queries, topk=3, until every
          query is done or the world's horizon ends.

    PYTHONPATH=src python scripts/torch_tile_counts.py [--only readme|smoke]
"""
from __future__ import annotations

import argparse
import sys
import time

T = 8
COUNTERS = ("admitted_steps", "unique_frames", "admitted_tiles",
            "unique_tiles")


def drive(eng, vis, gal, feats, q_vids, ticks, tiles):
    """Submit every query at its anchor and stream ``ticks`` steps (never
    past the horizon), stopping once every query is done.  Returns the
    counters, the matches and the ticks run."""
    t0 = int(vis.t_out[q_vids].min())
    eng.t = t0
    for i, q in enumerate(q_vids):
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    matches, n = 0, 0
    for t in range(t0, min(t0 + ticks, vis.horizon)):
        frames, labels = {}, {}
        for c in range(vis.n_cams):
            vids = gal[c, t][gal[c, t] >= 0]
            if len(vids):
                frames[c], labels[c] = feats[vids], tiles[vids]
        eng.ingest(frames, labels)
        matches += eng.tick()["matches"]
        n += 1
        if all(q.done for q in eng.queries.values()):
            break
    return dict({c: int(getattr(eng, c)) for c in COUNTERS},
                matches=matches, ticks=n,
                done=sum(q.done for q in eng.queries.values()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["readme", "smoke"])
    args = ap.parse_args()

    from repro import api as japi
    from repro.core import build_gallery, duke_like_network, simulate_network
    from repro.core.features import FeatureParams, make_features
    from repro.core.simulate import tile_index
    from repro.core.tracker import make_queries
    from repro_torch import api as tapi

    net = duke_like_network()
    vis = simulate_network(net, 2700, 5100, seed=0)
    gal, _ = build_gallery(vis, 24)
    feats, _ = make_features(vis, 2700, FeatureParams())
    tiles = tile_index(vis.tile_xy, T)
    jmodel = japi.profile(vis, time_limit=3000, tile_grid=T)
    tmodel = tapi.profile(vis, time_limit=3000, tile_grid=T, device="cpu")
    runs = dict(readme=(make_queries(vis, 60, seed=1)[0][:16], 400, 1),
                smoke=(make_queries(vis, 100, seed=1)[0], vis.horizon, 3))
    ok = True
    for name, (q_vids, ticks, topk) in runs.items():
        if args.only not in (None, name):
            continue
        out = {}
        for side, api, model, kw in (
                ("jax", japi, jmodel, {}),
                ("torch", tapi, tmodel, dict(device="cpu"))):
            t0 = time.perf_counter()
            eng = api.serve(model, lambda x: x, api.SearchPolicy(),
                            geo_adj=net.geo_adjacent, topk=topk,
                            tile_grid=T, **kw)
            out[side] = drive(eng, vis, gal, feats, q_vids, ticks, tiles)
            print(f"{name} {side}: {out[side]} "
                  f"({time.perf_counter() - t0:.1f} s host clock, CPU)",
                  flush=True)
        r = out["jax"]
        base = T * T * r["admitted_steps"]
        print(f"{name}: admitted tiles {r['admitted_tiles']} of {base} "
              f"camera-granular ({base / max(r['admitted_tiles'], 1):.3f}x);"
              f" unique {r['unique_tiles']} of "
              f"{T * T * r['unique_frames']}; port "
              f"{'equal' if out['torch'] == r else 'DIFFERS'}")
        ok &= out["torch"] == r
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
