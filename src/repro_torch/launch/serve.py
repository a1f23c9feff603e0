"""Serving command line: ReXCam-filtered cross-camera analytics on live streams,
on the PyTorch/CUDA port.

Replays the duke world at the benchmark's scale (8 cameras, 2,700
entities, 5,100 one-second steps — the DukeMTMC span — profiled on the
first 3,000 steps) through ``repro_torch.api.serve``:

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 100 --steps 600

``--device cuda`` (the default) ranks through the hand-written CUDA kernel
and raises without a card; ``--device cpu`` runs the plain PyTorch path.
``--tile-grid T`` profiles per camera-pair entry-region masks on a T x T
tile grid and serves through the tile-masked kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tile-grid 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import api as rexcam
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.simulate import (CameraNetwork, Visits, build_gallery,
                                       duke_like_network, simulate_network,
                                       tile_index)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class World:
    net: CameraNetwork
    vis: Visits
    gal: np.ndarray          # (C, T, K) visit ids per (camera, step), -1 empty
    feats: np.ndarray        # (V, D) per-visit re-id features
    q_vids: np.ndarray       # (Q,) query visit ids


def duke_world(n_queries: int = 100, n_entities: int = 2700,
               horizon: int = 5100, seed: int = 0) -> World:
    """The duke deployment of ``benchmarks/scenarios.py``: DukeMTMC's 85
    minutes at one step per second, with ``n_queries`` live queries."""
    net = duke_like_network()
    vis = simulate_network(net, n_entities, horizon, seed=seed)
    gal, _ = build_gallery(vis, 24)
    feats, _ = make_features(vis, n_entities, FeatureParams())
    q_vids, _ = rexcam.make_queries(vis, n_queries, seed=seed + 1)
    return World(net, vis, gal, feats, q_vids)


def run_stream(eng, world: World, ticks: int, trace: list | None = None):
    """Submit every query at its anchor, then stream ``ticks`` wall steps
    of detections into ``eng`` (stopping early once every query is done).
    A tile-mode engine also gets each detection's tile on its
    ``eng.tile_grid`` grid.  Returns the host-clock seconds of each tick;
    each tick ends with the round's outcome on the host, so the clock
    covers the device work."""
    vis, gal, feats = world.vis, world.gal, world.feats
    vis_tiles = tile_index(vis.tile_xy, eng.tile_grid) \
        if eng.tile_grid > 0 else None
    t0 = int(vis.t_out[world.q_vids].min())
    eng.t = t0
    for i, q in enumerate(world.q_vids):
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    tick_s = []
    for t in range(t0, t0 + ticks):
        t_start = time.perf_counter()
        if t < vis.horizon:
            frames, tiles = {}, {}
            for c in range(vis.n_cams):
                vids = gal[c, t][gal[c, t] >= 0]
                if len(vids):
                    frames[c] = feats[vids]
                    if vis_tiles is not None:
                        tiles[c] = vis_tiles[vids]
            eng.ingest(frames, tiles if vis_tiles is not None else None)
        eng.tick(record_trace=trace)
        tick_s.append(time.perf_counter() - t_start)
        if all(q.done for q in eng.queries.values()):
            break
    return tick_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--s-thresh", type=float, default=0.05)
    ap.add_argument("--t-thresh", type=float, default=0.02)
    ap.add_argument("--scheme", default="rexcam",
                    choices=["rexcam", "all", "geo", "spatial_only"])
    ap.add_argument("--topk", type=int, default=1,
                    help="candidate bands surfaced per query round")
    ap.add_argument("--topk-rerank", action="store_true",
                    help="§5.2 top-k confidence re-ranking")
    ap.add_argument("--tile-grid", type=int, default=0,
                    help="sub-frame spatial admission: T > 0 profiles per "
                         "camera-pair entry-region masks on a T x T grid "
                         "and ranks through the tile-masked kernel")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    resolve_device(args.device)     # no card: fail before building the world

    world = duke_world(args.queries)
    model = rexcam.profile(world.vis, time_limit=3000,
                           tile_grid=args.tile_grid, device=args.device)
    policy = rexcam.SearchPolicy(scheme=args.scheme, s_thresh=args.s_thresh,
                                 t_thresh=args.t_thresh)
    eng = rexcam.serve(model, embed_fn=lambda x: x, policy=policy,
                       geo_adj=world.net.geo_adjacent, topk=args.topk,
                       topk_rerank=args.topk_rerank,
                       tile_grid=args.tile_grid, device=args.device)
    tick_s = run_stream(eng, world, args.steps)
    wall = sum(tick_s)

    # all-camera search of the same query rounds
    naive_steps = eng.content_steps * world.net.n_cams
    p50, p99 = np.percentile(np.asarray(tick_s) * 1e3, [50, 99])
    print(f"device={eng.device} ticks={len(tick_s)} "
          f"queries={len(world.q_vids)} scheme={policy.scheme}")
    print(f"admission: {eng.admitted_steps} camera-steps over "
          f"{eng.content_steps} query rounds (all-camera: {naive_steps}; "
          f"savings {naive_steps / max(eng.admitted_steps, 1):.1f}x)")
    print(f"inference plane: {eng.unique_frames} unique frames "
          f"({eng.frames_processed} embedded + {eng.cache_hits} cache-hot)")
    if args.tile_grid > 0:
        TT = args.tile_grid * args.tile_grid
        base_tiles = TT * eng.admitted_steps
        print(f"spatial plane [T={args.tile_grid}]: {eng.admitted_tiles} "
              f"admitted tiles of {base_tiles} camera-granular "
              f"(pixel-load savings "
              f"{base_tiles / max(eng.admitted_tiles, 1):.1f}x; "
              f"{eng.unique_tiles} deduplicated of "
              f"{TT * eng.unique_frames})")
    matches = sum(len(q.matches) for q in eng.queries.values())
    rescues = sum(q.rescued for q in eng.queries.values())
    print(f"matches: {matches} (replay rescues: {rescues}, replay misses "
          f"past retention: {eng.replay_misses})")
    print(f"wall: {wall:.3f}s ({len(tick_s) / max(wall, 1e-9):.1f} ticks/s; "
          f"tick p50 {p50:.3f} ms, p99 {p99:.3f} ms)")


if __name__ == "__main__":
    main()
