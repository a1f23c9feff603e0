"""Serving command line: ReXCam-filtered cross-camera analytics on live streams,
on the PyTorch/CUDA port.

Replays the world of the reference's command line (the 8-camera duke
network, 1,500 entities over 3,000 one-second steps, profiled on the first
2,000) through ``repro_torch.api.serve`` and prints its report, the
reference's lines but for the device on the first and the host-clock
tick rate on the ``wall:`` line:

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 8 --steps 600

``--device cuda`` (the default) ranks through the hand-written CUDA kernel
and raises without a card; ``--device cpu`` runs the plain PyTorch path.
``--tile-grid T`` profiles per camera-pair entry-region masks on a T x T
tile grid and serves through the tile-masked kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tile-grid 8

``--recalibrate`` closes the §6 drift loop: the engine's live rescue matrix
is polled and a model re-profiled from the world's recent visits hot-swaps
in when the drift score trips the trigger (``--drift-threshold``,
``--recal-cooldown``, ``--recal-window``):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --recalibrate

``--shards K`` serves through the sharded fleet: K workers on the one
device, each ranking its own block of query rows, with the fleet-shared
sharded gallery by default (``--gallery``); ``--transport inproc|fake``
routes gallery fetches through the fetch plane (``fake`` injects
``--rtt`` / ``--jitter`` / ``--drop`` per fetch on a virtual clock, so no
real time passes) and ``--prefetch`` issues the next round's cached
reads at the end of each round:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --shards 4 \
      --gallery sharded --transport fake --rtt 0.002 --prefetch
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


def run_stream(eng, world: World, ticks: int, trace: list | None = None,
               on_step=None, *, until_done: bool = True,
               stats: list | None = None):
    """Submit every query at its anchor, then stream ``ticks`` wall steps
    of detections into ``eng`` (with ``until_done``, stopping early once
    every query is done).  A tile-mode engine also gets each detection's
    tile on its ``eng.tile_grid`` grid; ``on_step(eng, step)`` runs before
    each step's ingest (a fleet may lose a worker there); pass a list as
    ``stats`` to collect each tick's stats.  Returns the host-clock
    seconds of each tick; each tick ends with the round's outcome on the
    host, so the clock covers the device work."""
    vis, gal, feats = world.vis, world.gal, world.feats
    vis_tiles = tile_index(vis.tile_xy, eng.tile_grid) \
        if eng.tile_grid > 0 else None
    t0 = int(vis.t_out[world.q_vids].min())
    eng.t = t0
    for i, q in enumerate(world.q_vids):
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    tick_s = []
    for step, t in enumerate(range(t0, t0 + ticks)):
        t_start = time.perf_counter()
        if on_step is not None:
            on_step(eng, step)
        if t < vis.horizon:
            frames, tiles = {}, {}
            for c in range(vis.n_cams):
                vids = gal[c, t][gal[c, t] >= 0]
                if len(vids):
                    frames[c] = feats[vids]
                    if vis_tiles is not None:
                        tiles[c] = vis_tiles[vids]
            eng.ingest(frames, tiles if vis_tiles is not None else None)
        st = eng.tick(record_trace=trace)
        tick_s.append(time.perf_counter() - t_start)
        if stats is not None:
            stats.append(st)
        if until_done and all(q.done for q in eng.queries.values()):
            break
    return tick_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--s-thresh", type=float, default=0.05)
    ap.add_argument("--t-thresh", type=float, default=0.02)
    ap.add_argument("--scheme", default="rexcam",
                    choices=["rexcam", "all", "geo", "spatial_only"])
    ap.add_argument("--shards", type=int, default=None,
                    help="partition the query axis over this many workers "
                         "on the device (default: the single engine)")
    ap.add_argument("--gallery", default="auto",
                    choices=["auto", "local", "sharded"],
                    help="embedding plane: auto (local for one engine, "
                         "fleet-shared sharded store for --shards), local "
                         "(replicated baseline) or sharded (fleet only)")
    ap.add_argument("--topk", type=int, default=1,
                    help="candidate bands surfaced per query round")
    ap.add_argument("--topk-rerank", action="store_true",
                    help="§5.2 top-k confidence re-ranking")
    ap.add_argument("--tile-grid", type=int, default=0,
                    help="sub-frame spatial admission: T > 0 profiles per "
                         "camera-pair entry-region masks on a T x T grid "
                         "and ranks through the tile-masked kernel")
    ap.add_argument("--transport", default="none",
                    choices=["none", "inproc", "fake"],
                    help="gallery fetch plane (fleet only): none (direct "
                         "reads), inproc (the same through the Transport "
                         "contract, counters tick) or fake (FakeRpcTransport "
                         "with --rtt/--jitter/--drop injected per fetch on a "
                         "virtual clock, timeout/retry/backoff)")
    ap.add_argument("--rtt", type=float, default=0.005,
                    help="injected fetch latency in seconds (--transport "
                         "fake)")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="uniform extra latency bound in seconds "
                         "(--transport fake)")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="per-attempt drop probability; dropped fetches "
                         "time out and retry with backoff (--transport fake)")
    ap.add_argument("--prefetch", action="store_true",
                    help="double-buffered speculative fetch: issue the next "
                         "round's predicted gallery reads at the end of "
                         "each round")
    ap.add_argument("--recalibrate", action="store_true",
                    help="close the §6 drift loop: watch the live rescue "
                         "matrix and hot-swap a re-profiled model when the "
                         "drift score trips the trigger")
    ap.add_argument("--drift-threshold", type=float, default=0.1,
                    help="recalibration trigger: max drift_score to trip at")
    ap.add_argument("--recal-cooldown", type=int, default=240,
                    help="min ticks between model swaps (hysteresis)")
    ap.add_argument("--recal-window", type=int, default=1200,
                    help="sliding re-profile window (recent steps)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    resolve_device(args.device)     # no card: fail before building the world

    # the reference command line's world: 25 minutes of the duke network,
    # profiled on the first 2,000 steps
    world = duke_world(args.queries, n_entities=1500, horizon=3000)
    vis, net = world.vis, world.net
    model = rexcam.profile(vis, time_limit=2000, tile_grid=args.tile_grid,
                           device=args.device)
    policy = rexcam.SearchPolicy(scheme=args.scheme, s_thresh=args.s_thresh,
                                 t_thresh=args.t_thresh)
    recal = rexcam.RecalibrationPolicy(
        drift_threshold=args.drift_threshold, cooldown=args.recal_cooldown,
        window=args.recal_window) if args.recalibrate else None
    if args.transport == "fake":
        clock, sleep = rexcam.manual_clock()
        transport = rexcam.FakeRpcTransport(
            default=rexcam.FaultProfile(latency=args.rtt, jitter=args.jitter,
                                        drop=args.drop),
            timeout=max(4 * (args.rtt + args.jitter), 1.0), clock=clock,
            sleep=sleep)
    else:
        transport = None if args.transport == "none" else args.transport
    eng = rexcam.serve(model, embed_fn=lambda x: x, policy=policy,
                       geo_adj=net.geo_adjacent, topk=args.topk,
                       shards=args.shards, gallery=args.gallery,
                       transport=transport, prefetch=args.prefetch,
                       topk_rerank=args.topk_rerank,
                       tile_grid=args.tile_grid, recalibrate=recal,
                       visit_source=rexcam.visits_window_source(vis)
                       if args.recalibrate else None, device=args.device)
    # every step up to the horizon, as the reference streams them
    t0 = int(vis.t_out[world.q_vids].min())
    stats = []
    tick_s = run_stream(eng, world, min(args.steps, vis.horizon - t0),
                        until_done=False, stats=stats)
    matches = sum(st["matches"] for st in stats)
    wall = sum(tick_s)

    # two cost conventions (not to be mixed): admitted_steps is per-query
    # camera-steps (comparable with the tracker / policy_sweep); the frame
    # counts are the serving plane's deduplicated inference load
    naive_steps = args.steps * net.n_cams * len(world.q_vids)
    naive_frames = args.steps * net.n_cams
    print(f"device={eng.device} steps={args.steps} queries={args.queries} "
          f"scheme={policy.scheme}")
    print(f"admission: {eng.admitted_steps} camera-steps "
          f"(naive all-camera: {naive_steps}; "
          f"savings {naive_steps / max(eng.admitted_steps, 1):.1f}x)")
    print(f"inference plane: {eng.unique_frames} unique frames "
          f"({eng.frames_processed} embedded + {eng.cache_hits} cache-hot; "
          f"dedup {eng.admitted_steps / max(eng.unique_frames, 1):.1f}x; "
          f"naive per-camera: {naive_frames}; "
          f"savings {naive_frames / max(eng.frames_processed, 1):.1f}x)")
    if args.tile_grid > 0:
        TT = args.tile_grid * args.tile_grid
        base_tiles = TT * eng.admitted_steps
        print(f"spatial plane [T={args.tile_grid}]: {eng.admitted_tiles} "
              f"admitted tiles of {base_tiles} camera-granular "
              f"(pixel-load savings "
              f"{base_tiles / max(eng.admitted_tiles, 1):.1f}x; "
              f"{eng.unique_tiles} deduplicated of "
              f"{TT * eng.unique_frames})")
    print(f"matches flagged: {matches} "
          f"(replay rescues: {sum(q.rescued for q in eng.queries.values())}, "
          f"replay misses past retention: {eng.replay_misses})")
    print(f"frame-store residency: {eng.store.memory_frames()} frames "
          f"(retention {eng.cfg.retention}s — paper §5.3 'last few minutes')")
    g = eng.gallery_report()
    print(f"gallery plane [{g['kind']}]: {g['cached']} blocks resident "
          f"({g['bytes']} bytes), {g['hits']} hits / {g['misses']} misses, "
          f"{g['evictions']} evictions")
    if args.transport != "none" or args.prefetch:
        c = eng.gallery.counters()
        kind = getattr(getattr(eng.gallery, "transport", None), "kind",
                       "local")
        print(f"transport plane [{kind}]: {c['remote_fetches']} remote "
              f"fetches ({c['prefetch_hits']} served by prefetch, "
              f"{c['prefetch_wasted']} wasted speculations), "
              f"{c['retries']} retries, {c['timeouts']} timeouts, "
              f"{c.get('dead_peers', 0)} dead peers")
    p50, p99 = np.percentile(np.asarray(tick_s) * 1e3, [50, 99]) \
        if tick_s else (0.0, 0.0)
    print(f"wall: {wall:.3f}s host clock ({len(tick_s) / max(wall, 1e-9):.1f} "
          f"ticks/s; tick p50 {p50:.3f} ms, p99 {p99:.3f} ms)")
    if args.recalibrate:
        ev = eng.recal.events
        print(f"recalibration [epoch {eng.model_epoch}]: {len(ev)} swaps, "
              f"{len(eng.recal.polls)} polls "
              f"(threshold {args.drift_threshold}, "
              f"cooldown {args.recal_cooldown}, window {args.recal_window})")
        for e in ev:
            print(f"  t={e['t']}: epoch {e['epoch']} "
                  f"(score {e['score']:.2f}, {e['rescues']} rescues, "
                  f"re-profiled {e['visits']} visits in "
                  f"[{e['window'][0]}, {e['window'][1]}))")
    if args.shards is not None:
        # per-worker demand is shard-local dedup; owned_frames is each
        # worker's slice of the fleet-global dedup (sums to the engine
        # total with the sharded gallery)
        print(f"fleet: {eng.n_shards} shards (workers on {eng.device}), "
              f"{eng.rebalances} rebalances, {eng.worker_dispatches} "
              f"worker rank dispatches")
        per_worker = g.get("per_worker", {})
        for row in eng.shard_report():
            state = "live" if row["alive"] else "lost"
            gw = per_worker.get(row["worker"])
            gal = (f" gallery={gw['blocks']} blocks/{gw['bytes']}B "
                   f"({gw['cameras']} cams)" if gw else "")
            print(f"  {row['worker']} [{state}]: {row['queries']} queries, "
                  f"admitted_steps={row['admitted_steps']} "
                  f"unique_frames={row['unique_frames']} "
                  f"owned_frames={row['owned_frames']} "
                  f"query_rounds={row['query_rounds']}{gal}")
    for qid, q in eng.queries.items():
        lag = max(eng.t - 1 - q.f_curr, 0)
        state = "done" if q.done else f"tracking (phase {q.phase}, lag {lag}s)"
        print(f"  query {qid}: {len(q.matches)} matches, {state}")

if __name__ == "__main__":
    main()
