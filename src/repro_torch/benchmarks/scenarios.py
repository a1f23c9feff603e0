"""Serving scenarios of the §6 recalibration loop: the counterparts of
``benchmarks/scenarios.py``'s ``drift_sweep`` and ``soak_130``, with its
record schema.

  drift_sweep  the duke world whose camera topology is re-permuted
               mid-run, served frozen, with recalibration, and with
               recalibration on an 8-worker fleet
               (``recalibrated_shards8``); the recalibrated recall must
               beat the frozen one and the fleet must equal the single
               engine (admitted steps, swap ticks, recall).
  soak_130     the 130-camera clustered city with localized hub drift and
               a late query wave, served exhaustively, with row-targeted
               recalibration on an 8-worker fleet that loses worker w1 at
               step 120 (``targeted_fleet``, one rebalance) and with full
               rebuilds on one engine, under the reference's gates
               (savings >= 20x, targeted recall within 5 % of exhaustive
               and 2 % of full, fewer rows than C a swap).

The fleets' workers are logical partitions of the query axis, all on the
engine's device (``runtime.fleet``).

    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios \\
        --only drift_sweep soak_130 [--device cpu] [--bench-dir DIR]

prints ``name,us_per_call,derived`` CSV rows and, with ``--bench-dir``,
writes ``DIR/BENCH_<sweep>.json`` in the schema
``scripts/bench_schema_check.py`` checks.  ``--device cuda`` (the default)
serves on the card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

from repro_torch import api as rexcam
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.profiler import build_model
from repro_torch.core.simulate import (build_gallery, clustered_city_network,
                                       concat_visits, duke_like_network,
                                       permute_network, simulate_network,
                                       tile_index)
from repro_torch.core.tracker import make_queries
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Machine-readable benchmark records (BENCH_<sweep>.json).
# ---------------------------------------------------------------------------

#: sweep name -> records appended by ``bench_record`` while a sweep runs;
#: ``main`` drains it into ``BENCH_<sweep>.json``
BENCH_RECORDS: dict = {}

#: Every measured record carries these keys (``benchmarks/scenarios.py``'s
#: schema); summary rows opt out with ``derived=True``.
REQUIRED_BENCH_KEYS = ("scenario", "admitted_steps", "unique_frames",
                       "wall_s", "p50_tick_ms", "p99_tick_ms")


def bench_record(sweep: str, **fields) -> None:
    """Append one machine-readable record for ``BENCH_<sweep>.json``.
    Measured rows must carry every ``REQUIRED_BENCH_KEYS`` field; derived
    summary rows (``derived=True``) are exempt."""
    if not fields.get("derived"):
        missing = [k for k in REQUIRED_BENCH_KEYS if k not in fields]
        if missing:
            raise ValueError(
                f"bench_record({sweep!r}): measured record missing required "
                f"keys {missing} (pass derived=True for summary rows)")
    BENCH_RECORDS.setdefault(sweep, []).append(fields)


def pop_bench_records(sweep: str):
    """Drain (and clear) the records a sweep accumulated."""
    return BENCH_RECORDS.pop(sweep, [])


def _tick_pcts(tick_lat):
    """(p50_ms, p99_ms) over a list of per-tick wall latencies in seconds."""
    if not tick_lat:
        return 0.0, 0.0
    p50, p99 = np.percentile(np.asarray(tick_lat) * 1e3, [50, 99])
    return float(p50), float(p99)


def _serving_recall(eng, vis, q_vids, gt_vids) -> float:
    """Tracker-comparable recall for the live engine: a ground-truth visit
    counts as retrieved when some confirmed match (cam, frame) lands inside
    it."""
    hits = total = 0
    for i in range(len(q_vids)):
        gts = gt_vids[i][gt_vids[i] >= 0]
        total += len(gts)
        ms = eng.queries[i].matches
        hits += sum(any(c == vis.cam[v] and vis.t_in[v] <= f <= vis.t_out[v]
                        for c, f in ms) for v in gts)
    return hits / max(total, 1)


def drive(sc, policy, *, device="cuda", recal=None, churn_wave=None,
          tile_grid=0, model=None, trace=None, shards=None, lose_at=None,
          lose_worker=1):
    """Serve the scenario's live stream on one engine until its horizon:
    every query submitted at the first anchor's tick, or with
    ``churn_wave`` half of them there and the rest that many steps in
    (replaying to catch up).  ``recal`` (a ``RecalibrationPolicy``)
    attaches the drift loop over the world's ground-truth visits;
    ``tile_grid=T`` serves the tile plane (``model`` overrides the world's
    profile); ``trace`` collects the trace records; ``shards=k`` serves on
    a k-worker fleet, which loses ``lose_worker`` at step ``lose_at``.
    The counterpart of ``drift_sweep``'s inner drive and ``_drive_soak``.
    Returns (engine, wall_s, per-tick latencies)."""
    vis, gal, feats, net = sc["vis"], sc["gal"], sc["feats"], sc["net"]
    q_vids = sc["q_vids"]
    vis_tiles = tile_index(vis.tile_xy, tile_grid) if tile_grid > 0 \
        else None
    wall0 = time.perf_counter()
    eng = rexcam.serve(sc["model"] if model is None else model,
                       embed_fn=lambda x: x, policy=policy,
                       geo_adj=net.geo_adjacent, tile_grid=tile_grid,
                       shards=shards, recalibrate=recal,
                       visit_source=rexcam.visits_window_source(vis)
                       if recal is not None else None, device=device)
    t0 = int(vis.t_out[q_vids].min())
    eng.t = t0
    first = len(q_vids) if churn_wave is None else max(1, len(q_vids) // 2)
    for i in range(first):
        q = q_vids[i]
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    tick_lat = []
    for step, t in enumerate(range(t0, vis.horizon)):
        if churn_wave is not None and step == churn_wave:
            for j in range(first, len(q_vids)):
                q = q_vids[j]
                eng.submit_query(j, feats[q], int(vis.cam[q]),
                                 int(vis.t_out[q]))
        if lose_at is not None and step == lose_at and shards is not None:
            eng.lose_worker(lose_worker)
        frames, tiles = {}, {}
        for c in range(net.n_cams):
            vids = gal[c, t][gal[c, t] >= 0]
            if len(vids):
                frames[c] = feats[vids]
                if vis_tiles is not None:
                    tiles[c] = vis_tiles[vids]
        eng.ingest(frames, tiles if vis_tiles is not None else None)
        tk0 = time.perf_counter()
        eng.tick(record_trace=trace)
        tick_lat.append(time.perf_counter() - tk0)
    return eng, time.perf_counter() - wall0, tick_lat


def _keep(runs, config, eng, wall, lat, trace):
    if runs is not None:
        runs[config] = dict(eng=eng, wall=wall, tick_s=lat, trace=trace)


# ---------------------------------------------------------------------------
# drift_sweep: §6 on the serving plane.
# ---------------------------------------------------------------------------

#: the trigger tuned to the duke profile's density: the hot drifted pairs
#: carry ~10-30 historical transitions, so a handful of rescues there
#: scores ~0.1-0.15
DRIFT_RECAL = rexcam.RecalibrationPolicy(drift_threshold=.06, min_rescues=8,
                                         cooldown=300, poll_every=20,
                                         window=600)
DRIFT_POLICY = rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05,
                                   t_thresh=.02)


@functools.lru_cache(maxsize=None)
def drifted_duke(n_queries: int = 32, t_shift: int = 400,
                 post_horizon: int = 1800):
    """Duke-like world whose live stream shifts topology at ``t_shift``:
    cameras are re-permuted (every pair the frozen profile trusts becomes
    wrong), while the model (on the CPU; the engine moves it) stays
    profiled on dedicated pre-shift history, kept as ``hist``.  Queries
    are drawn from the post-shift traffic."""
    net = duke_like_network()
    shifted = permute_network(net, np.roll(np.arange(net.n_cams), 3))
    hist = simulate_network(net, 2000, 4000, seed=31)
    model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out,
                        net.n_cams, device="cpu")
    vis_a = simulate_network(net, 300, t_shift, seed=32)
    vis_b = simulate_network(shifted, 800, post_horizon, seed=33)
    vis = concat_visits(vis_a, vis_b, t_shift)
    gal, _ = build_gallery(vis, 24)
    feats, _ = make_features(vis, int(vis.ent.max()) + 1,
                             FeatureParams(seed=33))
    q_b, gt_b = make_queries(vis_b, n_queries, seed=34)
    q_vids = q_b + len(vis_a)
    gt_vids = np.where(gt_b >= 0, gt_b + len(vis_a), gt_b)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, t_shift=t_shift, hist=hist,
                name="duke-drift")


def drift_sweep(n_queries: int = 32, shards: int = 8, *, device="cuda",
                runs=None):
    """§6 on the serving plane: the re-permuted topology makes the frozen
    profile prune the frames the traffic now uses; with recalibration the
    live rescue matrix trips the trigger, a model re-profiled from the
    recent window hot-swaps in and post-shift recall recovers.  Asserts a
    swap and recalibrated recall strictly above frozen, then serves the
    recalibrating run again on a ``shards``-worker fleet, whose admitted
    steps, swap ticks and recall must equal the single engine's (the swap
    is atomic across the workers).  ``runs`` (a dict) receives each
    configuration's engine, wall, tick latencies and trace."""
    device = resolve_device(device)
    sc = drifted_duke(n_queries)
    vis, q_vids, gt_vids = sc["vis"], sc["q_vids"], sc["gt_vids"]

    def record(config, eng, wall, tick_lat, recall, **extra):
        p50, p99 = _tick_pcts(tick_lat)
        bench_record("drift_sweep", scenario=sc["name"], config=config,
                     admitted_steps=int(eng.admitted_steps),
                     unique_frames=int(eng.unique_frames),
                     wall_s=round(wall, 4), p50_tick_ms=round(p50, 3),
                     p99_tick_ms=round(p99, 3), recall=round(recall, 4),
                     epoch=int(eng.model_epoch), **extra)

    rows = []
    trace = [] if runs is not None else None
    frozen, wall_f, lat_f = drive(sc, DRIFT_POLICY, device=device,
                                  trace=trace)
    _keep(runs, "frozen", frozen, wall_f, lat_f, trace)
    r_frozen = _serving_recall(frozen, vis, q_vids, gt_vids)
    record("frozen", frozen, wall_f, lat_f, r_frozen)
    rows.append((f"drift_sweep/{sc['name']}/frozen",
                 wall_f * 1e6 / max(len(q_vids), 1),
                 f"recall={r_frozen:.2f} "
                 f"admitted_steps={frozen.admitted_steps} "
                 f"rescues={int(frozen.rescue_pairs.sum())} epoch=0 "
                 f"note=stale model degrades silently (no re-profiling)"))

    trace = [] if runs is not None else None
    fresh, wall_r, lat_r = drive(sc, DRIFT_POLICY, device=device,
                                 recal=DRIFT_RECAL, trace=trace)
    _keep(runs, "recalibrated", fresh, wall_r, lat_r, trace)
    r_fresh = _serving_recall(fresh, vis, q_vids, gt_vids)
    record("recalibrated", fresh, wall_r, lat_r, r_fresh,
           swaps=len(fresh.model_swaps))
    ev = fresh.recal.events
    swaps = ";".join(f"t={e['t']}:epoch{e['epoch']}(score={e['score']:.2f})"
                     for e in ev)
    rows.append((f"drift_sweep/{sc['name']}/recalibrated",
                 wall_r * 1e6 / max(len(q_vids), 1),
                 f"recall={r_fresh:.2f} admitted_steps={fresh.admitted_steps} "
                 f"epoch={fresh.model_epoch} swaps=[{swaps}] "
                 f"note=rescue spike -> re-profile -> hot-swap restores the "
                 f"operating point"))
    assert ev, "drift_sweep: the injected shift never tripped the trigger"
    assert r_fresh > r_frozen, \
        f"drift_sweep: recalibrated recall {r_fresh:.3f} must beat the " \
        f"frozen model's {r_frozen:.3f} after the injected shift"

    trace = [] if runs is not None else None
    fleet, wall_s, lat_s = drive(sc, DRIFT_POLICY, device=device,
                                 recal=DRIFT_RECAL, trace=trace,
                                 shards=shards)
    _keep(runs, f"recalibrated_shards{shards}", fleet, wall_s, lat_s, trace)
    r_fleet = _serving_recall(fleet, vis, q_vids, gt_vids)
    assert fleet.admitted_steps == fresh.admitted_steps, \
        "recalibrating fleet diverged from the single engine"
    assert fleet.model_swaps == fresh.model_swaps, \
        "fleet model swaps did not land on the single engine's ticks"
    assert r_fleet == r_fresh
    record(f"recalibrated_shards{shards}", fleet, wall_s, lat_s, r_fleet,
           swaps=len(fleet.model_swaps))
    rows.append((f"drift_sweep/{sc['name']}/recalibrated_shards{shards}",
                 wall_s * 1e6 / max(len(q_vids), 1),
                 f"recall={r_fleet:.2f} "
                 f"admitted_steps={fleet.admitted_steps} "
                 f"epoch={fleet.model_epoch} "
                 f"note=swap atomic across the mesh (same ticks as the "
                 f"single engine)"))
    return rows


# ---------------------------------------------------------------------------
# soak_130: the 130-camera soak on one engine.
# ---------------------------------------------------------------------------

SOAK_POLICY = rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05,
                                  t_thresh=.02, exit_t=120)
SOAK_EXHAUSTIVE = rexcam.SearchPolicy(scheme="all", exit_t=120)
#: city-scale trigger: a dense prior keeps per-pair scores small, so the
#: trip gates on the sustained rescue count; the wide window gives merged
#: rows enough live samples; row_threshold keeps the targeted selection to
#: the spiking rows
SOAK_RECAL_KW = dict(drift_threshold=.01, min_rescues=5, cooldown=150,
                     poll_every=20, window=450)
SOAK_RECAL_TARGETED = rexcam.RecalibrationPolicy(targeted=True,
                                                 row_threshold=.05,
                                                 **SOAK_RECAL_KW)
SOAK_RECAL_FULL = rexcam.RecalibrationPolicy(targeted=False, **SOAK_RECAL_KW)


def reroute_hub_traffic(net, n_drift_hubs=4, moved_frac=0.7):
    """Localized drift for the city soaks: on the first ``n_drift_hubs``
    hub rows, move ``moved_frac`` of the strongest outgoing mass onto that
    hub's three weakest leaf edges (just below ``s_thresh`` in the profiled
    model, so phase 1 prunes the now-dominant hops while replay still
    admits them).  Travel times are untouched: a row-local drift.
    Returns (shifted_net, drifted_row_ids)."""
    C = net.n_cams
    hubs = np.flatnonzero(net.entry > 1.0 / C)
    drift_rows = hubs[:n_drift_hubs]
    T = net.trans.copy()
    for h in drift_rows:
        row = T[h, :C]
        dests = np.flatnonzero(row)
        order = np.argsort(row[dests])
        boost = dests[order[:3]]           # weakest leaf edges
        take = dests[order[-3:]]           # strongest (corridor) edges
        moved = moved_frac * row[take].sum()
        row[take] *= 1.0 - moved_frac
        row[boost] += moved / len(boost)
    return dataclasses.replace(net, trans=T), drift_rows


@functools.lru_cache(maxsize=None)
def soak_city(n_cams=130, n_queries=12, t_shift=260, horizon=900, seed=9,
              anchor_hi=160):
    """The 130-camera soak world: ``clustered_city_network`` with the
    localized hub drift of ``reroute_hub_traffic`` at ``t_shift``; the
    model (on the CPU) trains on dense pre-shift history (6,000 entities x
    4,000 steps) and the queries anchor early in the post-shift traffic
    (``t_out <= anchor_hi``), so every chain has runway across the drift."""
    net = clustered_city_network(n_cams=n_cams, seed=seed)
    shifted, drift_rows = reroute_hub_traffic(net)
    hist = simulate_network(net, 6000, 4000, seed=seed + 1)
    model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out, n_cams,
                        device="cpu")
    vis_a = simulate_network(net, 150, t_shift, seed=seed + 2)
    vis_b = simulate_network(shifted, 300, horizon - t_shift, seed=seed + 3)
    vis = concat_visits(vis_a, vis_b, t_shift)
    gal, _ = build_gallery(vis, 24)
    feats, _ = make_features(vis, int(vis.ent.max()) + 1,
                             FeatureParams(seed=seed + 3))
    q_b, gt_b = make_queries(vis_b, 8 * n_queries, seed=seed + 4)
    keep = np.flatnonzero(vis_b.t_out[q_b] <= anchor_hi)[:n_queries]
    q_b, gt_b = q_b[keep], gt_b[keep]
    q_vids = q_b + len(vis_a)
    gt_vids = np.where(gt_b >= 0, gt_b + len(vis_a), gt_b)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, t_shift=t_shift,
                drift_rows=drift_rows, name=f"city-{n_cams}")


def soak_130(n_queries=12, shards=8, churn_wave=60, lose_at=120, *,
             device="cuda", runs=None):
    """The 130-camera soak under three configurations: ``exhaustive``
    (scheme="all" on one engine, the cost baseline and recall ceiling),
    ``targeted_fleet`` (rexcam with row-targeted recalibration on a
    ``shards``-worker fleet that loses worker w1 at step ``lose_at``) and
    ``full_single`` (rexcam with full rebuilds on one engine), each with
    the late query wave.  Asserts the reference's gates, the fleet's one
    rebalance among them; emits one record per configuration and a derived
    gate row.  ``runs`` (a dict) receives each configuration's engine,
    wall, tick latencies and trace."""
    device = resolve_device(device)
    sc = soak_city(n_queries=n_queries)
    vis, net = sc["vis"], sc["net"]
    q_vids, gt_vids = sc["q_vids"], sc["gt_vids"]
    C = net.n_cams
    n_q = len(q_vids)
    rows = []

    def record(config, eng, wall, lat, recall, **extra):
        p50, p99 = _tick_pcts(lat)
        bench_record("soak_130", scenario=sc["name"], config=config,
                     n_cams=C, n_queries=n_q,
                     admitted_steps=int(eng.admitted_steps),
                     unique_frames=int(eng.unique_frames),
                     replay_steps=int(eng.replay_steps),
                     wall_s=round(wall, 4), p50_tick_ms=round(p50, 3),
                     p99_tick_ms=round(p99, 3), recall=round(recall, 4),
                     epoch=int(eng.model_epoch), **extra)

    def run(config, policy, recal, fleet=None):
        trace = [] if runs is not None else None
        out = drive(sc, policy, device=device, recal=recal,
                    churn_wave=churn_wave, trace=trace, shards=fleet,
                    lose_at=lose_at if fleet else None, lose_worker=1)
        _keep(runs, config, *out, trace)
        return out

    ex, wall_e, lat_e = run("exhaustive", SOAK_EXHAUSTIVE, None)
    r_ex = _serving_recall(ex, vis, q_vids, gt_vids)
    record("exhaustive", ex, wall_e, lat_e, r_ex, shards=0)
    rows.append((f"soak_130/{sc['name']}/exhaustive",
                 wall_e * 1e6 / n_q,
                 f"recall={r_ex:.2f} admitted_steps={ex.admitted_steps} "
                 f"note=all-camera baseline, the recall ceiling"))

    tg, wall_t, lat_t = run("targeted_fleet", SOAK_POLICY,
                            SOAK_RECAL_TARGETED, fleet=shards)
    r_tg = _serving_recall(tg, vis, q_vids, gt_vids)
    ctl_t = tg.recal
    record("targeted_fleet", tg, wall_t, lat_t, r_tg, shards=shards,
           swaps=ctl_t.targeted_swaps,
           rows_reprofiled=int(ctl_t.rows_reprofiled),
           profile_wall_s=round(ctl_t.profile_wall, 4))

    fu, wall_f, lat_f = run("full_single", SOAK_POLICY, SOAK_RECAL_FULL)
    r_fu = _serving_recall(fu, vis, q_vids, gt_vids)
    ctl_f = fu.recal
    record("full_single", fu, wall_f, lat_f, r_fu, shards=0,
           swaps=ctl_f.full_rebuilds,
           rows_reprofiled=int(ctl_f.rows_reprofiled),
           profile_wall_s=round(ctl_f.profile_wall, 4))

    # --- the acceptance gate ------------------------------------------
    savings = ex.admitted_steps / max(tg.admitted_steps, 1)
    assert savings >= 20.0, \
        f"soak_130: savings {savings:.1f}x below the 20x floor " \
        f"(paper brackets 23x-38x at city scale)"
    assert r_tg >= r_ex - 0.05, \
        f"soak_130: targeted recall {r_tg:.3f} more than 5% below the " \
        f"exhaustive ceiling {r_ex:.3f}"
    assert tg.replay_steps > 0, "soak_130: late wave never replayed"
    assert tg.rebalances == 1, "soak_130: worker loss never rebalanced"
    assert ctl_t.targeted_swaps >= 1 and ctl_t.full_rebuilds == 0
    assert ctl_f.full_rebuilds >= 1 and ctl_f.targeted_swaps == 0
    assert r_tg >= r_fu - 0.02, \
        f"soak_130: targeted recall {r_tg:.3f} fell behind full-rebuild " \
        f"recall {r_fu:.3f}"
    assert ctl_t.rows_reprofiled < C * ctl_t.targeted_swaps, \
        f"soak_130: targeted recal touched {ctl_t.rows_reprofiled} rows " \
        f"over {ctl_t.targeted_swaps} swaps, no better than full (C={C})"
    assert ctl_f.rows_reprofiled == C * ctl_f.full_rebuilds
    per_t = ctl_t.profile_wall / ctl_t.targeted_swaps
    per_f = ctl_f.profile_wall / ctl_f.full_rebuilds
    assert per_t < per_f, \
        f"soak_130: targeted per-swap profiling wall {per_t * 1e3:.1f}ms " \
        f"not below full-rebuild {per_f * 1e3:.1f}ms"

    rows_per_swap = ctl_t.rows_reprofiled / ctl_t.targeted_swaps
    bench_record("soak_130", scenario=sc["name"], config="gate",
                 savings_x=round(savings, 2),
                 recall_exhaustive=round(r_ex, 4),
                 recall_targeted=round(r_tg, 4),
                 recall_full=round(r_fu, 4),
                 rows_per_targeted_swap=round(rows_per_swap, 1),
                 profile_ms_targeted=round(per_t * 1e3, 2),
                 profile_ms_full=round(per_f * 1e3, 2), derived=True)
    rows.append((f"soak_130/{sc['name']}/gate", 0.0,
                 f"soak_gate=ok savings={savings:.1f}x "
                 f"recall_ex={r_ex:.2f} recall_targeted={r_tg:.2f} "
                 f"recall_full={r_fu:.2f} "
                 f"rows/swap={rows_per_swap:.0f}/{C} "
                 f"profile_ms={per_t * 1e3:.1f}vs{per_f * 1e3:.1f}"))
    return rows


SWEEPS = {"drift_sweep": drift_sweep, "soak_130": soak_130}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, choices=list(SWEEPS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bench-dir", default=None, metavar="DIR",
                    help="write BENCH_<sweep>.json files into DIR")
    args = ap.parse_args()
    resolve_device(args.device)     # no card: fail before building a world
    print("name,us_per_call,derived")
    for name in args.only or list(SWEEPS):
        t0 = time.perf_counter()
        pop_bench_records(name)
        rows = SWEEPS[name](device=args.device)
        for rname, us, derived in rows:
            print(f"{rname},{us:.1f},{derived}")
        recs = pop_bench_records(name)
        if args.bench_dir and recs:
            os.makedirs(args.bench_dir, exist_ok=True)
            path = os.path.join(args.bench_dir, f"BENCH_{name}.json")
            with open(path, "w") as f:
                json.dump({"scenario": name, "records": recs}, f, indent=1)
            print(f"# {name}: {len(recs)} records -> {path}", file=sys.stderr)
        print(f"# {name} done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)


if __name__ == "__main__":
    main()
