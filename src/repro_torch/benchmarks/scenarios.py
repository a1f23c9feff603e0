"""The serving scenarios of ``benchmarks/scenarios.py``, on the port.

Each scenario is (network, profile model, live visits, gallery, features,
queries): profiling runs on a dedicated historical partition, live
tracking on held-out traffic, the paper's §8.1 methodology.  The worlds
(``duke``, ``anoncampus``, ``porto``) are built once a process; their
models live on the CPU and every consumer moves them to its device.

  policy_sweep         every admission scheme through ``api.track``:
                       savings against the all-camera baseline.
  serving_sweep        the live engine per scheme (admitted steps, unique
                       frames, dedup, replay cache), then the rexcam
                       scheme under each §5.3 replay mode (Fig. 15 on the
                       serving plane).
  tile_sweep           tile-granular serving: the all-admitted
                       differential, then learned entry-region masks,
                       gated at >= 2x fewer tiles and recall no lower.
  serving_shard_sweep  the fleet at 1, 2, 4 and 8 workers, totals equal to
                       the single engine's.
  gallery_sweep        the fleet's local against its sharded gallery.
  transport_sweep      blocking fetches against prefetch through a
                       real-clock ``FakeRpcTransport`` whose RTT is the
                       measured p50 tick, under three gates.
  query_churn_sweep    the consolidated 8-worker fleet against the
                       unconsolidated single engine at N live queries,
                       trace-identical, sublinear in N.
  drift_sweep          the duke world whose camera topology is re-permuted
                       mid-run, served frozen, with recalibration, and with
                       recalibration on an 8-worker fleet
                       (``recalibrated_shards8``); the recalibrated recall
                       must beat the frozen one and the fleet must equal the
                       single engine (admitted steps, swap ticks, recall).
  soak_130             the 130-camera clustered city with localized hub
                       drift and a late query wave, served exhaustively,
                       with row-targeted recalibration on an 8-worker fleet
                       that loses worker w1 at step 120
                       (``targeted_fleet``, one rebalance) and with full
                       rebuilds on one engine, under the reference's gates
                       (savings >= 20x, targeted recall within 5 % of
                       exhaustive and 2 % of full, fewer rows than C a
                       swap).

The fleets' workers are logical partitions of the query axis, all on the
engine's device (``runtime.fleet``), so no shard count is ever skipped.
The reference's shape machinery (``RecompileGuard``, ``prime_batch``,
``prime_gallery``, ``padded_gallery_rows``, tile_sweep's warm-up drive)
has no counterpart: the port pads nothing and compiles nothing.  The
wall-clock gates are pure functions of the measured numbers
(``tile_gate``, ``transport_gates``, ``sublinear_gate``).

    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios \\
        --only serving_sweep tile_sweep [--device cpu] [--bench-dir DIR]

is ``python -m repro_torch.benchmarks.run`` (the same entries and flags):
it prints ``name,us_per_call,derived`` CSV rows and, with ``--bench-dir``,
writes ``DIR/BENCH_<sweep>.json`` in the schema
``scripts/bench_schema_check.py`` checks.  ``--device cuda`` (the default)
serves on the card and raises without one.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import time

import numpy as np

from repro_torch import api as rexcam
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.profiler import build_model
from repro_torch.core.simulate import (anoncampus_like_network,
                                       build_gallery, clustered_city_network,
                                       concat_visits, duke_like_network,
                                       permute_network, porto_like_network,
                                       restrict_network, simulate_network,
                                       tile_index)
from repro_torch.core.tracker import make_queries
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Machine-readable benchmark records (BENCH_<sweep>.json).
# ---------------------------------------------------------------------------

#: sweep name -> records appended by ``bench_record`` while a sweep runs;
#: ``run.main`` drains it into ``BENCH_<sweep>.json``
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


# ---------------------------------------------------------------------------
# Clock readings: what two runs of one sweep may disagree on.
# ---------------------------------------------------------------------------

#: record fields read off a clock (or derived from such a reading)
CLOCK_KEYS = ("wall_s", "steady_wall_s", "p50_tick_ms", "p99_tick_ms",
              "rtt_ms", "wall_ratio", "profile_wall_s",
              "profile_ms_targeted", "profile_ms_full")

#: ``key=value`` text of a CSV row read off a clock
_CLOCK_TEXT = re.compile(
    r" ?\b(wall|extra|stall_floor|vs_blocking|rtt|rtt_unit|p50_tick|"
    r"p99_tick|speedup|steady_wall(_n\d+/n\d+)?|profile_ms)=\S+"
    r"( vs camera \S+)?")


def strip_clock_row(row):
    """(name, derived) of a ``(name, us_per_call, derived)`` row: the
    per-call microseconds and the clock readings in the text dropped."""
    name, _us, derived = row
    return name, _CLOCK_TEXT.sub("", derived).strip()


def strip_clock_records(recs):
    """The records without their ``CLOCK_KEYS`` fields."""
    return [{k: v for k, v in r.items() if k not in CLOCK_KEYS}
            for r in recs]


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


# ---------------------------------------------------------------------------
# The worlds (models on the CPU; consumers move them).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def duke(n_queries: int = 100, n_entities: int = 2700, horizon: int = 5100,
         time_limit: int = 3000):
    """The 8-camera duke world: 85 minutes at one step a second, profiled
    on the first ``time_limit`` steps."""
    net = duke_like_network()
    vis = simulate_network(net, n_entities, horizon, seed=0)
    gal, _ = build_gallery(vis, 24)
    model = build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, net.n_cams,
                        time_limit=time_limit, device="cpu")
    feats, _ = make_features(vis, n_entities, FeatureParams())
    q_vids, gt_vids = make_queries(vis, n_queries, seed=1)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, name="duke")


@functools.lru_cache(maxsize=None)
def anoncampus(n_queries: int = 20, n_entities: int = 700,
               horizon: int = 2100, time_limit: int = 1300):
    """The 5-camera indoor campus (35 minutes), with noisier features
    (occlusions, the paper's §8.2 recall note)."""
    net = anoncampus_like_network()
    vis = simulate_network(net, n_entities, horizon, seed=5)
    gal, _ = build_gallery(vis, 24)
    model = build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, net.n_cams,
                        time_limit=time_limit, device="cpu")
    feats, _ = make_features(vis, n_entities,
                             FeatureParams(noise_sigma=0.55, seed=5))
    q_vids, gt_vids = make_queries(vis, n_queries, seed=6)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, name="anoncampus")


@functools.lru_cache(maxsize=None)
def porto(n_cams: int = 130, n_queries: int = 100,
          history=(6000, 7200), live=(2000, 3600)):
    """The porto road grid restricted to its first ``n_cams`` cameras,
    profiled on a dedicated historical partition (``history``: entities,
    steps) and served on ``live`` traffic with 400 lookalike groups."""
    net = porto_like_network(130)
    if n_cams < 130:
        net = restrict_network(net, np.arange(n_cams))
    hist = simulate_network(net, history[0], history[1], seed=11)
    model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out,
                        net.n_cams, device="cpu")
    vis = simulate_network(net, live[0], live[1], seed=2)
    gal, _ = build_gallery(vis, 16)
    feats, _ = make_features(vis, live[0],
                             FeatureParams(n_clusters=400, seed=2))
    q_vids, gt_vids = make_queries(vis, n_queries, seed=3)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, name=f"porto{n_cams}")


# ---------------------------------------------------------------------------
# drive: the recalibration sweeps' serving loop.
# ---------------------------------------------------------------------------

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
# policy_sweep: every admission scheme through the api facade.
# ---------------------------------------------------------------------------

SWEEP_POLICIES = (
    ("all", rexcam.SearchPolicy(scheme="all")),
    ("geo", rexcam.SearchPolicy(scheme="geo")),
    ("spatial_only", rexcam.SearchPolicy(scheme="spatial_only", s_thresh=.05)),
    ("rexcam", rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05,
                                   t_thresh=.02)),
)

#: the serving sweeps' policy
REXCAM = rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05, t_thresh=.02)


def policy_sweep(scenarios=("duke", "porto130"), *, device="cuda"):
    """(name, us_per_call, derived) rows: per scenario, each scheme's cost,
    recall/precision, and savings multiplier against the all-camera
    baseline (the paper's targets: 8.3x Duke spatio-temporal, 23-38x at
    130 cameras)."""
    device = resolve_device(device)
    worlds = {"duke": lambda: duke(60), "anoncampus": lambda: anoncampus(20),
                "porto130": lambda: porto(130, 60)}
    rows = []
    for sc_name in scenarios:
        sc = worlds[sc_name]()
        base_cost = None
        for pname, policy in SWEEP_POLICIES:
            t0 = time.perf_counter()
            r = rexcam.track(sc["model"], sc["vis"], sc["gal"], sc["feats"],
                             sc["q_vids"], sc["gt_vids"], policy,
                             geo_adj=sc["net"].geo_adjacent, device=device)
            us = (time.perf_counter() - t0) * 1e6 / max(len(sc["q_vids"]), 1)
            if pname == "all":
                base_cost = r.total_cost
            savings = base_cost / max(r.total_cost, 1.0)
            rows.append((f"policy_sweep/{sc['name']}/{pname}", us,
                         f"savings={savings:.1f}x recall={r.recall:.2f} "
                         f"precision={r.precision:.2f} "
                         f"rescued={int(r.rescued.sum())}"))
    return rows


# ---------------------------------------------------------------------------
# serving_sweep: the live engine's cost accounting, per scheme.
# ---------------------------------------------------------------------------

def _drive_serving(sc, policy, n_queries, steps, shards=None,
                   gallery="auto", transport=None, prefetch=False,
                   tile_grid=0, model=None, topk_rerank=False, *,
                   device="cuda"):
    """The engine-driving loop every serving sweep shares: build the engine
    on ``device`` (a ``shards``-worker fleet when given), submit the
    scenario's first ``n_queries`` queries, replay the live stream tick by
    tick for ``steps`` ticks.  ``tile_grid=T > 0`` serves the tile plane
    (each detection's tile rides along at ingest); ``model`` overrides the
    scenario's profile; ``transport`` / ``prefetch`` / ``gallery`` /
    ``topk_rerank`` pass through to ``api.serve``.
    Returns (engine, matches, wall seconds including the engine's
    construction, per-tick wall latencies)."""
    vis, gal, feats, net = sc["vis"], sc["gal"], sc["feats"], sc["net"]
    q_vids = sc["q_vids"][:n_queries]
    vis_tiles = tile_index(vis.tile_xy, tile_grid) if tile_grid > 0 \
        else None
    wall0 = time.perf_counter()
    eng = rexcam.serve(sc["model"] if model is None else model,
                       embed_fn=lambda x: x, policy=policy,
                       geo_adj=net.geo_adjacent, shards=shards,
                       gallery=gallery, transport=transport,
                       prefetch=prefetch, tile_grid=tile_grid,
                       topk_rerank=topk_rerank, device=device)
    t0 = int(vis.t_out[q_vids].min())
    eng.t = t0
    for i, q in enumerate(q_vids):
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    matches = 0
    tick_lat = []
    for t in range(t0, min(t0 + steps, vis.horizon)):
        frames, tiles = {}, {}
        for c in range(net.n_cams):
            vids = gal[c, t][gal[c, t] >= 0]
            if len(vids):
                frames[c] = feats[vids]
                if vis_tiles is not None:
                    tiles[c] = vis_tiles[vids]
        eng.ingest(frames, tiles if vis_tiles is not None else None)
        tk0 = time.perf_counter()
        matches += eng.tick()["matches"]
        tick_lat.append(time.perf_counter() - tk0)
    return eng, matches, time.perf_counter() - wall0, tick_lat


def _match_delay(eng) -> float:
    """Mean ticks from submit to the first confirmed match (the Fig. 15
    detection-delay metric) over the queries that ever matched; -1 when
    none did."""
    d = [q.first_match_t - q.submit_t for q in eng.queries.values()
         if q.first_match_t >= 0]
    return float(np.mean(d)) if d else -1.0


#: §5.3 replay catch-up modes for the Fig. 15-style serving rows: real-time
#: replay, fast-forward (extra content rounds per wall tick) and frame-skip
#: (sample every k-th content frame while behind).
REPLAY_MODES = (
    ("base", {}),
    ("ff", dict(replay_speed=4.0)),
    ("skip", dict(replay_skip=4)),
)


def serving_sweep(scenarios=("duke",), n_queries=16, steps=400, *,
                  device="cuda"):
    """The live engine per scheme over real ingest, with both cost
    conventions: ``admitted_steps`` (per-query camera-steps, comparable
    with the tracker's cost) and ``unique_frames`` (deduplicated inference
    load), plus cross-query dedup and the embedding cache's hit rate on
    replay re-reads.  Then the rexcam scheme under each §5.3 replay mode
    (real-time, fast-forward, frame-skip): cost against the detection
    delay, one record per mode."""
    device = resolve_device(device)
    worlds = {"duke": lambda: duke(60)}
    rows = []
    for sc_name in scenarios:
        sc = worlds[sc_name]()
        n_q = min(n_queries, len(sc["q_vids"]))
        base = None
        for pname, policy in SWEEP_POLICIES:
            eng, matches, wall, lat = _drive_serving(sc, policy, n_q, steps,
                                                     device=device)
            us = wall * 1e6 / max(n_q, 1)
            if pname == "all":
                base = eng.admitted_steps
            savings = base / max(eng.admitted_steps, 1)
            dedup = eng.admitted_steps / max(eng.unique_frames, 1)
            # hit rate over replay re-reads only: live first-embeds can
            # never be cache hits
            hot = eng.cache_hits / max(eng.cache_hits + eng.replay_embeds, 1)
            p50, p99 = _tick_pcts(lat)
            bench_record("serving_sweep", scenario=sc["name"], policy=pname,
                         admitted_steps=int(eng.admitted_steps),
                         unique_frames=int(eng.unique_frames),
                         wall_s=round(wall, 4), p50_tick_ms=round(p50, 3),
                         p99_tick_ms=round(p99, 3), matches=int(matches))
            rows.append((f"serving_sweep/{sc['name']}/{pname}", us,
                         f"savings={savings:.1f}x "
                         f"admitted_steps={eng.admitted_steps} "
                         f"unique_frames={eng.unique_frames} "
                         f"dedup={dedup:.1f}x replay_cache_hot={hot:.2f} "
                         f"matches={matches}"))
        for mode, knobs in REPLAY_MODES:
            policy = rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05,
                                         t_thresh=.02, **knobs)
            eng, matches, wall, lat = _drive_serving(sc, policy, n_q, steps,
                                                     device=device)
            delay = _match_delay(eng)
            p50, p99 = _tick_pcts(lat)
            bench_record("serving_sweep", scenario=sc["name"],
                         policy="rexcam", replay_mode=mode,
                         replay_speed=float(policy.replay_speed),
                         replay_skip=int(policy.replay_skip),
                         admitted_steps=int(eng.admitted_steps),
                         unique_frames=int(eng.unique_frames),
                         content_steps=int(eng.content_steps),
                         replay_steps=int(eng.replay_steps),
                         skipped_steps=int(eng.skipped_steps),
                         detection_delay_ticks=round(delay, 2),
                         matches=int(matches), wall_s=round(wall, 4),
                         p50_tick_ms=round(p50, 3),
                         p99_tick_ms=round(p99, 3))
            rows.append((f"serving_sweep/{sc['name']}/replay_{mode}",
                         wall * 1e6 / max(n_q, 1),
                         f"delay={delay:.1f}ticks "
                         f"admitted_steps={eng.admitted_steps} "
                         f"content_steps={eng.content_steps} "
                         f"replay_steps={eng.replay_steps} "
                         f"skipped={eng.skipped_steps} matches={matches}"))
    return rows


# ---------------------------------------------------------------------------
# tile_sweep: tile-granular pixel load against the camera-granular baseline.
# ---------------------------------------------------------------------------

def tile_gate(reduction, recall_tiles, recall_camera, admitted_tiles,
              pixel_base) -> None:
    """tile_sweep's acceptance gate: the learned masks cut the admitted
    pixel load (tiles scored against T*T a camera-granular step) at least
    2x, at recall no lower than camera-granular serving's.  Raises
    ``AssertionError``."""
    assert reduction >= 2.0, \
        f"tile_sweep: learned masks cut pixel load only {reduction:.2f}x " \
        f"({admitted_tiles} of {pixel_base} tiles) — need >= 2x"
    assert recall_tiles >= recall_camera, \
        f"tile_sweep: tile recall {recall_tiles:.3f} dropped below the " \
        f"camera-granular baseline's {recall_camera:.3f}"


def tile_sweep(n_queries=16, steps=400, tile_grid=8, tile_keep=1.0, *,
               device="cuda"):
    """Sub-frame spatial admission on duke.  The all-admitted differential:
    serving with ``tile_grid=T`` over the tile-less profile must reproduce
    the camera-granular run (admitted steps, unique frames, matches) with
    ``admitted_tiles == T*T * admitted_steps`` (asserted).  The learned
    masks: a re-profile with ``tile_grid=T`` served through its per
    camera-pair entry-region masks, under ``tile_gate``.  A
    camera-granular step decodes all T*T tiles of its frame, a tile step
    only the cells the model admits; ``unique_tiles`` is the same under
    the deduplicated convention."""
    device = resolve_device(device)
    sc = duke(60)
    vis = sc["vis"]
    n_q = min(n_queries, len(sc["q_vids"]))
    q_vids, gt_vids = sc["q_vids"][:n_q], sc["gt_vids"][:n_q]
    T, TT = tile_grid, tile_grid * tile_grid
    policy = REXCAM
    rows = []

    # camera-granular baseline
    base, m_base, wall_b, lat_b = _drive_serving(sc, policy, n_q, steps,
                                                 device=device)
    recall_b = _serving_recall(base, vis, q_vids, gt_vids)
    p50_b, p99_b = _tick_pcts(lat_b)
    bench_record("tile_sweep", scenario=sc["name"], config="camera",
                 tile_grid=0, admitted_steps=int(base.admitted_steps),
                 unique_frames=int(base.unique_frames),
                 admitted_tiles=TT * int(base.admitted_steps),
                 recall=round(recall_b, 4), matches=int(m_base),
                 wall_s=round(wall_b, 4), p50_tick_ms=round(p50_b, 3),
                 p99_tick_ms=round(p99_b, 3))
    rows.append((f"tile_sweep/{sc['name']}/camera",
                 wall_b * 1e6 / max(n_q, 1),
                 f"recall={recall_b:.2f} "
                 f"admitted_steps={base.admitted_steps} "
                 f"pixel_load={TT * base.admitted_steps}tiles "
                 f"matches={m_base}"))

    # all tiles admitted: the tile path over the same tile-less model must
    # change nothing but the counters' units
    alladm, m_all, wall_a, lat_a = _drive_serving(
        sc, policy, n_q, steps, tile_grid=T, device=device)
    assert alladm.admitted_steps == base.admitted_steps, \
        "tile path changed admitted_steps under all-admitted tiles"
    assert alladm.unique_frames == base.unique_frames, \
        "tile path changed unique_frames under all-admitted tiles"
    assert m_all == m_base, "tile path changed match outcomes"
    assert alladm.admitted_tiles == TT * alladm.admitted_steps
    assert alladm.unique_tiles == TT * alladm.unique_frames
    p50_a, p99_a = _tick_pcts(lat_a)
    bench_record("tile_sweep", scenario=sc["name"], config="all_admitted",
                 tile_grid=T, admitted_steps=int(alladm.admitted_steps),
                 unique_frames=int(alladm.unique_frames),
                 admitted_tiles=int(alladm.admitted_tiles),
                 unique_tiles=int(alladm.unique_tiles),
                 recall=round(recall_b, 4), matches=int(m_all),
                 wall_s=round(wall_a, 4), p50_tick_ms=round(p50_a, 3),
                 p99_tick_ms=round(p99_a, 3))
    rows.append((f"tile_sweep/{sc['name']}/all_admitted",
                 wall_a * 1e6 / max(n_q, 1),
                 f"differential=ok admitted_tiles={alladm.admitted_tiles} "
                 f"(=TT*admitted_steps) matches={m_all} "
                 f"wall={wall_a:.2f}s vs camera {wall_b:.2f}s"))

    # learned entry-region masks, profiled on the scenario's own profile
    # partition (the camera model's time_limit)
    tile_model = rexcam.profile(vis, time_limit=3000, tile_grid=T,
                                tile_keep=tile_keep, device=device)
    learned, m_t, wall_t, lat_t = _drive_serving(
        sc, policy, n_q, steps, tile_grid=T, model=tile_model,
        device=device)
    recall_t = _serving_recall(learned, vis, q_vids, gt_vids)
    pixel_base = TT * base.admitted_steps
    reduction = pixel_base / max(learned.admitted_tiles, 1)
    dedup_red = (TT * learned.unique_frames) / max(learned.unique_tiles, 1)
    p50_t, p99_t = _tick_pcts(lat_t)
    bench_record("tile_sweep", scenario=sc["name"], config="learned",
                 tile_grid=T, tile_keep=tile_keep,
                 admitted_steps=int(learned.admitted_steps),
                 unique_frames=int(learned.unique_frames),
                 admitted_tiles=int(learned.admitted_tiles),
                 unique_tiles=int(learned.unique_tiles),
                 pixel_reduction=round(reduction, 2),
                 recall=round(recall_t, 4), matches=int(m_t),
                 wall_s=round(wall_t, 4), p50_tick_ms=round(p50_t, 3),
                 p99_tick_ms=round(p99_t, 3))
    rows.append((f"tile_sweep/{sc['name']}/learned",
                 wall_t * 1e6 / max(n_q, 1),
                 f"pixel_reduction={reduction:.1f}x "
                 f"admitted_tiles={learned.admitted_tiles} "
                 f"of {pixel_base} camera-granular "
                 f"dedup_reduction={dedup_red:.1f}x "
                 f"recall={recall_t:.2f} (camera {recall_b:.2f}) "
                 f"matches={m_t} wall={wall_t:.2f}s"))

    tile_gate(reduction, recall_t, recall_b, learned.admitted_tiles,
              pixel_base)
    rows.append((f"tile_sweep/{sc['name']}/acceptance", 0.0,
                 f"tile_gate=ok reduction={reduction:.1f}x>=2x "
                 f"recall_delta={recall_t - recall_b:+.3f}"))
    return rows


# ---------------------------------------------------------------------------
# serving_shard_sweep: the fleet against one engine, per shard count.
# ---------------------------------------------------------------------------

def serving_shard_sweep(scenarios=("duke",), n_queries=16, steps=300,
                        shard_counts=(1, 2, 4, 8), *, device="cuda"):
    """The live query axis over 1, 2, 4 and 8 workers: per shard count the
    wall-clock speedup against the single engine, the fleet totals (which
    must equal the single engine's, asserted) and the per-worker
    ``admitted_steps`` / ``unique_frames`` split."""
    device = resolve_device(device)
    worlds = {"duke": lambda: duke(60)}
    rows = []
    for sc_name in scenarios:
        sc = worlds[sc_name]()
        n_q = min(n_queries, len(sc["q_vids"]))
        base_eng, _, base_wall, _ = _drive_serving(sc, REXCAM, n_q, steps,
                                                   device=device)
        for S in shard_counts:
            eng, _, wall, _ = _drive_serving(sc, REXCAM, n_q, steps,
                                             shards=S, device=device)
            assert eng.admitted_steps == base_eng.admitted_steps, \
                "fleet diverged from the single engine (admitted_steps)"
            assert eng.unique_frames == base_eng.unique_frames, \
                "fleet diverged from the single engine (unique_frames)"
            rep = eng.shard_report()
            per_adm = "/".join(str(r["admitted_steps"]) for r in rep)
            per_uni = "/".join(str(r["unique_frames"]) for r in rep)
            rows.append((f"serving_shard_sweep/{sc['name']}/shards{S}",
                         wall * 1e6 / max(n_q, 1),
                         f"speedup={base_wall / max(wall, 1e-9):.2f}x "
                         f"wall={wall:.2f}s "
                         f"admitted_steps={eng.admitted_steps} "
                         f"unique_frames={eng.unique_frames} "
                         f"per_shard_admitted={per_adm} "
                         f"per_shard_unique={per_uni}"))
    return rows


# ---------------------------------------------------------------------------
# gallery_sweep: one fleet-wide embedding plane against the replicated one.
# ---------------------------------------------------------------------------

def gallery_sweep(scenarios=("duke",), n_queries=16, steps=300, shards=4, *,
                  device="cuda"):
    """The gallery plane's win: the fleet with the fleet-shared
    ``ShardedGalleryStore`` and with the replicated ``LocalGalleryStore``,
    reporting per mode the embed-call reduction (fleet-global embeds,
    ``frames_processed``, against the sum of each worker's shard-local
    demand) and each worker's resident bytes (the whole cache on every
    worker when replicated).  Both must equal the single engine's
    ``unique_frames`` and ``frames_processed`` (asserted)."""
    device = resolve_device(device)
    worlds = {"duke": lambda: duke(60)}
    rows = []
    for sc_name in scenarios:
        sc = worlds[sc_name]()
        n_q = min(n_queries, len(sc["q_vids"]))
        single, _, _, _ = _drive_serving(sc, REXCAM, n_q, steps,
                                         device=device)
        for mode in ("local", "sharded"):
            eng, _, wall, lat = _drive_serving(sc, REXCAM, n_q, steps,
                                               shards=shards, gallery=mode,
                                               device=device)
            assert eng.unique_frames == single.unique_frames, \
                f"gallery={mode} fleet diverged from the single engine"
            assert eng.frames_processed == single.frames_processed, \
                f"gallery={mode} fleet re-embedded (no longer one plane)"
            rep = eng.shard_report()
            replicated_embeds = sum(r["unique_frames"] for r in rep)
            reduction = replicated_embeds / max(eng.frames_processed, 1)
            g = eng.gallery_report()
            if mode == "sharded":
                per_w = g["per_worker"]
                mem = "/".join(f"{per_w[r['worker']]['bytes']}" for r in rep)
                peak = max(v["bytes"] for v in per_w.values())
            else:
                # replicated baseline: every worker would hold the full cache
                mem = "/".join(str(g["bytes"]) for _ in rep)
                peak = g["bytes"]
            p50, p99 = _tick_pcts(lat)
            bench_record("gallery_sweep", scenario=sc["name"], gallery=mode,
                         shards=shards,
                         admitted_steps=int(eng.admitted_steps),
                         unique_frames=int(eng.unique_frames),
                         wall_s=round(wall, 4), p50_tick_ms=round(p50, 3),
                         p99_tick_ms=round(p99, 3),
                         embed_calls=int(eng.frames_processed),
                         cache_hits=int(eng.cache_hits),
                         peak_worker_bytes=int(peak))
            rows.append((f"gallery_sweep/{sc['name']}/{mode}",
                         wall * 1e6 / max(n_q, 1),
                         f"embed_calls={eng.frames_processed} "
                         f"replicated_demand={replicated_embeds} "
                         f"embed_reduction={reduction:.1f}x "
                         f"cache_hits={eng.cache_hits} "
                         f"per_worker_bytes={mem} peak_worker_bytes={peak}"))
    return rows


# ---------------------------------------------------------------------------
# transport_sweep: latency hiding, prefetch against blocking fetches.
# ---------------------------------------------------------------------------

def transport_gates(walls_blocking: dict, rtt: float, remote_fetches: int,
                    wall_prefetch: float, wall_prefetch_rtt0: float,
                    wall_baseline: float, prefetch_hits: int,
                    cache_hits: int) -> None:
    """transport_sweep's three gates on its measured numbers.
    ``walls_blocking`` maps each RTT scale to its blocking run's wall:

    * the blocking path degrades about linearly in RTT: the wall between
      the smallest and largest scale grows by at least 0.6 x the injected
      stall floor (``remote_fetches`` x the RTT difference);
    * prefetch hides the latency: its wall at one RTT lands within 25 % of
      the zero-latency control's (or the baseline's, if slower);
    * speculation predicts the reads: prefetch hits >= 0.8 x cache hits.

    Raises ``AssertionError``."""
    lo, hi = min(walls_blocking), max(walls_blocking)
    floor = 0.6 * remote_fetches * rtt * (hi - lo)
    assert walls_blocking[hi] - walls_blocking[lo] >= floor, \
        f"blocking path did not degrade linearly: " \
        f"{walls_blocking[hi]:.2f}s @ {hi}x vs {walls_blocking[lo]:.2f}s " \
        f"@ {lo}x (expected >= {floor:.2f}s of injected stall)"
    bound = 1.25 * max(wall_prefetch_rtt0, wall_baseline)
    assert wall_prefetch <= bound, \
        f"prefetched wall {wall_prefetch:.2f}s exceeds 1.25x the " \
        f"zero-latency baseline " \
        f"({max(wall_prefetch_rtt0, wall_baseline):.2f}s)"
    assert prefetch_hits >= 0.8 * max(cache_hits, 1), \
        f"speculation mispredicted: {prefetch_hits} prefetch hits vs " \
        f"{cache_hits} cache hits"


#: drives of each wall the prefetch gate compares (transport_sweep)
TRANSPORT_REPEATS = 3


def transport_sweep(scenarios=("duke",), n_queries=16, steps=600, shards=4,
                    rtt_scales=(1, 4, 8), *, device="cuda"):
    """The transport plane's wall-clock argument: the fleet through a
    real-clock ``FakeRpcTransport`` whose injected RTT is the measured p50
    tick ("comparable to one ranking pass"), blocking at each of
    ``rtt_scales`` and prefetched at one RTT, under ``transport_gates``.
    Every run must equal the baseline's admitted steps and unique frames
    (transport moves when blocks arrive, never what is ranked).  A
    120-tick warm-up drive runs first: on the card it also builds and
    loads the kernels, so the compared walls hold no one-time cost.

    The three walls the prefetch gate compares (the baseline, the
    zero-latency control and the prefetched run) are each the median of
    ``TRANSPORT_REPEATS`` drives, taken in rotation (the first baseline
    first: its p50 tick is the RTT), because on the card's host single
    walls of the same drive differ by a third from one run to the next;
    the gate's bound is the reference's.  Each record carries its median
    drive."""
    device = resolve_device(device)
    worlds = {"duke": lambda: duke(60)}
    rows = []
    for sc_name in scenarios:
        sc = worlds[sc_name]()
        n_q = min(n_queries, len(sc["q_vids"]))
        policy = REXCAM
        _drive_serving(sc, policy, n_q, min(steps, 120), shards=shards,
                       device=device)
        ref = {}

        def run(config, transport=None, prefetch=False, rtt_s=0.0):
            eng, _, wall, lat = _drive_serving(sc, policy, n_q, steps,
                                               shards=shards,
                                               transport=transport,
                                               prefetch=prefetch,
                                               device=device)
            ref.setdefault("steps", eng.admitted_steps)
            ref.setdefault("frames", eng.unique_frames)
            assert eng.admitted_steps == ref["steps"], \
                f"transport config {config} changed admitted_steps"
            assert eng.unique_frames == ref["frames"], \
                f"transport config {config} changed unique_frames"
            c = eng.gallery.counters()
            p50, p99 = _tick_pcts(lat)
            rec = dict(scenario=sc["name"], config=config,
                       rtt_ms=round(rtt_s * 1e3, 3),
                       admitted_steps=int(eng.admitted_steps),
                       unique_frames=int(eng.unique_frames),
                       wall_s=round(wall, 4), p50_tick_ms=round(p50, 3),
                       p99_tick_ms=round(p99, 3))
            if transport is None:
                rec["cache_hits"] = int(eng.cache_hits)
            else:
                rec.update(remote_fetches=int(c["remote_fetches"]),
                           prefetch_hits=int(c["prefetch_hits"]),
                           prefetch_wasted=int(c["prefetch_wasted"]),
                           retries=int(c["retries"]),
                           timeouts=int(c["timeouts"]))
            return dict(wall=wall, p50=p50, p99=p99, c=c, rec=rec)

        rtt = None
        drives = {"baseline": [], "prefetch_rtt0": [], "prefetch_rtt1x": []}
        for k in range(TRANSPORT_REPEATS):
            for j in range(3):
                config = list(drives)[(j - k) % 3]
                if config == "baseline":
                    d = run(config)
                    if rtt is None:
                        # "RTT comparable to one ranking pass": the
                        # measured p50 tick
                        rtt = max(0.002, d["p50"] / 1e3)
                elif config == "prefetch_rtt0":
                    # zero-latency control for the prefetched path: the
                    # same speculation through the in-proc transport
                    d = run(config, rexcam.InProcTransport(), True)
                else:
                    d = run(config, rexcam.FakeRpcTransport(
                        default=rexcam.FaultProfile(latency=rtt),
                        timeout=4 * rtt + 1.0), True, rtt)
                drives[config].append(d)
        base, p0, pf = (sorted(drives[c], key=lambda d: d["wall"])
                        [(TRANSPORT_REPEATS - 1) // 2] for c in drives)
        wall0, hits = base["wall"], base["rec"]["cache_hits"]
        rows.append((f"transport_sweep/{sc['name']}/baseline",
                     wall0 * 1e6 / max(n_q, 1),
                     f"wall={wall0:.2f}s cache_hits={hits} "
                     f"p50_tick={base['p50']:.1f}ms "
                     f"rtt_unit={rtt * 1e3:.1f}ms"))
        bench_record("transport_sweep", **base["rec"])
        bench_record("transport_sweep", **p0["rec"])

        walls_b = {}
        for s in rtt_scales:
            lat_s = rtt * s
            d = run(f"blocking_rtt{s}x", rexcam.FakeRpcTransport(
                default=rexcam.FaultProfile(latency=lat_s),
                timeout=4 * lat_s + 1.0), False, lat_s)
            wall_b, cb = d["wall"], d["c"]
            walls_b[s] = wall_b
            bench_record("transport_sweep", **d["rec"])
            rows.append((f"transport_sweep/{sc['name']}/blocking_rtt{s}x",
                         wall_b * 1e6 / max(n_q, 1),
                         f"wall={wall_b:.2f}s rtt={lat_s * 1e3:.1f}ms "
                         f"extra={wall_b - wall0:+.2f}s "
                         f"stall_floor={cb['remote_fetches'] * lat_s:.2f}s "
                         f"remote_fetches={cb['remote_fetches']} "
                         f"p99_tick={d['p99']:.1f}ms"))

        wall_p, cp = pf["wall"], pf["c"]
        bench_record("transport_sweep", **pf["rec"])
        hidden = walls_b[min(rtt_scales)] - wall_p
        rows.append((f"transport_sweep/{sc['name']}/prefetch_rtt1x",
                     wall_p * 1e6 / max(n_q, 1),
                     f"wall={wall_p:.2f}s rtt={rtt * 1e3:.1f}ms "
                     f"vs_blocking={hidden:+.2f}s "
                     f"prefetch_hits={cp['prefetch_hits']} "
                     f"wasted={cp['prefetch_wasted']} "
                     f"p99_tick={pf['p99']:.1f}ms"))
        transport_gates(walls_b, rtt, cp["remote_fetches"], wall_p,
                        p0["wall"], wall0, cp["prefetch_hits"], hits)
    return rows


# ---------------------------------------------------------------------------
# query_churn_sweep: per-round cost against the live query count.
# ---------------------------------------------------------------------------

def _churn_trace_key(trace):
    """The canonical per-round tuple stream: admissions (mask), the match
    decision, tie-break (gallery row index), raw kernel score, the top-k
    candidate bands and the model epoch.  Compared exactly."""
    return [(r["qid"], r["f_curr"], r["phase"], r["epoch"],
             tuple(bool(x) for x in r["mask"]), bool(r["matched"]),
             int(r["match_cam"]), float(r["match_val"]), int(r["match_idx"]),
             tuple(r["topk"]))
            for r in trace]


def _drive_churn(sc, policy, pool, n_queries, steps, t0, *, wave_at,
                 shards=None, consolidate=True, device="cuda"):
    """Churn drive: submits half the queries up front and the other half
    at tick ``wave_at`` (so the late joiners enter in replay), records the
    full round trace, and returns per-tick walls so callers can carve out
    a steady-state window.  Query ``i`` anchors on ``pool[i % len(pool)]``:
    many live queries, far fewer distinct (cam, frame) demands.  Returns
    (engine, trace, tick latencies, matches, wall seconds)."""
    vis, gal, feats, net = sc["vis"], sc["gal"], sc["feats"], sc["net"]
    wall0 = time.perf_counter()
    eng = rexcam.serve(sc["model"], embed_fn=lambda x: x, policy=policy,
                       geo_adj=net.geo_adjacent, shards=shards,
                       consolidate=consolidate, device=device)
    eng.t = t0

    def submit(lo, hi):
        for i in range(lo, hi):
            q = pool[i % len(pool)]
            eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))

    first = max(1, n_queries // 2)
    submit(0, first)
    trace, tick_lat, matches = [], [], 0
    for step_i, t in enumerate(range(t0, min(t0 + steps, vis.horizon))):
        if step_i == wave_at:
            submit(first, n_queries)      # mid-sweep churn: the second wave
        frames = {}
        for c in range(net.n_cams):
            vids = gal[c, t][gal[c, t] >= 0]
            if len(vids):
                frames[c] = feats[vids]
        eng.ingest(frames)
        tk0 = time.perf_counter()
        matches += eng.tick(record_trace=trace)["matches"]
        tick_lat.append(time.perf_counter() - tk0)
    return eng, trace, tick_lat, matches, time.perf_counter() - wall0


def sublinear_ratios(embed_calls: dict, steady_wall: dict, n_levels):
    """From the second-largest level of ``n_levels`` to the largest: (embed
    ratio, steady-wall ratio, the query count's ratio)."""
    lo, hi = n_levels[-2], n_levels[-1]
    return (embed_calls[hi] / max(embed_calls[lo], 1),
            steady_wall[hi] / max(steady_wall[lo], 1e-9), hi / lo)


def sublinear_gate(embed_calls: dict, steady_wall: dict, n_levels):
    """query_churn_sweep's gate across N: from the second-largest level to
    the largest, fleet-wide embed calls and the steady-state wall must each
    grow by less than the query count does.  Returns
    ``sublinear_ratios``; raises ``AssertionError``."""
    lo, hi = n_levels[-2], n_levels[-1]
    er, wr, factor = sublinear_ratios(embed_calls, steady_wall, n_levels)
    assert er < factor, \
        f"embed calls grew superlinearly: {embed_calls[hi]} @ N={hi} vs " \
        f"{embed_calls[lo]} @ N={lo} ({er:.2f}x >= {factor:.1f}x)"
    assert wr < factor, \
        f"steady wall grew superlinearly: {steady_wall[hi]:.3f}s @ N={hi} " \
        f"vs {steady_wall[lo]:.3f}s @ N={lo} ({wr:.2f}x >= {factor:.1f}x)"
    return er, wr, factor


def query_churn_sweep(n_levels=(8, 64, 256), steps=180, shards=8,
                      pool_size=32, *, device="cuda"):
    """Consolidation under churn: N live queries (N in ``n_levels``) over
    duke with mid-sweep submits (a second wave at ``steps // 3`` replays
    in) and mid-sweep completions (``exit_t`` retires queries), the
    consolidated ``shards``-worker fleet (one segment-masked re-id call a
    worker and round) against the unconsolidated single engine (the
    frame-tagged ``reid_topk_masked`` path).  Asserted per N: the two
    traces identical (``_churn_trace_key``, scores exact) with equal
    admitted, unique and embed totals, some completions and some replay;
    across N, ``sublinear_gate``."""
    device = resolve_device(device)
    sc = duke(60)
    vis = sc["vis"]
    # anchor pool: distinct visits all exiting inside one short window, so
    # every query (the late wave too) ranks the same stretch of stream
    cand = np.flatnonzero((vis.t_out >= 120) & (vis.t_out < 180))
    pool = cand[np.random.default_rng(7).permutation(len(cand))[:pool_size]]
    assert len(pool) >= 8, f"anchor window too sparse: {len(pool)} visits"
    t0 = int(vis.t_out[pool].min())
    # exit_t counts from the last sighting, so a moderate horizon retires
    # the pool's quieter entities mid-sweep: real completion churn
    policy = rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05, t_thresh=.02,
                                 exit_t=45)
    wave_at = steps // 3
    steady_from = wave_at + 5
    S = shards
    rows = []
    emb, wall = {}, {}
    for N in n_levels:
        eng_c, tr_c, lat_c, m_c, wall_c = _drive_churn(
            sc, policy, pool, N, steps, t0, wave_at=wave_at, shards=S,
            consolidate=True, device=device)
        eng_r, tr_r, lat_r, m_r, wall_r = _drive_churn(
            sc, policy, pool, N, steps, t0, wave_at=wave_at, shards=None,
            consolidate=False, device=device)
        assert _churn_trace_key(tr_c) == _churn_trace_key(tr_r), \
            f"N={N}: consolidated fleet trace diverged from the " \
            f"unconsolidated single engine"
        assert eng_c.admitted_steps == eng_r.admitted_steps
        assert eng_c.unique_frames == eng_r.unique_frames
        assert eng_c.frames_processed == eng_r.frames_processed, \
            f"N={N}: consolidation changed the embed-call count"
        done = sum(q.done for q in eng_c.queries.values())
        assert done > 0, f"N={N}: no mid-sweep completions (exit_t too big)"
        assert eng_c.replay_steps > 0, \
            f"N={N}: second wave never replayed (wave_at too early)"
        emb[N] = int(eng_c.frames_processed)
        wall[N] = float(sum(lat_c[steady_from:]))
        steady_r = float(sum(lat_r[steady_from:]))
        p50, p99 = _tick_pcts(lat_c)
        for config, eng, w, steady, lat, m in (
                ("consolidated_fleet", eng_c, wall_c, wall[N], lat_c, m_c),
                ("unconsolidated_single", eng_r, wall_r, steady_r, lat_r,
                 m_r)):
            cp50, cp99 = _tick_pcts(lat)
            bench_record("query_churn_sweep", scenario=sc["name"],
                         config=config, n_queries=N,
                         shards=S if config == "consolidated_fleet" else 0,
                         admitted_steps=int(eng.admitted_steps),
                         unique_frames=int(eng.unique_frames),
                         embed_calls=int(eng.frames_processed),
                         replay_steps=int(eng.replay_steps),
                         wall_s=round(w, 4), steady_wall_s=round(steady, 4),
                         p50_tick_ms=round(cp50, 3),
                         p99_tick_ms=round(cp99, 3), matches=int(m),
                         done=int(done))
        rows.append((f"query_churn_sweep/{sc['name']}/n{N}/consolidated",
                     wall[N] * 1e6 / max(N, 1),
                     f"embed_calls={emb[N]} steady_wall={wall[N]:.3f}s "
                     f"admitted_steps={eng_c.admitted_steps} "
                     f"unique_frames={eng_c.unique_frames} "
                     f"replay_steps={eng_c.replay_steps} done={done}/{N} "
                     f"matches={m_c} p99_tick={p99:.1f}ms trace=identical"))
        rows.append((f"query_churn_sweep/{sc['name']}/n{N}/unconsolidated",
                     steady_r * 1e6 / max(N, 1),
                     f"steady_wall={steady_r:.3f}s "
                     f"note=per-frame reference path, same trace"))
    er, wr, factor = sublinear_gate(emb, wall, n_levels)
    lo, hi = n_levels[-2], n_levels[-1]
    bench_record("query_churn_sweep", scenario=sc["name"],
                 config="sublinearity", n_lo=lo, n_hi=hi,
                 embed_ratio=round(er, 3), wall_ratio=round(wr, 3),
                 bound=factor, derived=True)
    rows.append((f"query_churn_sweep/{sc['name']}/sublinearity", 0.0,
                 f"sublinear=ok embed_n{hi}/n{lo}={er:.2f}x "
                 f"steady_wall_n{hi}/n{lo}={wr:.2f}x bound={factor:.1f}x"))
    return rows


# ---------------------------------------------------------------------------
# drift_sweep: §6 on the serving plane.
# ---------------------------------------------------------------------------

#: the trigger tuned to the duke profile's density: the hot drifted pairs
#: carry ~10-30 historical transitions, so a handful of rescues there
#: scores ~0.1-0.15
DRIFT_RECAL = rexcam.RecalibrationPolicy(drift_threshold=.06, min_rescues=8,
                                         cooldown=300, poll_every=20,
                                         window=600)
DRIFT_POLICY = REXCAM


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


def main(argv=None) -> int:
    """``python -m repro_torch.benchmarks.run`` under this module's name."""
    from repro_torch.benchmarks import run

    return run.main(argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
