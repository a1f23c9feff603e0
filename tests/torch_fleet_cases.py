"""The port's fleet driven like ``conftest.drive_serving_trace``, and the
differential against the reference's single engine that the port's fleet
tests share (``test_torch_fleet*.py``).

The reference single engine runs under ``conftest.drive_serving_trace``
(one JAX device, the Pallas kernels in interpret mode); the port's fleet
runs on the CPU with ``devices=["cpu"] * shards``.  Traces are compared as
in ``test_torch_engine.py`` (scores within 1e-5, everything else exact):
a worker's block has fewer rows than the round, and the CPU's plain matrix
product may round a score differently at another row count."""
import functools

import numpy as np

from conftest import (drive_serving_trace, make_drifted_world,
                      make_serving_world, make_soak_world)
from repro.core.policy import SearchPolicy as JPolicy
from repro_torch import api
from repro_torch.core.policy import SearchPolicy
from repro_torch.core.simulate import tile_index
from repro_torch.runtime.gallery import ShardedGalleryStore
from repro_torch.runtime.transport import (FakeRpcTransport, FaultProfile,
                                           manual_clock)
from test_torch_engine import _port_model, assert_traces_match

#: the policy of every ``conftest.fleet_case_*`` serving world
POLICY = dict(scheme="rexcam", s_thresh=.05, t_thresh=.02, exit_t=60)

WORLDS = {"serving": make_serving_world, "drifted": make_drifted_world,
          "soak": make_soak_world}


@functools.lru_cache(maxsize=None)
def world(kind="serving", **kw):
    return WORLDS[kind](**kw)


def _items(d):
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=None)
def _reference(world_key, policy_items, kw_items):
    kind, wkw = world_key
    kw = dict(kw_items)
    if "recalibrate" in kw:
        from repro.runtime.recal import RecalibrationPolicy as JRecal
        kw["recalibrate"] = JRecal(**dict(kw["recalibrate"]))
    eng, trace, summary = drive_serving_trace(
        world(kind, **dict(wkw)), JPolicy(**dict(policy_items)), **kw)
    summary = dict(summary, admitted_tiles=eng.admitted_tiles,
                   unique_tiles=eng.unique_tiles,
                   frames_processed=eng.frames_processed,
                   cache_hits=eng.cache_hits)
    return trace, summary


def reference(kind="serving", policy=POLICY, *, recalibrate=None, **kw):
    """The reference single engine's (trace, summary) on ``world(kind,
    **world_kw)``; ``kw`` splits into the world's keywords (``seed``,
    ``n_queries``, ``horizon``) and ``drive_serving_trace``'s."""
    wkw = {k: kw.pop(k) for k in ("seed", "n_queries", "horizon")
           if k in kw}
    if recalibrate is not None:
        kw["recalibrate"] = _items(recalibrate)
    return _reference((kind, _items(wkw)), _items(policy), _items(kw))


def fake_rpc(profiles=None, **kw):
    """``conftest._fake_rpc_factory`` for the port: a zero-arg factory of a
    virtual-clock ``FakeRpcTransport`` (``profiles`` maps peer ->
    FaultProfile keywords, ``default`` may be a dict of them)."""
    def make():
        clock, sleep = manual_clock()
        faults = {w: FaultProfile(**p) for w, p in (profiles or {}).items()}
        kw2 = dict(kw)
        if isinstance(kw2.get("default"), dict):
            kw2["default"] = FaultProfile(**kw2["default"])
        return FakeRpcTransport(faults=faults, clock=clock, sleep=sleep, **kw2)
    return make


def drive_port(w, policy=POLICY, *, shards=None, lose_at=None,
               lose_worker=0, extra_ticks=500, gallery="auto", topk=1,
               recalibrate=None, transport=None, prefetch=False,
               consolidate=True, tile_grid=0, model=None, churn_wave=None,
               embed_fn=None, on_tick=None):
    """``conftest.drive_serving_trace`` for the port on the CPU: the fleet
    (``shards`` workers on ``devices=["cpu"] * shards``) when ``shards`` is
    given, else the single engine.  ``recalibrate`` is a dict of
    ``RecalibrationPolicy`` keywords (re-profiling from the world's
    visits); ``transport`` a zero-arg factory; ``on_tick(eng, step)`` runs
    before each tick.  Returns (engine, trace, summary)."""
    vis, gal, feats = w["vis"], w["gal"], w["feats"]
    q_vids = w["q_vids"]
    if callable(transport):
        transport = transport()
    vis_tiles = tile_index(vis.tile_xy, tile_grid) if tile_grid else None
    recal = None if recalibrate is None \
        else api.RecalibrationPolicy(**recalibrate)
    eng = api.serve(_port_model(w) if model is None else model,
                    embed_fn=embed_fn if embed_fn is not None
                    else (lambda x: x),
                    policy=SearchPolicy(**policy),
                    geo_adj=w["net"].geo_adjacent,
                    devices=None if shards is None else ["cpu"] * shards,
                    gallery=gallery, topk=topk, recalibrate=recal,
                    transport=transport, prefetch=prefetch,
                    consolidate=consolidate, tile_grid=tile_grid,
                    visit_source=api.visits_window_source(vis)
                    if recal is not None else None, device="cpu")
    t0 = int(vis.t_out[q_vids].min())
    eng.t = t0
    first = len(q_vids) if churn_wave is None else max(1, len(q_vids) // 2)
    for i in range(first):
        q = q_vids[i]
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    trace = []
    for step, t in enumerate(range(t0, vis.horizon + extra_ticks)):
        if churn_wave is not None and step == churn_wave:
            for j in range(first, len(q_vids)):
                q = q_vids[j]
                eng.submit_query(j, feats[q], int(vis.cam[q]),
                                 int(vis.t_out[q]))
        if lose_at is not None and step == lose_at and shards is not None:
            eng.lose_worker(lose_worker)
        if t < vis.horizon:
            frames, tiles = {}, {}
            for c in range(vis.n_cams):
                vids = gal[c, t][gal[c, t] >= 0]
                if len(vids):
                    frames[c] = feats[vids]
                    if vis_tiles is not None:
                        tiles[c] = vis_tiles[vids]
            eng.ingest(frames, tiles if tile_grid else None)
        if on_tick is not None:
            on_tick(eng, step)
        eng.tick(record_trace=trace)
        if all(q.done for q in eng.queries.values()) and \
                (churn_wave is None or step >= churn_wave):
            break
    summary = dict(
        admitted_steps=eng.admitted_steps, unique_frames=eng.unique_frames,
        content_steps=eng.content_steps, replay_steps=eng.replay_steps,
        rescue_pairs=eng.rescue_pairs.copy(), model_epoch=eng.model_epoch,
        model_swaps=list(eng.model_swaps),
        per_query=[(q.matches, q.rescued, q.done, q.phase, q.f_curr)
                   for q in eng.queries.values()],
        admitted_tiles=eng.admitted_tiles, unique_tiles=eng.unique_tiles,
        frames_processed=eng.frames_processed, cache_hits=eng.cache_hits)
    return eng, trace, summary


def assert_fleet_matches(eng, trace, summary, ref):
    """``conftest.assert_fleet_trace_identical``'s assertions for the
    port's fleet against the reference's single engine ``ref`` = (trace,
    summary): every trace record (scores within 1e-5), both cost
    conventions, rescue attribution, epochs and swap ticks, per-query
    outcomes, and the per-worker rows tiling the totals."""
    ref_trace, ref_sum = ref
    assert_traces_match(trace, ref_trace)
    for f in ("admitted_steps", "unique_frames", "content_steps",
              "replay_steps", "model_epoch", "model_swaps", "per_query"):
        assert summary[f] == ref_sum[f], f
    np.testing.assert_array_equal(summary["rescue_pairs"],
                                  ref_sum["rescue_pairs"])
    if hasattr(eng, "shard_report"):
        rep = eng.shard_report()
        assert sum(r["admitted_steps"] for r in rep) == eng.admitted_steps
        assert sum(r["unique_frames"] for r in rep) >= eng.unique_frames
        assert sum(r["query_rounds"] for r in rep) == \
            eng.content_steps - eng.skipped_steps
        if isinstance(eng.gallery, ShardedGalleryStore):
            assert sum(r["owned_frames"] for r in rep) == eng.unique_frames
