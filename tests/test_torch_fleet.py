"""The port's serving fleet against the reference's single engine: shard
counts, placement balance, the consolidated and per-frame paths, the
gallery modes and plan conservation.

Each test mirrors one ``conftest.fleet_case_*`` with the port's fleet
(``devices=["cpu"] * shards``) in place of the reference's
``shard_map`` fleet, which needs 8 JAX devices; the reference side is its
single engine (``drive_serving_trace``), to which its own fleet is
trace-identical.  Scores within 1e-5, everything else exact."""
import collections

import numpy as np
import pytest

from repro_torch.runtime.engine import ServingEngine
from torch_fleet_cases import (assert_fleet_matches, drive_port, reference,
                               world)

SHARDS = (1, 2, 4, 8)


@pytest.mark.parametrize("shards", SHARDS)
def test_fleet_matches_single_engine_across_shard_counts(shards):
    """``fleet_case_shard_counts``: 5 queries, divisible by no shard count
    past 1; submit-time placement leaves at most one query of imbalance
    between live workers."""
    w = world(seed=0, n_queries=5)
    eng, trace, summary = drive_port(w, shards=shards)
    assert_fleet_matches(eng, trace, summary,
                         reference(seed=0, n_queries=5))
    counts = collections.Counter(eng._placement.values())
    loads = [counts.get(r["worker"], 0)
             for r in eng.shard_report() if r["alive"]]
    assert max(loads) - min(loads) <= 1, loads
    assert eng.n_shards == shards and eng.gallery.kind == "sharded"


def test_fleet_matches_single_engine_divisible_queries():
    """``fleet_case_shard_counts``'s second world: 4 queries on 4 workers,
    one each."""
    w = world(seed=10, n_queries=4)
    eng, trace, summary = drive_port(w, shards=4)
    assert_fleet_matches(eng, trace, summary,
                         reference(seed=10, n_queries=4))
    assert sorted(collections.Counter(eng._placement.values()).values()) \
        == [1, 1, 1, 1]


@pytest.mark.parametrize("shards", SHARDS)
def test_fleet_consolidated_matches_per_frame_reference(shards):
    """``fleet_case_consolidation``: the consolidated fleet against the
    reference's unconsolidated (per-frame) single engine."""
    w = world(seed=3, n_queries=5)
    eng, trace, summary = drive_port(w, shards=shards, consolidate=True)
    assert_fleet_matches(eng, trace, summary,
                         reference(seed=3, n_queries=5, consolidate=False))


@pytest.mark.parametrize("shards", (2, 8))
def test_fleet_per_frame_path_matches_reference(shards):
    """The fleet with ``consolidate=False`` (the per-frame kernel call, one
    a worker) against the reference's per-frame single engine."""
    w = world(seed=3, n_queries=5)
    eng, trace, summary = drive_port(w, shards=shards, consolidate=False)
    assert_fleet_matches(eng, trace, summary,
                         reference(seed=3, n_queries=5, consolidate=False))


def _embeds_by_key(monkeypatch, **kw):
    """Drive the port and count the blocks cached per (cam, frame) key:
    one ``put_emb`` per embedded key, so a count past 1 is a re-embed."""
    from repro_torch.runtime.stream_store import FrameStore

    counts = collections.Counter()
    orig = FrameStore.put_emb

    def put_emb(self, cam, t, emb):
        counts[(cam, t)] += 1
        return orig(self, cam, t, emb)

    monkeypatch.setattr(FrameStore, "put_emb", put_emb)
    out = drive_port(world(seed=0, n_queries=5), **kw)
    monkeypatch.setattr(FrameStore, "put_emb", orig)
    return out, counts


@pytest.mark.parametrize("mode", ["sharded", "local"])
def test_fleet_gallery_modes_embed_once(mode, monkeypatch):
    """``fleet_case_gallery_modes``: with the shared sharded gallery and
    with the replicated local baseline, the fleet matches the single
    engine, embeds no (cam, frame) pair twice and embeds exactly the
    single engine's keys (the reference's embed and cache-hit counts);
    owner attribution tiles the dedup set and the resident blocks the
    cache."""
    (_, _, _), single = _embeds_by_key(monkeypatch)
    (eng, trace, summary), fleet = _embeds_by_key(monkeypatch, shards=4,
                                                  gallery=mode)
    ref = reference(seed=0, n_queries=5)
    assert_fleet_matches(eng, trace, summary, ref)
    assert eng.gallery.kind == mode
    assert single and max(single.values()) == 1
    assert fleet == single
    assert summary["frames_processed"] == ref[1]["frames_processed"] == \
        sum(fleet.values())
    assert summary["cache_hits"] == ref[1]["cache_hits"]
    rep = eng.shard_report()
    if mode == "sharded":
        per_w = eng.gallery.per_worker_report()
        assert sum(v["blocks"] for v in per_w.values()) == \
            eng.store.cached_embeddings()
        assert sum(v["cameras"] for v in per_w.values()) == eng.C
    else:
        assert all(r["owned_frames"] == 0 for r in rep)


@pytest.mark.parametrize("consolidate", [True, False])
def test_fleet_round_plan_conserves_admission_mass(consolidate,
                                                   monkeypatch):
    """``fleet_case_plan_conservation``: every round's plan keeps its
    admission mass (``want_count`` sums to ``plan.admitted``, the mask's
    popcount over the batch rows and the per-query camera lists; ``work``
    is the sorted key set), and the plans sum to ``admitted_steps``, for
    the single engine and every shard count."""
    w = world(seed=4, n_queries=5)
    orig = ServingEngine._plan_round
    total = [0]

    def checked(self, qs):
        plan = orig(self, qs)
        per_key = sum(plan.want_count.values())
        assert per_key == plan.admitted == int(plan.mask[plan.slots].sum())
        assert plan.work == sorted(plan.want_count)
        assert plan.admitted == sum(len(c) for c in plan.cams_by_q)
        assert sorted(plan.slots.tolist()) == list(range(len(qs)))
        total[0] += plan.admitted
        return plan

    monkeypatch.setattr(ServingEngine, "_plan_round", checked)
    admitted = set()
    for shards in (None,) + SHARDS:
        total[0] = 0
        eng, _, _ = drive_port(w, shards=shards, consolidate=consolidate)
        assert total[0] == eng.admitted_steps
        admitted.add(eng.admitted_steps)
    assert len(admitted) == 1


def test_fleet_rows_grouped_by_worker_in_worker_order():
    """The fleet's layout: each worker's rows form one block, blocks in
    worker order, each in submit order; the rank bodies ran once per
    worker holding a row (``worker_dispatches``)."""
    w = world(seed=0, n_queries=5)
    seen = []

    def on_tick(eng, step):
        if step == 20:
            qs = [q for q in eng.queries.values() if not q.done]
            n, slots = eng._layout(qs)
            blocks = list(eng._row_blocks)
            seen.append((qs, n, slots, blocks))

    eng, _, _ = drive_port(w, shards=4, on_tick=on_tick)
    qs, n, slots, blocks = seen[0]
    assert n == len(qs) and sorted(slots.tolist()) == list(range(n))
    order = [eng._shard_of[w_] for w_, _, _ in blocks]
    assert order == sorted(order)
    for w_, a, b in blocks:
        rows = [i for i, q in enumerate(qs) if eng._placement[q.qid] == w_]
        assert slots[rows].tolist() == list(range(a, b))
    assert eng.worker_dispatches > 0
    assert np.sum([r["query_rounds"] for r in eng.shard_report()]) > 0
