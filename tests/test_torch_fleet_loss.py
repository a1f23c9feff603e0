"""The port's fleet through worker loss, the tile plane, gallery rehome,
O(1) load accounting and heartbeat-driven scale-down, against the
reference's single engine (``conftest.fleet_case_worker_loss``,
``_consolidation``'s loss leg, ``_tiles``, ``_gallery_rehome``,
``_load_accounting`` and ``test_sharded_engine``'s heartbeat case).
Scores within 1e-5, everything else exact."""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.policy import SearchPolicy
from repro_torch.runtime.cluster import HeartbeatMonitor
from repro_torch.runtime.fleet import ShardedServingEngine
from repro_torch.runtime.engine import EngineConfig
from test_torch_engine import _port_model
from torch_fleet_cases import (POLICY, assert_fleet_matches, drive_port,
                               reference, world)


def test_fleet_worker_loss_matches_single_engine():
    """``fleet_case_worker_loss``: losing w1 at step 50 shrinks 4 workers
    to 3 and re-scatters its queries; the trace never parts, the lost
    worker served rounds first, and its cameras moved away."""
    w = world(seed=1, n_queries=7)
    eng, trace, summary = drive_port(w, shards=4, lose_at=50, lose_worker=1)
    assert_fleet_matches(eng, trace, summary, reference(seed=1, n_queries=7))
    assert eng.n_shards == 3 and eng.rebalances == 1
    rep = {r["worker"]: r for r in eng.shard_report()}
    assert not rep["w1"]["alive"] and rep["w1"]["admitted_steps"] > 0
    live = {x for x, r in rep.items() if r["alive"]}
    assert set(eng._placement.values()) <= live
    assert eng.gallery.kind == "sharded"
    assert "w1" not in set(eng.gallery._owner.values())


def test_fleet_consolidated_worker_loss_matches_per_frame_reference():
    """``fleet_case_consolidation``'s loss leg: 4 workers, w1 lost at step
    50, against the per-frame reference."""
    w = world(seed=4, n_queries=7)
    eng, trace, summary = drive_port(w, shards=4, lose_at=50, lose_worker=1)
    assert_fleet_matches(eng, trace, summary,
                         reference(seed=4, n_queries=7, consolidate=False))
    assert eng.rebalances == 1


@pytest.mark.parametrize("shards", (None, 1, 2, 4, 8))
def test_tile_fleet_all_admitted_matches_camera_path(shards):
    """``fleet_case_tiles``: ``tile_grid=4`` over a tile-less model (every
    tile admitted) equals the reference's camera path for the single
    engine and every shard count, and the tile counters tile T*T."""
    T = 4
    w = world(seed=3, n_queries=5)
    eng, trace, summary = drive_port(w, shards=shards, tile_grid=T)
    assert_fleet_matches(eng, trace, summary, reference(seed=3, n_queries=5))
    assert eng.admitted_tiles == T * T * eng.admitted_steps
    assert eng.unique_tiles == T * T * eng.unique_frames


def test_tile_fleet_worker_loss_matches_camera_path():
    """``fleet_case_tiles``' loss leg: the tile fleet on 4 workers loses w1
    at step 50 and still equals the camera path."""
    T = 4
    w = world(seed=4, n_queries=7)
    eng, trace, summary = drive_port(w, shards=4, lose_at=50, lose_worker=1,
                                     tile_grid=T)
    assert_fleet_matches(eng, trace, summary, reference(seed=4, n_queries=7))
    assert eng.rebalances == 1
    assert eng.admitted_tiles == T * T * eng.admitted_steps


def test_fleet_gallery_rehome_moves_only_the_lost_shard():
    """``fleet_case_gallery_rehome``: losing w1 after a 60-tick warmup
    moves exactly its cameras' blocks to survivors chosen by the camera
    hash, onto their devices, bit for bit; survivors keep their cameras."""
    w = world(seed=1, n_queries=6)
    state = {}

    def on_tick(eng, step):
        if step != 60:
            return
        store = eng.gallery
        state["pre_owner"] = dict(store._owner)
        state["keys"] = [k for k in store._blocks
                         if store.owner_of(k[0]) == "w1"]
        state["vals"] = {k: store._fetch(*k).copy() for k in state["keys"]}
        state["before"] = store.rehomed_blocks
        eng.lose_worker(1)
        state["after"] = store.rehomed_blocks

    eng, _, _ = drive_port(w, shards=4, on_tick=on_tick)
    store = eng.gallery
    assert state["keys"], "warmup cached no block owned by w1"
    assert state["after"] - state["before"] == len(state["keys"])
    for cam, owner in state["pre_owner"].items():
        if owner != "w1":
            assert store._owner[cam] == owner
    assert "w1" not in set(store._owner.values())
    for k in state["keys"]:
        if k not in store._blocks:        # evicted later in the run
            continue
        arr, _ = store._blocks[k]
        assert arr.device == eng._device_of[store.owner_of(k[0])]
        np.testing.assert_array_equal(store._fetch(*k), state["vals"][k])


def test_fleet_load_counters_equal_the_placement_scan():
    """``fleet_case_load_accounting``: the O(1) per-worker live counts equal
    a scan of the placement map at every tick — through submits, query
    completions on the device round and the skip fast path
    (``replay_skip=2``), and a loss at step 40 — and end at zero."""
    w = world(seed=2, n_queries=7)

    def brute(eng, worker):
        return sum(1 for qid, x in eng._placement.items()
                   if x == worker and qid in eng.queries
                   and not eng.queries[qid].done)

    def on_tick(eng, step):
        if step == 40:
            eng.lose_worker(2)
        assert all(eng._load(x) == brute(eng, x) for x in eng._workers), \
            step

    eng, trace, summary = drive_port(w, dict(POLICY, replay_skip=2),
                                     shards=4, on_tick=on_tick)
    assert all(q.done for q in eng.queries.values())
    assert all(eng._load(x) == 0 == brute(eng, x) for x in eng._workers)
    assert eng.skipped_steps > 0
    assert_fleet_matches(eng, trace, summary,
                         reference("serving",
                                   dict(POLICY, replay_skip=2), seed=2,
                                   n_queries=7))


def test_fleet_heartbeat_drives_scale_down():
    """``test_sharded_engine.py::test_fleet_heartbeat_drives_scale_down``:
    a worker that stops heartbeating is dropped by ``poll_health``, its
    queries re-scatter, and a straggler is quarantined and dropped."""
    w = world(seed=0, n_queries=5)
    now = [0.0]
    mon = HeartbeatMonitor([f"w{i}" for i in range(4)], timeout=5.0,
                           clock=lambda: now[0])
    eng = ShardedServingEngine(_port_model(w), lambda x: x,
                               EngineConfig(policy=SearchPolicy(**POLICY)),
                               devices=["cpu"] * 4, monitor=mon,
                               device="cpu")
    for i, q in enumerate(w["q_vids"]):
        eng.submit_query(i, w["feats"][q], int(w["vis"].cam[q]),
                         int(w["vis"].t_out[q]))
    assert eng.poll_health() == []
    now[0] = 3.0
    for x in ("w0", "w1", "w3"):
        mon.heartbeat(x, tick_latency=0.01)
    now[0] = 6.0
    assert eng.poll_health() == ["w2"]
    assert eng.n_shards == 3 and "w2" not in eng._placement.values()
    mon.heartbeat("w0", tick_latency=1.0)
    mon.heartbeat("w1", tick_latency=0.01)
    mon.heartbeat("w3", tick_latency=0.01)
    assert eng.poll_health() == ["w0"]
    assert mon.workers["w0"].quarantined and eng.n_shards == 2
    assert eng.rebalances == 2
    assert sum(eng._load(x) for x in eng._workers) == len(w["q_vids"])
    with pytest.raises(ValueError, match="does not track"):
        ShardedServingEngine(_port_model(w), lambda x: x, EngineConfig(),
                             devices=["cpu"] * 5, monitor=mon, device="cpu")


def test_fleet_swap_and_loss_keep_one_model_per_device():
    """The replicated control plane: one (M, windows, geo) replica per
    distinct live worker device, the engine's own where the device is the
    engine's; a swap and a loss refresh it."""
    w = world(seed=0, n_queries=5)
    eng = api.serve(_port_model(w), lambda x: x, SearchPolicy(**POLICY),
                    shards=3, device="cpu")
    assert list(eng._replicas) == [torch.device("cpu")]
    rep = eng._replicas[torch.device("cpu")]
    assert rep.model is eng.model and rep.windows is eng._windows
    eng.swap_model(_port_model(w))
    assert eng._replicas[torch.device("cpu")].model is eng.model
    assert eng.model.epoch == 1
    eng.lose_worker("w0")
    assert eng._workers == ["w1", "w2"] and eng.mesh == [
        [torch.device("cpu")], [torch.device("cpu")]]
    with pytest.raises(KeyError):
        eng.lose_worker("w0")
    eng.lose_worker(1)
    with pytest.raises(RuntimeError, match="last worker"):
        eng.lose_worker(2)
    with pytest.raises(ValueError, match="infeasible"):
        api.serve(_port_model(w), lambda x: x, devices=["cpu"], shards=2,
                  device="cpu")
