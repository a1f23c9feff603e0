"""The port's fleet behind the transports and prefetch, against the
reference's single engine: the transport shard matrix, the fault matrix,
the timeout-driven rehome and the mid-fetch worker loss
(``conftest.fleet_case_transport_*``).  A transport changes when a block
arrives, never what is ranked.  Scores within 1e-5, everything else
exact; every transport runs on a virtual clock."""
import pytest

from repro_torch.runtime.transport import InProcTransport
from torch_fleet_cases import (assert_fleet_matches, drive_port, fake_rpc,
                               reference, world)


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_fake_rpc_prefetch_fleet_matches_single_engine(shards):
    """``fleet_case_transport_shard_counts``: fake RPC with latency and
    jitter and the prefetch pipeline; every cache hit goes through the
    fetch plane, no peer dies, nothing times out."""
    w = world(seed=0, n_queries=5)
    eng, trace, summary = drive_port(
        w, shards=shards, prefetch=True,
        transport=fake_rpc(default=dict(latency=.01, jitter=.005)))
    assert_fleet_matches(eng, trace, summary, reference(seed=0, n_queries=5))
    c = eng.gallery.counters()
    assert c["remote_fetches"] > 0
    assert c["dead_peers"] == 0 and c["timeouts"] == 0
    assert c["prefetch_hits"] <= eng.cache_hits
    assert sum(r["remote_fetches"] for r in eng.shard_report()) == \
        c["remote_fetches"]


def test_fleet_ranks_blocks_before_waiting_for_prefetches(monkeypatch):
    """A block still in flight is waited for only when the first worker
    block whose queries admit it ranks: in some rounds other workers'
    blocks rank while the fetches are in flight.  The trace stays the
    reference's, and every such wait is served by the prefetch."""
    from repro_torch.runtime.fleet import ShardedServingEngine

    ranked_before_wait = []
    defer = ShardedServingEngine._defer_late

    def spy(self, *args):
        start = self.worker_dispatches
        defer(self, *args)
        resolve = self._resolve_late

        def counted():
            ranked_before_wait.append(self.worker_dispatches - start)
            resolve()
        self._resolve_late = counted
    monkeypatch.setattr(ShardedServingEngine, "_defer_late", spy)
    w = world(seed=0, n_queries=5)
    eng, trace, summary = drive_port(
        w, shards=4, prefetch=True,
        transport=fake_rpc(default=dict(latency=.01)))
    assert_fleet_matches(eng, trace, summary, reference(seed=0, n_queries=5))
    assert ranked_before_wait and max(ranked_before_wait) >= 1
    c = eng.gallery.counters()
    assert c["prefetch_wasted"] == 0
    assert c["prefetch_hits"] >= len(ranked_before_wait)


@pytest.mark.parametrize("prefetch", [True, False])
def test_inproc_fleet_matches_single_engine(prefetch):
    """The named in-process transport, with and without prefetch."""
    w = world(seed=0, n_queries=5)
    eng, trace, summary = drive_port(w, shards=4, prefetch=prefetch,
                                     transport=InProcTransport)
    assert_fleet_matches(eng, trace, summary, reference(seed=0, n_queries=5))
    c = eng.gallery.counters()
    assert c["remote_fetches"] > 0
    assert (c["prefetch_hits"] > 0) == prefetch


FAULTS = {
    "drop+retry": (fake_rpc(default=dict(latency=.01, drop=.3),
                            timeout=.05, max_retries=6), True),
    "reorder": (fake_rpc(default=dict(latency=.01, jitter=.01, reorder=.5,
                                      reorder_delay=.2), timeout=1.0), True),
    "blocking-latency": (fake_rpc(default=dict(latency=.05)), False),
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_fault_matrix_matches_single_engine(name):
    """``fleet_case_transport_faults``: drop and retry, reordered
    responses, and blocking latency without prefetch."""
    factory, prefetch = FAULTS[name]
    w = world(seed=0, n_queries=5)
    eng, trace, summary = drive_port(w, shards=4, transport=factory,
                                     prefetch=prefetch)
    assert_fleet_matches(eng, trace, summary, reference(seed=0, n_queries=5))
    c = eng.gallery.counters()
    assert c["remote_fetches"] > 0 and c["dead_peers"] == 0
    if name == "drop+retry":
        assert c["retries"] > 0 and c["timeouts"] > 0
    rep = eng.shard_report()
    assert sum(r["remote_fetches"] for r in rep) == c["remote_fetches"]
    assert sum(r["retries"] for r in rep) == c["retries"]


def test_timeout_drives_rehome_and_scale_down():
    """``fleet_case_transport_timeout_rehome``: w1 drops every attempt, so
    its first fetch exhausts the retry budget mid-round, the gallery
    re-homes at once (the blocked fetch retries against the new owner) and
    the fleet scales down at the end of the tick."""
    w = world(seed=1, n_queries=6)
    factory = fake_rpc({"w1": dict(drop=1.0)}, timeout=.05, max_retries=2,
                       backoff=.01)
    eng, trace, summary = drive_port(w, shards=4, transport=factory)
    assert_fleet_matches(eng, trace, summary, reference(seed=1, n_queries=6))
    c = eng.gallery.counters()
    assert c["dead_peers"] == 1
    assert c["timeouts"] >= 3 and c["retries"] >= 2
    assert "w1" not in eng._workers and eng.n_shards == 3
    assert "w1" not in set(eng.gallery._owner.values())
    assert eng.rebalances == 1


def test_midfetch_worker_loss_fails_inflight_prefetch_fast():
    """``fleet_case_transport_midfetch_loss``: losing w1 at step 50 with
    prefetch handles in flight marks it dead on the transport; its handles
    fail at consume time and the round reads from the re-homed owner."""
    w = world(seed=1, n_queries=7)
    eng, trace, summary = drive_port(
        w, shards=4, lose_at=50, lose_worker=1, prefetch=True,
        transport=fake_rpc(default=dict(latency=.01, jitter=.005)))
    assert_fleet_matches(eng, trace, summary, reference(seed=1, n_queries=7))
    assert eng.gallery.transport.is_dead("w1")
    c = eng.gallery.counters()
    assert c["prefetch_hits"] > 0
    assert "w1" not in set(eng.gallery._owner.values())


def test_single_engine_prefetch_matches_reference():
    """``prefetch=True`` on the single engine (no transport: the local
    store delivers at once) serves the reference's trace and counts its
    hits through the pipeline."""
    w = world(seed=0, n_queries=5)
    eng, trace, summary = drive_port(w, prefetch=True)
    assert_fleet_matches(eng, trace, summary, reference(seed=0, n_queries=5))
    g = eng.gallery.counters()
    assert g["prefetch_hits"] > 0 and g["hits"] == eng.cache_hits
