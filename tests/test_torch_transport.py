"""The fleet plane's units against the reference's, and the fleet's
per-worker rows against the reference fleet's.

Each unit test runs one scripted call sequence through the reference's
module (``repro.runtime.cluster`` / ``transport`` / ``gallery`` /
``stream_store``) and through the port's, and the two logs — returned
values, counters, schedules, owners, clocks and raised errors — must be
equal.  The last test runs the reference fleet on 8 host devices in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_sharded_engine.py`` does) and holds its ``shard_report()``,
``gallery.per_worker_report()`` and transport counters to the port
fleet's, row for row."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.runtime.cluster as j_cluster
import repro.runtime.gallery as j_gallery
import repro.runtime.stream_store as j_store
import repro.runtime.transport as j_transport
import repro_torch.runtime.cluster as t_cluster
import repro_torch.runtime.gallery as t_gallery
import repro_torch.runtime.stream_store as t_store
import repro_torch.runtime.transport as t_transport
from torch_fleet_cases import drive_port, fake_rpc, world

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(TESTS, "..", "src"))


def _jax_device():
    import jax
    return jax.devices()[0]


SIDES = {
    "jax": dict(cluster=j_cluster, transport=j_transport, gallery=j_gallery,
                store=j_store, device=_jax_device),
    "port": dict(cluster=t_cluster, transport=t_transport,
                 gallery=t_gallery, store=t_store, device=lambda: "cpu"),
}


def _plain(x):
    """A log entry made comparable: arrays to lists, errors to text."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    if hasattr(x, "peer") and hasattr(x, "issued_at"):     # a FetchHandle
        return ("handle", x.peer, _plain(x.key), x.issued_at,
                _plain(x.payload))
    if hasattr(x, "cam") and hasattr(x, "t"):              # a local handle
        return ("local", x.cam, x.t)
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def both(script):
    logs = {}
    for side, mods in SIDES.items():
        log = []
        script(log, **mods)
        logs[side] = _plain(log)
    assert logs["port"] == logs["jax"]
    return logs["port"]


def _call(log, fn, *a, **kw):
    try:
        out = fn(*a, **kw)
    except Exception as e:          # the error is part of the log
        log.append(("raised", type(e).__name__, str(e)))
        return None
    log.append(("ok", out))
    return out


def test_heartbeat_monitor_scripted_as_reference():
    def script(log, cluster, **_):
        now = [0.0]
        mon = cluster.HeartbeatMonitor(["a", "b", "c", "d"], timeout=5.0,
                                       straggler_factor=3.0,
                                       clock=lambda: now[0])
        steps = [(1.0, "a", 0.0), (1.0, "b", 0.01), (2.0, "c", 0.012),
                 (3.0, "a", 0.2), (4.0, "b", None), (6.5, "c", 0.011),
                 (7.0, "a", 0.5), (9.0, "b", 0.02)]
        for t, w, lat in steps:
            now[0] = t
            mon.heartbeat(w, lat)
            log.append((t, mon.dead(), mon.stragglers(), mon.active(),
                        {k: (s.last_seen, s.latency_ewma, s.quarantined)
                         for k, s in mon.workers.items()}))
            for s in mon.stragglers():
                mon.quarantine(s)
        _call(log, mon.heartbeat, "zz")
    assert both(script)


def test_elastic_mesh_grid_and_rebalance_as_reference():
    def script(log, cluster, **_):
        for mp in (1, 2, 3):
            m = cluster.ElasticMesh(model_parallel=mp)
            for n in range(0, 9):
                _call(log, m.grid_for, n)
            for n_sh in (1, 2, 3, 5):
                log.append(m.rebalance_streams(list(range(11)), n_sh))
    both(script)
    grid = t_cluster.ElasticMesh(2).make_mesh(["cpu"] * 5)
    assert grid == [["cpu", "cpu"], ["cpu", "cpu"]]


FAULT_CASES = [
    dict(default=dict(latency=.01, jitter=.005)),
    dict(default=dict(latency=.01, drop=.3), timeout=.05, max_retries=6),
    dict(default=dict(latency=.01, jitter=.01, reorder=.5,
                      reorder_delay=.2), timeout=1.0),
    dict(default=dict(latency=2.0), timeout=1.0, max_retries=2),
    dict(faults={"w1": dict(drop=1.0)}, timeout=.05, max_retries=2,
         backoff=.01, seed=7),
]


@pytest.mark.parametrize("case", range(len(FAULT_CASES)))
def test_fake_rpc_schedules_as_reference(case):
    """Blocking and async fetches over three peers and twelve keys: the
    payload, the virtual clock after each wait, the counters per peer and
    in all, the dead-peer signal and the errors."""
    kw = FAULT_CASES[case]

    def script(log, transport, **_):
        clock, sleep = transport.manual_clock()
        dead = []
        k2 = dict(kw)
        faults = {p: transport.FaultProfile(**f)
                  for p, f in k2.pop("faults", {}).items()}
        if "default" in k2:
            k2["default"] = transport.FaultProfile(**k2["default"])
        tr = transport.FakeRpcTransport(faults, clock=clock, sleep=sleep,
                                        on_dead=dead.append, **k2)
        handles = []
        for i in range(12):
            peer = f"w{i % 3}"
            key = (i % 5, 100 + i)
            if i % 2:
                h = _call(log, tr.fetch_async, peer, key,
                          lambda i=i: np.full(3, i, np.float32))
                if h is not None:
                    handles.append(h)
            else:
                _call(log, tr.fetch, peer, key,
                      lambda i=i: np.full(3, i, np.float32))
            log.append(clock())
        for h in reversed(handles):
            _call(log, tr.wait, h)
            log.append(clock())
        log.append((tr.counters(), tr.peer_counters(), dead,
                    [tr.is_dead(f"w{j}") for j in range(3)]))
        log.append([transport._stable_hash(x)
                    for x in ("w0", (1, 2), 3, "peer")])
    both(script)


def test_inproc_transport_and_mark_dead_as_reference():
    def script(log, transport, **_):
        tr = transport.InProcTransport()
        box = [np.arange(3)]
        h = tr.fetch_async("w0", (0, 1), lambda: box[0])
        box[0] = np.arange(4)            # delivery is lazy: sees the change
        log.append(tr.wait(h))
        h2 = tr.fetch_async("w1", (0, 2), lambda: box[0])
        tr.mark_dead("w1")
        _call(log, tr.wait, h2)
        _call(log, tr.fetch_async, "w1", (0, 3), lambda: box[0])
        log.append((tr.counters(), tr.peer_counters()))
        _call(log, transport.FakeRpcTransport, timeout=0)
    both(script)


def test_sanitizer_refuses_fetches_from_the_dead_peer_callback(monkeypatch):
    """Under ``REPRO_SANITIZE=1`` a fetch issued from inside ``on_dead``
    raises; without it the callback may fetch."""
    def run():
        clock, sleep = t_transport.manual_clock()
        tr = t_transport.FakeRpcTransport(
            {"w0": t_transport.FaultProfile(drop=1.0)}, clock=clock,
            sleep=sleep, timeout=.05, max_retries=0)
        tr.on_dead = lambda p: tr.fetch("w1", (0, 0), lambda: 1)
        return tr.fetch("w0", (0, 0), lambda: 0)

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(AssertionError, match="on_dead"):
        run()
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    with pytest.raises(t_transport.PeerDeadError):
        run()


def _store_script(transport_case):
    def script(log, transport, gallery, device, **_):
        dev = device()
        workers = ["w0", "w1", "w2", "w3"]
        tr = None
        holder = {}
        if transport_case:
            clock, sleep = transport.manual_clock()

            def on_dead(peer):
                holder["s"].rehome(peer, [w for w in workers if w != peer])

            tr = transport.FakeRpcTransport(
                {"w2": transport.FaultProfile(drop=1.0)},
                default=transport.FaultProfile(latency=.01, jitter=.002),
                clock=clock, sleep=sleep, timeout=.05, max_retries=1,
                backoff=.01, on_dead=on_dead)
        s = holder["s"] = gallery.ShardedGalleryStore(
            10, 4, workers, {w: dev for w in workers}, transport=tr)
        log.append([s.owner_of(c) for c in range(10)])
        log.append([gallery._cam_hash(c) for c in range(10)])
        rng = np.random.default_rng(0)
        for t in range(8):
            for cam in range(0, 10, 3):
                n = 1 + (cam + t) % 5
                log.append(s.put(cam, t, rng.normal(size=(n, 4))
                                 .astype(np.float32)))
        for cam, t in [(0, 7), (3, 2), (6, 6), (9, 1), (9, 7), (1, 1)]:
            _call(log, s.get, cam, t)
        log.append(s.drop(3, 7))
        log.append(s.rehome("w1", ["w0", "w2", "w3"]))
        log.append([s.owner_of(c) for c in range(10)])
        for cam, t in [(0, 7), (3, 6), (6, 7), (9, 7)]:
            _call(log, s.get, cam, t)
        h = _call(log, s.fetch_async, 0, 7)
        if h is not None:
            _call(log, s.wait_fetch, h)
        _call(log, s.fetch_async, 0, 0)
        log.append((s.counters(), s.per_worker_report(), s.cached(6, 7),
                    s.cached(6, 0), s.cached_embeddings(), s.memory_bytes()))
    return script


@pytest.mark.parametrize("transport_case", [False, True],
                         ids=["direct", "fake-rpc-dead-owner"])
def test_sharded_gallery_store_as_reference(transport_case):
    """Owners by camera hash, pow2-padded blocks on the owner, the
    retention horizon, drops, a rehome, and — through a fake RPC whose w2
    drops every attempt — the blocking get that re-homes its camera on the
    dead-peer signal and retries against the new owner."""
    log = both(_store_script(transport_case))
    assert log


def test_prefetch_pipeline_as_reference():
    def script(log, transport, store, **_):
        fs = store.FrameStore(4, 5)
        pipe = transport.PrefetchPipeline(fs)
        blk = np.ones((2, 3), np.float32)
        for t in (0, 1, 2):
            fs.append(1, t, blk * t)
            fs.put_emb(1, t, blk * t)
        log.append(pipe.issue([(1, 0), (1, 1), (1, 2), (1, 9), (1, 1)]))
        log.append(pipe.in_flight)
        log.append(pipe.consume(1, 1))
        log.append(pipe.consume(1, 1))
        fs.append(1, 7, blk)               # (1, 0) and (1, 1) fall behind
        log.append(pipe.consume(1, 0))
        log.append(pipe.issue([(1, 2)]))
        fs.append(1, 9, blk)
        log.append(pipe.sweep())
        log.append((pipe.in_flight, fs.gallery.counters()))
    both(script)


REF_FLEET = """
import json, conftest
from repro.core.policy import SearchPolicy
w = conftest.make_serving_world(seed=1, n_queries=7)
eng, _, _ = conftest.drive_serving_trace(
    w, SearchPolicy(scheme="rexcam", s_thresh=.05, t_thresh=.02, exit_t=60),
    shards=4, lose_at=50, lose_worker=1, prefetch=True,
    transport=conftest._fake_rpc_factory(default=dict(latency=.01,
                                                      jitter=.005)))
print(json.dumps(dict(
    shard_report=eng.shard_report(),
    per_worker=eng.gallery.per_worker_report(),
    counters=eng.gallery.counters(),
    peers=eng.gallery.transport.peer_counters(),
    rebalances=eng.rebalances, n_shards=eng.n_shards)))
"""


def test_fleet_per_worker_rows_equal_the_reference_fleet():
    """The reference fleet on 8 host devices (shards 4, w1 lost at step 50,
    fake RPC with latency and jitter, prefetch) against the port's fleet on
    the same world: every ``shard_report`` row, every per-worker gallery
    row, the gallery and transport counters, equal."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-c", REF_FLEET], capture_output=True,
                       text=True, timeout=600, env=env, cwd=TESTS)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    eng, _, _ = drive_port(
        world(seed=1, n_queries=7), shards=4, lose_at=50, lose_worker=1,
        prefetch=True,
        transport=fake_rpc(default=dict(latency=.01, jitter=.005)))
    port = json.loads(json.dumps(dict(
        shard_report=eng.shard_report(),
        per_worker=eng.gallery.per_worker_report(),
        counters=eng.gallery.counters(),
        peers=eng.gallery.transport.peer_counters(),
        rebalances=eng.rebalances, n_shards=eng.n_shards)))
    for key in ref:
        assert port[key] == ref[key], key
    assert ref["counters"]["remote_fetches"] > 0
    assert ref["counters"]["prefetch_hits"] > 0
    assert ref["rebalances"] == 1 and ref["n_shards"] == 3
