"""The serving sweeps on the port (``repro_torch.benchmarks.scenarios``)
against ``benchmarks/scenarios.py``, on small worlds swapped into both
packages' scenario modules (``torch_bench_cases``).

The single-engine sweeps (``policy_sweep``, ``serving_sweep``,
``tile_sweep``, ``query_churn_sweep``) must print the reference's rows and
records once clock readings are taken out.  The fleet sweeps
(``serving_shard_sweep``, ``gallery_sweep``, ``transport_sweep``) hold
their totals to the reference's single engine (the reference's fleets
need 8 host devices; ``scripts/torch_bench_counts.py`` compares them at
full size) and their ``shard_report`` rows to those totals.  No wall is
asserted here: the wall gates are pure functions (``tile_gate``,
``transport_gates``, ``sublinear_gate``), tested on fixed numbers below,
and the sweeps that call them run under a counting clock or with the gate
recorded."""
import os
import sys

import pytest

import torch_bench_cases as cases

one_thread = pytest.fixture(autouse=True)(cases.one_thread)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class CountingClock:
    """A ``time`` stand-in whose ``perf_counter`` advances one millisecond
    a reading: every wall a sweep measures is a count of readings."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def _both(monkeypatch, name, kw, clock=False):
    from benchmarks import scenarios as j_scen
    from repro_torch.benchmarks import scenarios as t_scen

    cases.small_worlds(monkeypatch)
    if clock:
        monkeypatch.setattr(j_scen, "time", CountingClock())
        monkeypatch.setattr(t_scen, "time", CountingClock())
    out = []
    for mod, extra in ((j_scen, {}), (t_scen, dict(device="cpu"))):
        mod.pop_bench_records(name)
        rows = getattr(mod, name)(**kw, **extra)
        out.append(cases.without_clock(rows, mod.pop_bench_records(name)))
    return out


@pytest.mark.parametrize("name,kw", [
    ("policy_sweep", {}),
    ("serving_sweep", dict(steps=400)),
    ("tile_sweep", dict(steps=400)),
])
def test_single_engine_sweep_equals_the_reference(monkeypatch, name, kw):
    (j_rows, j_recs), (t_rows, t_recs) = _both(monkeypatch, name, kw)
    assert len(j_rows) >= 4
    assert t_rows == j_rows
    assert t_recs == j_recs


def test_serving_sweep_replay_modes_differ(monkeypatch):
    """The small world's replay modes do replay, and frame skipping cuts
    the admitted steps (the rows above are not vacuous)."""
    from repro_torch.benchmarks import scenarios

    cases.small_worlds(monkeypatch)
    scenarios.pop_bench_records("serving_sweep")
    scenarios.serving_sweep(steps=400, device="cpu")
    recs = {r.get("replay_mode"): r
            for r in scenarios.pop_bench_records("serving_sweep")}
    assert recs["base"]["replay_steps"] > 0
    assert recs["skip"]["skipped_steps"] > 0
    assert recs["skip"]["admitted_steps"] < recs["base"]["admitted_steps"]


def test_query_churn_sweep_equals_the_reference(monkeypatch):
    """Consolidated 8-worker fleet against the unconsolidated single engine
    at N = 8 and 32: the port's rows and records are the reference's (whose
    fleet runs on the one visible JAX device: its records say shards=1),
    and its unconsolidated runs rank through ``reid_topk_masked``."""
    from repro_torch.kernels import ops

    calls = {"masked": 0, "segments": 0}
    for entry, key in (("reid_topk_masked", "masked"),
                       ("reid_topk_segments", "segments")):
        real = getattr(ops, entry)

        def counted(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(ops, entry, counted)
    kw = dict(n_levels=(8, 32), pool_size=8)
    (j_rows, j_recs), (t_rows, t_recs) = _both(monkeypatch,
                                               "query_churn_sweep", kw,
                                               clock=True)
    j_rows = [r for r in j_rows if "degraded" not in r[1]]
    assert t_rows == j_rows
    assert [r.get("shards") for r in t_recs] == [8, 0, 8, 0, None]
    assert [{k: v for k, v in r.items() if k != "shards"} for r in t_recs] \
        == [{k: v for k, v in r.items() if k != "shards"} for r in j_recs]
    assert calls["masked"] > 0 and calls["segments"] > 0


def _reference_single(steps, n_queries=16):
    from benchmarks import scenarios as j_scen
    from repro import api as japi

    sc = j_scen.duke(60)
    eng, _, _, _ = j_scen._drive_serving(
        sc, japi.SearchPolicy(scheme="rexcam", s_thresh=.05, t_thresh=.02),
        min(n_queries, len(sc["q_vids"])), steps)
    return eng


def _fields(derived):
    return dict(kv.split("=", 1) for kv in derived.split() if "=" in kv)


def test_serving_shard_sweep_totals_equal_the_reference(monkeypatch):
    from repro_torch.benchmarks import scenarios

    cases.small_worlds(monkeypatch)
    ref = _reference_single(300)
    rows = scenarios.serving_shard_sweep(device="cpu")
    assert [r[0] for r in rows] == [
        f"serving_shard_sweep/duke/shards{s}" for s in (1, 2, 4, 8)]
    for name, _, derived in rows:
        f = _fields(derived)
        S = int(name.rsplit("shards", 1)[1])
        assert int(f["admitted_steps"]) == ref.admitted_steps > 0
        assert int(f["unique_frames"]) == ref.unique_frames
        per_adm = [int(x) for x in f["per_shard_admitted"].split("/")]
        per_uni = [int(x) for x in f["per_shard_unique"].split("/")]
        assert len(per_adm) == len(per_uni) == S
        assert sum(per_adm) == ref.admitted_steps


def test_gallery_sweep_totals_equal_the_reference(monkeypatch):
    from repro_torch.benchmarks import scenarios

    cases.small_worlds(monkeypatch)
    ref = _reference_single(300)
    scenarios.pop_bench_records("gallery_sweep")
    rows = scenarios.gallery_sweep(device="cpu")
    recs = scenarios.pop_bench_records("gallery_sweep")
    assert [r["gallery"] for r in recs] == ["local", "sharded"]
    for (_, _, derived), rec in zip(rows, recs):
        f = _fields(derived)
        assert rec["admitted_steps"] == ref.admitted_steps
        assert rec["unique_frames"] == ref.unique_frames
        assert rec["embed_calls"] == int(f["embed_calls"]) \
            == ref.frames_processed
        # the replicated demand is each worker's shard-local unique frames
        assert int(f["replicated_demand"]) >= ref.unique_frames
        per_w = [int(x) for x in f["per_worker_bytes"].split("/")]
        assert len(per_w) == rec["shards"] == 4
        assert max(per_w) == rec["peak_worker_bytes"]


def test_transport_sweep_totals_equal_the_reference(monkeypatch):
    """Every configuration serves the reference single engine's admitted
    steps; the blocking runs fetch remotely, the prefetched one serves its
    fetches by prefetch.  The gate is recorded, not asserted (walls)."""
    from repro_torch.benchmarks import scenarios

    cases.small_worlds(monkeypatch)
    gate = []
    monkeypatch.setattr(scenarios, "transport_gates",
                        lambda *a: gate.append(a))
    ref = _reference_single(600)
    scenarios.pop_bench_records("transport_sweep")
    scenarios.transport_sweep(rtt_scales=(1, 2), device="cpu")
    recs = {r["config"]: r
            for r in scenarios.pop_bench_records("transport_sweep")}
    assert list(recs) == ["baseline", "prefetch_rtt0", "blocking_rtt1x",
                          "blocking_rtt2x", "prefetch_rtt1x"]
    for r in recs.values():
        assert r["admitted_steps"] == ref.admitted_steps > 0
        assert r["unique_frames"] == ref.unique_frames
    assert recs["blocking_rtt1x"]["remote_fetches"] > 0
    assert recs["blocking_rtt1x"]["prefetch_hits"] == 0
    assert recs["prefetch_rtt1x"]["prefetch_hits"] > 0
    (walls_b, rtt, fetches, _, _, _, hits_p, hits), = gate
    assert sorted(walls_b) == [1, 2] and rtt >= 0.002
    assert fetches == recs["prefetch_rtt1x"]["remote_fetches"]
    assert hits_p == recs["prefetch_rtt1x"]["prefetch_hits"]
    assert hits == recs["baseline"]["cache_hits"]


def test_transport_sweep_gates_the_median_of_rotated_drives(monkeypatch):
    """The baseline, the zero-latency control and the prefetched run are
    each driven three times, in rotation (each once first, second and
    third, the first baseline first), before the blocking runs; the gate
    and the records get each one's median drive."""
    from repro_torch.benchmarks import scenarios
    from repro_torch.runtime.transport import InProcTransport

    cases.small_worlds(monkeypatch)
    calls = []
    drive = scenarios._drive_serving

    def spy(*args, **kw):
        out = drive(*args, **kw)
        tr = kw.get("transport")
        kind = "baseline" if tr is None else \
            "prefetch_rtt0" if isinstance(tr, InProcTransport) else \
            "prefetch_rtt1x" if kw.get("prefetch") else "blocking"
        calls.append((kind, out[2]))
        return out
    monkeypatch.setattr(scenarios, "_drive_serving", spy)
    gate = []
    monkeypatch.setattr(scenarios, "transport_gates",
                        lambda *a: gate.append(a))
    scenarios.pop_bench_records("transport_sweep")
    scenarios.transport_sweep(rtt_scales=(1, 2), device="cpu")
    recs = {r["config"]: r
            for r in scenarios.pop_bench_records("transport_sweep")}
    kinds = [k for k, _ in calls[1:]]        # after the warm-up drive
    assert kinds == ["baseline", "prefetch_rtt0", "prefetch_rtt1x",
                     "prefetch_rtt1x", "baseline", "prefetch_rtt0",
                     "prefetch_rtt0", "prefetch_rtt1x", "baseline",
                     "blocking", "blocking"]
    median = {k: sorted(w for kk, w in calls[1:] if kk == k)[1]
              for k in ("baseline", "prefetch_rtt0", "prefetch_rtt1x")}
    (_, _, _, wall_p, wall_p0, wall0, _, _), = gate
    assert (wall_p, wall_p0, wall0) == (median["prefetch_rtt1x"],
                                        median["prefetch_rtt0"],
                                        median["baseline"])
    for k, w in median.items():
        assert recs[k]["wall_s"] == round(w, 4)


# -- the gates on fixed numbers -----------------------------------------------

def test_tile_gate_passes_and_fails():
    from repro_torch.benchmarks.scenarios import tile_gate

    tile_gate(2.0, 0.5, 0.5, 100, 200)
    tile_gate(3.7, 0.6, 0.5, 54, 200)
    with pytest.raises(AssertionError, match="need >= 2x"):
        tile_gate(1.99, 0.6, 0.5, 101, 200)
    with pytest.raises(AssertionError, match="dropped below"):
        tile_gate(4.0, 0.49, 0.5, 50, 200)


TRANSPORT_PASS = dict(walls_blocking={1: 1.0, 4: 1.5, 8: 2.0}, rtt=0.002,
                      remote_fetches=100, wall_prefetch=1.2,
                      wall_prefetch_rtt0=1.0, wall_baseline=0.9,
                      prefetch_hits=90, cache_hits=100)


@pytest.mark.parametrize("change,match", [
    ({}, None),
    # blocking must carry >= 0.6 x 100 fetches x 14 ms = 0.84 s more at 8x
    (dict(walls_blocking={1: 1.0, 4: 1.4, 8: 1.83}), "degrade linearly"),
    (dict(walls_blocking={1: 1.0, 8: 1.85}), None),
    # prefetch within 1.25 x max(rtt0 control, baseline)
    (dict(wall_prefetch=1.26), "exceeds 1.25x"),
    (dict(wall_prefetch=1.5, wall_baseline=1.2), None),
    # speculation: hits >= 0.8 x cache hits
    (dict(prefetch_hits=79), "mispredicted"),
    (dict(prefetch_hits=0, cache_hits=0), "mispredicted"),
    (dict(prefetch_hits=1, cache_hits=0), None),
])
def test_transport_gates_pass_and_fail(change, match):
    from repro_torch.benchmarks.scenarios import transport_gates

    kw = dict(TRANSPORT_PASS, **change)
    if match is None:
        transport_gates(**kw)
    else:
        with pytest.raises(AssertionError, match=match):
            transport_gates(**kw)


def test_sublinear_gate_passes_and_fails():
    from repro_torch.benchmarks.scenarios import sublinear_gate

    levels = (8, 64, 256)
    er, wr, bound = sublinear_gate({64: 100, 256: 200},
                                   {64: 1.0, 256: 3.0}, levels)
    assert (er, wr, bound) == (2.0, 3.0, 4.0)
    with pytest.raises(AssertionError, match="embed calls grew"):
        sublinear_gate({64: 100, 256: 400}, {64: 1.0, 256: 1.0}, levels)
    with pytest.raises(AssertionError, match="steady wall grew"):
        sublinear_gate({64: 100, 256: 100}, {64: 1.0, 256: 4.0}, levels)


def test_strip_clock_takes_out_only_clock_readings():
    from repro_torch.benchmarks.scenarios import (strip_clock_records,
                                                  strip_clock_row)

    row = ("transport_sweep/duke/blocking_rtt4x", 123.4,
           "wall=1.20s rtt=8.0ms extra=+0.40s stall_floor=0.33s "
           "remote_fetches=41 p99_tick=9.1ms")
    assert strip_clock_row(row) == ("transport_sweep/duke/blocking_rtt4x",
                                    "remote_fetches=41")
    row = ("tile_sweep/duke/all_admitted", 1.0,
           "differential=ok admitted_tiles=64 (=TT*admitted_steps) "
           "matches=3 wall=0.52s vs camera 0.50s")
    assert strip_clock_row(row)[1] == \
        "differential=ok admitted_tiles=64 (=TT*admitted_steps) matches=3"
    row = ("query_churn_sweep/duke/sublinearity", 0.0,
           "sublinear=ok embed_n256/n64=1.10x steady_wall_n256/n64=2.01x "
           "bound=4.0x")
    assert strip_clock_row(row)[1] == \
        "sublinear=ok embed_n256/n64=1.10x bound=4.0x"
    assert strip_clock_records([dict(scenario="duke", wall_s=1.0,
                                     steady_wall_s=0.5, p50_tick_ms=1.0,
                                     p99_tick_ms=2.0, rtt_ms=3.0,
                                     admitted_steps=7)]) == [
        dict(scenario="duke", admitted_steps=7)]


def test_host_masked_scores_do_not_depend_on_the_rows_in_the_call():
    """The plain masked score on the host is one depth-ordered sum a pair:
    a query row scores the same bits alone, in any block of rows, or in
    the whole round (the churn sweep's exact trace key rests on it), and
    within 1e-5 of the matrix product."""
    import numpy as np
    import torch

    from repro_torch.kernels.ref import masked_scores

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(37, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(150, 64)).astype(np.float32))
    full = masked_scores(q, g)
    assert full.dtype == torch.float32 and full.shape == (37, 150)
    for step in (1, 3, 8, 16):
        parts = torch.cat([masked_scores(q[a:a + step], g)
                           for a in range(0, 37, step)])
        assert torch.equal(parts, full)
    cols = torch.cat([masked_scores(q, g[a:a + 64])
                      for a in range(0, 150, 64)], dim=1)
    assert torch.equal(cols, full)
    torch.testing.assert_close(full, q @ g.T, rtol=1e-5, atol=1e-5)
    assert masked_scores(q[:0], g).shape == (0, 150)
    assert masked_scores(q, g[:0]).shape == (37, 0)
