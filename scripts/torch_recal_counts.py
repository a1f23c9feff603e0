"""The §6 recalibration benchmarks at full size: the JAX reference against
the PyTorch port, both on the CPU.

Runs ``sec6_drift`` (``benchmarks/drift.py::run`` against
``repro_torch.benchmarks.drift.run``), ``drift_sweep`` (frozen,
recalibrated, and recalibrated on an 8-worker fleet) and ``soak_130``
(exhaustive, row-targeted on an 8-worker fleet that loses a worker at step
120, and full rebuilds) from ``benchmarks/scenarios.py`` against
``repro_torch.benchmarks.scenarios``, at the reference's sizes.  The
reference's fleets run on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set here before
``jax`` is imported); the port's on 8 workers on the CPU:

- sec6_drift: duke, history 2,000 x 4,000, live 2,000 x 4,000, 60 queries;
- drift_sweep: duke re-permuted at t = 400, history 2,000 x 4,000, live
  300 x 400 then 800 x 1,800, 32 queries;
- soak_130: the 130-camera clustered city, history 6,000 x 4,000, live
  150 x 260 then 300 x 640, 12 queries with a late wave at step 60.

Each sweep's rows and records must be equal with their wall-clock fields
taken out.  Then every configuration of the two serving sweeps is driven
once more on each side, the same loop as the sweeps', and the engine's
counters, swap ticks, epochs, per-query matches, the controller's events,
polls and counters and, for the two fleets, the rebalances and every
per-worker row of ``shard_report`` must be equal.  Prints one line per compared
item and the wall seconds of each side; exits non-zero if anything
differs.

    PYTHONPATH=src python scripts/torch_recal_counts.py
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# the reference's fleets need 8 devices; jax reads this at import
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                           "--xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

#: record fields read off a clock, left out of the comparison
WALL_KEYS = ("wall_s", "p50_tick_ms", "p99_tick_ms", "profile_wall_s",
             "profile_ms_targeted", "profile_ms_full")


def strip_row(row):
    """A CSV row without its clock readings (us_per_call, profile_ms)."""
    name, _us, derived = row
    return name, re.sub(r" profile_ms=\S+", "", derived)


def strip_records(recs):
    return [{k: v for k, v in r.items() if k not in WALL_KEYS}
            for r in recs]


def engine_counts(eng):
    ctl = eng.recal
    out = dict(
        admitted_steps=eng.admitted_steps, unique_frames=eng.unique_frames,
        content_steps=eng.content_steps, replay_steps=eng.replay_steps,
        rescue_pairs=eng.rescue_pairs.tolist(), model_epoch=eng.model_epoch,
        model_swaps=list(eng.model_swaps),
        per_query=[(q.matches, q.rescued, q.done, q.phase, q.f_curr)
                   for q in eng.queries.values()])
    if ctl is not None:
        out.update(events=ctl.events, polls=list(ctl.polls),
                   rows_reprofiled=ctl.rows_reprofiled,
                   targeted_swaps=ctl.targeted_swaps,
                   full_rebuilds=ctl.full_rebuilds)
    if hasattr(eng, "shard_report"):
        out.update(rebalances=eng.rebalances, shard_report=eng.shard_report())
    return out


def main() -> int:
    from benchmarks import drift as j_drift
    from benchmarks import scenarios as j_scen
    from repro import api as japi
    from repro_torch.benchmarks import drift as t_drift
    from repro_torch.benchmarks import scenarios as t_scen

    ok = True
    wall = {"jax": 0.0, "port": 0.0}

    def both(label, j_fn, t_fn):
        out = {}
        for side, fn in (("jax", j_fn), ("port", t_fn)):
            t0 = time.perf_counter()
            out[side] = fn()
            wall[side] += time.perf_counter() - t0
            print(f"  {label} {side}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        return out["jax"], out["port"]

    def check(label, j, t):
        nonlocal ok
        same = j == t
        ok &= same
        print(f"{label}: {'equal' if same else 'DIFFERS'}", flush=True)
        if not same:
            print(f"  jax  {j!r}\n  port {t!r}")

    # -- the three sweeps, row by row and record by record -------------
    j, t = both("sec6_drift", j_drift.run,
                lambda: t_drift.run(device="cpu"))
    for name, _, derived in t:
        print(f"  {name}: {derived}")
    check("sec6_drift rows", j, t)

    for name in ("drift_sweep", "soak_130"):
        j_scen.pop_bench_records(name)
        t_scen.pop_bench_records(name)
        j, t = both(name, getattr(j_scen, name),
                    lambda: getattr(t_scen, name)(device="cpu"))
        rows = {"jax": [strip_row(r) for r in j if "skipped" not in r[2]
                        and "degraded" not in r[2]],
                "port": [strip_row(r) for r in t if "skipped" not in r[2]
                         and "degraded" not in r[2]]}
        for r in rows["port"]:
            print(f"  {r[0]}: {r[1]}")
        check(f"{name} rows", rows["jax"], rows["port"])
        check(f"{name} records",
              strip_records(j_scen.pop_bench_records(name)),
              strip_records(t_scen.pop_bench_records(name)))

    # -- every serving configuration's engine and controller -----------
    def jpol(p):
        return japi.SearchPolicy(**dataclasses.asdict(p))

    def jrecal(p):
        return None if p is None else \
            japi.RecalibrationPolicy(**dataclasses.asdict(p))

    # (label, world, policy, recalibration, late wave, shards, loss step)
    runs = [("drift_sweep/frozen", "drift", t_scen.DRIFT_POLICY, None, None,
             None, None),
            ("drift_sweep/recalibrated", "drift", t_scen.DRIFT_POLICY,
             t_scen.DRIFT_RECAL, None, None, None),
            ("drift_sweep/recalibrated_shards8", "drift", t_scen.DRIFT_POLICY,
             t_scen.DRIFT_RECAL, None, 8, None),
            ("soak_130/exhaustive", "soak", t_scen.SOAK_EXHAUSTIVE, None, 60,
             None, None),
            ("soak_130/targeted_fleet", "soak", t_scen.SOAK_POLICY,
             t_scen.SOAK_RECAL_TARGETED, 60, 8, 120),
            ("soak_130/full_single", "soak", t_scen.SOAK_POLICY,
             t_scen.SOAK_RECAL_FULL, 60, None, None)]
    for label, world, pol, recal, wave, shards, lose_at in runs:
        j_sc = j_scen.drifted_duke(32) if world == "drift" \
            else j_scen.soak_city(n_queries=12)
        t_sc = t_scen.drifted_duke(32) if world == "drift" \
            else t_scen.soak_city(n_queries=12)
        j, t = both(label,
                    lambda: j_scen._drive_soak(j_sc, jpol(pol),
                                               shards=shards,
                                               recal=jrecal(recal),
                                               churn_wave=wave,
                                               lose_at=lose_at,
                                               lose_worker=1)[0],
                    lambda: t_scen.drive(t_sc, pol, device="cpu",
                                         recal=recal, churn_wave=wave,
                                         shards=shards, lose_at=lose_at,
                                         lose_worker=1)[0])
        jc, tc = engine_counts(j), engine_counts(t)
        swaps = tc["model_swaps"]
        extra = "" if t.recal is None else (
            f", rows_reprofiled {tc['rows_reprofiled']}, targeted "
            f"{tc['targeted_swaps']}, full {tc['full_rebuilds']}, "
            f"{len(tc['polls'])} polls")
        if shards is not None:
            extra += (f", {shards} workers, {tc['rebalances']} rebalances, "
                      f"admitted_steps by worker "
                      f"{[r['admitted_steps'] for r in tc['shard_report']]}")
        print(f"  {label}: admitted_steps {tc['admitted_steps']}, "
              f"unique_frames {tc['unique_frames']}, replay_steps "
              f"{tc['replay_steps']}, epoch {tc['model_epoch']}, swaps "
              f"{swaps}{extra}")
        for k in jc:
            if jc[k] != tc[k]:
                print(f"  {label} {k} DIFFERS")
        check(f"{label} engine and controller", jc, tc)

    print(f"wall: jax {wall['jax']:.1f} s, port {wall['port']:.1f} s "
          f"(host clock, CPU)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
