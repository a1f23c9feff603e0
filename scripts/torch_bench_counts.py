"""The benchmark suite's tables and sweeps at full size: the JAX
reference against the PyTorch port, both on the CPU.

Runs each entry of ``benchmarks/run.py`` that the port's
``repro_torch.benchmarks.run`` gained with its tables and sweeps, at the
reference's own sizes: ``policy_sweep``, ``serving_sweep``,
``tile_sweep``, ``serving_shard_sweep``, ``gallery_sweep``,
``transport_sweep``, ``query_churn_sweep``, ``sec3_potential`` and
``fig10_anoncampus`` through ``fig17_identity_detection``.  The
reference's fleets run on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set here before
``jax`` is imported); the port's on 8 logical workers on the CPU.  Each
entry's CSV rows and ``BENCH`` records must be equal once the clock
readings are taken out (``scenarios.strip_clock_row`` /
``strip_clock_records``: the per-call microseconds, walls, tick
percentiles, the transport sweep's RTTs and stall floors, the shard
sweep's speedups).  Prints one line per entry with both sides' seconds;
``--bench-dir DIR`` writes the port's ``BENCH_<entry>.json`` (check them
with ``scripts/bench_schema_check.py DIR``).  Exits non-zero if anything
differs or raises.

    PYTHONPATH=src python scripts/torch_bench_counts.py [--only ENTRY ...] \\
        [--bench-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# the reference's fleets need 8 devices; jax reads this at import
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                           "--xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ENTRIES = ("policy_sweep", "serving_sweep", "tile_sweep",
           "serving_shard_sweep", "gallery_sweep", "transport_sweep",
           "query_churn_sweep", "sec3_potential", "fig10_anoncampus",
           "fig11_duke", "fig12_porto", "fig13_camera_scaling",
           "fig14_frame_skipping", "fig15_replay", "fig16_profiling",
           "fig17_identity_detection")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, choices=ENTRIES)
    ap.add_argument("--bench-dir", default=None, metavar="DIR")
    args = ap.parse_args()

    from benchmarks import run as j_run
    from benchmarks import scenarios as j_scen
    from repro_torch.benchmarks import run as t_run
    from repro_torch.benchmarks.scenarios import (pop_bench_records,
                                                  strip_clock_records,
                                                  strip_clock_row)

    ok = True
    for name in args.only or ENTRIES:
        out, secs = {}, {}
        for side in ("jax", "port"):
            t0 = time.perf_counter()
            try:
                if side == "jax":
                    j_scen.pop_bench_records(name)
                    rows = j_run.ALL[name]()
                    recs = j_scen.pop_bench_records(name)
                else:
                    pop_bench_records(name)
                    rows = t_run.ALL[name](device="cpu")
                    recs = pop_bench_records(name)
            except Exception as e:  # noqa: BLE001 — report every entry
                rows, recs = None, f"{type(e).__name__}: {e}"
            secs[side] = time.perf_counter() - t0
            out[side] = rows, recs
        (j_rows, j_recs), (t_rows, t_recs) = out["jax"], out["port"]
        if j_rows is None or t_rows is None:
            ok = False
            print(f"{name}: RAISED (jax {j_recs if j_rows is None else '-'};"
                  f" port {t_recs if t_rows is None else '-'})", flush=True)
            continue
        for r in t_rows:
            print(f"  {r[0]}: {r[2]}")
        same_rows = [strip_clock_row(r) for r in j_rows] == \
            [strip_clock_row(r) for r in t_rows]
        same_recs = strip_clock_records(j_recs) == strip_clock_records(t_recs)
        ok &= same_rows and same_recs
        print(f"{name}: {len(t_rows)} rows "
              f"{'equal' if same_rows else 'DIFFER'}, {len(t_recs)} records "
              f"{'equal' if same_recs else 'DIFFER'} (jax "
              f"{secs['jax']:.1f} s, port {secs['port']:.1f} s, host clock)",
              flush=True)
        if not same_rows:
            for a, b in zip(j_rows, t_rows):
                if strip_clock_row(a) != strip_clock_row(b):
                    print(f"  jax  {a}\n  port {b}")
        if not same_recs:
            for a, b in zip(strip_clock_records(j_recs),
                            strip_clock_records(t_recs)):
                if a != b:
                    print(f"  jax  {a}\n  port {b}")
        if args.bench_dir and t_recs:
            os.makedirs(args.bench_dir, exist_ok=True)
            with open(os.path.join(args.bench_dir, f"BENCH_{name}.json"),
                      "w") as f:
                json.dump({"scenario": name, "records": t_recs}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
