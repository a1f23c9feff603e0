"""The benchmark suite, the counterpart of ``benchmarks/run.py``: one entry
per paper table or figure, per serving sweep, the §6 drift run and the
kernel benchmark, each run on ``--device``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--only ENTRY ...] [--device cuda|cpu] [--bench-dir DIR]

Prints ``name,us_per_call,derived`` CSV rows on stdout and, on stderr, a
``# <entry>: N records -> path`` line for each ``BENCH_<entry>.json``
written into ``--bench-dir`` and a ``# <entry> done in S s`` line.  An
entry that raises prints an ``<entry>/ERROR`` row and the suite goes on;
the exit code is then 1.  ``--device cuda`` (the default) raises at once
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.benchmarks import drift, kernels_bench, scenarios, tables
from repro_torch.device import resolve_device

ALL = {
    "policy_sweep": scenarios.policy_sweep,
    "serving_sweep": scenarios.serving_sweep,
    "serving_shard_sweep": scenarios.serving_shard_sweep,
    "gallery_sweep": scenarios.gallery_sweep,
    "drift_sweep": scenarios.drift_sweep,
    "transport_sweep": scenarios.transport_sweep,
    "query_churn_sweep": scenarios.query_churn_sweep,
    "tile_sweep": scenarios.tile_sweep,
    "soak_130": scenarios.soak_130,
    "sec3_potential": tables.sec3_potential,
    "fig10_anoncampus": tables.fig10_anoncampus,
    "fig11_duke": tables.fig11_duke,
    "fig12_porto": tables.fig12_porto,
    "fig13_camera_scaling": tables.fig13_camera_scaling,
    "fig14_frame_skipping": tables.fig14_frame_skipping,
    "fig15_replay": tables.fig15_replay,
    "fig16_profiling": tables.fig16_profiling,
    "fig17_identity_detection": tables.fig17_identity_detection,
    "sec6_drift": drift.run,
    "kernels": kernels_bench.run,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, choices=list(ALL))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bench-dir", default=None, metavar="DIR",
                    help="write machine-readable BENCH_<scenario>.json files "
                    "(admitted_steps, unique_frames, wall, p50/p99 round "
                    "latency per config) for every sweep that records them")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # no card: fail before any world
    failed = []
    print("name,us_per_call,derived", flush=True)
    for name in args.only or list(ALL):
        t0 = time.time()
        scenarios.pop_bench_records(name)  # drop stale in-process records
        try:
            rows = ALL[name](device=device)
        except Exception as e:  # noqa: BLE001 — report, go on, exit 1
            print(f"{name}/ERROR,0,{type(e).__name__}: {e}", flush=True)
            failed.append(name)
            continue
        for rname, us, derived in rows:
            print(f"{rname},{us:.1f},{derived}", flush=True)
        recs = scenarios.pop_bench_records(name)
        if args.bench_dir and recs:
            os.makedirs(args.bench_dir, exist_ok=True)
            path = os.path.join(args.bench_dir, f"BENCH_{name}.json")
            with open(path, "w") as f:
                json.dump({"scenario": name, "records": recs}, f, indent=1)
            print(f"# {name}: {len(recs)} records -> {path}",
                  file=sys.stderr)
        print(f"# {name} done in {time.time() - t0:.1f}s", file=sys.stderr)
    if failed:
        print(f"# failed: {' '.join(failed)}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
