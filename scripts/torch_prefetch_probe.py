"""Probe of ``transport_sweep``'s prefetch gate on the port.

Runs the sweep's drives (duke(60), 16 queries, 600 ticks, a 4-worker
fleet, RTT = the baseline's p50 tick) ``--reps`` times in the reference
sweep's order, each wall one drive, once with the round's wait for in-flight prefetched blocks where
it is now (``new``: when the first worker block that admits one ranks)
and once where it was before (``old``: in the round's key loop, before
any block ranks), and prints for each drive its wall, p50 tick and the
transport's sleeps (count, asked and got), and for each sweep the gate's
ratio r (the prefetched wall over 1.25 x the larger control) and a
control that sleeps as often and as long in all as the prefetched run,
through the blocking path.  Ends with one ``transport_sweep`` call and
its rows.  ``--blocks`` instead counts, on the host, the worker blocks of
each round that reads a prefetched block, and those that admit one.
``--host`` instead runs, ``--reps`` times, the zero-latency control and
the prefetched run right after the baseline, again after the three
blocking runs, and the control once more after ten idle seconds: the
same work before and after the blocking runs' sleeps.  ``--transports``
instead runs, ``--reps`` times in rotated order, the prefetched drive
through the in-process transport, through the fake RPC at zero latency
and through the fake RPC at one RTT: the transport's own cost apart from
the latency it injects.  ``--sweeps N`` instead calls ``transport_sweep``
itself N times and prints each call's gate ratio from its records.

  PYTHONPATH=src python scripts/torch_prefetch_probe.py            # card
  PYTHONPATH=src python scripts/torch_prefetch_probe.py --device cpu --reps 1
"""
import argparse
import collections
import time

import numpy as np

from repro_torch import api as rexcam
from repro_torch.benchmarks import scenarios as S
from repro_torch.runtime import engine as E
from repro_torch.runtime import transport as T


class SleepLog:
    """A ``FakeRpcTransport`` sleep that records (start, end, asked)."""

    def __init__(self):
        self.ev = []

    def __call__(self, dt):
        t0 = time.perf_counter()
        time.sleep(dt)
        self.ev.append((t0, time.perf_counter(), dt))

    def line(self):
        asked = sum(e[2] for e in self.ev)
        got = sum(e[1] - e[0] for e in self.ev)
        return f"sleeps {len(self.ev)} asked {asked * 1e3:.1f} ms " \
               f"got {got * 1e3:.1f} ms"


def fake(lat):
    sl = SleepLog()
    return sl, rexcam.FakeRpcTransport(
        default=rexcam.FaultProfile(latency=lat), timeout=4 * lat + 1.0,
        sleep=sl)


def drive(sc, tag, args, sl=None, **kw):
    _, _, wall, lat = S._drive_serving(sc, S.REXCAM, 16, args.steps,
                                       shards=4, device=args.device, **kw)
    print(f"  {tag:15s} wall {wall:.4f} s p50 tick "
          f"{np.median(lat) * 1e3:.3f} ms"
          + ("" if sl is None else "; " + sl.line()), flush=True)
    return wall, lat


def sweep(sc, args, control):
    """The reference sweep's drives in its order, one drive a wall;
    returns the gate ratio."""
    w0, lat0 = drive(sc, "baseline", args)
    rtt = max(0.002, float(np.median(lat0)))
    wp0, _ = drive(sc, "prefetch_rtt0", args,
                   transport=rexcam.InProcTransport(), prefetch=True)
    for s in (1, 4, 8):
        sl, tr = fake(rtt * s)
        drive(sc, f"blocking_rtt{s}x", args, sl, transport=tr)
    slp, tr = fake(rtt)
    wp, _ = drive(sc, "prefetch_rtt1x", args, slp, transport=tr,
                  prefetch=True)
    r = wp / (1.25 * max(wp0, w0))
    print(f"  => rtt {rtt * 1e3:.3f} ms, r = {r:.4f} "
          f"({'ok' if r <= 1 else 'FAIL'}); prefetched - rtt0 "
          f"{wp - wp0:+.4f} s", flush=True)
    if control and slp.ev:
        per = sum(e[2] for e in slp.ev) / len(slp.ev)
        sl, tr = fake(per)
        wc, _ = drive(sc, "same-sleep ctl", args, sl, transport=tr)
        print(f"  => control: blocking at {per * 1e3:.3f} ms, wall - "
              f"baseline {wc - w0:+.4f} s", flush=True)
    return r


def host_order(sc, args):
    """The control and the prefetched run before and after the blocking
    runs (and the control after an idle pause): their walls a rep."""
    for rep in range(args.reps):
        print(f"rep {rep}", flush=True)
        _, lat0 = drive(sc, "baseline", args)
        rtt = max(0.002, float(np.median(lat0)))
        walls = {}

        def pair(tag):
            walls["rtt0" + tag], _ = drive(
                sc, "prefetch_rtt0" + tag, args,
                transport=rexcam.InProcTransport(), prefetch=True)
            sl, tr = fake(rtt)
            walls["rtt1x" + tag], _ = drive(sc, "prefetch_rtt1x" + tag,
                                            args, sl, transport=tr,
                                            prefetch=True)
        pair("")
        for s in (1, 4, 8):
            sl, tr = fake(rtt * s)
            drive(sc, f"blocking_rtt{s}x", args, sl, transport=tr)
        pair(" after")
        time.sleep(10.0)
        walls["rtt0 idle"], _ = drive(
            sc, "prefetch_rtt0 after 10 s idle", args,
            transport=rexcam.InProcTransport(), prefetch=True)
        print("  => " + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items()),
              flush=True)


def transports(sc, args):
    """The prefetched drive through three transports, rotated a rep."""
    _, lat0 = drive(sc, "baseline", args)
    rtt = max(0.002, float(np.median(lat0)))
    walls = collections.defaultdict(list)

    def inproc():
        return None, rexcam.InProcTransport()

    configs = [("inproc", inproc), ("fake_rpc_0", lambda: fake(0.0)),
               ("fake_rpc_rtt", lambda: fake(rtt))]
    for rep in range(args.reps):
        print(f"rep {rep}", flush=True)
        for k in range(len(configs)):
            name, make = configs[(rep + k) % len(configs)]
            sl, tr = make()
            w, _ = drive(sc, name, args, sl, transport=tr, prefetch=True)
            walls[name].append(w)
    for name, ws in walls.items():
        print(f"{name}: median wall {np.median(ws):.4f} s "
              f"({', '.join(f'{w:.4f}' for w in ws)})")


def sweeps(args):
    """``transport_sweep`` itself, ``args.sweeps`` times: r a call."""
    for i in range(args.sweeps):
        S.pop_bench_records("transport_sweep")
        t0 = time.perf_counter()
        try:
            S.transport_sweep(device=args.device)
            verdict = "gates hold"
        except AssertionError as e:
            verdict = f"GATE FAILED: {e}"
        w = {r["config"]: r["wall_s"]
             for r in S.pop_bench_records("transport_sweep")}
        r = w["prefetch_rtt1x"] / (1.25 * max(w["prefetch_rtt0"],
                                              w["baseline"]))
        print(f"sweep {i}: {time.perf_counter() - t0:.1f} s, {verdict}; "
              f"baseline {w['baseline']:.4f} s, control "
              f"{w['prefetch_rtt0']:.4f} s, prefetched "
              f"{w['prefetch_rtt1x']:.4f} s, r = {r:.4f}", flush=True)


def count_blocks(sc, args):
    hist = collections.Counter()
    plan_round = E.ServingEngine._plan_round

    def spy(self, qs):
        plan = plan_round(self, qs)
        pf = self._prefetch
        if pf is not None and pf.in_flight:
            inflight = set(pf._inflight)
            need = {self._placement[q.qid] for i, q in enumerate(plan.qs)
                    if {(int(c), q.f_curr)
                        for c in plan.cams_by_q[i]} & inflight}
            if need:
                hist[(len(self._row_blocks), len(need))] += 1
        return plan
    E.ServingEngine._plan_round = spy
    S._drive_serving(sc, S.REXCAM, 16, args.steps, shards=4,
                     device=args.device, transport=rexcam.InProcTransport(),
                     prefetch=True)
    E.ServingEngine._plan_round = plan_round
    for (blocks, need), n in sorted(hist.items()):
        print(f"{n} rounds read prefetched blocks with {blocks} live worker "
              f"blocks, {need} of them admitting one")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--blocks", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--transports", action="store_true")
    ap.add_argument("--sweeps", type=int, default=0)
    args = ap.parse_args()
    if args.sweeps:
        sweeps(args)
        return
    sc = S.duke(60)
    if args.blocks:
        count_blocks(sc, args)
        return
    drive(sc, "warm-up", args)
    if args.host:
        host_order(sc, args)
        return
    if args.transports:
        transports(sc, args)
        return
    pending = T.PrefetchPipeline.pending
    ratios = collections.defaultdict(list)
    for rep in range(args.reps):
        for variant in ("new", "old"):
            T.PrefetchPipeline.pending = pending if variant == "new" \
                else (lambda self, cam, t: False)
            print(f"rep {rep} {variant}", flush=True)
            ratios[variant].append(
                sweep(sc, args, control=rep == 0 and variant == "new"))
    T.PrefetchPipeline.pending = pending
    for variant, rs in ratios.items():
        print(f"{variant}: r = {', '.join(f'{r:.4f}' for r in rs)}; "
              f"{sum(r > 1 for r in rs)} of {len(rs)} over the bound")
    S.pop_bench_records("transport_sweep")
    t0 = time.perf_counter()
    try:
        rows, verdict = S.transport_sweep(device=args.device), "gates hold"
    except AssertionError as e:
        rows, verdict = [], f"GATE FAILED: {e}"
    print(f"transport_sweep: {time.perf_counter() - t0:.1f} s, {verdict}")
    for name, _, derived in rows:
        print(f"  | {name}: {derived}")


if __name__ == "__main__":
    main()
