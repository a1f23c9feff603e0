#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line or block each:

  1. environment: torch / CUDA versions, the card, its power limit; TF32
     off for matmul and cuDNN (the plain versions must be full fp32);
  2. build: every CUDA source of the serving path, with nvcc for sm_90a;
  3. each kernel against its plain PyTorch version on the card, on ragged,
     tied, masked, k > G, G == 0 and C = 130 inputs and at a stress shape:
     scores within rtol/atol 1e-5, indices exact on integer-valued inputs
     and exact elsewhere except between scores within 1e-5 of each other;
     every shape is timed (kernel, plain version, library yardstick) beside
     its bound;
  4. the main path: the duke world at the benchmark's scale (8 cameras,
     2,700 entities, 5,100 steps, 100 queries) served for 600 ticks through
     ``repro_torch.api.serve(device="cuda")``; every kernel's launch count
     is reset just before and read just after, and must equal the rounds
     that ranked a non-empty gallery.  The same ticks run again with
     ``device="cpu"`` (the plain versions) and the two traces must agree;
  5. each kernel against its plain version at every round shape phase 4
     produced, timed as in phase 3; the most frequent one's times go into
     the kernels line, beside the stress shape's.

Times are device times per call: CUDA-graph replays of back-to-back calls,
timed with CUDA events, median over replays.  ``bound_ms`` is the larger of
the bytes the call must move (each input read once, each output written
once) over 3.35 TB/s and the fp32 operations this run's data needs (two
per eligible (query, gallery row) pair and feature) over 67 TFLOP/s, the
H100 SXM data sheet's peaks.  ``library_ms`` times one PyTorch composition
of the same function (``torch.matmul``, masking, ``torch.topk``), which
the port never calls.

Exits non-zero, before the last line, on any failed phase, and without a
result when no card is present or the repository is not beside it.  The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
TOL = 1e-5
TICKS = 600
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/reid_topk.cu"
KERNEL_REPLACES = "src/repro/kernels/reid_topk.py:139"


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def device_ms(torch, fn, calls: int = 10, replays: int = 25) -> float:
    """Median device time of one ``fn()`` call: ``calls`` back-to-back
    calls captured in a CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def eligible_pairs(torch, q_tag, admit, gal_cam, gal_tag) -> int:
    C = admit.shape[1]
    ok = (gal_cam >= 0) & (gal_cam < C)
    cams = torch.where(ok, gal_cam, 0).long()
    valid = admit[:, cams] & ok[None, :] & (gal_tag[None, :] == q_tag[:, None])
    return int(valid.sum())


def bound(torch, args, k: int):
    q, q_tag, admit, g, gal_cam, gal_tag = args
    Q, D = q.shape
    G = g.shape[0]
    nbytes = (q.numel() * 4 + q_tag.numel() * 4 + admit.numel()
              + g.numel() * 4 + gal_cam.numel() * 4 + gal_tag.numel() * 4
              + Q * k * 8)
    ops = 2 * D * eligible_pairs(torch, q_tag, admit, gal_cam, gal_tag)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(torch, neg_inf):
    """One PyTorch composition of the segment-masked top-k (yardstick)."""
    def run(q, q_tag, admit, g, gal_cam, gal_tag, k):
        s = torch.matmul(q, g.T)
        C = admit.shape[1]
        ok = (gal_cam >= 0) & (gal_cam < C)
        valid = admit[:, torch.where(ok, gal_cam, 0).long()] & ok[None, :] \
            & (gal_tag[None, :] == q_tag[:, None])
        return torch.topk(torch.where(valid, s, neg_inf), min(k, g.shape[0]),
                          dim=1)
    return run


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

def check_against_plain(torch, ops, ref, name, args, k, exact_idx):
    """Kernel vs plain version on the same card inputs; returns the max
    absolute score error.  Slots past the plain version's k + 1-th band let
    a near-tie at the last slot be recognised."""
    kv, ki = ops.reid_topk_segments(*args, k)
    pv, pi = ref.reid_topk_segments_ref(*args, k + 1)
    torch.cuda.synchronize()
    if kv.shape != (args[0].shape[0], k) or ki.dtype != torch.int32:
        fail(f"{name}: kernel returned {tuple(kv.shape)} {ki.dtype}")
    if not torch.isfinite(kv).all():
        fail(f"{name}: non-finite kernel scores")
    err = float((kv - pv[:, :k]).abs().max()) if kv.numel() else 0.0
    if not torch.allclose(kv, pv[:, :k], rtol=TOL, atol=TOL):
        fail(f"{name}: scores differ from the plain version (max abs {err})")
    bad = ki != pi[:, :k]
    if exact_idx:
        if bad.any():
            fail(f"{name}: indices differ on integer-valued inputs")
    else:
        near = torch.zeros_like(bad)
        gap = (pv[:, 1:] - pv[:, :-1]).abs() <= TOL * (1 + pv[:, 1:].abs())
        near[:, 1:] |= gap[:, :k - 1]
        near |= gap[:, :k]
        if (bad & ~near).any():
            fail(f"{name}: indices differ away from any near-tie")
    return err


def synthetic_inputs(torch, rng, Q, G, D, C, *, ties=False, n_tags=3,
                     p_admit=0.6, masked_row=False, pad_rows=0):
    import numpy as np

    if ties:
        qf = rng.integers(0, 2, (Q, D)).astype(np.float32)
        gf = rng.integers(0, 2, (G, D)).astype(np.float32)
    else:
        qf = rng.normal(size=(Q, D)).astype(np.float32)
        gf = rng.normal(size=(G, D)).astype(np.float32)
    q_tag = rng.integers(0, n_tags, Q).astype(np.int32)
    gal_tag = rng.integers(0, n_tags, G).astype(np.int32)
    admit = rng.random((Q, C)) < p_admit
    gal_cam = rng.integers(0, C, G).astype(np.int32)
    if masked_row and Q:
        admit[0] = False
    if pad_rows:
        gal_cam[G - pad_rows:] = -1
        gal_tag[G - pad_rows:] = -1
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (qf, q_tag, admit, gf, gal_cam, gal_tag))


def measure(torch, ops, ref, lib, args, k):
    b_ms, b_by = bound(torch, args, k)
    return dict(
        ms=device_ms(torch, lambda: ops.reid_topk_segments(*args, k)),
        plain_ms=device_ms(torch,
                           lambda: ref.reid_topk_segments_ref(*args, k)),
        library_ms=(device_ms(torch, lambda: lib(*args, k))
                    if args[3].shape[0] >= k else None),
        bound_ms=b_ms, bound_by=b_by)


def check_and_time(torch, ops, ref, lib, label, args, k, exact_idx):
    """Hold the kernel to its plain version on ``args``, time both and the
    library yardstick, print one line; returns (max abs err, timings)."""
    err = check_against_plain(torch, ops, ref, label, args, k, exact_idx)
    t = measure(torch, ops, ref, lib, args, k)
    Q, D = args[0].shape
    lib_ms = "n/a (k > G)" if t["library_ms"] is None \
        else f"{t['library_ms']:.4f} ms"
    say(f"  {label}: Q={Q} G={args[3].shape[0]} D={D} C={args[2].shape[1]} "
        f"k={k} agree (max abs err {err:.3g}); kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, library {lib_ms}, bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    return err, t


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def device_share(torch, serve, ticks: int = 200):
    """Where a tick's time goes: the main path served again for ``ticks``
    ticks under ``torch.profiler``; prints the device's busy time (kernels
    and copies) against the host clock, and the operations that took the
    most device time.  The profiler's own overhead lengthens the host
    clock, so the busy share it gives is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, tick_s = serve(DEVICE, None, ticks)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): a host op's device time
    # repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = sum(tick_s) * 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    rank_ms = sum(e.self_device_time_total for e in events
                  if "reid_topk" in e.key) / 1e3
    say(f"[4 main] profiled {len(tick_s)} ticks: device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms host clock "
        f"({100 * busy_ms / wall_ms:.2f} % busy), of it the re-id top-k "
        f"kernel {rank_ms:.3f} ms; most device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))


def record_key(r, with_idx=True):
    return (r["qid"], r["f_curr"], r["phase"], r["epoch"],
            tuple(bool(x) for x in r["mask"]), bool(r["matched"]),
            int(r["match_cam"]), int(r["match_idx"]) if with_idx else None,
            tuple((c, f) for _, c, f in r["topk"]))


def same_record(a, b, with_idx=True):
    vals_a = [a["match_val"]] + [v for v, _, _ in a["topk"]]
    vals_b = [b["match_val"]] + [v for v, _, _ in b["topk"]]
    return record_key(a, with_idx) == record_key(b, with_idx) and all(
        abs(x - y) <= TOL * (1 + abs(y)) for x, y in zip(vals_a, vals_b))


def compare_traces(gpu, cpu, match_thresh):
    """Query by query, record by record: everything exact but the scores
    (1e-5).  The one difference forgiven is a record whose band-0 score
    lies within 1e-5 of the match threshold, where fp32 rounding may
    decide the match: it is printed and that query's later records are
    not compared, since its two runs may rightly part there.  The other
    queries' records are all compared; their ``match_idx`` only before the
    forgiven record, because the parted query's admitted frames shift the
    later round galleries' rows (band cameras and frames still name each
    row).  Fails if a second query parts.  Returns the number of records
    compared and the parted query (or None)."""
    if not gpu:
        fail("empty trace")
    by_q = {}
    for side, trace in enumerate((gpu, cpu)):
        for pos, r in enumerate(trace):
            by_q.setdefault(r["qid"], ([], []))[side].append((pos, r))
    # pass 1: where each query first differs, row indices aside
    parted = None           # (qid, cuda trace position of the record)
    for qid, (ra, rb) in sorted(by_q.items()):
        for (pos, a), (_, b) in zip(ra, rb):
            if same_record(a, b, with_idx=False):
                continue
            v0 = b["topk"][0][0]
            if parted is None and abs((1.0 - v0) - match_thresh) <= TOL:
                say(f"  query {qid} parts at an fp32 near-threshold "
                    f"record; its later records are not compared:\n"
                    f"    cuda {a}\n    cpu  {b}")
                parted = (qid, pos)
                break
            fail(f"trace record of query {qid} differs:\n  cuda {a}\n  "
                 f"cpu  {b}")
        else:
            if len(ra) != len(rb):
                fail(f"query {qid}: cuda has {len(ra)} records, cpu "
                     f"{len(rb)}")
    # pass 2: the row indices, up to the parting
    stop = len(gpu) if parted is None else parted[1]
    n = 0
    for qid, (ra, rb) in sorted(by_q.items()):
        for (pos, a), (_, b) in zip(ra, rb):
            if parted is not None and qid == parted[0] and pos >= stop:
                break
            if pos < stop and not same_record(a, b):
                fail(f"trace record of query {qid} differs in match_idx:"
                     f"\n  cuda {a}\n  cpu  {b}")
            n += 1
    return n, None if parted is None else parted[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch import api
        from repro_torch.kernels import build, ops, ref, reid_topk
        from repro_torch.launch.serve import duke_world, run_stream
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")

    # -- phase 1: environment ------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device '{kind}' x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build("reid_topk")
    say(f"[2 build] nvcc sm_90a: reid_topk.cu in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # -- phase 3: kernel vs plain on synthetic inputs -------------------
    rng = np.random.default_rng(0)
    lib = library_call(torch, ref.NEG_INF)
    max_err = 0.0
    cases = [
        # name, Q, G, D, C, k, inputs
        ("ragged 33x517 masked-row pad", 33, 517, 64, 8, 3,
         dict(masked_row=True, pad_rows=40)),
        ("ragged 7x70 k16", 7, 70, 64, 8, 16, {}),
        ("k>G 5x3 k8", 5, 3, 64, 8, 8, {}),
        ("ties 40x300 int", 40, 300, 16, 8, 5, dict(ties=True)),
        ("ties 130cams 96x700 int", 96, 700, 32, 130, 8,
         dict(ties=True, pad_rows=12)),
        ("130cams 64x1000", 64, 1000, 64, 130, 4, dict(masked_row=True)),
        ("k1 128x256", 128, 256, 64, 8, 1, {}),
    ]
    say("[3 kernel] against the plain version on the card, times per call:")
    for name, Q, G, D, C, k, kw in cases:
        args = synthetic_inputs(torch, rng, Q, G, D, C, **kw)
        err, _ = check_and_time(torch, ops, ref, lib, name, args, k,
                                exact_idx=kw.get("ties", False))
        max_err = max(max_err, err)
    empty = synthetic_inputs(torch, rng, 4, 0, 64, 8)
    before = reid_topk.LAUNCHES
    ev, ei = ops.reid_topk_segments(*empty, 3)
    if reid_topk.LAUNCHES != before or (ei != -1).any() or \
            not (ev < -1e29).all():
        fail("G == 0 must return the sentinel bands without a launch")
    say("  G=0: sentinel bands, no launch")

    stress = synthetic_inputs(torch, rng, 256, 8192, 2048, 130, n_tags=2,
                              p_admit=0.75, pad_rows=80)
    err, st = check_and_time(torch, ops, ref, lib, "stress", stress, 16,
                             exact_idx=False)
    max_err = max(max_err, err)

    # -- phase 4: the main path -----------------------------------------
    t0 = time.perf_counter()
    world = duke_world(100)
    model = api.profile(world.vis, time_limit=3000, device=DEVICE)
    policy = api.SearchPolicy()
    say(f"[4 main] duke world: {world.net.n_cams} cameras, "
        f"{len(world.vis)} visits, horizon {world.vis.horizon}, "
        f"{len(world.q_vids)} queries; built in "
        f"{time.perf_counter() - t0:.1f} s")

    rounds = []          # (Q, G) of every ranked round
    kept = {}            # (Q, G) -> a copy of that round's kernel inputs
    real_call = ops.reid_topk_segments

    def recording_call(*a):
        shape = (a[0].shape[0], a[3].shape[0])
        rounds.append(shape)
        if shape not in kept:
            kept[shape] = (tuple(t.clone() for t in a[:6]), a[6])
        return real_call(*a)

    def serve(device, trace, ticks=TICKS):
        eng = api.serve(model.to(device), lambda x: x, policy,
                        geo_adj=world.net.geo_adjacent, topk=3,
                        consolidate=True, device=device)
        return eng, run_stream(eng, world, ticks, trace)

    gpu_trace = []
    ops.reid_topk_segments = recording_call
    reid_topk.LAUNCHES = 0
    try:
        eng, tick_s = serve(DEVICE, gpu_trace)
    finally:
        launches = reid_topk.LAUNCHES
        ops.reid_topk_segments = real_call
    nonempty = sum(1 for q, g in rounds if q > 0 and g > 0)
    if launches == 0 or launches != nonempty:
        fail(f"reid_topk launches {launches} != non-empty rounds {nonempty}")
    naive = eng.content_steps * world.net.n_cams   # all-camera search
    matches = sum(len(q.matches) for q in eng.queries.values())
    rescues = sum(q.rescued for q in eng.queries.values())
    lat = np.asarray(tick_s) * 1e3
    served = len({r["qid"] for r in gpu_trace})
    say(f"[4 main] cuda: {len(tick_s)} ticks, {served} of "
        f"{len(world.q_vids)} queries reached their anchor and were served, "
        f"{len(rounds)} ranked rounds, "
        f"reid_topk launches {launches} (= non-empty rounds); "
        f"admitted_steps={eng.admitted_steps} "
        f"unique_frames={eng.unique_frames} over {eng.content_steps} query "
        f"rounds, savings vs all-camera search of those rounds "
        f"{naive / max(eng.admitted_steps, 1):.2f}x; matches={matches} "
        f"replay rescues={rescues}; {len(tick_s) / sum(tick_s):.1f} ticks/s; "
        f"tick p50 {np.percentile(lat, 50):.3f} ms p99 "
        f"{np.percentile(lat, 99):.3f} ms")

    cpu_trace = []
    t0 = time.perf_counter()
    eng_cpu, _ = serve("cpu", cpu_trace)
    n, parted = compare_traces(gpu_trace, cpu_trace, policy.match_thresh)
    if parted is None and (eng_cpu.admitted_steps, eng_cpu.unique_frames) \
            != (eng.admitted_steps, eng.unique_frames):
        fail("cuda and cpu runs disagree on the cost counters")
    say(f"[4 main] cpu rerun (plain versions) in "
        f"{time.perf_counter() - t0:.1f} s: {n} of {len(gpu_trace)} trace "
        f"records agree"
        + ("; cost counters equal" if parted is None else
           f"; query {parted} parted at a near-threshold record, so the "
           f"cost counters are not compared"))

    device_share(torch, serve)

    # -- phase 5: the main path's round shapes ----------------------------
    shapes = sorted(kept, key=lambda s: s[0] * s[1])
    main_shape = max(kept, key=lambda s: (rounds.count(s), s[0] * s[1]))
    say(f"[5 rounds] {len(shapes)} round shapes (Q, G) with their round "
        f"counts: {[(s, rounds.count(s)) for s in shapes]}")
    timings = {}
    for shape in shapes:
        args, k = kept[shape]
        err, timings[shape] = check_and_time(
            torch, ops, ref, lib, f"round {shape}", args, k, exact_idx=False)
        max_err = max(max_err, err)
    row = timings[main_shape]
    args, k = kept[main_shape]
    say(f"[5 rounds] all agree (max abs err {max_err:.3g}); the most frequent "
        f"round shape is Q={main_shape[0]} G={main_shape[1]} "
        f"({rounds.count(main_shape)} rounds)")

    say(smi)
    say(json.dumps({"kernels": [dict(
        name="reid_topk_segment_masked", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, max_abs_err=max_err,
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=dict(Q=main_shape[0], G=main_shape[1], D=int(args[0].shape[1]),
                   C=int(args[2].shape[1]), k=k),
        stress=dict(Q=256, G=8192, D=2048, C=130, k=16, ms=st["ms"],
                    plain_ms=st["plain_ms"], library_ms=st["library_ms"],
                    bound_ms=st["bound_ms"], bound_by=st["bound_by"]))]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
