#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line or block each:

  1. environment: torch / CUDA versions, the card, its power limit; TF32
     off for matmul and cuDNN (the plain versions must be full fp32);
  2. build: every CUDA source of the serving path, with nvcc for sm_90a,
     one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, on ragged,
     tied, masked, k > G, G == 0, C = 130 (and C*T*T = 8,320 cells) inputs
     and at a stress shape: scores within rtol/atol 1e-5, indices exact on
     integer-valued inputs and exact elsewhere except between scores
     within 1e-5 of each other; every shape is timed (kernel, plain
     version, library yardstick) beside its bound; the tile kernel with
     every tile admitted must equal the camera kernel bit for bit;
  4. the camera-granular main path: the duke world at the benchmark's
     scale (8 cameras, 2,700 entities, 5,100 steps, 100 queries) served for
     600 ticks through ``repro_torch.api.serve(device="cuda")``; every
     kernel's launch count is reset just before and read just after: the
     camera kernel's must equal the rounds that ranked a non-empty gallery,
     the tile kernel's must be 0.  The same ticks run again with
     ``device="cpu"`` (the plain versions) and the two traces must agree;
  5. the camera kernel against its plain version at every round shape
     phase 4 produced, timed as in phase 3; the most frequent one's times
     go into the kernels line, beside the stress shape's;
  6. the tile path: the same world profiled with ``tile_grid=8`` and served
     with ``api.serve(tile_grid=8, topk=3)`` until every query is done or
     the world's horizon ends; the counts are reset just before and read
     just after: the tile kernel's must equal the non-empty rounds, the
     camera kernel's must be 0.  A CPU rerun must agree on the trace and
     on all four cost counters (admitted and unique frames and tiles); it
     also counts the (32-row, 64-row) tiles of each round that hold an
     eligible pair, the kernel's live tiles;
  7. the tile kernel against its plain version at every round shape phase
     6 produced; the most frequent and the largest are timed.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
TOL = 1e-5
TICKS = 600
DEVICE = "cuda"
TILE_GRID = 8
CAMERA = dict(name="reid_topk_segment_masked", route="cuda",
              source="src/repro_torch/kernels/csrc/reid_topk.cu",
              replaces="src/repro/kernels/reid_topk.py:139")
TILES = dict(name="reid_topk_tiles", route="cuda",
             source="src/repro_torch/kernels/csrc/reid_topk_tiles.cu",
             replaces="src/repro/kernels/reid_topk.py:265")
QB, GB = 32, 64             # the kernels' (query, gallery) tile


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


def eligible(torch, q_tag, admit, gal_cam, gal_tag):
    """(Q, G) bool: the pairs a kernel may score (cell or camera in range
    and admitted, tags equal)."""
    C = admit.shape[1]
    ok = (gal_cam >= 0) & (gal_cam < C)
    cams = torch.where(ok, gal_cam, 0).long()
    return admit[:, cams] & ok[None, :] & (gal_tag[None, :] == q_tag[:, None])


def live_tiles(torch, args):
    """(live, total) (32-row, 64-row) tiles of one call: a tile is live
    when it holds an eligible pair, and only live tiles run the product."""
    valid = eligible(torch, args[1], args[2], args[4], args[5])
    Q, G = valid.shape
    nq, ng = -(-Q // QB), -(-G // GB)
    padded = torch.zeros((nq * QB, ng * GB), dtype=torch.bool,
                         device=valid.device)
    padded[:Q, :G] = valid
    live = padded.reshape(nq, QB, ng, GB).any(dim=3).any(dim=1)
    return int(live.sum()), nq * ng


def bound(torch, args, k: int):
    q, q_tag, admit, g, gal_cam, gal_tag = args
    Q, D = q.shape
    G = g.shape[0]
    nbytes = (q.numel() * 4 + q_tag.numel() * 4 + admit.numel()
              + g.numel() * 4 + gal_cam.numel() * 4 + gal_tag.numel() * 4
              + Q * k * 8)
    ops = 2 * D * int(eligible(torch, q_tag, admit, gal_cam, gal_tag).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(torch, neg_inf):
    """One PyTorch composition of the masked top-k (yardstick); the same
    for both kernels, whose camera or cell axis is admit's columns."""
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

def check_against_plain(torch, kern, name, args, k, exact_idx):
    """Kernel vs plain version on the same card inputs; returns the max
    absolute score error.  Slots past the plain version's k + 1-th band let
    a near-tie at the last slot be recognised.  ``kern`` holds the wrapper
    (``call``) and the plain version (``plain``)."""
    kv, ki = kern["call"](*args, k)
    pv, pi = kern["plain"](*args, k + 1)
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


def measure(torch, kern, lib, args, k):
    b_ms, b_by = bound(torch, args, k)
    return dict(
        ms=device_ms(torch, lambda: kern["call"](*args, k)),
        plain_ms=device_ms(torch, lambda: kern["plain"](*args, k)),
        library_ms=(device_ms(torch, lambda: lib(*args, k))
                    if args[3].shape[0] >= k else None),
        bound_ms=b_ms, bound_by=b_by)


def check_and_time(torch, kern, lib, label, args, k, exact_idx):
    """Hold the kernel to its plain version on ``args``, time both and the
    library yardstick, print one line; returns (max abs err, timings)."""
    err = check_against_plain(torch, kern, label, args, k, exact_idx)
    t = measure(torch, kern, lib, args, k)
    Q, D = args[0].shape
    lib_ms = "n/a (k > G)" if t["library_ms"] is None \
        else f"{t['library_ms']:.4f} ms"
    live, total = live_tiles(torch, args)
    say(f"  {label}: Q={Q} G={args[3].shape[0]} D={D} "
        f"{kern['axis']}={args[2].shape[1]} k={k} agree (max abs err "
        f"{err:.3g}); kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
        f"ms, library {lib_ms}, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}); live tiles {live}/{total}")
    return err, t


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def device_share(torch, serve, tag: str, ticks: int = 200):
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
    say(f"{tag} profiled {len(tick_s)} ticks: device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms host clock "
        f"({100 * busy_ms / wall_ms:.2f} % busy), of it the re-id top-k "
        f"kernels {rank_ms:.3f} ms; most device time: "
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

    # -- phase 2: build, one nvcc per source, all started together -------
    t0 = time.perf_counter()
    sources = ("reid_topk", "reid_topk_tiles")
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(build.build, name) for name in sources}
        lib_paths = {name: f.result() for name, f in futures.items()}
    say(f"[2 build] nvcc sm_90a: {', '.join(f'{n}.cu' for n in sources)} "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, path in lib_paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    camera = dict(CAMERA, call=ops.reid_topk_segments,
                  plain=ref.reid_topk_segments_ref, axis="C")
    tiles = dict(TILES, call=ops.reid_topk_tiles,
                 plain=ref.reid_topk_tiles_ref, axis="CT")

    # -- phase 3: kernels vs plain on synthetic inputs -------------------
    rng = np.random.default_rng(0)
    lib = library_call(torch, ref.NEG_INF)
    max_err = {CAMERA["name"]: 0.0, TILES["name"]: 0.0}
    TT = TILE_GRID * TILE_GRID
    cases = [
        # kernel, name, Q, G, D, C (camera) or C*T*T (tiles), k, inputs
        (camera, "ragged 33x517 masked-row pad", 33, 517, 64, 8, 3,
         dict(masked_row=True, pad_rows=40)),
        (camera, "ragged 7x70 k16", 7, 70, 64, 8, 16, {}),
        (camera, "k>G 5x3 k8", 5, 3, 64, 8, 8, {}),
        (camera, "ties 40x300 int", 40, 300, 16, 8, 5, dict(ties=True)),
        (camera, "ties 130cams 96x700 int", 96, 700, 32, 130, 8,
         dict(ties=True, pad_rows=12)),
        (camera, "130cams 64x1000", 64, 1000, 64, 130, 4,
         dict(masked_row=True)),
        (camera, "k1 128x256", 128, 256, 64, 8, 1, {}),
        (tiles, "tiles 8cams T8 ragged 33x517 masked-row unlabeled", 33,
         517, 64, 8 * TT, 3, dict(masked_row=True, pad_rows=40)),
        (tiles, "tiles 8cams T8 ragged 7x70 k16", 7, 70, 64, 8 * TT, 16, {}),
        (tiles, "tiles k>G 5x3 k8", 5, 3, 64, 8 * TT, 8, {}),
        (tiles, "tiles 8cams T8 ties 40x300 int", 40, 300, 16, 8 * TT, 5,
         dict(ties=True)),
        (tiles, "tiles 130cams T8 ties 96x700 int", 96, 700, 32, 130 * TT,
         8, dict(ties=True, pad_rows=12)),
        (tiles, "tiles 130cams T8 64x1000", 64, 1000, 64, 130 * TT, 4,
         dict(masked_row=True)),
        (tiles, "tiles 8cams T8 k1 128x256", 128, 256, 64, 8 * TT, 1, {}),
        (tiles, "tiles 8cams T8 sparse 128x2048", 128, 2048, 64, 8 * TT, 3,
         dict(p_admit=0.0005)),
    ]
    say("[3 kernel] against the plain version on the card, times per call:")
    for kern, name, Q, G, D, C, k, kw in cases:
        args = synthetic_inputs(torch, rng, Q, G, D, C, **kw)
        err, _ = check_and_time(torch, kern, lib, name, args, k,
                                exact_idx=kw.get("ties", False))
        max_err[kern["name"]] = max(max_err[kern["name"]], err)
    for kern in (camera, tiles):
        empty = synthetic_inputs(torch, rng, 4, 0, 64, 8)
        before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
        ev, ei = kern["call"](*empty, 3)
        if (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) != before or \
                (ei != -1).any() or not (ev < -1e29).all():
            fail(f"{kern['name']}: G == 0 must return the sentinel bands "
                 f"without a launch")
    say("  G=0: sentinel bands, no launch (both kernels)")
    # every tile of each admitted camera admitted: the camera kernel's
    # eligibility and FMA order, so its exact bits
    for Q, G, C, k in ((33, 517, 8, 3), (64, 1000, 130, 16)):
        cam_args = synthetic_inputs(torch, rng, Q, G, 64, C, pad_rows=9)
        tile_of = torch.from_numpy(rng.integers(0, TT, G).astype(
            np.int32)).to(DEVICE)
        gal_ct = torch.where(cam_args[4] >= 0, cam_args[4] * TT + tile_of,
                             -1).to(torch.int32)
        tile_args = (cam_args[0], cam_args[1],
                     cam_args[2].repeat_interleave(TT, dim=1).contiguous(),
                     cam_args[3], gal_ct, cam_args[5])
        sv, si = ops.reid_topk_segments(*cam_args, k)
        tv, ti = ops.reid_topk_tiles(*tile_args, k)
        if not (torch.equal(sv, tv) and torch.equal(si, ti)):
            fail(f"all tiles admitted: the tile kernel differs from the "
                 f"camera kernel at Q={Q} G={G} C={C} k={k}")
    say("  all tiles admitted: the tile kernel equals the camera kernel bit "
        "for bit (Q=33 G=517 C=8 k=3; Q=64 G=1000 C=130 k=16)")

    stress = synthetic_inputs(torch, rng, 256, 8192, 2048, 130, n_tags=2,
                              p_admit=0.75, pad_rows=80)
    err, st = check_and_time(torch, camera, lib, "stress", stress, 16,
                             exact_idx=False)
    max_err[CAMERA["name"]] = max(max_err[CAMERA["name"]], err)
    stress_t = synthetic_inputs(torch, rng, 256, 8192, 2048, 130 * TT,
                                n_tags=2, p_admit=0.75, pad_rows=80)
    err, st_t = check_and_time(torch, tiles, lib, "tiles stress", stress_t,
                               16, exact_idx=False)
    max_err[TILES["name"]] = max(max_err[TILES["name"]], err)
    del stress, stress_t

    # -- phase 4: the camera-granular main path ---------------------------
    t0 = time.perf_counter()
    world = duke_world(100)
    model = api.profile(world.vis, time_limit=3000, device=DEVICE)
    policy = api.SearchPolicy()
    say(f"[4 main] duke world: {world.net.n_cams} cameras, "
        f"{len(world.vis)} visits, horizon {world.vis.horizon}, "
        f"{len(world.q_vids)} queries; built in "
        f"{time.perf_counter() - t0:.1f} s")

    def recorder(entry, rounds, kept, hook=None):
        """A stand-in for ``ops.<entry>`` that records each ranked round's
        (Q, G), keeps a copy of the first inputs of each shape, and calls
        ``hook`` on the inputs before the real wrapper runs."""
        real = getattr(ops, entry)

        def call(*a):
            shape = (a[0].shape[0], a[3].shape[0])
            rounds.append(shape)
            if kept is not None and shape not in kept:
                kept[shape] = (tuple(t.clone() for t in a[:6]), a[6])
            if hook is not None:
                hook(a)
            return real(*a)
        return real, call

    def serve(device, trace, ticks=TICKS):
        eng = api.serve(model.to(device), lambda x: x, policy,
                        geo_adj=world.net.geo_adjacent, topk=3,
                        consolidate=True, device=device)
        return eng, run_stream(eng, world, ticks, trace)

    rounds, kept = [], {}      # (Q, G) of every ranked round; inputs by shape
    gpu_trace = []
    real_call, ops.reid_topk_segments = recorder("reid_topk_segments",
                                                 rounds, kept)
    reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
    try:
        eng, tick_s = serve(DEVICE, gpu_trace)
    finally:
        launches, stray = reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES
        ops.reid_topk_segments = real_call
    nonempty = sum(1 for q, g in rounds if q > 0 and g > 0)
    if launches == 0 or launches != nonempty:
        fail(f"reid_topk launches {launches} != non-empty rounds {nonempty}")
    if stray:
        fail(f"the camera path launched the tile kernel {stray} times")
    naive = eng.content_steps * world.net.n_cams   # all-camera search
    matches = sum(len(q.matches) for q in eng.queries.values())
    rescues = sum(q.rescued for q in eng.queries.values())
    lat = np.asarray(tick_s) * 1e3
    served = len({r["qid"] for r in gpu_trace})
    say(f"[4 main] cuda: {len(tick_s)} ticks, {served} of "
        f"{len(world.q_vids)} queries reached their anchor and were served, "
        f"{len(rounds)} ranked rounds, "
        f"reid_topk launches {launches} (= non-empty rounds), "
        f"reid_topk_tiles launches 0; "
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

    device_share(torch, serve, "[4 main]")

    # -- phase 5: the camera path's round shapes --------------------------
    shapes = sorted(kept, key=lambda s: s[0] * s[1])
    main_shape = max(kept, key=lambda s: (rounds.count(s), s[0] * s[1]))
    say(f"[5 rounds] {len(shapes)} round shapes (Q, G) with their round "
        f"counts: {[(s, rounds.count(s)) for s in shapes]}")
    timings = {}
    for shape in shapes:
        args, k = kept[shape]
        err, timings[shape] = check_and_time(
            torch, camera, lib, f"round {shape}", args, k, exact_idx=False)
        max_err[CAMERA["name"]] = max(max_err[CAMERA["name"]], err)
    row = timings[main_shape]
    args, k = kept[main_shape]
    say(f"[5 rounds] all agree (max abs err {max_err[CAMERA['name']]:.3g}); "
        f"the most frequent round shape is Q={main_shape[0]} "
        f"G={main_shape[1]} ({rounds.count(main_shape)} rounds)")
    camera_row = dict(
        launches=launches, max_abs_err=max_err[CAMERA["name"]], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=dict(Q=main_shape[0], G=main_shape[1], D=int(args[0].shape[1]),
                   C=int(args[2].shape[1]), k=k),
        stress=dict(Q=256, G=8192, D=2048, C=130, k=16, ms=st["ms"],
                    plain_ms=st["plain_ms"], library_ms=st["library_ms"],
                    bound_ms=st["bound_ms"], bound_by=st["bound_by"]))
    del kept

    # -- phase 6: the tile path, until every query is done ----------------
    t0 = time.perf_counter()
    tile_model = api.profile(world.vis, time_limit=3000, tile_grid=TILE_GRID,
                             device=DEVICE)
    horizon_ticks = world.vis.horizon - int(world.vis.t_out[world.q_vids]
                                            .min())
    say(f"[6 tiles] profiled with tile_grid={TILE_GRID} in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{int(tile_model.tile_admit.sum())} of "
        f"{tile_model.tile_admit.numel()} (src, dst, tile) cells admitted")

    def serve_tiles(device, trace, ticks=horizon_ticks):
        eng = api.serve(tile_model.to(device), lambda x: x, policy,
                        geo_adj=world.net.geo_adjacent, topk=3,
                        tile_grid=TILE_GRID, device=device)
        return eng, run_stream(eng, world, ticks, trace)

    t_rounds, t_kept = [], {}
    gpu_trace = []
    real_call, ops.reid_topk_tiles = recorder("reid_topk_tiles", t_rounds,
                                              t_kept)
    reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
    try:
        eng, tick_s = serve_tiles(DEVICE, gpu_trace)
    finally:
        t_launches, stray = reid_topk.TILE_LAUNCHES, reid_topk.LAUNCHES
        ops.reid_topk_tiles = real_call
    nonempty = sum(1 for q, g in t_rounds if q > 0 and g > 0)
    if t_launches == 0 or t_launches != nonempty:
        fail(f"reid_topk_tiles launches {t_launches} != non-empty rounds "
             f"{nonempty}")
    if stray:
        fail(f"the tile path launched the camera kernel {stray} times")
    done = sum(q.done for q in eng.queries.values())
    served = len({r["qid"] for r in gpu_trace})
    lat = np.asarray(tick_s) * 1e3
    base_tiles = TT * eng.admitted_steps
    counters = ("admitted_steps", "unique_frames", "admitted_tiles",
                "unique_tiles")
    say(f"[6 tiles] cuda: {len(tick_s)} ticks (horizon {horizon_ticks}), "
        f"{served} of {len(world.q_vids)} queries served, {done} done; "
        f"{len(t_rounds)} ranked rounds, reid_topk_tiles launches "
        f"{t_launches} (= non-empty rounds), reid_topk launches 0; "
        + " ".join(f"{c}={getattr(eng, c)}" for c in counters)
        + f"; admitted tiles {eng.admitted_tiles} of {base_tiles} "
        f"camera-granular ({base_tiles / max(eng.admitted_tiles, 1):.3f}x), "
        f"unique {eng.unique_tiles} of {TT * eng.unique_frames}; "
        f"matches={sum(len(q.matches) for q in eng.queries.values())}; "
        f"{len(tick_s) / sum(tick_s):.1f} ticks/s; tick p50 "
        f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} "
        f"ms")

    live = [0, 0]

    def count_live(a):
        n_live, n_total = live_tiles(torch, a)
        live[0] += n_live
        live[1] += n_total

    cpu_trace = []
    t0 = time.perf_counter()
    real_call, ops.reid_topk_tiles = recorder("reid_topk_tiles", [], None,
                                              count_live)
    try:
        eng_cpu, _ = serve_tiles("cpu", cpu_trace)
    finally:
        ops.reid_topk_tiles = real_call
    n, parted = compare_traces(gpu_trace, cpu_trace, policy.match_thresh)
    if parted is None and any(getattr(eng_cpu, c) != getattr(eng, c)
                              for c in counters):
        fail("cuda and cpu tile runs disagree on the cost counters: "
             + " ".join(f"{c} {getattr(eng, c)}/{getattr(eng_cpu, c)}"
                        for c in counters))
    live_share = live[0] / max(live[1], 1)
    say(f"[6 tiles] cpu rerun (plain versions) in "
        f"{time.perf_counter() - t0:.1f} s: {n} of {len(gpu_trace)} trace "
        f"records agree"
        + ("; all four cost counters equal" if parted is None else
           f"; query {parted} parted at a near-threshold record, so the "
           f"cost counters are not compared")
        + f"; live (32-row, 64-row) tiles over the run's rounds: {live[0]} "
          f"of {live[1]} ({100 * live_share:.2f} %)")

    device_share(torch, serve_tiles, "[6 tiles]", ticks=TICKS)

    # -- phase 7: the tile path's round shapes ----------------------------
    t_shapes = sorted(t_kept, key=lambda s: s[0] * s[1])
    t_main = max(t_kept, key=lambda s: (t_rounds.count(s), s[0] * s[1]))
    largest = t_shapes[-1]
    for shape in t_shapes:
        args, k = t_kept[shape]
        err = check_against_plain(torch, tiles, f"tile round {shape}", args,
                                  k, exact_idx=False)
        max_err[TILES["name"]] = max(max_err[TILES["name"]], err)
    say(f"[7 tile rounds] {len(t_shapes)} round shapes (Q, G), all agree "
        f"with the plain version (max abs err "
        f"{max_err[TILES['name']]:.3g}); the most frequent is "
        f"Q={t_main[0]} G={t_main[1]} ({t_rounds.count(t_main)} rounds), "
        f"the largest Q={largest[0]} G={largest[1]}")
    t_timings = {}
    for shape in dict.fromkeys((t_main, largest)):
        args, k = t_kept[shape]
        _, t_timings[shape] = check_and_time(
            torch, tiles, lib, f"tile round {shape}", args, k,
            exact_idx=False)
    row = t_timings[t_main]
    args, k = t_kept[t_main]
    big = t_timings[largest]
    tiles_row = dict(
        launches=t_launches, max_abs_err=max_err[TILES["name"]],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=dict(Q=t_main[0], G=t_main[1], D=int(args[0].shape[1]),
                   CT=int(args[2].shape[1]), k=k),
        largest=dict(Q=largest[0], G=largest[1], ms=big["ms"],
                     plain_ms=big["plain_ms"], library_ms=big["library_ms"],
                     bound_ms=big["bound_ms"], bound_by=big["bound_by"]),
        live_tile_share=live_share,
        stress=dict(Q=256, G=8192, D=2048, CT=130 * TT, k=16, ms=st_t["ms"],
                    plain_ms=st_t["plain_ms"],
                    library_ms=st_t["library_ms"],
                    bound_ms=st_t["bound_ms"], bound_by=st_t["bound_by"]))

    say(smi)
    say(json.dumps({"kernels": [
        dict(CAMERA, **camera_row),
        dict(TILES, **tiles_row)]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
