"""The port's ``ServingEngine`` against ``repro``'s on the same world and M.

The reference runs under ``conftest.drive_serving_trace`` (the Pallas
kernels in interpret mode); the port runs on the CPU with the same M
carried across by ``convert.model_from_numpy``.  Every trace field is exact
except ``match_val`` and the top-k band values (fp32 scores, 1e-5); the
summary counters, the tile plane's included, are exact."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import drive_serving_trace, make_serving_world, trace_key
from repro.core.policy import SearchPolicy as JPolicy
from repro.core.profiler import build_model as j_build_model
from repro_torch import api
from repro_torch.convert import model_from_numpy
from repro_torch.core.correlation import FIELDS
from repro_torch.core.policy import SearchPolicy
from repro_torch.launch.serve import World, run_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
POLICY = dict(scheme="rexcam", s_thresh=.05, t_thresh=.02, exit_t=60)


@functools.lru_cache(maxsize=None)
def _world(seed=0):
    return make_serving_world(seed=seed, n_queries=4)


@functools.lru_cache(maxsize=None)
def _j_tile_model(seed, T):
    """The reference's ``profile(..., tile_grid=T)`` of the world's visits
    on its profile partition (the same ``time_limit`` as its M)."""
    vis = _world(seed)["vis"]
    return j_build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, vis.n_cams,
                         time_limit=int(vis.horizon * 0.7),
                         tile_xy=vis.tile_xy, tile_grid=T)


def _port_model(world, m=None):
    m = world["model"] if m is None else m
    tiles = getattr(m, "tile_admit", None)
    return model_from_numpy({f: np.asarray(getattr(m, f)) for f in FIELDS},
                            m.bin_width, m.epoch,
                            tile_admit=None if tiles is None
                            else np.asarray(tiles),
                            tile_grid=getattr(m, "tile_grid", 0),
                            tile_learned=getattr(m, "tile_learned", False))


@functools.lru_cache(maxsize=None)
def _reference(seed, policy_items, kw_items, learned_T=0):
    kw = dict(kw_items)
    if learned_T:
        kw["model"] = _j_tile_model(seed, learned_T)
    eng, trace, summary = drive_serving_trace(
        _world(seed), JPolicy(**dict(policy_items)), **kw)
    summary = dict(summary, admitted_tiles=eng.admitted_tiles,
                   unique_tiles=eng.unique_tiles)
    return trace, summary


def _drive_port(world, policy, model=None, **kw):
    eng = api.serve(model if model is not None else _port_model(world),
                    lambda x: x, policy,
                    geo_adj=world["net"].geo_adjacent, device="cpu", **kw)
    vis = world["vis"]
    trace = []
    ticks = vis.horizon + 500 - int(vis.t_out[world["q_vids"]].min())
    run_stream(eng, World(world["net"], vis, world["gal"], world["feats"],
                          world["q_vids"]), ticks, trace)
    summary = dict(
        admitted_steps=eng.admitted_steps, unique_frames=eng.unique_frames,
        content_steps=eng.content_steps, replay_steps=eng.replay_steps,
        rescue_pairs=eng.rescue_pairs.copy(), model_epoch=eng.model_epoch,
        model_swaps=list(eng.model_swaps),
        per_query=[(q.matches, q.rescued, q.done, q.phase, q.f_curr)
                   for q in eng.queries.values()],
        admitted_tiles=eng.admitted_tiles, unique_tiles=eng.unique_tiles)
    return eng, trace, summary


def _close(a, b):
    return abs(a - b) <= TOL * (1 + abs(b))


def assert_traces_match(port, ref):
    assert len(port) == len(ref)
    for n, (p, r) in enumerate(zip(port, ref)):
        for f in ("qid", "f_curr", "phase", "epoch", "matched", "match_cam",
                  "match_idx"):
            assert p[f] == r[f], (n, f, p, r)
        np.testing.assert_array_equal(np.asarray(p["mask"], bool),
                                      np.asarray(r["mask"], bool))
        assert _close(p["match_val"], r["match_val"]), (n, p, r)
        assert len(p["topk"]) == len(r["topk"])
        for (pv, pc, pf), (rv, rc, rf) in zip(p["topk"], r["topk"]):
            assert (pc, pf) == (rc, rf) and _close(pv, rv), (n, p, r)


ENGINE_CASES = [
    (0, POLICY, dict(consolidate=True, topk=1)),
    (0, POLICY, dict(consolidate=False, topk=1)),
    (0, POLICY, dict(consolidate=True, topk=3)),
    (0, POLICY, dict(consolidate=False, topk=3)),
    (0, POLICY, dict(consolidate=True, topk=3, topk_rerank=True)),
    (0, POLICY, dict(consolidate=True, topk=1, topk_rerank=True)),
    (1, dict(POLICY, exit_t=120, replay_skip=2), dict(topk=2)),
    (2, dict(POLICY, scheme="geo"), dict(consolidate=False, topk=1)),
]


@pytest.mark.parametrize("seed,pol,kw", ENGINE_CASES,
                         ids=lambda x: str(x) if not isinstance(x, dict)
                         else "-".join(f"{k}={v}" for k, v in x.items()))
def test_engine_matches_reference(seed, pol, kw):
    ref_trace, ref_sum = _reference(seed, tuple(sorted(pol.items())),
                                    tuple(sorted(kw.items())))
    _, trace, summary = _drive_port(_world(seed), SearchPolicy(**pol), **kw)
    assert_traces_match(trace, ref_trace)
    for f in ("admitted_steps", "unique_frames", "content_steps",
              "replay_steps", "model_epoch", "model_swaps", "per_query"):
        assert summary[f] == ref_sum[f], f
    np.testing.assert_array_equal(summary["rescue_pairs"],
                                  ref_sum["rescue_pairs"])
    assert any(r["matched"] for r in trace)


def test_consolidated_and_per_frame_paths_identical():
    world = _world(0)
    _, a, sa = _drive_port(world, SearchPolicy(**POLICY), topk=3)
    _, b, sb = _drive_port(world, SearchPolicy(**POLICY), topk=3,
                           consolidate=False)
    assert trace_key(a) == trace_key(b)
    assert sa["per_query"] == sb["per_query"]


def test_swap_model_bumps_epoch_between_rounds():
    world = _world(0)
    eng = api.serve(_port_model(world), lambda x: x, SearchPolicy(**POLICY),
                    device="cpu")
    assert eng.swap_model(_port_model(world)) == 1
    assert eng.model.epoch == 1 and eng.model_swaps == [(0, 1)]


@pytest.mark.parametrize("kw,kind,n", [
    (dict(shards=2), "fleet", 2),
    (dict(prefetch=True), "single", 1),
    (dict(devices=["cpu", "cpu"]), "fleet", 2),
    (dict(transport="inproc"), "raises", 0),
    (dict(shards=3, transport="inproc", prefetch=True), "fleet", 3),
    (dict(gallery="sharded"), "raises", 0),
], ids=["shards", "prefetch", "devices", "transport-alone", "fleet-transport",
        "sharded-alone"])
def test_unported_serve_options_raise(kw, kind, n):
    """The fleet keywords behave as the reference's: ``shards`` and
    ``devices`` build a ``ShardedServingEngine`` (``shards`` workers on the
    engine's device, or one a listed device), ``prefetch`` alone gives the
    single engine a pipeline, and ``transport`` or ``gallery='sharded'``
    without a fleet raise the reference's ``ValueError``."""
    from repro import api as japi
    from repro_torch.runtime.fleet import ShardedServingEngine
    from repro_torch.runtime.transport import PrefetchPipeline

    world = _world(0)
    if kind == "raises":
        with pytest.raises(ValueError) as port_err:
            api.serve(_port_model(world), lambda x: x, device="cpu", **kw)
        with pytest.raises(ValueError) as ref_err:
            japi.serve(world["model"], lambda x: x, **kw)
        assert str(port_err.value) == str(ref_err.value)
        return
    eng = api.serve(_port_model(world), lambda x: x, device="cpu", **kw)
    assert isinstance(eng, ShardedServingEngine) == (kind == "fleet")
    if kind == "fleet":
        assert eng.n_shards == n and eng.gallery.kind == "sharded"
        assert all(d == torch.device("cpu") for d in eng._device_of.values())
    assert isinstance(eng._prefetch, PrefetchPipeline) == \
        bool(kw.get("prefetch"))
    if "transport" in kw:
        assert eng.gallery.transport.kind == "inproc"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    world = _world(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.serve(_port_model(world), lambda x: x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.profile(world["vis"])


def test_serve_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--queries", "2", "--steps", "5"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "device='cpu'" in r.stderr


# -- the tile plane -----------------------------------------------------------

# (seed, policy, serve keywords, learned): learned=True serves the port's
# copy of the reference's profile(..., tile_grid=T); False a tile-less M,
# for which both engines synthesise the all-admitted masks
TILE_CASES = [
    (0, POLICY, dict(tile_grid=4, consolidate=True, topk=1), False),
    (0, POLICY, dict(tile_grid=8, consolidate=False, topk=3), False),
    (0, POLICY, dict(tile_grid=4, consolidate=True, topk=1), True),
    (0, POLICY, dict(tile_grid=4, consolidate=False, topk=3), True),
    (0, POLICY, dict(tile_grid=8, consolidate=True, topk=3), True),
    (0, POLICY, dict(tile_grid=8, consolidate=True, topk=3,
                     topk_rerank=True), True),
    (0, POLICY, dict(tile_grid=8, consolidate=False, topk=1,
                     topk_rerank=True), True),
    (1, dict(POLICY, exit_t=120, replay_skip=2), dict(tile_grid=8, topk=2),
     True),
]


@pytest.mark.parametrize("seed,pol,kw,learned", TILE_CASES,
                         ids=lambda x: str(x) if not isinstance(x, dict)
                         else "-".join(f"{k}={v}" for k, v in x.items()))
def test_tile_engine_matches_reference(seed, pol, kw, learned):
    T = kw["tile_grid"]
    ref_trace, ref_sum = _reference(seed, tuple(sorted(pol.items())),
                                    tuple(sorted(kw.items())),
                                    T if learned else 0)
    world = _world(seed)
    model = _port_model(world, _j_tile_model(seed, T)) if learned else None
    eng, trace, summary = _drive_port(world, SearchPolicy(**pol),
                                      model=model, **kw)
    assert_traces_match(trace, ref_trace)
    for f in ("admitted_steps", "unique_frames", "content_steps",
              "replay_steps", "model_epoch", "model_swaps", "per_query",
              "admitted_tiles", "unique_tiles"):
        assert summary[f] == ref_sum[f], f
    np.testing.assert_array_equal(summary["rescue_pairs"],
                                  ref_sum["rescue_pairs"])
    assert any(r["matched"] for r in trace)
    TT = T * T
    if learned:
        assert eng.model.tile_learned
        assert summary["admitted_tiles"] < TT * summary["admitted_steps"]
        assert any(q.tile_q >= 0 for q in eng.queries.values())
    else:
        assert summary["admitted_tiles"] == TT * summary["admitted_steps"]


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("kw", [dict(topk=3), dict(topk=1, consolidate=False),
                                dict(topk=3, topk_rerank=True)],
                         ids=["topk3", "per_frame", "rerank"])
def test_all_tiles_admitted_equals_camera_path(T, kw):
    """Over a tile-less M the tile path is the camera path: the same trace
    and counters, with the tile counters T*T times the camera ones."""
    world = _world(0)
    policy = SearchPolicy(**POLICY)
    _, cam, cam_sum = _drive_port(world, policy, **kw)
    eng, tile, tile_sum = _drive_port(world, policy, tile_grid=T, **kw)
    assert trace_key(tile) == trace_key(cam)
    for f in ("admitted_steps", "unique_frames", "content_steps",
              "replay_steps", "per_query"):
        assert tile_sum[f] == cam_sum[f], f
    assert eng.admitted_tiles == T * T * eng.admitted_steps > 0
    assert eng.unique_tiles == T * T * eng.unique_frames
    assert cam_sum["admitted_tiles"] == cam_sum["unique_tiles"] == 0


def test_tile_ingest_requires_labels():
    world = make_serving_world(n_entities=60, horizon=240, seed=3,
                               n_queries=2)
    eng = api.serve(_port_model(world), lambda x: x, SearchPolicy(),
                    tile_grid=4, device="cpu")
    crops = np.zeros((3, world["feats"].shape[1]), np.float32)
    with pytest.raises(ValueError, match="tile labels"):
        eng.ingest({0: crops})
    with pytest.raises(ValueError, match="tile labels"):
        eng.ingest({0: crops}, {1: np.zeros(3, np.int32)})
    with pytest.raises(ValueError, match="3 detections"):
        eng.ingest({0: crops}, {0: np.zeros(2, np.int32)})
    eng.ingest({0: crops}, {0: np.zeros(3, np.int32)})   # labeled: accepted
    assert eng.store.get_tile(0, eng.t).tolist() == [0, 0, 0]


def test_tile_grid_mismatch_raises():
    world = _world(0)
    model = _port_model(world, _j_tile_model(0, 4))
    with pytest.raises(ValueError, match="tile_grid mismatch"):
        api.serve(model, lambda x: x, tile_grid=8, device="cpu")


def test_swap_model_carries_tile_masks():
    """A swapped-in M without tile data keeps the incumbent masks; one
    profiled at the serving grid brings its own; another grid raises."""
    world = _world(0)
    learned = _port_model(world, _j_tile_model(0, 4))
    eng = api.serve(learned, lambda x: x, SearchPolicy(**POLICY),
                    tile_grid=4, device="cpu")
    incumbent = eng.model.tile_admit
    assert eng.swap_model(_port_model(world)) == 1
    assert eng.model.tile_admit is incumbent and eng.model.tile_learned
    assert eng.model.tile_grid == 4 and eng.model.epoch == 1
    fresh = dataclasses.replace(learned, tile_admit=~learned.tile_admit)
    assert eng.swap_model(fresh) == 2
    assert torch.equal(eng.model.tile_admit, ~incumbent)
    with pytest.raises(ValueError, match="tile_grid mismatch"):
        eng.swap_model(_port_model(world, _j_tile_model(0, 8)))
    # a tile-less engine synthesises all-admitted masks, and keeps them
    eng = api.serve(_port_model(world), lambda x: x, tile_grid=4,
                    device="cpu")
    assert eng.model.tile_admit.all() and not eng.model.tile_learned
    eng.swap_model(_port_model(world))
    assert eng.model.tile_admit.all() and eng.model.tile_admit.shape == \
        (8, 8, 16)


@pytest.mark.parametrize("rerank", [False, True])
def test_follow_tile_takes_the_matched_band(rerank):
    """A confirmed match pins the query to its matched gallery row's tile
    (``repro.runtime.engine``'s follow update): band 0's row, or under
    re-ranking the first band of the winning camera; an unmatched query,
    or a row without a cell, keeps its tile."""
    world = _world(0)
    eng = api.serve(_port_model(world), lambda x: x, topk=3,
                    topk_rerank=rerank, tile_grid=4, device="cpu")
    for qid in range(4):
        eng.submit_query(qid, np.ones(4, np.float32), 0, 10)
    qs = list(eng.queries.values())
    qs[3].tile_q = 7
    matched = np.array([True, True, False, True])
    match_cam = np.array([2, 5, 0, 1], np.int32)
    topk_cam = np.array([[5, 2, 2], [5, 5, 2], [1, 1, 1], [3, 1, 1]],
                        np.int32)
    topk_idx = np.array([[0, 1, 2], [3, 4, 5], [0, 1, 2], [0, 6, 1]],
                        np.int32)
    gal_ct = np.array([5 * 16 + 3, 2 * 16 + 9, 2 * 16 + 1, 5 * 16 + 15,
                       5 * 16 + 2, 2 * 16, -1], np.int32)
    eng._follow_tiles(qs, matched, match_cam, topk_idx, topk_cam, gal_ct,
                      np.arange(4))
    if rerank:
        # query 0: camera 2 won, first at band 1 (row 1, tile 9); query 3:
        # camera 1 won at band 1, row 6, which has no cell
        assert [q.tile_q for q in qs] == [9, 15, -1, 7]
    else:
        assert [q.tile_q for q in qs] == [3, 15, -1, 3]
