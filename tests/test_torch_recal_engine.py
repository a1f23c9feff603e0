"""The port's engine with the §6 recalibration loop attached, against
``repro``'s on the same drifting worlds.

The reference runs under ``conftest.drive_serving_trace(...,
recalibrate=)`` (the Pallas kernels in interpret mode), the port on the
CPU with the same M carried across; every trace record is compared as in
``test_torch_engine.py`` (scores within 1e-5, the rest exact), and the
summaries, the swap ticks, the epochs, the controller's events, polls and
counters must be equal."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import drive_serving_trace, make_drifted_world, make_soak_world
from repro import api as japi
from repro.core.policy import SearchPolicy as JPolicy
from repro.core.profiler import build_model as j_build_model
from repro.core.simulate import duke_like_network, simulate_network
from repro.runtime.recal import RecalibrationPolicy as JRecal
from repro_torch import api
from repro_torch.core.policy import SearchPolicy
from repro_torch.core.simulate import tile_index
from repro_torch.runtime.recal import RecalibrationPolicy, \
    RecalibrationController
from test_torch_engine import TOL, _port_model, assert_traces_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = dict(scheme="rexcam", s_thresh=.05, t_thresh=.02, exit_t=120)
#: ``conftest.fleet_case_recalibration``'s trigger
DRIFT_RECAL = dict(drift_threshold=.02, min_rescues=2, cooldown=60,
                   poll_every=10, window=200)
#: ``conftest.fleet_case_soak``'s targeted trigger
SOAK_RECAL = dict(drift_threshold=.005, min_rescues=2, cooldown=80,
                  poll_every=10, window=250, targeted=True,
                  row_threshold=.02)


@functools.lru_cache(maxsize=None)
def _drifted():
    return make_drifted_world(seed=0, n_queries=8, horizon=500)


@functools.lru_cache(maxsize=None)
def _soak():
    return make_soak_world(seed=3, n_queries=8)


@functools.lru_cache(maxsize=None)
def _j_tile_model(T):
    """The drifted world's pre-shift history (``make_drifted_world``'s
    seed + 50) profiled with ``tile_grid=T``."""
    hist = simulate_network(duke_like_network(), 400, 900, seed=50)
    return j_build_model(hist.ent, hist.cam, hist.t_in, hist.t_out,
                         hist.n_cams, tile_xy=hist.tile_xy, tile_grid=T)


def drive(rexcam, world, policy, *, model=None, churn_wave=None,
          tile_grid=0, extra_ticks=500, **serve_kw):
    """``conftest.drive_serving_trace`` for either package's ``api``
    (``serve_kw`` carries ``recalibrate=``, ``visit_source=`` and, for the
    port, ``device=``): the same submits, churn wave, ingest, trace and
    early stop.  Returns (engine, trace, summary)."""
    vis, gal, feats = world["vis"], world["gal"], world["feats"]
    q_vids = world["q_vids"]
    vis_tiles = tile_index(vis.tile_xy, tile_grid) if tile_grid else None
    eng = rexcam.serve(world["model"] if model is None else model,
                       embed_fn=lambda x: x, policy=policy,
                       geo_adj=world["net"].geo_adjacent,
                       tile_grid=tile_grid, **serve_kw)
    t0 = int(vis.t_out[q_vids].min())
    eng.t = t0
    first = len(q_vids) if churn_wave is None else max(1, len(q_vids) // 2)
    for i in range(first):
        q = q_vids[i]
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    trace = []
    for step, t in enumerate(range(t0, vis.horizon + extra_ticks)):
        if churn_wave is not None and step == churn_wave:
            for j in range(first, len(q_vids)):
                q = q_vids[j]
                eng.submit_query(j, feats[q], int(vis.cam[q]),
                                 int(vis.t_out[q]))
        if t < vis.horizon:
            frames, tiles = {}, {}
            for c in range(vis.n_cams):
                vids = gal[c, t][gal[c, t] >= 0]
                if len(vids):
                    frames[c] = feats[vids]
                    if vis_tiles is not None:
                        tiles[c] = vis_tiles[vids]
            if tile_grid:
                eng.ingest(frames, tiles)
            else:
                eng.ingest(frames)
        eng.tick(record_trace=trace)
        if all(q.done for q in eng.queries.values()) and \
                (churn_wave is None or step >= churn_wave):
            break
    return eng, trace, summary_of(eng)


def summary_of(eng):
    return dict(
        admitted_steps=eng.admitted_steps, unique_frames=eng.unique_frames,
        content_steps=eng.content_steps, replay_steps=eng.replay_steps,
        rescue_pairs=eng.rescue_pairs.copy(), model_epoch=eng.model_epoch,
        model_swaps=list(eng.model_swaps),
        per_query=[(q.matches, q.rescued, q.done, q.phase, q.f_curr)
                   for q in eng.queries.values()])


def assert_engines_match(t_eng, t_trace, t_sum, j_eng, j_trace, j_sum):
    assert_traces_match(t_trace, j_trace)
    for f in ("admitted_steps", "unique_frames", "content_steps",
              "replay_steps", "model_epoch", "model_swaps", "per_query"):
        assert t_sum[f] == j_sum[f], f
    np.testing.assert_array_equal(t_sum["rescue_pairs"], j_sum["rescue_pairs"])
    tc, jc = t_eng.recal, j_eng.recal
    assert len(tc.events) == len(jc.events)
    for te, je in zip(tc.events, jc.events):
        assert abs(te["score"] - je["score"]) <= TOL * (1 + abs(je["score"]))
        assert {k: v for k, v in te.items() if k != "score"} == \
            {k: v for k, v in je.items() if k != "score"}
    assert [(p["t"], p["rescues"]) for p in tc.polls] == \
        [(p["t"], p["rescues"]) for p in jc.polls]
    np.testing.assert_allclose([p["score"] for p in tc.polls],
                               [p["score"] for p in jc.polls], rtol=TOL,
                               atol=TOL)
    for f in ("rows_reprofiled", "full_rebuilds", "targeted_swaps"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert int(t_eng.model.epoch) == t_eng.model_epoch
    assert len(t_eng.sightings) == len(j_eng.sightings)


def test_drifted_world_swaps_as_reference():
    """``fleet_case_recalibration``'s single engine: the swaps land on the
    reference's ticks, with rounds of both epochs in the trace."""
    world = _drifted()
    j_eng, j_trace, j_sum = drive_serving_trace(
        world, JPolicy(**POLICY), recalibrate=JRecal(**DRIFT_RECAL))
    t_eng, t_trace, t_sum = drive(
        api, world, SearchPolicy(**POLICY), model=_port_model(world),
        recalibrate=RecalibrationPolicy(**DRIFT_RECAL),
        visit_source=api.visits_window_source(world["vis"]), device="cpu")
    assert j_sum["model_epoch"] >= 1
    assert len({r["epoch"] for r in t_trace}) >= 2
    assert_engines_match(t_eng, t_trace, t_sum, j_eng, j_trace, j_sum)
    assert all(e["mode"] == "full" for e in t_eng.recal.events)


def test_soak_world_targeted_swaps_as_reference():
    """``fleet_case_soak``'s single engine: a late query wave and a
    row-targeted swap re-profiling a strict subset of the 32 rows."""
    world = _soak()
    C = world["net"].n_cams
    j_eng, j_trace, j_sum = drive_serving_trace(
        world, JPolicy(**POLICY), recalibrate=JRecal(**SOAK_RECAL),
        churn_wave=40)
    t_eng, t_trace, t_sum = drive(
        api, world, SearchPolicy(**POLICY), model=_port_model(world),
        churn_wave=40, recalibrate=RecalibrationPolicy(**SOAK_RECAL),
        visit_source=api.visits_window_source(world["vis"]), device="cpu")
    assert_engines_match(t_eng, t_trace, t_sum, j_eng, j_trace, j_sum)
    ctl = t_eng.recal
    assert ctl.targeted_swaps >= 1 and ctl.full_rebuilds == 0
    assert ctl.rows_reprofiled < C * ctl.targeted_swaps
    assert t_sum["replay_steps"] > 0
    for ev in ctl.events:
        assert ev["mode"] == "targeted" and 0 < ev["rows"] < C


@pytest.mark.parametrize("targeted", [False, True])
def test_tile_plane_recalibrates_as_reference(targeted):
    """Tile-learned M on the drifted world at ``tile_grid=4``: a re-profile
    without tile positions keeps serving the incumbent masks (a full
    rebuild through ``swap_model``'s carry, a targeted merge through its
    own), and the tile counters stay the reference's."""
    world, T = _drifted(), 4
    kw = dict(DRIFT_RECAL, targeted=targeted)
    j_model = _j_tile_model(T)
    j_eng, j_trace, j_sum = drive_serving_trace(
        world, JPolicy(**POLICY), recalibrate=JRecal(**kw), tile_grid=T,
        model=j_model)
    t_eng, t_trace, t_sum = drive(
        api, world, SearchPolicy(**POLICY), model=_port_model(world, j_model),
        tile_grid=T, recalibrate=RecalibrationPolicy(**kw),
        visit_source=api.visits_window_source(world["vis"]), device="cpu")
    assert_engines_match(t_eng, t_trace, t_sum, j_eng, j_trace, j_sum)
    assert (t_eng.admitted_tiles, t_eng.unique_tiles) == \
        (j_eng.admitted_tiles, j_eng.unique_tiles)
    assert t_eng.model_epoch >= 1 and t_eng.model.tile_learned
    np.testing.assert_array_equal(t_eng.model.tile_admit.numpy(),
                                  np.asarray(j_model.tile_admit))


def test_match_log_source_default_as_reference():
    """No ``visit_source``: both controllers re-profile from their engine's
    own sighting log (the reference driven by hand, ``visit_source=None``)."""
    world = _drifted()
    recal = dict(DRIFT_RECAL, window=300)
    j_eng, j_trace, j_sum = drive(japi, world, JPolicy(**POLICY),
                                  recalibrate=JRecal(**recal))
    t_eng, t_trace, t_sum = drive(
        api, world, SearchPolicy(**POLICY), model=_port_model(world),
        recalibrate=RecalibrationPolicy(**recal), device="cpu")
    assert t_eng.recal.visit_source is not None
    assert_engines_match(t_eng, t_trace, t_sum, j_eng, j_trace, j_sum)
    assert t_sum["model_epoch"] >= 1


@pytest.mark.parametrize("window", [None, 5, 200])
def test_sighting_log_bound_as_reference(window):
    """The log keeps what the longer of retention and the recalibration
    window can still reach: ``t - 2 * max(retention, window)``."""
    world = _drifted()
    kw = {} if window is None else dict(
        recalibrate=RecalibrationPolicy(window=window))
    jkw = {} if window is None else dict(recalibrate=JRecal(window=window))
    engines = [api.serve(_port_model(world), lambda x: x, retention=10,
                         device="cpu", **kw),
               japi.serve(world["model"], lambda x: x, retention=10, **jkw)]
    lengths = []
    for eng in engines:
        eng.sightings.extend((0, 0, f) for f in range(400))
        eng.t = 500
        eng.tick()
        lengths.append(len(eng.sightings))
        eng.sightings.append((0, 0, eng.t - 1))
        eng.tick()
        lengths.append(len(eng.sightings))
    assert lengths[:2] == lengths[2:]
    keep = 10 if window is None else max(10, window)
    assert lengths[0] == len([f for f in range(400) if f >= 501 - 2 * keep])


def test_serve_attaches_the_controller():
    world = _drifted()
    model = _port_model(world)
    assert api.serve(model, lambda x: x, device="cpu").recal is None
    eng = api.serve(model, lambda x: x, recalibrate=True, device="cpu")
    assert isinstance(eng.recal, RecalibrationController)
    assert eng.recal.policy == RecalibrationPolicy()
    custom = RecalibrationPolicy(drift_threshold=.3)
    eng = api.serve(model, lambda x: x, recalibrate=custom,
                    visit_source=api.visits_window_source(world["vis"]),
                    device="cpu")
    assert eng.recal.policy is custom and eng.recal.engine is eng
    with pytest.raises(TypeError, match="RecalibrationPolicy"):
        api.serve(model, lambda x: x, recalibrate=123, device="cpu")


def test_visit_source_without_recalibrate_raises_value_error():
    """visit_source= without recalibrate= raises ValueError."""
    world = _drifted()
    with pytest.raises(ValueError, match="visit_source"):
        api.serve(_port_model(world), lambda x: x,
                  visit_source=api.visits_window_source(world["vis"]),
                  device="cpu")


def test_recalibrating_serve_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    world = _drifted()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.serve(_port_model(world), lambda x: x, recalibrate=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.serve(_port_model(world), lambda x: x,
                  recalibrate=RecalibrationPolicy(),
                  visit_source=api.visits_window_source(world["vis"]))


def test_serve_cli_recalibrate_reports_the_loop():
    """``launch/serve.py --recalibrate`` attaches the controller (polls every
    20 ticks) and closes with the reference's recalibration line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", "--queries", "4", "--steps", "100",
                        "--recalibrate", "--recal-window", "300"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "recalibration [epoch 0]: 0 swaps, 5 polls (threshold 0.1, " \
        "cooldown 240, window 300)" in r.stdout, r.stdout
