"""The port's §6 recalibration loop against ``repro``'s, on the host.

Both controllers run over stub engines (the surface the controller
touches: model, rescue matrix, ``swap_model``, wall tick) fed the same
rescue matrices under the same clock, on the scenarios of
``tests/test_recal.py``; their events, polls, swap ticks and every array
of every swapped-in model must be equal.  ``splice_rows`` and
``merge_reprofiled_rows`` are held to the reference's bit for bit and the
merge to the port's own full ``build_model`` on untouched rows;
``drift_score``, ``profiling_cost`` and the two trajectory sources to the
reference's exactly."""
import numpy as np
import pytest
import torch

from repro.core import correlation as j_corr
from repro.core import profiler as j_prof
from repro.core.simulate import Visits as JVisits
from repro.runtime import recal as j_recal
from repro_torch.core import correlation as t_corr
from repro_torch.core import profiler as t_prof
from repro_torch.core.simulate import Visits as TVisits
from repro_torch.runtime import recal as t_recal

FIELDS = ("S", "exit_frac", "cdf", "f0", "entry", "counts")


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_models_equal(a, b, tiles=False):
    """Every field bit for bit, the epoch and the bin width too."""
    for f in FIELDS + (("tile_admit",) if tiles else ()):
        np.testing.assert_array_equal(_arr(getattr(a, f)),
                                      _arr(getattr(b, f)), err_msg=f)
        assert _arr(getattr(a, f)).dtype == _arr(getattr(b, f)).dtype, f
    assert int(a.epoch) == int(b.epoch)
    assert a.bin_width == b.bin_width


# -- the two packages behind one interface -----------------------------------

class _Side:
    def __init__(self, name):
        self.name = name
        self.recal = j_recal if name == "jax" else t_recal
        self.prof = j_prof if name == "jax" else t_prof

    def build_model(self, *a, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.prof.build_model(*a, **kw)


SIDES = (_Side("jax"), _Side("port"))


class _StubEngine:
    """The engine surface the controller touches; records every swap."""

    def __init__(self, model):
        self.model = model
        self.C = model.n_cams
        self.rescue_pairs = np.zeros((self.C, self.C), np.int64)
        self.t = 0
        self.model_epoch = int(model.epoch)
        self.device = torch.device("cpu")
        self.swap_times: list[int] = []
        self.swapped: list = []

    def swap_model(self, model):
        self.model_epoch += 1
        self.model = model
        self.swap_times.append(self.t)
        self.swapped.append(model)
        return self.model_epoch


def _toy_model(side, n_cams=4, epoch=0):
    ent = np.array([0, 0, 0, 1, 1, 1])
    cam = np.array([0, 1, 2, 0, 1, 2])
    t_in = np.array([0, 20, 40, 100, 120, 140])
    t_out = np.array([5, 25, 45, 105, 125, 145])
    return side.build_model(ent, cam, t_in, t_out, n_cams, epoch=epoch)


def _source():
    ent = np.array([0, 0, 1, 1])
    cam = np.array([0, 3, 0, 3])
    t_in = np.array([0, 30, 60, 95])
    t_out = np.array([5, 35, 65, 100])
    return lambda lo, hi: (ent, cam, t_in, t_out)


def _empty_source():
    z = np.zeros(0, np.int64)
    return lambda lo, hi: (z, z, z, z)


# -- the controller scenarios of tests/test_recal.py, as scripts ------------
# Each script drives (engine, controller, now) through ticks and rescue
# updates and returns what it observed beyond the controller's own record.

def _hysteresis(eng, ctl, now):
    for t in range(0, 100, 5):
        now[0] = eng.t = t
        eng.rescue_pairs[:] = 0
        eng.rescue_pairs[2, 3] = 1 if (t // 5) % 2 == 0 else 0
        eng.rescue_pairs[0, 2] = 4
        ctl.on_tick()
    for t in range(100, 160, 5):
        now[0] = eng.t = t
        eng.rescue_pairs[2, 3] = 1
        ctl.on_tick()


def _min_rescue_guard(eng, ctl, now):
    eng.rescue_pairs[2, 3] = 7
    scores = [float(ctl.score().max())]
    for t in range(30):
        now[0] = eng.t = t
        ctl.on_tick()
    eng.rescue_pairs[2, 3] = 8
    now[0] = eng.t = 30
    ctl.on_tick()
    return scores


def _cadence(eng, ctl, now):
    for t in range(35):
        now[0] = eng.t = t
        ctl.on_tick()


def _rescue_reset(eng, ctl, now):
    eng.rescue_pairs[2, 3] = 5
    ctl.on_tick()
    after = int(eng.rescue_pairs.sum())
    for t in range(1, 40):
        now[0] = eng.t = t
        ctl.on_tick()
    return [after]


def _one_tick(hot_rows, mild=()):
    """Five rescues on (r, 3) for each hot row (a never-profiled pair),
    one on each (r, c) of ``mild``, then one poll."""
    def script(eng, ctl, now):
        for r in hot_rows:
            eng.rescue_pairs[r, 3] = 5
        for r, c in mild:
            eng.rescue_pairs[r, c] = 1
        return [ctl.on_tick()]
    return script


CONTROLLER_CASES = {
    # name: (policy keywords, source, script)
    "hysteresis": (dict(drift_threshold=.1, min_rescues=4, cooldown=100,
                        poll_every=5, window=200, reset_rescues=False),
                   _source, _hysteresis),
    "min_rescue_guard": (dict(drift_threshold=.1, min_rescues=8, cooldown=50,
                              poll_every=1), _source, _min_rescue_guard),
    "poll_cadence": (dict(poll_every=10), _source, _cadence),
    "rescue_reset": (dict(drift_threshold=.1, min_rescues=2, cooldown=10,
                          poll_every=1, reset_rescues=True), _source,
                     _rescue_reset),
    "empty_window": (dict(drift_threshold=.1, min_rescues=1, cooldown=1,
                          poll_every=1), _empty_source, _one_tick([2])),
    "targeted_rows": (dict(drift_threshold=.1, min_rescues=1, cooldown=1,
                           poll_every=1, targeted=True), _source,
                      _one_tick([2])),
    "targeted_row_threshold": (dict(drift_threshold=.1, min_rescues=1,
                                    cooldown=1, poll_every=1, targeted=True,
                                    row_threshold=.01), _source,
                               _one_tick([0, 2])),
    # row 0's mild score (1 / (2 + 3)) trips drift_threshold but not
    # row_threshold: only row 2 is re-profiled
    "targeted_row_threshold_narrows": (dict(drift_threshold=.1,
                                            min_rescues=1, cooldown=1,
                                            poll_every=1, targeted=True,
                                            row_threshold=1.0), _source,
                                       _one_tick([2], mild=[(0, 1)])),
    "full_rebuild": (dict(drift_threshold=.1, min_rescues=1, cooldown=1,
                          poll_every=1, targeted=False), _source,
                     _one_tick([2])),
}


def _run_case(side, name):
    kw, source, script = CONTROLLER_CASES[name]
    eng = _StubEngine(_toy_model(side))
    now = [0]
    ctl = side.recal.RecalibrationController(
        eng, source(), side.recal.RecalibrationPolicy(**kw),
        clock=lambda: now[0])
    seen = script(eng, ctl, now)
    return eng, ctl, seen


@pytest.mark.parametrize("name", list(CONTROLLER_CASES))
def test_controller_matches_reference(name):
    (je, jc, jseen), (te, tc, tseen) = (_run_case(s, name) for s in SIDES)
    assert te.swap_times == je.swap_times
    assert tc.events == jc.events
    assert list(tc.polls) == list(jc.polls)
    assert tc.polls.maxlen == jc.polls.maxlen == 512
    for f in ("rows_reprofiled", "full_rebuilds", "targeted_swaps"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert te.model_epoch == je.model_epoch
    np.testing.assert_array_equal(te.rescue_pairs, je.rescue_pairs)
    assert len(te.swapped) == len(je.swapped)
    for tm, jm in zip(te.swapped, je.swapped):
        assert_models_equal(tm, jm)
    if jseen is not None:
        for a, b in zip(tseen, jseen):
            assert a == b
    assert len(tc.walls) == len(tc.events)
    assert (tc.profile_wall > 0.0) == bool(tc.events)


def test_controller_scenarios_behave():
    """The port's own controller on the reference test's assertions."""
    port = SIDES[1]
    eng, ctl, _ = _run_case(port, "hysteresis")
    assert eng.swap_times == [0, 100] and eng.model_epoch == 2
    assert [e["epoch"] for e in ctl.events] == [1, 2]
    eng, ctl, scores = _run_case(port, "min_rescue_guard")
    assert scores[0] > .1 and eng.swap_times == [30]
    eng, ctl, _ = _run_case(port, "poll_cadence")
    assert [p["t"] for p in ctl.polls] == [0, 10, 20, 30]
    assert all(p["score"] == 0.0 and p["rescues"] == 0 for p in ctl.polls)
    eng, ctl, after = _run_case(port, "rescue_reset")
    assert eng.swap_times == [0] and after == [0]
    eng, ctl, ev = _run_case(port, "empty_window")
    assert ev == [None] and eng.swap_times == [] and ctl.events == []
    eng, ctl, (ev,) = _run_case(port, "targeted_rows")
    assert ev["mode"] == "targeted" and ev["row_ids"] == [2]
    assert ctl.targeted_swaps == 1 and ctl.rows_reprofiled == 1
    eng, ctl, (ev,) = _run_case(port, "targeted_row_threshold")
    assert ev["row_ids"] == [0, 2] and ctl.rows_reprofiled == 2
    eng, ctl, (ev,) = _run_case(port, "targeted_row_threshold_narrows")
    assert ev["row_ids"] == [2] and ctl.rows_reprofiled == 1
    eng, ctl, (ev,) = _run_case(port, "full_rebuild")
    assert ev["mode"] == "full" and ev["row_ids"] is None
    assert ev["rows"] == ctl.rows_reprofiled == eng.C
    assert ctl.full_rebuilds == 1 and ctl.targeted_swaps == 0


def test_targeted_swap_carries_untouched_rows():
    """The targeted swap's untouched rows are the old model's; the hot row
    and ``entry`` are a full rebuild's over the window."""
    eng, ctl, _ = _run_case(SIDES[1], "targeted_rows")
    old, new = _toy_model(SIDES[1]), eng.model
    np.testing.assert_array_equal(new.S[[0, 1, 3]].numpy(),
                                  old.S[[0, 1, 3]].numpy())
    full = SIDES[1].build_model(*_source()(0, 0), eng.C)
    np.testing.assert_array_equal(new.S[2].numpy(), full.S[2].numpy())
    np.testing.assert_array_equal(new.entry.numpy(), full.entry.numpy())


# -- row-targeted re-profiling: splice and merge ------------------------------

def _soak_windows(C=6, rows=(1, 4), seed=0):
    """Two visit windows sharing their non-drifted traffic bit for bit:
    ``shared`` entities walk only the complement cameras, the drift
    entities stay inside ``rows`` (``tests/test_recal.py``'s generator).
    Returns two (ent, cam, t_in, t_out, tile_xy) tuples."""
    rng = np.random.default_rng(seed)
    keep = [c for c in range(C) if c not in rows]

    def walk(eid, cams, n_hops, t0):
        e, c, ti, to, xy = [], [], [], [], []
        t = t0
        for _ in range(n_hops):
            e.append(eid)
            c.append(int(rng.choice(cams)))
            ti.append(t)
            to.append(t + int(rng.integers(1, 4)))
            xy.append(rng.uniform(0, 1, 2))
            t = to[-1] + int(rng.integers(2, 8))
        return e, c, ti, to, xy

    shared = [walk(e, keep, 5, e * 3) for e in range(6)]

    def window(drift_seed):
        drng = np.random.default_rng(drift_seed)
        parts = [list(map(list, s)) for s in shared]
        for e in range(6, 10):
            t = int(drng.integers(0, 10))
            ent_d, cam_d, ti_d, to_d, xy_d = [], [], [], [], []
            for _ in range(4):
                ent_d.append(e)
                cam_d.append(int(drng.choice(rows)))
                ti_d.append(t)
                to_d.append(t + int(drng.integers(1, 4)))
                xy_d.append(drng.uniform(0, 1, 2))
                t = to_d[-1] + int(drng.integers(2, 8))
            parts.append([ent_d, cam_d, ti_d, to_d, xy_d])
        ent = np.concatenate([p[0] for p in parts]).astype(np.int64)
        cam = np.concatenate([p[1] for p in parts]).astype(np.int64)
        t_in = np.concatenate([p[2] for p in parts]).astype(np.int64)
        t_out = np.concatenate([p[3] for p in parts]).astype(np.int64)
        xy = np.concatenate([np.asarray(p[4]).reshape(-1, 2) for p in parts])
        return ent, cam, t_in, t_out, xy

    return window(seed + 100), window(seed + 200)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_reference_and_full_rebuild(seed):
    """The merge equals the reference's bit for bit, and (the windows
    sharing their non-drifted traffic) the port's own full rebuild on the
    new window, tile masks and epoch included."""
    C, R, T = 6, (1, 4), 4
    (ea, ca, ia, oa, xya), (eb, cb, ib, ob, xyb) = _soak_windows(C, R, seed)
    merged = {}
    for side in SIDES:
        old = side.build_model(ea, ca, ia, oa, C, n_bins=32, bin_width=2,
                               tile_xy=xya, tile_grid=T, epoch=4)
        merged[side.name] = side.prof.merge_reprofiled_rows(
            old, eb, cb, ib, ob, R, tile_xy=xyb, epoch=5)
    assert_models_equal(merged["port"], merged["jax"], tiles=True)
    full = SIDES[1].build_model(eb, cb, ib, ob, C, n_bins=32, bin_width=2,
                                tile_xy=xyb, tile_grid=T, epoch=5)
    assert_models_equal(merged["port"], full, tiles=True)
    assert merged["port"].tile_grid == T and merged["port"].tile_learned


@pytest.mark.parametrize("rows", [(1, 4), (0,), (5, 2, 2)])
def test_merge_without_tiles_carries_old_tile_rows(rows):
    """Without window positions the incumbent masks ride forward whole;
    untouched rows are the old model's; the result equals the reference."""
    C = 6
    (ea, ca, ia, oa, xya), (eb, cb, ib, ob, _) = _soak_windows(C, (1, 4), 3)
    out = {}
    for side in SIDES:
        old = side.build_model(ea, ca, ia, oa, C, tile_xy=xya, tile_grid=4)
        out[side.name] = (old, side.prof.merge_reprofiled_rows(
            old, eb, cb, ib, ob, rows))
    (t_old, t_new), (_, j_new) = out["port"], out["jax"]
    assert_models_equal(t_new, j_new, tiles=True)
    np.testing.assert_array_equal(t_new.tile_admit.numpy(),
                                  t_old.tile_admit.numpy())
    keep = [c for c in range(C) if c not in rows]
    for f in ("S", "cdf", "f0", "counts"):
        np.testing.assert_array_equal(getattr(t_new, f)[keep].numpy(),
                                      getattr(t_old, f)[keep].numpy())
    assert int(t_new.epoch) == int(t_old.epoch)


def test_splice_rows_matches_reference():
    """float64 blocks spliced in the base's dtype, as numpy casts them."""
    (ea, ca, ia, oa, _), _ = _soak_windows()
    rng = np.random.default_rng(7)
    updates = dict(S=rng.uniform(size=(2, 6)),
                   cdf=rng.uniform(size=(2, 6, 256)),
                   f0=rng.integers(0, 2 ** 30, size=(2, 6)),
                   counts=rng.uniform(0, 50, size=(2, 6)))
    entry = rng.uniform(size=6)
    out = [side_mod.splice_rows(side.build_model(ea, ca, ia, oa, 6),
                                [3, 0], updates, entry=entry, epoch=9)
           for side, side_mod in zip(SIDES, (j_corr, t_corr))]
    assert_models_equal(out[1], out[0])
    assert out[1].f0.dtype == torch.int32 and out[1].epoch == 9


def test_splice_and_merge_raise_as_reference():
    (ea, ca, ia, oa, _), _ = _soak_windows()
    old = SIDES[1].build_model(ea, ca, ia, oa, 6)
    with pytest.raises(ValueError, match="not row-local"):
        t_corr.splice_rows(old, [0], {"entry": np.zeros((1,))})
    with pytest.raises(ValueError, match="no 'tile_admit'"):
        t_corr.splice_rows(old, [0], {"tile_admit": np.ones((1, 6, 16),
                                                            bool)})
    for rows in ([], [0, 6], [-1]):
        with pytest.raises(ValueError, match="camera range"):
            t_prof.merge_reprofiled_rows(old, ea, ca, ia, oa, rows)


# -- drift_score, profiling_cost, the trajectory sources ---------------------

@pytest.mark.parametrize("smoothing", [3.0, 0.5, 0.0])
def test_drift_score_matches_reference(smoothing):
    (ea, ca, ia, oa, _), _ = _soak_windows(seed=5)
    rng = np.random.default_rng(11)
    rescues = rng.integers(0, 4, size=(6, 6)) * (rng.uniform(size=(6, 6))
                                                 < .3)
    for r in (rescues, np.zeros((6, 6), np.int64)):
        j, t = (side.prof.drift_score(side.build_model(ea, ca, ia, oa, 6),
                                      r, smoothing) for side in SIDES)
        assert t.dtype == j.dtype == np.float64
        np.testing.assert_array_equal(t, j)
    assert np.isfinite(t).all()


def test_drift_score_reads_counts_once_per_model():
    """The host copy of ``counts`` is taken once per model object."""
    (ea, ca, ia, oa, _), _ = _soak_windows(seed=5)
    m = SIDES[1].build_model(ea, ca, ia, oa, 6)
    r = np.ones((6, 6), np.int64)
    t_prof.drift_score(m, r)
    assert m.host_counts is m.host_counts
    np.testing.assert_array_equal(m.host_counts,
                                  m.counts.numpy().astype(np.float64))


@pytest.mark.parametrize("kw", [dict(), dict(sample_every=4),
                                dict(time_limit=60), dict(sample_every=3,
                                                          time_limit=61)])
def test_profiling_cost_matches_reference(kw):
    (ea, ca, ia, oa, _), _ = _soak_windows(seed=2)
    assert t_prof.profiling_cost(ea, ca, ia, oa, **kw) == \
        j_prof.profiling_cost(ea, ca, ia, oa, **kw)


def test_visits_window_source_matches_reference():
    (ea, ca, ia, oa, _), _ = _soak_windows(seed=4)
    T = int(oa.max()) + 1
    j_src = j_recal.visits_window_source(JVisits(ea, ca, ia, oa, T, 6))
    t_src = t_recal.visits_window_source(TVisits(ea, ca, ia, oa, T, 6))
    for lo, hi in ((0, T), (10, 30), (40, 41), (T, T + 5)):
        for a, b in zip(t_src(lo, hi), j_src(lo, hi)):
            np.testing.assert_array_equal(a, b)
    assert t_src(10, 30)[0].size > 0


def test_match_log_source_matches_reference():
    class Log:
        sightings = [(0, 0, 10), (0, 1, 55), (0, 2, 99), (1, 0, 200),
                     (1, 3, 149)]
    for lo, hi in ((0, 150), (50, 100), (300, 400), (0, 1000)):
        j = j_recal.match_log_source(Log)(lo, hi)
        t = t_recal.match_log_source(Log)(lo, hi)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    ent, cam, t_in, t_out = t_recal.match_log_source(Log)(0, 150)
    m = SIDES[1].build_model(ent, cam, t_in, t_out, 4)
    assert float(m.counts[0, 1]) == float(m.counts[1, 2]) == 1.0
