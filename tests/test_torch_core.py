"""The port's world inputs, profiler and control plane against ``repro``.

Simulators, features and queries are numpy in both packages and must be
bit-identical per seed; every ``build_model`` field must be exactly equal;
``admit`` / ``advance`` / ``phase_windows`` must agree exactly on
randomized batched states (float32 threshold arithmetic included)."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_serving_world
from repro.core import policy as jpol
from repro.core import simulate as jsim
from repro.core.features import FeatureParams as JFeatureParams
from repro.core.features import make_features as j_make_features
from repro.core.profiler import build_model as j_build_model
from repro.core.profiler import \
    tile_admit_from_visits as j_tile_admit_from_visits
from repro.core.tracker import make_queries as j_make_queries
from repro_torch.convert import model_from_numpy, model_to_numpy, \
    phase_state_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core import simulate as tsim
from repro_torch.core.correlation import FIELDS
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.profiler import build_model, tile_admit_from_visits
from repro_torch.core.tracker import make_queries

NETWORKS = {
    "duke": (lambda m: m.duke_like_network(), 200, 600),
    "porto": (lambda m: m.porto_like_network(), 150, 400),
    "city130": (lambda m: m.clustered_city_network(130), 150, 400),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_world_inputs_bit_identical(name):
    make, n_ent, horizon = NETWORKS[name]
    jn, tn = make(jsim), make(tsim)
    for f in dataclasses.fields(jn):
        np.testing.assert_array_equal(getattr(tn, f.name),
                                      getattr(jn, f.name))
    jv = jsim.simulate_network(jn, n_ent, horizon, seed=3)
    tv = tsim.simulate_network(tn, n_ent, horizon, seed=3)
    for f in ("ent", "cam", "t_in", "t_out", "tile_xy"):
        a, b = getattr(tv, f), getattr(jv, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jg, jo = jsim.build_gallery(jv, 16)
    tg, to = tsim.build_gallery(tv, 16)
    np.testing.assert_array_equal(tg, jg)
    assert to == jo
    for a, b in zip(make_features(tv, n_ent, FeatureParams(seed=2)),
                    j_make_features(jv, n_ent, JFeatureParams(seed=2))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(make_queries(tv, 12, seed=5), j_make_queries(jv, 12,
                                                                 seed=5)):
        np.testing.assert_array_equal(a, b)


def _j_fields(model):
    return {f: np.asarray(getattr(model, f)) for f in FIELDS}


@pytest.mark.parametrize("kw", [
    dict(time_limit=252),
    dict(sample_every=3, bin_width=2, n_bins=64, epoch=4),
], ids=["serving_world", "sampled_binned"])
def test_build_model_fields_exact(kw):
    vis = make_serving_world()["vis"]
    args = (vis.ent, vis.cam, vis.t_in, vis.t_out, vis.n_cams)
    jm = j_build_model(*args, **kw)
    tm = build_model(*args, device="cpu", **kw)
    got, want = model_to_numpy(tm), _j_fields(jm)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (tm.bin_width, tm.epoch) == (jm.bin_width, jm.epoch)


TILE_PROFILES = [
    dict(tile_grid=4, time_limit=252),
    dict(tile_grid=8, time_limit=252),
    dict(tile_grid=8, sample_every=3, time_limit=300, tile_keep=0.8),
    dict(tile_grid=4, sample_every=2, bin_width=2, n_bins=64),
]


@pytest.mark.parametrize("kw", TILE_PROFILES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_build_model_tiles_exact(kw):
    vis = make_serving_world()["vis"]
    args = (vis.ent, vis.cam, vis.t_in, vis.t_out, vis.n_cams)
    jm = j_build_model(*args, tile_xy=vis.tile_xy, **kw)
    tm = build_model(*args, tile_xy=vis.tile_xy, device="cpu", **kw)
    got, want = model_to_numpy(tm), _j_fields(jm)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert tm.tile_admit.dtype == torch.bool
    np.testing.assert_array_equal(tm.tile_admit.numpy(),
                                  np.asarray(jm.tile_admit))
    assert (tm.tile_grid, tm.tile_learned) == (jm.tile_grid, jm.tile_learned)
    assert tm.tile_learned and not tm.tile_admit.all()
    # the model moves with its tile masks
    assert tm.to("cpu").tile_admit is not None


@pytest.mark.parametrize("T,keep", [(4, 1.0), (8, 1.0), (8, 0.6)])
def test_tile_admit_from_visits_exact_with_rows(T, keep):
    vis = make_serving_world()["vis"]
    args = (vis.ent, vis.cam, vis.t_in, vis.tile_xy, vis.n_cams, T, keep)
    full = tile_admit_from_visits(*args)
    np.testing.assert_array_equal(full, j_tile_admit_from_visits(*args))
    rows = [1, 3, vis.n_cams - 1]
    block = tile_admit_from_visits(*args, rows=rows)
    np.testing.assert_array_equal(block,
                                  j_tile_admit_from_visits(*args, rows=rows))
    np.testing.assert_array_equal(block, full[rows])


def test_build_model_tiles_need_positions():
    vis = make_serving_world()["vis"]
    with pytest.raises(ValueError, match="tile_xy"):
        build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, vis.n_cams,
                    tile_grid=4, device="cpu")


@functools.lru_cache(maxsize=None)
def _models():
    jm = make_serving_world()["model"]
    return jm, model_from_numpy(_j_fields(jm), jm.bin_width, jm.epoch)


def _random_state(rng, Q, C):
    f_q = rng.integers(0, 400, Q)
    f_curr = f_q + rng.integers(0, 260, Q)
    behind = rng.random(Q) < 0.4
    live = np.where(behind, f_curr + rng.integers(1, 30, Q) + 0.25,
                    f_curr.astype(np.float64))
    return dict(f_q=f_q, c_q=rng.integers(0, C, Q), f_curr=f_curr,
                phase=rng.integers(1, 4, Q), live_f=live,
                done=rng.random(Q) < 0.1)


def _j_state(s):
    return jpol.PhaseState(
        f_q=jnp.asarray(s["f_q"], jnp.int32),
        c_q=jnp.asarray(s["c_q"], jnp.int32),
        f_curr=jnp.asarray(s["f_curr"], jnp.int32),
        phase=jnp.asarray(s["phase"], jnp.int32),
        live_f=jnp.asarray(s["live_f"], jnp.float32),
        done=jnp.asarray(s["done"], bool))


POLICIES = [
    dict(scheme=scheme, exhaustive_final=ex, **extra)
    for scheme in ("rexcam", "all", "geo", "spatial_only")
    for ex in (False, True)
    for extra in (dict(), dict(s_thresh=0.03, t_thresh=0.3, replay_skip=2,
                               replay_speed=1.5, exit_t=120))
]


@pytest.mark.parametrize("pkw", POLICIES, ids=lambda p: "-".join(
    f"{k}={v}" for k, v in p.items()))
def test_admit_advance_exact(pkw):
    jm, tm = _models()
    C = tm.n_cams
    geo = make_serving_world()["net"].geo_adjacent
    jp, tp = jpol.SearchPolicy(**pkw), tpol.SearchPolicy(**pkw)
    jw, tw = jpol.phase_windows(jm, jp), tpol.phase_windows(tm, tp)
    np.testing.assert_array_equal(tw.w_end1.numpy(), np.asarray(jw.w_end1))
    np.testing.assert_array_equal(tw.w_end2.numpy(), np.asarray(jw.w_end2))
    rng = np.random.default_rng(len(str(pkw)))
    for _ in range(3):
        s = _random_state(rng, 96, C)
        js, ts = _j_state(s), phase_state_from_numpy(s)
        want = np.asarray(jpol.admit(jm, jp, js, jnp.asarray(geo)))
        got = tpol.admit(tm, tp, ts, torch.from_numpy(geo)).numpy()
        np.testing.assert_array_equal(got, want)
        matched = rng.random(96) < 0.3
        cam = rng.integers(0, C, 96).astype(np.int32)
        jn = jpol.advance(jp, jw, js, jnp.asarray(matched), jnp.asarray(cam),
                          2 ** 30)
        tn = tpol.advance(tp, tw, ts, torch.from_numpy(matched),
                          torch.from_numpy(cam), 2 ** 30)
        for f in ("f_q", "c_q", "f_curr", "phase", "live_f", "done"):
            a, b = getattr(tn, f).numpy(), np.asarray(getattr(jn, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_phase_state_dtypes():
    ps = tpol.PhaseState.init([1, 2], [10, 20])
    assert [getattr(ps, f).dtype for f in
            ("f_q", "c_q", "f_curr", "phase", "live_f", "done")] == \
        [torch.int32] * 4 + [torch.float32, torch.bool]


def _ulp_trap_threshold():
    """A t_thresh where float32 ``1 - f32(t)`` and a double ``1 - t``
    rounded to float32 differ."""
    for t in np.linspace(0.01, 0.5, 4001):
        a = np.float32(1.0) - np.float32(t)
        b = np.float32(1.0 - float(t))
        if a != b:
            return float(t), a, b
    raise AssertionError("no ulp-trap threshold found")


def test_temporal_threshold_is_float32_arithmetic():
    """The CDF comparison ``arrived <= 1 - th`` subtracts in float32 (the
    reference's traced arithmetic), not in Python doubles: at a CDF value
    exactly between the two roundings the port must agree with JAX."""
    t, f32_val, dbl_val = _ulp_trap_threshold()
    jm, tm = _models()
    C, NB = tm.n_cams, tm.n_bins
    cdf = np.full((C, C, NB), max(f32_val, dbl_val), np.float32)
    fields = dict(_j_fields(jm), cdf=cdf, f0=np.zeros((C, C), np.int32))
    jm2 = dataclasses.replace(jm, cdf=jnp.asarray(cdf),
                              f0=jnp.zeros((C, C), jnp.int32))
    tm2 = model_from_numpy(fields, tm.bin_width)
    c = np.arange(C, dtype=np.int32)
    e = np.full(C, 5, np.int32)
    th = np.full(C, t, np.float32)
    want = np.asarray(jpol.temporal_mask(jm2, jnp.asarray(c), jnp.asarray(e),
                                         jnp.asarray(th)))
    got = tpol.temporal_mask(tm2, torch.from_numpy(c), torch.from_numpy(e),
                             torch.from_numpy(th)).numpy()
    np.testing.assert_array_equal(got, want)
    # through admit, whose thresholds start as Python floats on the policy
    pol = dict(scheme="rexcam", s_thresh=0.0, t_thresh=t)
    s = dict(f_q=np.zeros(C), c_q=c, f_curr=e, phase=np.ones(C),
             live_f=e.astype(np.float64), done=np.zeros(C, bool))
    want = np.asarray(jpol.admit(jm2, jpol.SearchPolicy(**pol), _j_state(s)))
    got = tpol.admit(tm2, tpol.SearchPolicy(**pol),
                     phase_state_from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    # and the window end, whose thresholds are Python floats in both
    np.testing.assert_array_equal(
        tpol.window_end(tm2, 0.0, t).numpy(),
        np.asarray(jpol.window_end(jm2, 0.0, t)))


# -- the tile plane's admission ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _tile_models(T: int, learned: bool):
    """(JAX model, port model) at grid T: profiled masks, or the
    all-admitted tensor the engines synthesise for a tile-less model."""
    world = make_serving_world()
    vis = world["vis"]
    if learned:
        jm = j_build_model(vis.ent, vis.cam, vis.t_in, vis.t_out,
                           vis.n_cams, time_limit=252, tile_xy=vis.tile_xy,
                           tile_grid=T)
    else:
        jm = world["model"]
        jm = dataclasses.replace(
            jm, tile_admit=jnp.ones((jm.n_cams, jm.n_cams, T * T), bool),
            tile_grid=T, tile_learned=False)
    tm = model_from_numpy(_j_fields(jm), jm.bin_width, jm.epoch,
                          tile_admit=np.asarray(jm.tile_admit),
                          tile_grid=jm.tile_grid,
                          tile_learned=jm.tile_learned)
    return jm, tm


def _tile_q(rng, Q, T):
    """-1, the four corners, edges and interior tiles."""
    TT = T * T
    special = np.array([-1, 0, T - 1, TT - T, TT - 1, T // 2,
                        (T // 2) * T, (T // 2) * T + T // 2], np.int32)
    return np.where(rng.random(Q) < 0.5, rng.choice(special, Q),
                    rng.integers(-1, TT, Q)).astype(np.int32)


def test_tile_follow_mask_exact_and_floors_negatives():
    for T in (2, 4, 8):
        tq = np.arange(-T * T - 3, T * T, dtype=np.int32)
        got = tpol.tile_follow_mask(torch.from_numpy(tq), T).numpy()
        want = np.asarray(jpol.tile_follow_mask(jnp.asarray(tq), T))
        np.testing.assert_array_equal(got, want)
    # floor division and modulo on negative ids, as jnp computes them
    neg = torch.tensor([-1, -5, -9], dtype=torch.int32)
    assert (neg // 4).tolist() == [-1, -2, -3]
    assert (neg % 4).tolist() == [3, 3, 3]
    np.testing.assert_array_equal(np.asarray(jnp.asarray([-1, -5, -9]) // 4),
                                  [-1, -2, -3])


@pytest.mark.parametrize("learned", [True, False], ids=["learned",
                                                        "synthesised"])
@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("scheme", ["rexcam", "all", "geo", "spatial_only"])
def test_admit_tiles_exact(scheme, T, learned):
    jm, tm = _tile_models(T, learned)
    C = tm.n_cams
    geo = make_serving_world()["net"].geo_adjacent
    rng = np.random.default_rng(T * 10 + learned)
    for pkw in (dict(scheme=scheme),
                dict(scheme=scheme, exhaustive_final=True, replay_skip=2,
                     self_window=12)):
        jp, tp = jpol.SearchPolicy(**pkw), tpol.SearchPolicy(**pkw)
        s = _random_state(rng, 96, C)
        s["f_curr"] = s["f_q"] + rng.integers(0, 20, 96)   # follow window
        s["phase"] = rng.integers(1, 4, 96)
        js, ts = _j_state(s), phase_state_from_numpy(s)
        tq = _tile_q(rng, 96, T)
        for q in (tq, None):
            jq = None if q is None else jnp.asarray(q)
            tqq = None if q is None else torch.from_numpy(q)
            want = np.asarray(jpol.tile_admission(jm, jp, js, jq))
            got = tpol.tile_admission(tm, tp, ts, tqq).numpy()
            np.testing.assert_array_equal(got, want)
            jmask, jct = jpol.admit_tiles(jm, jp, js, jnp.asarray(geo), jq)
            tmask, tct = tpol.admit_tiles(tm, tp, ts, torch.from_numpy(geo),
                                          tqq)
            np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
            np.testing.assert_array_equal(tct.numpy(), np.asarray(jct))
            assert tct.shape == (96, C * T * T)
        if learned:
            # the follow column differs from the whole frame somewhere
            full = tpol.tile_admission(tm, tp, ts, None).numpy()
            assert (tpol.tile_admission(tm, tp, ts, torch.from_numpy(tq))
                    .numpy() != full).any()
