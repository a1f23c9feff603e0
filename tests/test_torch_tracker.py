"""The port's batched tracker and the model's query methods against
``repro``'s on the CPU.

Every ``TrackResult`` field, every ``trace_queries`` array and
``potential_savings`` must be exactly equal: the port sums the distances
and the representation's norm in the reference's order
(``repro_torch.core.fporder``), so even the float32 query representation
after the last step is equal to the bit.  The model is carried across by
``convert.model_from_numpy``."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_serving_world
from repro.core import tracker as jtracker
from repro.core.policy import SearchPolicy as JPolicy
from repro.core.profiler import build_model as j_build_model
from repro.core.simulate import Visits as JVisits
from repro_torch import api
from repro_torch.convert import model_from_numpy
from repro_torch.core import fporder
from repro_torch.core import tracker as ttracker
from repro_torch.core.correlation import FIELDS
from repro_torch.core.policy import SearchPolicy
from repro_torch.core.simulate import Visits


def _toy_world():
    """``tests/test_tracker.py``'s corridor: 2 entities walking 0 -> 1 -> 2
    on 3 cameras, travel 10 steps, dwell 5, orthogonal features."""
    ents, cams, tin, tout = [], [], [], []
    for e in range(22):
        t = e * 40
        for c in range(3):
            ents.append(e)
            cams.append(c)
            tin.append(t)
            tout.append(t + 5)
            t += 5 + 10
    horizon = max(tout) + 50
    vis = JVisits(np.array(ents), np.array(cams), np.array(tin),
                  np.array(tout), horizon, 3)
    feats = np.zeros((len(vis), 64), np.float32)
    for v in range(len(vis)):
        feats[v, vis.ent[v] % 64] = 1.0
    gal = np.full((3, horizon, 4), -1, np.int32)
    fill = np.zeros((3, horizon), np.int32)
    for v in range(len(vis)):
        for t in range(vis.t_in[v], vis.t_out[v] + 1):
            gal[vis.cam[v], t, fill[vis.cam[v], t]] = v
            fill[vis.cam[v], t] += 1
    model = j_build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, 3,
                          time_limit=20 * 40)
    return vis, gal, feats, model


def _port_model(m):
    return model_from_numpy({f: np.asarray(getattr(m, f)) for f in FIELDS},
                            m.bin_width, m.epoch)


def _port_visits(v):
    return Visits(v.ent, v.cam, v.t_in, v.t_out, v.horizon, v.n_cams)


@functools.lru_cache(maxsize=None)
def _world(name):
    """(jax model, port model, visits, gallery, feats, q_vids, gt_vids,
    geo_adj) of a test world."""
    if name == "toy":
        vis, gal, feats, model = _toy_world()
        q_vids, gt_vids = jtracker.make_queries(vis, 2, seed=0)
        geo = np.ones((3, 3), bool)
    else:
        w = make_serving_world(n_entities=160, horizon=540, seed=1,
                               n_queries=8)
        vis, gal, feats, model = w["vis"], w["gal"], w["feats"], w["model"]
        q_vids, gt_vids = w["q_vids"], w["gt_vids"]
        geo = w["net"].geo_adjacent
    return (model, _port_model(model), vis, gal, feats, q_vids, gt_vids,
            geo)


TOY = dict(scheme="rexcam", s_thresh=0.3, t_thresh=0.02, exit_t=60)
DUKE = dict(scheme="rexcam", s_thresh=0.05, t_thresh=0.02)
CASES = [
    ("toy", TOY),
    ("toy", dict(scheme="all", exit_t=60)),
    ("toy", dict(TOY, scheme="spatial_only")),
    ("duke", dict(scheme="all")),
    ("duke", dict(scheme="geo")),
    ("duke", dict(scheme="spatial_only", s_thresh=0.05)),
    ("duke", DUKE),
    ("duke", dict(DUKE, replay_skip=2)),
    ("duke", dict(DUKE, replay_speed=2.0)),
    ("duke", dict(DUKE, exhaustive_final=True)),
    ("duke", dict(DUKE, use_replay=False)),
]


def _ids(case):
    name, pol = case
    return name + "-" + "-".join(f"{k}={v}" for k, v in pol.items())


def _jax_state(jm, vis, gal, feats, q, gt, geo, pol, n_steps=None):
    """The reference's loop state: after its while loop, or after
    ``n_steps`` steps of its trace scan."""
    args = (jm, jnp.asarray(gal), jnp.asarray(feats),
            jnp.asarray(vis.ent, jnp.int32), jnp.asarray(vis.cam, jnp.int32),
            jnp.asarray(vis.t_out, jnp.int32), jnp.asarray(q, jnp.int32),
            jnp.asarray(gt, jnp.int32), jnp.asarray(geo), JPolicy(**pol),
            vis.horizon)
    if n_steps is None:
        return jtracker._track_jit(*args)[0]
    return jtracker._trace_jit(*args, n_steps)[0]


def _assert_results_equal(port, ref):
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(port, f.name),
                                      getattr(ref, f.name), err_msg=f.name)
        assert getattr(port, f.name).dtype == getattr(ref, f.name).dtype, \
            f.name
    assert port.summary() == ref.summary()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_track_queries_equals_reference(case):
    name, pol = case
    jm, tm, vis, gal, feats, q, gt, geo = _world(name)
    ref = jtracker.track_queries(jm, vis, gal, feats, q, gt, JPolicy(**pol),
                                 geo_adj=geo)
    port = api.track(tm, _port_visits(vis), gal, feats, q, gt,
                     SearchPolicy(**pol), geo_adj=geo, device="cpu")
    _assert_results_equal(port, ref)
    if name == "duke":
        assert port.n_match.sum() > 0 and port.cost.sum() > 0


@pytest.mark.parametrize("case", [CASES[0], CASES[7]], ids=_ids)
def test_query_representation_bit_equal(case):
    """The float32 representation after the last step: every EMA update,
    norm and distance went the reference's way to the bit."""
    name, pol = case
    jm, tm, vis, gal, feats, q, gt, geo = _world(name)
    ref = _jax_state(jm, vis, gal, feats, q, gt, geo, pol)
    st, steps = ttracker._track(tm, _port_visits(vis), gal, feats, q, gt,
                                SearchPolicy(**pol), geo, "cpu",
                                4 * vis.horizon)
    np.testing.assert_array_equal(st.q_feat.numpy(), np.asarray(ref["q_feat"]))
    assert steps >= int(ref["iters"])


@pytest.mark.parametrize("case,n_steps", [(CASES[0], 1500), (CASES[1], 800),
                                          (CASES[6], 500), (CASES[4], 300),
                                          (CASES[8], 400)],
                         ids=lambda c: _ids(c) if isinstance(c, tuple) else
                         str(c))
def test_trace_queries_equals_reference(case, n_steps):
    name, pol = case
    jm, tm, vis, gal, feats, q, gt, geo = _world(name)
    ref = jtracker.trace_queries(jm, vis, gal, feats, q, gt, JPolicy(**pol),
                                 geo_adj=geo, n_steps=n_steps)
    port = ttracker.trace_queries(tm, _port_visits(vis), gal, feats, q, gt,
                                  SearchPolicy(**pol), geo_adj=geo,
                                  n_steps=n_steps, device="cpu")
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        assert port[k].dtype == ref[k].dtype, k
    assert port["live"][0].all()


def test_trace_distances_decide_the_matches():
    jm, tm, vis, gal, feats, q, gt, geo = _world("duke")
    tr = ttracker.trace_queries(tm, _port_visits(vis), gal, feats, q, gt,
                                SearchPolicy(**DUKE), geo_adj=geo,
                                n_steps=400, device="cpu", with_dist=True)
    np.testing.assert_array_equal(
        tr["matched"], tr["live"] & (tr["best_d"] < np.float32(0.28)))
    empty = tr["best_d"] == np.float32(ttracker.BIG)
    assert empty.any() and (tr["match_cam"][empty] == 0).all()


@functools.lru_cache(maxsize=None)
def _tracked(every):
    jm, tm, vis, gal, feats, q, gt, geo = _world("duke")
    return ttracker._track(tm, _port_visits(vis), gal, feats, q, gt,
                           SearchPolicy(**DUKE), geo, "cpu",
                           4 * vis.horizon, every)


@pytest.mark.parametrize("every", [7, 64, 256])
def test_sync_interval_changes_nothing(every):
    """Asking the device for live queries every N steps gives the state
    of asking every step: the steps run past the last live one are
    no-ops."""
    (each, n_each), (got, n_got) = _tracked(1), _tracked(every)
    for f in dataclasses.fields(each):
        a, b = getattr(got, f.name), getattr(each, f.name)
        if f.name == "ps":
            for g in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(a, g.name).numpy(),
                                              getattr(b, g.name).numpy())
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), f.name)
    assert n_got == -(-n_each // every) * every


@pytest.mark.parametrize("cap", [1, 37, 150])
def test_loop_stops_exactly_at_the_cap(cap):
    """With every query still live at the cap, the loop runs exactly
    ``cap`` steps, whatever the check interval, and its state is the
    reference's after ``cap`` steps."""
    jm, tm, vis, gal, feats, q, gt, geo = _world("duke")
    ref = _jax_state(jm, vis, gal, feats, q, gt, geo, DUKE, n_steps=cap)
    for every in (1, 16, 64):
        st, steps = ttracker._track(tm, _port_visits(vis), gal, feats, q, gt,
                                    SearchPolicy(**DUKE), geo, "cpu", cap,
                                    every)
        assert steps == cap
        for k in ("q_feat", "cost", "n_match", "visit_hits",
                  "rescue_pairs"):
            np.testing.assert_array_equal(getattr(st, k).numpy(),
                                          np.asarray(ref[k]), k)
        np.testing.assert_array_equal(st.ps.f_curr.numpy(),
                                      np.asarray(ref["ps"].f_curr))


def test_track_queries_caps_at_four_horizons(monkeypatch):
    seen = {}
    real = ttracker._track

    def spy(*a, **kw):
        seen["cap"] = a[9]
        return real(*a, **kw)

    monkeypatch.setattr(ttracker, "_track", spy)
    jm, tm, vis, gal, feats, q, gt, geo = _world("toy")
    ttracker.track_queries(tm, _port_visits(vis), gal, feats, q, gt,
                           SearchPolicy(**TOY), device="cpu")
    assert seen["cap"] == 4 * vis.horizon


def test_track_and_trace_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    jm, tm, vis, gal, feats, q, gt, geo = _world("toy")
    args = (tm, _port_visits(vis), gal, feats, q, gt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.track(*args, SearchPolicy(**TOY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.trace_queries(*args, SearchPolicy(**TOY), n_steps=3)


# -- the model's query methods ------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("s,t", [(0.05, 0.0), (0.0, 0.02), (0.05, 0.02)])
def test_potential_savings_equal(s, t, weighted):
    jm, tm = _world("duke")[:2]
    want = jm.potential_savings(s, t, weight_by_traffic=weighted)
    got = tm.potential_savings(s, t, weight_by_traffic=weighted)
    assert type(got) is float and got == want


def test_model_masks_exact():
    jm, tm = _world("duke")[:2]
    C = tm.n_cams
    rng = np.random.default_rng(0)
    cams = rng.integers(0, C, 40).astype(np.int32)
    elapsed = rng.integers(0, 300, 40).astype(np.int32)
    for c, e in zip(cams[:8], elapsed[:8]):
        for s, t in [(0.05, 0.02), (0.005, 0.002), (0.3, 0.1)]:
            np.testing.assert_array_equal(
                tm.spatial_mask(int(c), s).numpy(),
                np.asarray(jm.spatial_mask(int(c), s)))
            np.testing.assert_array_equal(
                tm.temporal_mask(int(c), int(e), t).numpy(),
                np.asarray(jm.temporal_mask(int(c), int(e), t)))
            np.testing.assert_array_equal(
                tm.correlated(int(c), int(e), s, t).numpy(),
                np.asarray(jm.correlated(int(c), int(e), s, t)))
    ths = np.full(40, 0.02, np.float32)
    np.testing.assert_array_equal(
        tm.temporal_mask(torch.from_numpy(cams), torch.from_numpy(elapsed),
                         torch.from_numpy(ths)).numpy(),
        np.asarray(jm.temporal_mask(jnp.asarray(cams), jnp.asarray(elapsed),
                                    jnp.asarray(ths))))
    for s, t in [(0.05, 0.02), (0.005, 0.002), (0.05, 0.0)]:
        np.testing.assert_array_equal(tm.window_end(s, t).numpy(),
                                      np.asarray(jm.window_end(s, t)))


@pytest.mark.parametrize("window,n_windows", [(20, 16), (7, 16), (40, 6),
                                              (100, 4), (1, 300), (300, 2)])
def test_window_transfer_exact(window, n_windows):
    jm, tm = _world("duke")[:2]
    got = tm.window_transfer(window, n_windows)
    assert got.dtype == torch.float32 and got.shape[-1] == n_windows
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.window_transfer(window,
                                                                n_windows)))


@pytest.mark.parametrize("R,D", [(12, 64), (13, 64), (192, 64), (24, 68),
                                 (9, 5), (16, 70)])
def test_dot8_equals_the_reference_gemv(R, D):
    """``fporder.dot8`` against the reference's compiled einsum: full
    tiles, tail rows and a D % 8 tail, each to the bit."""
    rng = np.random.default_rng(R * D)
    g = rng.normal(size=(3, R, D)).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    want = np.asarray(jnp.einsum("qrd,qd->qr", g, q))
    rows = np.arange(3 * R) % R
    got = fporder.dot8(torch.from_numpy(g.reshape(3 * R, D)),
                       torch.from_numpy(np.repeat(q, R, axis=0)),
                       torch.from_numpy(rows >= R - R % 8))
    np.testing.assert_array_equal(got.numpy().reshape(3, R), want)


@pytest.mark.parametrize("D", [40, 64, 100, 200])
def test_norm_equals_the_reference(D):
    x = np.random.default_rng(D).normal(size=(50, D)).astype(np.float32)
    want = np.asarray(jnp.linalg.norm(jnp.asarray(x), axis=-1))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        fporder.sqrt(fporder.seq_sum(t * t)).numpy(), want)


@pytest.mark.parametrize("c,up", [(2.0 ** -70, True), (0.0, False),
                                  (-2.0 ** -70, False)])
def test_fma_rounds_once(c, up):
    """a * b = 1 + 2^-11 + 2^-24 lies on a float32 tie; a float64 sum
    with c = +-2^-70 rounds back onto it, so only the exact sum can say
    which way a single rounding goes (up above the tie, to even on it)."""
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    got = fporder.fma(a, a, torch.tensor([c], dtype=torch.float32))
    low = np.float32(1.0 + 2.0 ** -11)
    want = np.nextafter(low, np.float32(2)) if up else low
    assert got.dtype == torch.float32 and got.item() == want
