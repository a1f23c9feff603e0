"""The port's identity detection (paper §5.4) against ``repro``'s on the CPU.

``make_detection_queries``, ``_presence_and_dist`` and every
``identity_detection`` summary must be exactly equal.  ``propagate`` is
held to the reference within 1e-6 of the largest P (float32 rounding of
another summation order: the port's contraction is a pairwise sum, the
reference's a library matrix product).  With no mass moving between
windows (S = 0) P is the surfacing prior alone, held to the bit at the
default rho."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_model as j_build_model
from repro.core import detect as jdetect
from repro.core import duke_like_network, simulate_network
from repro.core.features import FeatureParams, make_features
from repro_torch.convert import model_from_numpy
from repro_torch.core import detect as tdetect
from repro_torch.core.correlation import FIELDS
from repro_torch.core.simulate import Visits

T_START = 1200
PROP_TOL = 1e-6     # of max |P|


@functools.lru_cache(maxsize=None)
def _world():
    """A small duke world (900 entities, 2,400 steps, profiled on the
    first 1,600) and 12 lost identities from t = 1,200."""
    net = duke_like_network()
    vis = simulate_network(net, 900, 2400, seed=0)
    jm = j_build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, net.n_cams,
                       time_limit=1600)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in FIELDS},
                          jm.bin_width)
    feats, _ = make_features(vis, 900, FeatureParams())
    q = jdetect.make_detection_queries(vis, 12, search_start=T_START, seed=2)
    tvis = Visits(vis.ent, vis.cam, vis.t_in, vis.t_out, vis.horizon,
                  vis.n_cams)
    return jm, tm, vis, tvis, feats, q


def _scan_indicators(Q, C, W, seed=0):
    I = (np.random.default_rng(seed).random((Q, C, W)) > 0.3)
    I[:, :, :2] = False
    return I.astype(np.float32)


def test_make_detection_queries_exact():
    jm, tm, vis, tvis, feats, q = _world()
    for n, start, seed in [(12, T_START, 2), (40, 600, 1), (5, 2000, 7)]:
        np.testing.assert_array_equal(
            tdetect.make_detection_queries(tvis, n, search_start=start,
                                           seed=seed),
            jdetect.make_detection_queries(vis, n, search_start=start,
                                           seed=seed))


@pytest.mark.parametrize("t_refs", [T_START, None])
def test_presence_and_dist_exact(t_refs):
    jm, tm, vis, tvis, feats, q = _world()
    got = tdetect._presence_and_dist(tvis, feats, q, 20, 64, t_refs=t_refs)
    want = jdetect._presence_and_dist(vis, feats, q, 20, 64, t_refs=t_refs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("rho", [0.97, 0.5, 0.0])
def test_propagate_within_tolerance(rho):
    jm, tm, vis, tvis, feats, q = _world()
    I = _scan_indicators(len(q), tm.n_cams, 64)
    p = dict(window=20, surface_rho=rho)
    want = np.asarray(jdetect.propagate(jm, jnp.asarray(I), 64,
                                        jdetect.DetectorParams(**p)))
    got = tdetect.propagate(tm, torch.from_numpy(I), 64,
                            tdetect.DetectorParams(**p)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PROP_TOL * np.abs(want).max())
    # window 0 has no inbound mass yet: the prior alone, to the bit
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])


@pytest.mark.parametrize("rho", [0.97, 0.8, 0.0])
def test_surfacing_prior_bit_equal(rho):
    """With S = 0 nothing propagates and P[:, :, w] is the surfacing
    prior, prior * ((1 - rho) * rho ** w) in float32, for every w.  The
    port raises float32(rho) to w correctly rounded; the reference's
    float32 power is too for the default rho = 0.97 over these 300
    windows, but not everywhere (rho = 0.8 is one ulp off at w = 171 and
    220), so there the hold is two ulps."""
    jm, tm, vis, tvis, feats, q = _world()
    jm0 = dataclasses.replace(jm, S=jnp.zeros_like(jm.S))
    tm0 = dataclasses.replace(tm, S=torch.zeros_like(tm.S))
    I = _scan_indicators(3, tm.n_cams, 300, seed=1)
    want = np.asarray(jdetect.propagate(jm0, jnp.asarray(I), 300,
                                        jdetect.DetectorParams(surface_rho=rho)))
    got = tdetect.propagate(tm0, torch.from_numpy(I), 300,
                            tdetect.DetectorParams(surface_rho=rho)).numpy()
    if rho == 0.8:
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("theta", [None, 0.95, 0.75],
                         ids=["baseline", "theta0.95", "theta0.75"])
def test_identity_detection_summaries_exact(theta):
    jm, tm, vis, tvis, feats, q = _world()
    kw = dict(baseline=theta is None, t_refs=T_START)
    p = dict(theta=theta or 0.95)
    want = jdetect.identity_detection(jm, vis, feats, q,
                                      jdetect.DetectorParams(**p), **kw)
    got = tdetect.identity_detection(tm, tvis, feats, q,
                                     tdetect.DetectorParams(**p),
                                     device="cpu", **kw)
    assert got == want
    assert got["recall"] > 0 and (theta is None or got["rounds"] > 1)


def test_identity_detection_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    jm, tm, vis, tvis, feats, q = _world()
    for baseline in (False, True):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdetect.identity_detection(tm, tvis, feats, q,
                                       tdetect.DetectorParams(),
                                       baseline=baseline, t_refs=T_START)
