"""The port's ``ServingEngine`` against ``repro``'s on the same world and M.

The reference runs under ``conftest.drive_serving_trace`` (the Pallas
kernel in interpret mode); the port runs on the CPU with the same M carried
across by ``convert.model_from_numpy``.  Every trace field is exact except
``match_val`` and the top-k band values (fp32 scores, 1e-5); the summary
counters are exact."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import drive_serving_trace, make_serving_world, trace_key
from repro.core.policy import SearchPolicy as JPolicy
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


def _port_model(world):
    m = world["model"]
    return model_from_numpy({f: np.asarray(getattr(m, f)) for f in FIELDS},
                            m.bin_width, m.epoch)


@functools.lru_cache(maxsize=None)
def _reference(seed, policy_items, kw_items):
    _, trace, summary = drive_serving_trace(
        _world(seed), JPolicy(**dict(policy_items)), **dict(kw_items))
    return trace, summary


def _drive_port(world, policy, **kw):
    eng = api.serve(_port_model(world), lambda x: x, policy,
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
                   for q in eng.queries.values()])
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


@pytest.mark.parametrize("kw", [dict(shards=2), dict(tile_grid=4),
                                dict(prefetch=True), dict(recalibrate=True),
                                dict(transport="inproc")])
def test_unported_serve_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        api.serve(_port_model(_world(0)), lambda x: x, device="cpu", **kw)


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
