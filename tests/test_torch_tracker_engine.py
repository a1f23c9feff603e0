"""The port's two consumers of the control plane agree: its batched
tracker (``trace_queries``) and its ``ServingEngine`` emit identical
admission masks, phases and match cameras step for step on the toy
corridor, for ``rexcam`` and ``all`` (the port's side of
``tests/test_policy.py``'s parity contract)."""
import numpy as np

from repro.core.tracker import make_queries
from repro_torch import api
from repro_torch.core.policy import SearchPolicy
from repro_torch.core.tracker import trace_queries
from test_torch_tracker import _port_model, _port_visits, _toy_world


def _drive_engine(vis, gal, feats, model, q_vids, policy, extra_ticks=400):
    eng = api.serve(model, lambda x: x, policy, retention=10 ** 6,
                    device="cpu")
    for i, q in enumerate(q_vids):
        eng.submit_query(i, feats[q], int(vis.cam[q]), int(vis.t_out[q]))
    trace = []
    for t in range(vis.horizon + extra_ticks):
        if t < vis.horizon:
            frames = {}
            for c in range(vis.n_cams):
                vids = gal[c, t][gal[c, t] >= 0]
                if len(vids):
                    frames[c] = feats[vids]
            eng.ingest(frames)
        eng.tick(record_trace=trace)
        if all(q.done for q in eng.queries.values()):
            break
    return eng, trace


def _steps(tr, i):
    return [(int(tr["f_curr"][s, i]), int(tr["phase"][s, i]),
             tuple(tr["mask"][s, i]), bool(tr["matched"][s, i]),
             int(tr["match_cam"][s, i]) if tr["matched"][s, i] else -1)
            for s in np.flatnonzero(tr["live"][:, i])]


def test_tracker_engine_admission_parity():
    vis, gal, feats, jm = _toy_world()
    model, tvis = _port_model(jm), _port_visits(vis)
    q_vids, gt_vids = make_queries(vis, 2, seed=0)
    p = SearchPolicy(scheme="rexcam", s_thresh=0.3, t_thresh=0.02, exit_t=60)
    tr = trace_queries(model, tvis, gal, feats, q_vids, gt_vids, p,
                       n_steps=2 * vis.horizon, device="cpu")
    eng, etrace = _drive_engine(vis, gal, feats, model, q_vids, p)
    for i in range(len(q_vids)):
        t_steps = _steps(tr, i)
        e_steps = [(r["f_curr"], r["phase"], tuple(r["mask"]), r["matched"],
                    r["match_cam"] if r["matched"] else -1)
                   for r in etrace if r["qid"] == i]
        assert len(t_steps) > 20, "trace unexpectedly short"
        assert e_steps == t_steps, f"query {i}: the two consumers diverged"
        assert eng.queries[i].done


def test_tracker_engine_parity_all_scheme():
    vis, gal, feats, jm = _toy_world()
    model, tvis = _port_model(jm), _port_visits(vis)
    q_vids, gt_vids = make_queries(vis, 1, seed=0)
    p = SearchPolicy(scheme="all", exit_t=30)
    tr = trace_queries(model, tvis, gal, feats, q_vids, gt_vids, p,
                       n_steps=2 * vis.horizon, device="cpu")
    eng, etrace = _drive_engine(vis, gal, feats, model, q_vids, p)
    t_steps = [(f, m) for f, _, m, _, _ in _steps(tr, 0)]
    assert len(t_steps) > 20
    assert [(r["f_curr"], tuple(r["mask"])) for r in etrace] == t_steps
