"""Small worlds for the benchmark-suite differentials
(``test_torch_bench_tables.py``, ``test_torch_bench_sweeps.py``).

The tables and sweeps read their worlds through module attributes
(``scenarios.duke`` / ``anoncampus`` / ``porto`` on both sides), so a test
swaps in a small world with ``monkeypatch`` and edits no file: the
reference's world functions below replay ``benchmarks/scenarios.py``'s
with the sizes as arguments, the port's are its own world functions with
smaller sizes.  Every world keeps the reference's seeds, networks,
gallery depth and feature settings."""
import functools

import numpy as np

#: duke: (entities, steps, profiled steps); the full horizon keeps fig17's
#: search start (t = 3,200) inside the world
DUKE = dict(n_entities=450, horizon=5100, time_limit=3000)
#: anoncampus: (entities, steps, profiled steps)
ANONCAMPUS = dict(n_entities=200, horizon=600, time_limit=400)
#: porto: history and live (entities, steps)
PORTO = dict(history=(600, 1200), live=(300, 400))
#: queries a world at most
QUERIES = 10


@functools.lru_cache(maxsize=None)
def ref_duke(n_queries=100):
    from repro.core import (build_gallery, build_model, duke_like_network,
                            simulate_network)
    from repro.core.features import FeatureParams, make_features
    from repro.core.tracker import make_queries

    n_ent, horizon, t_lim = (DUKE[k] for k in ("n_entities", "horizon",
                                               "time_limit"))
    net = duke_like_network()
    vis = simulate_network(net, n_ent, horizon, seed=0)
    gal, _ = build_gallery(vis, 24)
    model = build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, net.n_cams,
                        time_limit=t_lim)
    feats, _ = make_features(vis, n_ent, FeatureParams())
    q_vids, gt_vids = make_queries(vis, min(n_queries, QUERIES), seed=1)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, name="duke")


@functools.lru_cache(maxsize=None)
def ref_anoncampus(n_queries=20):
    from repro.core import (anoncampus_like_network, build_gallery,
                            build_model, simulate_network)
    from repro.core.features import FeatureParams, make_features
    from repro.core.tracker import make_queries

    n_ent, horizon, t_lim = (ANONCAMPUS[k] for k in (
        "n_entities", "horizon", "time_limit"))
    net = anoncampus_like_network()
    vis = simulate_network(net, n_ent, horizon, seed=5)
    gal, _ = build_gallery(vis, 24)
    model = build_model(vis.ent, vis.cam, vis.t_in, vis.t_out, net.n_cams,
                        time_limit=t_lim)
    feats, _ = make_features(vis, n_ent, FeatureParams(noise_sigma=0.55,
                                                       seed=5))
    q_vids, gt_vids = make_queries(vis, min(n_queries, QUERIES), seed=6)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, name="anoncampus")


@functools.lru_cache(maxsize=None)
def ref_porto(n_cams=130, n_queries=100):
    from repro.core import (build_gallery, build_model, porto_like_network,
                            simulate_network)
    from repro.core.features import FeatureParams, make_features
    from repro.core.simulate import restrict_network
    from repro.core.tracker import make_queries

    (h_ent, h_len), (l_ent, l_len) = PORTO["history"], PORTO["live"]
    net = porto_like_network(130)
    if n_cams < 130:
        net = restrict_network(net, np.arange(n_cams))
    hist = simulate_network(net, h_ent, h_len, seed=11)
    model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out, net.n_cams)
    vis = simulate_network(net, l_ent, l_len, seed=2)
    gal, _ = build_gallery(vis, 16)
    feats, _ = make_features(vis, l_ent, FeatureParams(n_clusters=400,
                                                       seed=2))
    q_vids, gt_vids = make_queries(vis, min(n_queries, QUERIES), seed=3)
    return dict(net=net, vis=vis, gal=gal, model=model, feats=feats,
                q_vids=q_vids, gt_vids=gt_vids, name=f"porto{n_cams}")


def _port_worlds():
    """The port's own (cached) world functions, whatever is patched over
    them."""
    from repro_torch.benchmarks import scenarios
    return _PORT.setdefault("b", (scenarios.duke, scenarios.anoncampus,
                                  scenarios.porto))


_PORT: dict = {}


def port_duke(n_queries=100):
    return _port_worlds()[0](min(n_queries, QUERIES), **DUKE)


def port_anoncampus(n_queries=20):
    return _port_worlds()[1](min(n_queries, QUERIES), **ANONCAMPUS)


def port_porto(n_cams=130, n_queries=100):
    return _port_worlds()[2](n_cams, min(n_queries, QUERIES), **PORTO)


def small_worlds(monkeypatch):
    """Swap the small worlds into both packages' scenario modules."""
    from benchmarks import scenarios as j_scen
    from repro_torch.benchmarks import scenarios as t_scen

    _port_worlds()
    for mod, (d, a, p) in ((j_scen, (ref_duke, ref_anoncampus, ref_porto)),
                           (t_scen, (port_duke, port_anoncampus,
                                     port_porto))):
        monkeypatch.setattr(mod, "duke", d)
        monkeypatch.setattr(mod, "anoncampus", a)
        monkeypatch.setattr(mod, "porto", p)


def without_clock(rows, recs=()):
    """Rows and records with their clock readings taken out (the port's
    ``strip_clock_row`` / ``strip_clock_records``, used for both sides)."""
    from repro_torch.benchmarks.scenarios import (strip_clock_records,
                                                  strip_clock_row)
    return [strip_clock_row(r) for r in rows], strip_clock_records(recs)


def one_thread():
    """Run a test on one torch thread: the tables' and sweeps' host work is thousands
    of small operations a step, which extra threads only slow down when
    other test processes share the machine."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
