"""Quickstart: build a correlation model from simulated history, track a
query across cameras, and compare against the all-camera baseline — all
through the ``repro_torch.api`` facade, on the card by default.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Prints the same lines, with the same numbers, as the JAX package's
``examples/quickstart.py``.
"""
from __future__ import annotations

import argparse

from repro_torch import api as rexcam
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.simulate import (build_gallery, duke_like_network,
                                       simulate_network)


def main(device: str = "cuda") -> None:
    # 1. A calibrated 8-camera network (DukeMTMC statistics; DESIGN.md §7)
    net = duke_like_network()
    visits = simulate_network(net, n_entities=1200, horizon=2400, seed=0)
    print(f"simulated {len(visits)} visits of 1200 identities on "
          f"{net.n_cams} cameras")

    # 2. Offline profiling (paper §6): historical partition -> model M
    model = rexcam.profile(visits, time_limit=1600, device=device)
    S = model.S.cpu().numpy()
    print(f"peers receiving >=5% of outbound traffic: "
          f"{(S >= .05).sum(1).mean():.2f} per camera (paper: 1.9)")

    # 3. Live tracking (paper Alg. 1): ReXCam vs the all-camera baseline —
    #    the same SearchPolicy/admit plane the serving engine runs.
    gallery, _ = build_gallery(visits, 24)
    feats, _ = make_features(visits, 1200, FeatureParams())
    queries, gt = rexcam.make_queries(visits, 25, seed=1)

    base = rexcam.track(model, visits, gallery, feats, queries, gt,
                        rexcam.SearchPolicy(scheme="all"), device=device)
    rex = rexcam.track(model, visits, gallery, feats, queries, gt,
                       rexcam.SearchPolicy(scheme="rexcam", s_thresh=.05,
                                           t_thresh=.02), device=device)

    print(f"\nbaseline:  {base.total_cost:9.0f} camera-frames | "
          f"recall {base.recall:.2f} | precision {base.precision:.2f}")
    print(f"ReXCam:    {rex.total_cost:9.0f} camera-frames | "
          f"recall {rex.recall:.2f} | precision {rex.precision:.2f}")
    print(f"compute savings: {base.total_cost / rex.total_cost:.1f}x "
          f"(paper: 8.3x on the real DukeMTMC)")
    print(f"replay rescues: {int(rex.rescued.sum())} "
          f"(delay {rex.mean_delay:.1f}s)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
