"""Multi-camera identity detection (paper §5.4): find a lost identity that
enters the camera network at an unknown time and place, by propagating
appearance probabilities through the spatio-temporal model on the card.

  PYTHONPATH=src python -m repro_torch.examples.identity_detection \
      [--device cpu]

Prints the same lines, with the same numbers, as the JAX package's
``examples/identity_detection.py``.
"""
from __future__ import annotations

import argparse

from repro_torch.core.detect import (DetectorParams, identity_detection,
                                     make_detection_queries)
from repro_torch.core.features import FeatureParams, make_features
from repro_torch.core.profiler import build_model
from repro_torch.core.simulate import duke_like_network, simulate_network


def main(device: str = "cuda") -> None:
    net = duke_like_network()
    visits = simulate_network(net, 1800, 3600, seed=3)
    model = build_model(visits.ent, visits.cam, visits.t_in, visits.t_out,
                        net.n_cams, time_limit=2400, device=device)
    feats, _ = make_features(visits, 1800, FeatureParams(seed=3))
    t_start = 2400
    queries = make_detection_queries(visits, 20, search_start=t_start,
                                     seed=4)
    print(f"searching for {len(queries)} lost identities from t={t_start}")

    for theta in (0.95, 0.75):
        r = identity_detection(model, visits, feats, queries,
                               DetectorParams(theta=theta), t_refs=t_start,
                               device=device)
        b = identity_detection(model, visits, feats, queries,
                               DetectorParams(theta=theta), baseline=True,
                               t_refs=t_start, device=device)
        print(f"theta={theta}: cost {r['cost']:9.0f} vs baseline "
              f"{b['cost']:9.0f} ({b['cost']/max(r['cost'],1):.1f}x) | "
              f"recall {r['recall']:.2f} (baseline {b['recall']:.2f}) | "
              f"precision {r['precision']:.2f} "
              f"(baseline {b['precision']:.2f})")
    print("paper: 7.6x at theta=0.95; 6.6x at 0.75 with no recall drop")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
