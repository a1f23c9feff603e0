"""Re-id feature oracle for the simulators (DESIGN.md §7).

Entity appearance embeddings are drawn from a clustered distribution
(lookalike groups — people in similar clothing) and every *visit* of an
entity gets a fixed per-visit perturbation (per-camera lighting/viewpoint).
Distances between these features drive the same ranking step the paper's
ResNet-50 re-id model performs (Fig. 2); cluster tightness + noise are
calibrated so the all-camera baseline lands at the paper's ~51% precision /
~81% recall operating point (§8.2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.simulate import Visits


@dataclasses.dataclass(frozen=True)
class FeatureParams:
    """Calibrated (scripts/calibrate.py) so the Duke all-camera baseline lands
    at the paper's ~0.51 precision / ~0.81 recall operating point (Fig. 11)."""
    dim: int = 64
    n_clusters: int = 150          # lookalike groups
    cluster_delta: float = 0.55    # individual separation within a cluster
    noise_sigma: float = 0.45      # per-visit appearance noise
    seed: int = 0


def make_features(visits: Visits, n_entities: int, p: FeatureParams):
    """Returns (feats (V, D) float32 L2-normalized, entity_emb (E, D))."""
    rng = np.random.default_rng(p.seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    centers = unit(rng.normal(size=(p.n_clusters, p.dim)))
    assign = rng.integers(0, p.n_clusters, n_entities)
    indiv = unit(rng.normal(size=(n_entities, p.dim)))
    emb = unit(centers[assign] + p.cluster_delta * indiv)

    noise = unit(rng.normal(size=(len(visits), p.dim)))
    feats = unit(emb[visits.ent] + p.noise_sigma * noise)
    return feats.astype(np.float32), emb.astype(np.float32)
