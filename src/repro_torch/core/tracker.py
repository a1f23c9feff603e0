"""Query sampling for the tracker and the serving engine (paper §8.1C).

Only ``make_queries`` is ported so far; the batched tracker
(``track_queries`` / ``trace_queries``) is next in ROADMAP.md, Queue 1.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.simulate import Visits


def make_queries(visits: Visits, n_queries: int, seed: int = 0,
                 min_future_visits: int = 1, vmax: int = 32):
    """Sample query identities (paper §8.1C: drawn from the test partition).

    Returns (q_vids (Q,), gt_vids (Q, vmax) padded -1)."""
    rng = np.random.default_rng(seed)
    by_ent: dict[int, list[int]] = {}
    order = np.lexsort((visits.t_in, visits.ent))
    for vid in order:
        by_ent.setdefault(int(visits.ent[vid]), []).append(int(vid))
    candidates = [vs[0] for vs in by_ent.values() if len(vs) >= 1 + min_future_visits]
    rng.shuffle(candidates)
    chosen = candidates[:n_queries]
    q_vids = np.array(chosen, np.int32)
    gt = np.full((len(chosen), vmax), -1, np.int32)
    for i, v0 in enumerate(chosen):
        e = int(visits.ent[v0])
        future = [v for v in by_ent[e] if visits.t_in[v] > visits.t_out[v0]]
        gt[i, :min(len(future), vmax)] = future[:vmax]
    return q_vids, gt
