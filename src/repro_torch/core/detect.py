"""Multi-camera identity detection (paper §5.4).

The PyTorch counterpart of ``repro.core.detect``.  Finding a query with
*unknown* location: maintain P[c, w] — the probability that the (still
unscanned) query appears in camera c during time-window w — propagated
through the spatio-temporal model:

    P[c, w] = P*_c·[w = 0] + Σ_{ci, dw>=1} I[ci, w-dw] · P[ci, w-dw]
                                   · S(ci, c) · Tw(ci, c, dw)

where I marks cells not yet scanned.  Each round scans every cell with
P >= θ · max P, pays window·|cells| compute, and stops at the first re-id
match.  ``propagate`` runs on the device; the per-round search stays a
host loop, as in the reference, with P brought to the host each round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fporder
from repro_torch.core.correlation import SpatioTemporalModel
from repro_torch.core.simulate import Visits
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    theta: float = 0.95
    window: int = 20            # steps per window
    match_thresh: float = 0.28
    max_rounds: int = 400
    max_travel_windows: int = 16
    # Surfacing prior: the paper places all prior mass at w=0 (identity
    # *enters* the network at search start).  A query that is already
    # mid-trajectory (our "reported lost" scenario) surfaces at a geometric
    # spread of early windows instead; rho=0 recovers the paper's formula.
    surface_rho: float = 0.97


def _surface_weights(rho: float, n_windows: int) -> torch.Tensor:
    """(n_windows,) float32 ``(1 - rho) * rho ** w`` in the reference's
    order: ``rho ** w`` is float32(rho) raised to w, correctly rounded to
    float32 (raised in float64 on the host, so the card and the host share
    it), times float32(1 - rho).  The reference's float32 power agrees
    with it at the default rho = 0.97 over the first 300 windows; for some
    other rho it is one ulp off at some w."""
    rho32 = np.float32(rho)
    power = (np.float64(rho32) ** np.arange(n_windows)).astype(np.float32)
    return torch.from_numpy(power) * torch.tensor(1 - rho,
                                                  dtype=torch.float32)


def propagate(model: SpatioTemporalModel, I: torch.Tensor, n_windows: int,
              p: DetectorParams) -> torch.Tensor:
    """P (Q, C, W) given scan indicators I (Q, C, W) (1 = unscanned), on
    I's device.  The contraction over (source camera, delay) is
    ``fporder.tree_sum``'s pairwise sum, so the card and the host give the
    same bits; against the reference's matrix product it differs by
    rounding only."""
    Q, C, W = I.shape
    model = model.to(I.device)
    Tw = model.window_transfer(p.window, p.max_travel_windows)   # (C, C, DW)
    M = model.S[:, :, None] * Tw                                 # (C, C, DW)
    DW = M.shape[-1]
    # M as (destination, delay * C + source), the contraction axis last
    Mk = M.permute(1, 2, 0).reshape(C, DW * C)

    # occupancy prior: where identities in the network tend to be (inbound
    # traffic distribution), mixed with the entry distribution
    inbound = model.counts.sum(0)
    occupancy = fporder.div(inbound, torch.clamp(inbound.sum(), min=1.0))
    prior = 0.5 * occupancy + 0.5 * model.entry
    if p.surface_rho > 0:
        scale = _surface_weights(p.surface_rho, W).to(I.device)
        base = prior[None, :] * scale[:, None]                   # (W, C)
    else:
        base = torch.zeros((W, C), dtype=torch.float32, device=I.device)
        base[0] = prior

    hist = torch.zeros((DW, Q, C), dtype=torch.float32, device=I.device)
    Ps = []
    for w in range(W):
        A = hist.permute(1, 0, 2).reshape(Q, 1, DW * C)          # recent I*P
        P_w = base[w] + fporder.tree_sum(A * Mk)
        hist = torch.cat([(P_w * I[:, :, w])[None], hist[:-1]])
        Ps.append(P_w)
    return torch.stack(Ps, dim=-1)                               # (Q, C, W)


def _presence_and_dist(visits: Visits, feats: np.ndarray, q_vids: np.ndarray,
                       window: int, n_windows: int, t_refs=None):
    """Per query: (C, W) true-entity presence and min feature distance over
    windows RELATIVE to the query's reference time (its last sighting — the
    'reported lost at t_ref' frame).  Window w covers
    [t_ref + w*window, t_ref + (w+1)*window)."""
    C = visits.n_cams
    W = n_windows
    Q = len(q_vids)
    q_ent = visits.ent[q_vids]
    q_feat = feats[q_vids]                                       # (Q, D)
    if t_refs is None:
        t_refs = visits.t_out[q_vids]                            # (Q,)
    t_ref = np.broadcast_to(np.asarray(t_refs), (Q,))
    presence = np.zeros((Q, C, W), bool)
    mind = np.full((Q, C, W), np.inf, np.float32)
    d_all = 1.0 - feats @ q_feat.T                               # (V, Q)
    for vid in range(len(visits)):
        c = visits.cam[vid]
        # per-query relative window span of this visit
        w_in = (visits.t_in[vid] - t_ref) // window              # (Q,)
        w_out = (visits.t_out[vid] - t_ref) // window
        for q in range(Q):
            a, b = int(w_in[q]), int(w_out[q])
            if b < 0 or a >= W:
                continue
            a, b = max(a, 0), min(b, W - 1)
            dv = d_all[vid, q]
            sl = mind[q, c, a:b + 1]
            np.minimum(sl, dv, out=sl)
            if visits.ent[vid] == q_ent[q]:
                presence[q, c, a:b + 1] = True
    return presence, mind


def make_detection_queries(visits: Visits, n: int, search_start: int,
                           seed: int = 0, max_delay_windows: int = 48,
                           window: int = 20):
    """Lost-identity scenario (paper §5.4): entities that ENTER the network at
    an unknown time after ``search_start``.  Returns the query vids: each
    entity's first visit; the search reference time is ``search_start``
    for every query."""
    rng = np.random.default_rng(seed)
    first = {}
    order = np.lexsort((visits.t_in, visits.ent))
    for vid in order[::-1]:
        first[int(visits.ent[vid])] = int(vid)
    horizon = search_start + max_delay_windows * window
    cands = [v for v in first.values()
             if search_start < visits.t_in[v] < horizon]
    rng.shuffle(cands)
    return np.array(cands[:n], np.int32)


def identity_detection(model: SpatioTemporalModel, visits: Visits,
                       feats: np.ndarray, q_vids: np.ndarray,
                       p: DetectorParams, baseline: bool = False,
                       n_windows: int = 64, t_refs=None, *,
                       device="cuda") -> dict:
    """Returns dict(cost, recall, precision, found_rate, rounds);
    ``propagate`` runs on ``device``.

    ``t_refs``: per-query (or scalar) search start; default = each query's
    last sighting (tracking hand-off).  For the lost-identity scenario pass
    the common search start from ``make_detection_queries``."""
    dev = resolve_device(device)
    C = visits.n_cams
    W = n_windows
    Q = len(q_vids)
    presence, mind = _presence_and_dist(visits, feats, q_vids, p.window, W,
                                        t_refs=t_refs)
    match_table = mind < p.match_thresh                          # flagged if scanned
    correct_table = match_table & presence

    I = np.ones((Q, C, W), np.float32)
    found = np.zeros(Q, bool)
    found_correct = np.zeros(Q, bool)
    cost = np.zeros(Q, np.float64)
    n_flagged = np.zeros(Q, np.int64)

    if baseline:
        # scan everything in time order until the query is verifiably found
        # (flags along the way are retrievals the verifier must sift through)
        for q in range(Q):
            for w in range(W):
                cost[q] += C * p.window
                flags = match_table[q, :, w]
                n_flagged[q] += int(flags.sum())
                if (correct_table[q, :, w]).any():
                    found[q] = found_correct[q] = True
                    break
        return _detect_summary(cost, found, found_correct, n_flagged, 0)

    model = model.to(dev)
    rounds = 0
    active = np.ones(Q, bool)
    for rounds in range(1, p.max_rounds + 1):
        if not active.any():
            break
        P = propagate(model, torch.from_numpy(I).to(dev), W, p).cpu().numpy()
        P = P * I                                                # only unscanned cells
        for q in np.where(active)[0]:
            # likelihood threshold relative to the current best cell: high
            # theta scans only the most probable cells (cheapest), low theta
            # casts a wider net per round (paper Fig. 17's theta sweep).
            pmax = P[q].max()
            if pmax <= 0:
                active[q] = False
                continue
            cells = P[q] >= p.theta * pmax
            cost[q] += cells.sum() * p.window
            I[q][cells] = 0.0
            flags = match_table[q] & cells
            n_flagged[q] += int(flags.sum())
            if (correct_table[q] & cells).any():
                found[q] = found_correct[q] = True
                active[q] = False
            elif I[q].sum() == 0:
                active[q] = False                                # exhausted
    return _detect_summary(cost, found, found_correct, n_flagged, rounds)


def _detect_summary(cost, found, found_correct, n_flagged, rounds):
    return {
        "cost": float(cost.sum()),
        "recall": float(found_correct.mean()),
        "precision": float(found_correct.sum() / max(n_flagged.sum(), 1)),
        "found_rate": float(found.mean()),
        "rounds": int(rounds),
    }
