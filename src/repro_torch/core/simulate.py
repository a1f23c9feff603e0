"""Calibrated camera-network trajectory simulators (DESIGN.md §7).

DukeMTMC/Porto raw video is not distributable, so the paper's claims are
validated against simulators calibrated to its published statistics:

  duke_like_network   — 8 cameras; transition matrix built to match the
                        paper's Fig. 4 properties (≈1.9/7 peers receive >=5%
                        of outbound traffic; >50% of c7→c6 but <25% reverse;
                        c5 correlated with c2/c6 but not the nearer c7/c8),
                        travel times μ≈44.2s σ≈10.3s pooled (§3.1.2),
                        ~2700 identities / 85 min (§8.1).
  anoncampus_like     — 5 cameras on a hallway path graph, heavier occlusion
                        noise (indoor), 35 min (§8.1).
  porto_like_network  — 130 cameras on a road grid; taxis random-walk with
                        momentum; spatial locality emerges from the graph
                        (§8.1, Fig. 12/13).

One simulation step = 1 second.  The paper's frame counts are per-frame at
60/24 fps; all reported *ratios* (savings, recall, precision) are invariant
to the per-second aggregation, which we verify by also reporting fps-scaled
frame counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraNetwork:
    name: str
    n_cams: int
    trans: np.ndarray        # (C, C+1) row-stochastic next-camera probs; last col = exit
    travel_mean: np.ndarray  # (C, C) seconds
    travel_std: np.ndarray   # (C, C)
    entry: np.ndarray        # (C,) entry-camera distribution
    dwell_mean: float        # mean seconds an entity stays in one FOV
    geo_adjacent: np.ndarray  # (C, C) bool — the geo-proximity baseline's mask
    fps: int = 60            # native frame rate (for fps-scaled frame counts)


@dataclasses.dataclass
class Visits:
    """Detection log: one row per (entity, camera) visit."""
    ent: np.ndarray     # (V,) entity id
    cam: np.ndarray     # (V,) camera id
    t_in: np.ndarray    # (V,) first visible step
    t_out: np.ndarray   # (V,) last visible step (inclusive)
    horizon: int        # total simulated steps
    n_cams: int
    # normalized sub-frame detection position in [0, 1)^2, one per visit —
    # grid-agnostic, so one simulated world serves every tile_grid choice
    # (``tile_index`` quantizes at consumption time).  None = no spatial
    # labels (tile-granular admission degrades to whole-camera).
    tile_xy: np.ndarray | None = None   # (V, 2) float32 (x, y)

    def __len__(self):
        return len(self.ent)


def tile_index(tile_xy: np.ndarray, tile_grid: int) -> np.ndarray:
    """Quantize normalized (x, y) detection positions onto a T x T grid:
    flat tile id = floor(y*T)*T + floor(x*T), int32 in [0, T*T)."""
    xy = np.clip(np.asarray(tile_xy, np.float64), 0.0, np.nextafter(1.0, 0.0))
    tx = np.floor(xy[..., 0] * tile_grid).astype(np.int32)
    ty = np.floor(xy[..., 1] * tile_grid).astype(np.int32)
    return ty * np.int32(tile_grid) + tx


# ---------------------------------------------------------------------------
# network constructions
# ---------------------------------------------------------------------------

def duke_like_network() -> CameraNetwork:
    C = 8
    # Calibrated to paper Fig. 4's qualitative structure (see module docstring).
    T = np.array([
        #  c1     c2     c3     c4     c5     c6     c7     c8    exit
        [0.000, 0.510, 0.010, 0.005, 0.005, 0.005, 0.005, 0.160, 0.300],  # c1
        [0.350, 0.000, 0.330, 0.010, 0.010, 0.005, 0.005, 0.005, 0.285],  # c2
        [0.010, 0.360, 0.000, 0.280, 0.010, 0.005, 0.005, 0.005, 0.325],  # c3
        [0.005, 0.010, 0.330, 0.000, 0.300, 0.010, 0.005, 0.005, 0.335],  # c4
        [0.005, 0.300, 0.010, 0.015, 0.000, 0.330, 0.005, 0.005, 0.330],  # c5 -> 2,6 not 7,8
        [0.005, 0.010, 0.005, 0.010, 0.270, 0.000, 0.210, 0.015, 0.475],  # c6 -> 7 at 21% (<25%)
        [0.005, 0.005, 0.010, 0.005, 0.010, 0.560, 0.000, 0.085, 0.320],  # c7 -> 6 at 56% (>50%)
        [0.270, 0.010, 0.010, 0.005, 0.010, 0.015, 0.160, 0.000, 0.520],  # c8 -> 1,7; not 2,5
    ])
    assert np.allclose(T.sum(1), 1.0), T.sum(1)
    # Campus pedestrians wander: long tracks (many instances per identity, as
    # in DukeMTMC's 85-min footage) -> modest per-hop exit probability.
    exit_p = 0.12
    T[:, :C] *= (1.0 - exit_p) / T[:, :C].sum(1, keepdims=True)
    T[:, C] = exit_p
    rng = np.random.default_rng(7)
    # per-pair travel-time means spread around 44.2s, pooled sigma ~10.3s
    mean = np.clip(rng.normal(44.2, 8.0, (C, C)), 20.0, 75.0)
    std = np.clip(rng.normal(6.5, 1.5, (C, C)), 3.0, 10.0)
    # entries concentrate at the campus gates (cameras 1 and 8), as on the
    # real Duke deployment's perimeter cameras
    entry = np.array([0.42, 0.06, 0.04, 0.03, 0.05, 0.08, 0.06, 0.26])
    entry = entry / entry.sum()
    # geographic proximity baseline: ring-ish adjacency incl. the misleading
    # pairs the paper calls out (5-7, 5-8, 2-8 are geographically close).
    geo = np.zeros((C, C), bool)
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 0),
             (1, 4), (4, 6), (4, 7), (1, 7), (5, 7)]
    for a, b in pairs:
        geo[a, b] = geo[b, a] = True
    return CameraNetwork("duke-like", C, T, mean, std, entry,
                         dwell_mean=12.0, geo_adjacent=geo, fps=60)


def anoncampus_like_network() -> CameraNetwork:
    C = 5
    # hallway path: 1-2-3-4-5 with some skips (stairwells)
    T = np.array([
        [0.00, 0.52, 0.06, 0.02, 0.02, 0.38],
        [0.30, 0.00, 0.34, 0.04, 0.02, 0.30],
        [0.04, 0.32, 0.00, 0.30, 0.04, 0.30],
        [0.02, 0.04, 0.34, 0.00, 0.28, 0.32],
        [0.02, 0.02, 0.06, 0.44, 0.00, 0.46],
    ])
    assert np.allclose(T.sum(1), 1.0)
    exit_p = 0.18
    T[:, :C] *= (1.0 - exit_p) / T[:, :C].sum(1, keepdims=True)
    T[:, C] = exit_p
    rng = np.random.default_rng(11)
    mean = np.clip(rng.normal(18.0, 5.0, (C, C)), 8.0, 35.0)  # indoor: short walks
    std = np.clip(rng.normal(4.0, 1.0, (C, C)), 2.0, 7.0)
    entry = np.array([0.3, 0.15, 0.1, 0.15, 0.3])
    geo = np.zeros((C, C), bool)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 4)]:
        geo[a, b] = geo[b, a] = True
    return CameraNetwork("anoncampus-like", C, T, mean, std, entry,
                         dwell_mean=8.0, geo_adjacent=geo, fps=24)


def porto_like_network(n_cams: int = 130, grid=(13, 10), seed: int = 3) -> CameraNetwork:
    """Road-grid city: cameras at intersections, taxi-like momentum walks.

    The transition structure is derived from the grid adjacency: from each
    intersection, traffic continues straight with higher probability than it
    turns (momentum is approximated at the network level by non-uniform
    neighbor weights), and a fraction exits (trip ends)."""
    rows, cols = grid
    assert rows * cols >= n_cams
    rng = np.random.default_rng(seed)
    coords = np.array([(r, c) for r in range(rows) for c in range(cols)][:n_cams])
    C = n_cams
    T = np.zeros((C, C + 1))
    dist = np.abs(coords[:, None] - coords[None]).sum(-1)       # manhattan
    for i in range(C):
        nbrs = np.where(dist[i] == 1)[0]
        if len(nbrs) == 0:
            T[i, C] = 1.0
            continue
        w = rng.dirichlet(np.full(len(nbrs), 0.6)) * 0.75       # skewed main-road flow
        # a little long-range leakage (trips that skip an instrumented node)
        far = np.where(dist[i] == 2)[0]
        fw = np.zeros(0)
        if len(far):
            fw = rng.dirichlet(np.full(len(far), 0.4)) * 0.10
        exit_p = 1.0 - w.sum() - fw.sum()
        T[i, nbrs] = w
        if len(far):
            T[i, far] = fw
        T[i, C] = exit_p
    # block length ~300m at urban speeds ~20-40 km/h -> 30-55 s per hop
    base = rng.uniform(30.0, 55.0, (C, C))
    mean = base * np.maximum(dist, 1)
    std = np.clip(mean * 0.18, 2.0, 25.0)
    entry = rng.dirichlet(np.full(C, 2.0))
    geo = dist <= 4  # paper: geo-proximity threshold 4*l (l=100m)
    np.fill_diagonal(geo, False)
    return CameraNetwork(f"porto-like-{C}", C, T, mean, std, entry,
                         dwell_mean=6.0, geo_adjacent=geo, fps=1)


def clustered_city_network(n_cams: int = 130, n_clusters: int | None = None,
                           seed: int = 17) -> CameraNetwork:
    """Large synthetic deployment for the paper's 130-camera soak (§8.1):
    clusters of cameras (a neighborhood: one hub + leaves) joined by a
    corridor graph over the hubs (arterial roads).

    Structure, per cluster (cameras are CONTIGUOUS id blocks — cluster k owns
    ``[starts[k], starts[k+1])`` with the hub first — so localized drift
    injections can permute one block without touching the rest):

      * leaves feed the hub heavily and their ring neighbors lightly
        (local foot traffic),
      * the hub fans back out to its leaves and to corridor-adjacent hubs
        (a ring over clusters plus seeded chords),
      * intra-cluster hops are short (~8-20 s), corridor hops long
        (~30-70 s) — two clearly separated travel-time regimes, which is
        what makes the temporal windows discriminative at this scale,
      * entry mass concentrates at hubs (where traffic enters a
        neighborhood), ``geo_adjacent`` = cluster-mates + corridor pairs.

    Every draw comes from one ``default_rng(seed)`` in a fixed order, so the
    topology is bit-reproducible per (n_cams, n_clusters, seed) — the soak
    differential harness depends on that."""
    C = n_cams
    if n_clusters is None:
        # ~13-camera neighborhoods at C=130; at least 2 so a corridor exists
        n_clusters = max(2, int(round(np.sqrt(C / 1.3))))
    assert C >= 2 * n_clusters, \
        f"need >= 2 cameras per cluster: C={C}, n_clusters={n_clusters}"
    rng = np.random.default_rng(seed)
    sizes = np.full(n_clusters, C // n_clusters)
    sizes[: C % n_clusters] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)])
    members = [np.arange(starts[k], starts[k + 1]) for k in range(n_clusters)]
    hubs = np.array([int(m[0]) for m in members])

    # corridor graph over hubs: a ring plus ~K/2 chords
    corridor = {(k, (k + 1) % n_clusters) for k in range(n_clusters)}
    for _ in range(n_clusters // 2):
        a, b = rng.choice(n_clusters, 2, replace=False)
        corridor.add((min(a, b), max(a, b)))

    W = np.zeros((C, C))
    for k in range(n_clusters):
        hub, leaves = hubs[k], members[k][1:]
        n_leaf = len(leaves)
        for i, v in enumerate(leaves):
            W[v, hub] += 3.0                       # leaf -> hub: dominant
            if n_leaf > 1:                         # leaf ring: light local flow
                W[v, leaves[(i + 1) % n_leaf]] += 1.0
                W[v, leaves[(i - 1) % n_leaf]] += 1.0
            W[hub, v] += 1.0                       # hub fans back out
    for a, b in sorted(corridor):
        W[hubs[a], hubs[b]] += 2.5
        W[hubs[b], hubs[a]] += 2.5
    # per-edge seeded perturbation: no two pairs identically weighted
    W *= rng.uniform(0.7, 1.3, W.shape)
    np.fill_diagonal(W, 0.0)

    exit_p = 0.15
    row = W.sum(1)
    assert (row > 0).all()                          # every camera has an edge
    T = np.zeros((C, C + 1))
    T[:, :C] = W / row[:, None] * (1.0 - exit_p)
    T[:, C] = exit_p

    same_cluster = np.zeros((C, C), bool)
    for m in members:
        same_cluster[np.ix_(m, m)] = True
    mean = np.where(same_cluster, rng.uniform(8.0, 20.0, (C, C)),
                    rng.uniform(30.0, 70.0, (C, C)))
    std = np.clip(mean * 0.15, 1.5, 8.0)

    entry = np.full(C, 0.4 / C)                    # 60% of entries at hubs
    entry[hubs] += 0.6 / n_clusters
    entry = entry / entry.sum()

    geo = same_cluster.copy()
    for a, b in sorted(corridor):
        geo[hubs[a], hubs[b]] = geo[hubs[b], hubs[a]] = True
    np.fill_diagonal(geo, False)
    return CameraNetwork(f"city-{C}", C, T, mean, std, entry,
                         dwell_mean=10.0, geo_adjacent=geo, fps=1)


def permute_network(net: CameraNetwork, perm) -> CameraNetwork:
    """Traffic-pattern shift (paper §6's drift risk): relabel the topology by
    a camera permutation — camera i now behaves like camera ``perm[i]`` did
    (transitions, travel times, entry mass, geo adjacency all follow).  A
    derangement makes a model profiled on ``net`` wrong on essentially every
    pair, which is the drift injection ``drift_sweep`` uses."""
    perm = np.asarray(perm)
    C = net.n_cams
    assert sorted(perm.tolist()) == list(range(C)), perm
    T = np.zeros_like(net.trans)
    T[:, :C] = net.trans[np.ix_(perm, perm)]
    T[:, C] = net.trans[perm, C]
    return CameraNetwork(
        f"{net.name}-perm", C, T,
        net.travel_mean[np.ix_(perm, perm)],
        net.travel_std[np.ix_(perm, perm)],
        net.entry[perm], net.dwell_mean,
        net.geo_adjacent[np.ix_(perm, perm)], net.fps)


def concat_visits(a: Visits, b: Visits, t_offset: int) -> Visits:
    """One continuous detection stream: ``b`` replayed starting ``t_offset``
    steps into ``a``'s clock, entity ids relabeled disjoint.  The mid-run
    traffic-pattern shift for drift experiments: a = the old world, b = the
    shifted world from ``t_offset`` on."""
    assert a.n_cams == b.n_cams
    e_off = int(a.ent.max()) + 1 if len(a) else 0
    tiles = None
    if a.tile_xy is not None and b.tile_xy is not None:
        tiles = np.concatenate([a.tile_xy, b.tile_xy])
    return Visits(
        np.concatenate([a.ent, b.ent + e_off]),
        np.concatenate([a.cam, b.cam]),
        np.concatenate([a.t_in, b.t_in + t_offset]),
        np.concatenate([a.t_out, b.t_out + t_offset]),
        max(a.horizon, t_offset + b.horizon), a.n_cams, tiles)


def restrict_network(net: CameraNetwork, cams: np.ndarray) -> CameraNetwork:
    """Sub-network over a camera subset (paper Fig. 13 scaling study).
    Transitions to removed cameras become exits."""
    cams = np.asarray(cams)
    C = len(cams)
    T = np.zeros((C, C + 1))
    T[:, :C] = net.trans[np.ix_(cams, cams)]
    T[:, C] = 1.0 - T[:, :C].sum(1)
    entry = net.entry[cams]
    entry = entry / entry.sum()
    return CameraNetwork(
        f"{net.name}-sub{C}", C, T,
        net.travel_mean[np.ix_(cams, cams)], net.travel_std[np.ix_(cams, cams)],
        entry, net.dwell_mean, net.geo_adjacent[np.ix_(cams, cams)], net.fps)


# ---------------------------------------------------------------------------
# trajectory simulation
# ---------------------------------------------------------------------------

# entry portals are a property of the camera PAIR geometry, not of any one
# simulation run: the doorway c7 feeds into c6 through sits at the same spot
# in every video.  Centers are drawn per directed (src, dst) pair from a
# dedicated generator seeded by the pair itself, so every seed/world over the
# same network shares them (what lets a model profiled on one world admit
# correctly on another).
_PORTAL_SALT = 0x7E11E5


def _portal_center(src: int, dst: int) -> np.ndarray:
    """Deterministic sub-frame entry region center for the directed camera
    pair (src -> dst), in [0.1, 0.9)^2 (portals sit inside the frame)."""
    g = np.random.default_rng([src, dst, _PORTAL_SALT])
    return g.uniform(0.1, 0.9, 2)


# detections scatter around the portal center by this much (normalized frame
# units).  At tile_grid=8 a tile is 0.125 wide, so ~95% of detections land
# within one tile of the center — the profiler's 3x3 smoothing halo covers
# the tail.
_PORTAL_JITTER = 0.03


def simulate_network(net: CameraNetwork, n_entities: int, horizon: int,
                     seed: int = 0) -> Visits:
    """Sample entity trajectories through the network -> visit table.

    Each visit also carries a normalized sub-frame position ``tile_xy``:
    network entries appear anywhere (uniform), while cross-camera handoffs
    appear near the directed pair's entry portal — the stable spatial
    structure CrossRoI-style tile admission learns and exploits."""
    rng = np.random.default_rng(seed)
    # spatial labels are an overlay on the visit process, not part of it:
    # they draw from their OWN generator so adding tile_xy left every
    # pre-existing world (visit order, dwell, transitions) bit-identical
    rng_xy = np.random.default_rng([seed, _PORTAL_SALT])
    ents, cams, tins, touts, xys = [], [], [], [], []
    C = net.n_cams
    enter_times = rng.uniform(0, horizon * 0.95, n_entities).astype(np.int64)
    for e in range(n_entities):
        t = int(enter_times[e])
        c = int(rng.choice(C, p=net.entry))
        xy = rng_xy.uniform(0.0, 1.0, 2)       # network entry: anywhere
        while t < horizon:
            dwell = max(2, int(rng.exponential(net.dwell_mean)))
            t_out = min(t + dwell, horizon - 1)
            ents.append(e)
            cams.append(c)
            tins.append(t)
            touts.append(t_out)
            xys.append(xy)
            if t_out >= horizon - 1:
                break
            nxt = int(rng.choice(C + 1, p=net.trans[c]))
            if nxt == C:
                break  # exits the network
            travel = max(1, int(rng.normal(net.travel_mean[c, nxt],
                                           net.travel_std[c, nxt])))
            xy = np.clip(_portal_center(c, nxt)
                         + rng_xy.normal(0.0, _PORTAL_JITTER, 2),
                         0.0, np.nextafter(1.0, 0.0))
            t = t_out + travel
            c = nxt
    return Visits(np.array(ents), np.array(cams), np.array(tins),
                  np.array(touts), horizon, C,
                  np.asarray(xys, np.float32).reshape(len(ents), 2))


# ---------------------------------------------------------------------------
# dense gallery (what the inference plane would extract per frame)
# ---------------------------------------------------------------------------

def build_gallery(visits: Visits, max_slots: int = 24):
    """Dense per-(camera, step) table of visit ids: (C, T, K) int32, -1 empty.

    The tracker reads gallery[c, t] as "entities detected in camera c's frame
    at step t" — i.e. the object-detector output the re-id model ranks."""
    C, T, K = visits.n_cams, visits.horizon, max_slots
    gal = np.full((C, T, K), -1, np.int32)
    fill = np.zeros((C, T), np.int32)
    overflow = 0
    for vid in range(len(visits)):
        c = visits.cam[vid]
        for t in range(visits.t_in[vid], visits.t_out[vid] + 1):
            k = fill[c, t]
            if k < K:
                gal[c, t, k] = vid
                fill[c, t] = k + 1
            else:
                overflow += 1
    return gal, overflow
