"""The admission control plane: one `SearchPolicy`, one `admit`, one `advance`.

The PyTorch counterpart of ``repro.core.policy`` (paper §5.1-§5.3,
Algorithm 1).  ``SearchPolicy`` is the frozen search configuration,
``PhaseState`` the batched (Q,) per-query search state, ``admit`` the
vectorized (Q, C) admission mask, ``admit_tiles`` its (camera x tile)
refinement and ``advance`` the phase machine.  All
of them run on whatever device the model and state tensors live on.

Thresholds are float32 arithmetic, as in the JAX reference: a threshold
is made a float32 tensor first and then combined (``1.0 - th``,
``s_thresh * relax``), because a Python-double ``1.0 - t_thresh`` can
land one ulp away and flip a CDF comparison.  ``window_end`` is the one
place the reference subtracts in Python doubles (its thresholds arrive as
Python floats), and it does the same here.

Phase semantics: phase 1 searches the normal spatio-temporal windows; when
those are exhausted the search rewinds to f_q + 1 and replays with
thresholds relaxed x ``relax_factor`` (phase 2); ``exhaustive_final=True``
adds the all-camera terminal sweep (phase 3).  ``exit_t`` bounds every
phase.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.core.correlation import SpatioTemporalModel


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The model query interface: thresholds vs the model's raw arrays.
# ---------------------------------------------------------------------------

def spatial_mask(model: "SpatioTemporalModel", c_s, s_thresh) -> torch.Tensor:
    """Destinations spatially correlated with c_s.

    Scalar c_s -> (C,); batched c_s (Q,) with per-query thresholds -> (Q, C).
    """
    c_s = torch.as_tensor(c_s, device=model.device)
    th = _f32(s_thresh, model.device)
    if c_s.ndim > 0 and th.ndim > 0:
        th = th[:, None]
    return model.S[c_s] >= th


def temporal_mask(model: "SpatioTemporalModel", c_s, elapsed,
                  t_thresh) -> torch.Tensor:
    """Destinations temporally correlated at ``elapsed`` steps since c_s.

    The fraction already arrived at time t is the CDF *before* t's bin (the
    exclusive form keeps the arrival bin itself searchable).  Scalar args ->
    (C,); batched (Q,) args -> (Q, C).
    """
    dev = model.device
    c_s = torch.as_tensor(c_s, device=dev)
    elapsed = torch.as_tensor(elapsed, device=dev)
    batched = c_s.ndim > 0 or elapsed.ndim > 0
    c, e = torch.broadcast_tensors(torch.atleast_1d(c_s),
                                   torch.atleast_1d(elapsed))
    th = _f32(t_thresh, dev).broadcast_to(c.shape)
    b = torch.clamp(torch.div(e, model.bin_width, rounding_mode="floor"),
                    0, model.n_bins - 1)
    arrived = torch.where((b > 0)[:, None],
                          model.cdf[c, :, torch.clamp(b - 1, min=0)], 0.0)
    started = e[:, None] >= model.f0[c]
    out = started & (arrived <= 1.0 - th[:, None])
    return out if batched else out[0]


def correlated(model: "SpatioTemporalModel", c_s, elapsed, s_thresh,
               t_thresh) -> torch.Tensor:
    """M(c_s, ·, elapsed): bool mask over destination cameras."""
    return spatial_mask(model, c_s, s_thresh) & \
        temporal_mask(model, c_s, elapsed, t_thresh)


def window_end(model: "SpatioTemporalModel", s_thresh: float,
               t_thresh: float) -> torch.Tensor:
    """(C,) int32 — per source camera, the elapsed time beyond which no
    admitted destination's temporal window is still open (Alg. 1 line 21).
    +1 bin for the exclusive-CDF convention of ``temporal_mask``.  The
    thresholds are Python floats: ``1.0 - t_thresh`` is a double rounded
    once to float32, as the reference's weak-typed scalar is."""
    dev = model.device
    open_bins = ((model.cdf <= _f32(1.0 - t_thresh, dev)).sum(
        -1, dtype=torch.int32) + 1) * model.bin_width
    open_bins = torch.clamp(open_bins, max=model.n_bins * model.bin_width)
    admitted = model.S >= _f32(s_thresh, dev)
    ends = torch.where(admitted, open_bins, 0)
    return ends.max(dim=1).values


def potential_savings(model: "SpatioTemporalModel", s_thresh: float,
                      t_thresh: float, weight_by_traffic: bool = True) -> float:
    """Analytic potential (paper §3.2): ratio of camera-steps searched by a
    correlation-agnostic baseline (all C cameras for the max window) to the
    camera-steps M admits, averaged over source cameras (optionally
    traffic-weighted).  Host numpy over the model's fields, as in the
    reference, so the float64 result is the reference's to the bit."""
    C = model.n_cams
    sp = model.S.cpu().numpy() >= s_thresh              # (C, C) searched pairs
    cdf = model.cdf.cpu().numpy()
    f0 = model.f0.cpu().numpy()
    NB = cdf.shape[-1]
    b = np.arange(NB)[None, None, :] * model.bin_width  # (1,1,NB) bin start times
    active = (b >= f0[..., None]) & (cdf <= 1.0 - t_thresh)   # (C,C,NB)
    steps = (active.sum(-1) * model.bin_width) * sp     # (C,C) searched steps
    per_src = steps.sum(1).astype(np.float64)           # camera-steps per source
    baseline = C * NB * model.bin_width
    if weight_by_traffic:
        w = model.counts.cpu().numpy().sum(1).astype(np.float64)
        w = w / max(w.sum(), 1.0)
        filt = float((per_src * w).sum())
    else:
        filt = float(per_src.mean())
    return baseline / max(filt, 1e-9)


# ---------------------------------------------------------------------------
# SearchPolicy — the one search configuration every consumer shares.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchPolicy:
    """Algorithm-1 parameters.  Frozen and hashable."""

    scheme: str = "rexcam"          # rexcam | all | geo | spatial_only
    s_thresh: float = 0.05
    t_thresh: float = 0.02
    exit_t: int = 240               # max steps without a match (baseline window)
    match_thresh: float = 0.28      # cosine-distance acceptance
    feat_alpha: float = 0.25        # query-representation EMA rate
    relax_factor: float = 10.0      # replay threshold relaxation (paper: x10)
    replay_speed: float = 1.0       # >1 = parallelism ("ff") mode
    replay_skip: int = 1            # >1 = frame-skip mode
    use_replay: bool = True
    exhaustive_final: bool = False  # paper-literal terminal all-camera pass
    self_window: int = 6            # steps the last-seen camera stays admitted

    @property
    def use_spatial(self) -> bool:
        return self.scheme in ("rexcam", "spatial_only")

    @property
    def use_temporal(self) -> bool:
        return self.scheme == "rexcam" and self.t_thresh > 0.0

    @property
    def replay_rate(self) -> float:
        """Content steps consumed per wall step while replaying."""
        return self.replay_speed * self.replay_skip


# ---------------------------------------------------------------------------
# PhaseState + precomputed exhaustion windows.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhaseState:
    """Batched (Q,) per-query search state — the Alg.-1 state machine."""

    f_q: torch.Tensor     # (Q,) int32   frame of the last confirmed sighting
    c_q: torch.Tensor     # (Q,) int32   camera of the last confirmed sighting
    f_curr: torch.Tensor  # (Q,) int32   content frame the search cursor is on
    phase: torch.Tensor   # (Q,) int32   1 = normal, 2 = relaxed replay, >=3 = exhaustive
    live_f: torch.Tensor  # (Q,) float32 live frontier (content time of "now")
    done: torch.Tensor    # (Q,) bool    search concluded

    @classmethod
    def init(cls, c_q, f_q, device="cpu") -> "PhaseState":
        """Fresh phase-1 state anchored at the (c_q, f_q) sightings."""
        f_q = torch.as_tensor(f_q, dtype=torch.int32, device=device)
        c_q = torch.as_tensor(c_q, dtype=torch.int32, device=device)
        return cls(f_q=f_q, c_q=c_q, f_curr=f_q + 1,
                   phase=torch.ones_like(f_q),
                   live_f=(f_q + 1).to(torch.float32),
                   done=torch.zeros(f_q.shape, dtype=torch.bool,
                                    device=device))

    @property
    def elapsed(self) -> torch.Tensor:
        return self.f_curr - self.f_q

    @property
    def behind(self) -> torch.Tensor:
        """Replaying: the cursor is strictly behind the live frontier."""
        return self.f_curr.to(torch.float32) < self.live_f - 0.5


@dataclasses.dataclass(frozen=True)
class PhaseWindows:
    """Per-source-camera exhaustion horizons for phases 1 and 2."""

    w_end1: torch.Tensor  # (C,) int32 phase-1 window end
    w_end2: torch.Tensor  # (C,) int32 relaxed (phase-2) window end


def phase_windows(model: "SpatioTemporalModel",
                  policy: SearchPolicy) -> PhaseWindows:
    t_th = policy.t_thresh if policy.use_temporal else 0.0
    w1 = window_end(model, policy.s_thresh, t_th)
    w2 = window_end(model, policy.s_thresh / policy.relax_factor,
                    t_th / policy.relax_factor)

    def clamp(w):
        return torch.clamp(torch.clamp(w, min=policy.self_window),
                           max=policy.exit_t)

    return PhaseWindows(w_end1=clamp(w1), w_end2=clamp(w2))


# ---------------------------------------------------------------------------
# admit — the one admission-mask construction.
# ---------------------------------------------------------------------------

def replay_sampled_out(policy: SearchPolicy, f_q, f_curr, behind):
    """§5.3 skip mode: True where a replaying cursor's content frame is
    sampled out by the 1-in-k gate.  Works batched (bool tensors, inside
    ``admit``) and scalar (Python ints/bools, the engine's host-side
    short-circuit of sampled-out replay rounds)."""
    if policy.replay_skip <= 1:
        return behind & False          # shape/type-preserving all-False
    return behind & ((f_curr - f_q) % policy.replay_skip != 0)


def admit(model: "SpatioTemporalModel", policy: SearchPolicy,
          state: PhaseState, geo_adj=None) -> torch.Tensor:
    """(Q, C) bool: which cameras each live query searches at its cursor.

    Combines the scheme's correlation mask, the self-camera follow window,
    the phase-2 threshold relaxation, the phase-3 exhaustive pass, and §5.3
    skip-mode sampling of historical frames.  Done queries admit nothing.
    """
    dev = model.device
    Q = state.f_q.shape[0]
    C = model.n_cams
    elapsed = state.elapsed

    # last-seen camera stays admitted briefly (single-camera follow)
    cams = torch.arange(C, dtype=state.c_q.dtype, device=dev)
    self_mask = (state.c_q[:, None] == cams[None, :]) & \
        (elapsed <= policy.self_window)[:, None]

    if policy.scheme == "all":
        mask = torch.ones((Q, C), dtype=torch.bool, device=dev)
    elif policy.scheme == "geo":
        if geo_adj is None:                 # no proximity data: degrade to all
            geo_adj = torch.ones((C, C), dtype=torch.bool, device=dev)
        mask = geo_adj[state.c_q] | self_mask
    else:
        relax = torch.where(state.phase >= 2,
                            _f32(1.0 / policy.relax_factor, dev),
                            _f32(1.0, dev))
        ones = torch.ones((Q, C), dtype=torch.bool, device=dev)
        sp = spatial_mask(model, state.c_q, _f32(policy.s_thresh, dev) * relax) \
            if policy.use_spatial else ones
        tp = temporal_mask(model, state.c_q, elapsed,
                           _f32(policy.t_thresh, dev) * relax) \
            if policy.use_temporal else ones
        mask = (sp & tp) | self_mask
        mask = mask | (state.phase >= 3)[:, None]           # exhaustive pass

    # lag-aware processing: behind the live frontier -> historical frames,
    # optionally sampled 1-in-k (skip mode)
    process = ~replay_sampled_out(policy, state.f_q, state.f_curr,
                                  state.behind)
    return mask & process[:, None] & (~state.done)[:, None]


def tile_follow_mask(tile_q: torch.Tensor, T: int) -> torch.Tensor:
    """(Q, T*T) bool: the 3x3 neighbourhood of each query's last-matched
    tile on the T x T grid, clipped at the frame's edges.  ``tile_q < 0``
    (no match yet) admits every tile.  ``//`` and ``%`` floor as ``jnp``'s
    do, so a negative ``tile_q`` lands where the reference puts it."""
    cells = torch.arange(T * T, dtype=torch.int32, device=tile_q.device)
    cy, cx = cells // T, cells % T
    qy, qx = tile_q[:, None] // T, tile_q[:, None] % T
    near = ((cy[None, :] - qy).abs() <= 1) & ((cx[None, :] - qx).abs() <= 1)
    return near | (tile_q < 0)[:, None]


def tile_admission(model: "SpatioTemporalModel", policy: SearchPolicy,
                   state: PhaseState, tile_q=None) -> torch.Tensor:
    """(Q, C, T*T) bool: which tiles of each destination camera a query
    searches, from the profiled masks ``model.tile_admit[c_q]``.

    Phases >= 2 admit every tile.  The self camera: with a learned model
    and ``tile_q`` given, inside the follow window its column is
    ``tile_follow_mask``, outside it the learned diagonal; a synthesised
    (tile-less) model keeps the whole frame inside the follow window,
    which keeps it identical to camera-granular serving."""
    C = model.n_cams
    tiles = model.tile_admit[state.c_q]                  # (Q, C, TT)
    cams = torch.arange(C, dtype=state.c_q.dtype, device=model.device)
    self_cam = state.c_q[:, None] == cams[None, :]       # one_hot(c_q, C)
    in_window = (state.elapsed <= policy.self_window)[:, None]
    if model.tile_learned and tile_q is not None:
        follow = tile_follow_mask(tile_q, model.tile_grid)     # (Q, TT)
        diag = model.tile_admit[state.c_q, state.c_q]          # (Q, TT)
        self_col = torch.where(in_window, follow, diag)
        tiles = torch.where(self_cam[:, :, None], self_col[:, None, :],
                            tiles)
    else:
        tiles = tiles | (self_cam & in_window)[:, :, None]
    return tiles | (state.phase >= 2)[:, None, None]


def admit_tiles(model: "SpatioTemporalModel", policy: SearchPolicy,
                state: PhaseState, geo_adj=None, tile_q=None):
    """Tile-granular admission: the (Q, C) camera mask (``admit``'s) and
    the fused (Q, C*T*T) cell admission the tile kernel consumes,
    ``mask_ct[q, c*T*T + t] = mask[q, c] & tile_admission[q, c, t]``.
    ``tile_q`` (Q,) int32 is each query's last-matched tile (-1 before the
    first match)."""
    mask = admit(model, policy, state, geo_adj)
    tiles = tile_admission(model, policy, state, tile_q)
    mask_ct = (mask[:, :, None] & tiles).reshape(mask.shape[0], -1)
    return mask, mask_ct


# ---------------------------------------------------------------------------
# advance — the one phase-machine transition.
# ---------------------------------------------------------------------------

def advance(policy: SearchPolicy, windows: PhaseWindows, state: PhaseState,
            matched: torch.Tensor, match_cam: torch.Tensor,
            horizon: int) -> PhaseState:
    """One Alg.-1 transition for every query at once.

    On a match: re-anchor at (match_cam, f_curr) and reset to phase 1.
    Otherwise advance the cursor; on window exhaustion escalate — phase 1
    rewinds to f_q + 1 with relaxed thresholds (phase 2), phase 2 either
    concludes exit or (``exhaustive_final``) enters the all-camera phase 3,
    which runs to the exit threshold.
    """
    matched = matched & ~state.done
    f_q = torch.where(matched, state.f_curr, state.f_q)
    c_q = torch.where(matched, match_cam.to(torch.int32), state.c_q)
    phase = torch.where(matched, torch.ones_like(state.phase), state.phase)

    f_next = state.f_curr + 1
    f_next_f = f_next.to(torch.float32)
    # behind the frontier: content advances (speed*skip) x realtime, so the
    # live frontier only moves 1/(speed*skip) wall-steps per content step
    rate = _f32(1.0 / policy.replay_rate, state.live_f.device)
    live_next = torch.where(state.behind, state.live_f + rate, f_next_f)
    live_next = torch.maximum(live_next, f_next_f)

    el_next = f_next - f_q
    if policy.scheme in ("all", "geo") or not policy.use_replay:
        done_new = state.done | (el_next > policy.exit_t) | (f_next >= horizon)
        phase_new = phase
        f_new = f_next
    else:
        nothing_relaxed = windows.w_end2[c_q] <= policy.self_window
        exh1 = (phase == 1) & (el_next > windows.w_end1[c_q])
        exh2 = (phase == 2) & (el_next > windows.w_end2[c_q])
        exh3 = (phase >= 3) & (el_next > policy.exit_t)
        if policy.exhaustive_final:
            esc = exh1 | exh2
            done_new = state.done | exh3 | (f_next >= horizon)
        else:
            esc = exh1 & ~nothing_relaxed
            done_new = (state.done | (exh1 & nothing_relaxed) | exh2 | exh3
                        | (f_next >= horizon))
        phase_new = torch.where(esc, phase + 1, phase)
        f_new = torch.where(esc, f_q + 1, f_next)

    return PhaseState(
        f_q=f_q,
        c_q=c_q,
        f_curr=torch.where(state.done, state.f_curr, f_new),
        phase=torch.where(state.done, state.phase, phase_new),
        live_f=torch.where(state.done, state.live_f, live_next),
        done=done_new,
    )
