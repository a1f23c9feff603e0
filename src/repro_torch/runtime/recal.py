"""Drift-aware recalibration: the online re-profiling loop (paper §6).

The counterpart of ``repro.runtime.recal``.  The engine attributes every
phase-2 rescue to its (anchor camera, match camera) pair in a live
``rescue_pairs`` (C, C) host matrix, and ``profiler.drift_score``
normalises it by the profile's own transition counts.  This module closes
the loop:

  ``RecalibrationController``  polls the score every ``poll_every`` ticks,
      and when the score reaches ``drift_threshold`` AND at least
      ``min_rescues`` rescues were observed AND ``cooldown`` ticks passed
      since the last swap, re-profiles a fresh M from a sliding ``window``
      of recent trajectories and hot-swaps it into the engine through
      ``engine.swap_model`` (epoch-bumped, between rounds).

Trajectory sources, ``source(lo, hi) -> (ent, cam, t_in, t_out)``:

  ``visits_window_source(visits)``  the deployment recipe: the visits of a
      ground-truth table active in the window (re-running the MTMC
      profiling pass over recent video).
  ``match_log_source(engine)``  the engine's own confirmed sightings
      (submit anchors and matches, entity = query id); the default.

The loop is host numpy, as in the reference: the score, the trigger and
the re-profile run on the host, and only the swapped model goes to the
engine's device.  After a swap the rescue matrix is reset: the old
rescues were evidence against the old model.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.profiler import (build_model, drift_score,
                                       merge_reprofiled_rows)
from repro_torch.core.simulate import Visits

# (ent, cam, t_in, t_out) arrays for a time window: what build_model eats
VisitSource = Callable[[int, int], tuple]


@dataclasses.dataclass(frozen=True)
class RecalibrationPolicy:
    """Trigger knobs for the §6 re-profiling loop.  All times are engine
    ticks (= simulation steps)."""

    # Trip when drift_score.max() reaches this.  One rescue on a pair the
    # profile never saw scores 1/smoothing (~0.33); k rescues on a pair
    # with n historical transitions score k/(n+smoothing).
    drift_threshold: float = 0.1
    min_rescues: int = 16          # total rescues before the score is trusted
    cooldown: int = 240            # min ticks between swaps (hysteresis)
    poll_every: int = 20           # score polling cadence
    window: int = 1200             # sliding re-profile window (recent steps)
    smoothing: float = 3.0         # drift_score additive smoothing
    reset_rescues: bool = True     # zero the rescue matrix after a swap
    # Row-targeted re-profiling: re-profile only the source-camera rows
    # whose per-row drift score reaches ``row_threshold`` (None: reuse
    # ``drift_threshold``) and merge them into the incumbent model
    # (``profiler.merge_reprofiled_rows``; untouched rows carry bit-exact).
    targeted: bool = False
    row_threshold: float | None = None


def visits_window_source(visits: Visits) -> VisitSource:
    """``source(lo, hi)``: the visits of a ground-truth ``Visits`` table
    active inside [lo, hi)."""
    ent = np.asarray(visits.ent)
    cam = np.asarray(visits.cam)
    t_in = np.asarray(visits.t_in)
    t_out = np.asarray(visits.t_out)

    def source(lo: int, hi: int):
        keep = (t_out >= lo) & (t_in < hi)
        return ent[keep], cam[keep], t_in[keep], t_out[keep]

    return source


def match_log_source(engine) -> VisitSource:
    """``source(lo, hi)``: the engine's confirmed sightings with a frame in
    [lo, hi), each a zero-dwell visit, so consecutive sightings of one
    query yield the (c_s -> c_d, dt) transitions the profiler counts."""

    def source(lo: int, hi: int):
        rows = [(q, c, f) for (q, c, f) in engine.sightings if lo <= f < hi]
        if not rows:
            z = np.zeros(0, np.int64)
            return z, z, z, z
        ent, cam, f = map(np.asarray, zip(*rows))
        return ent, cam, f, f

    return source


class RecalibrationController:
    """Watches one engine's live drift signal and hot-swaps its model.

    Attach through ``repro_torch.api.serve(recalibrate=...)`` (the engine
    then calls ``on_tick`` after every tick) or drive ``on_tick`` /
    ``maybe_recalibrate`` yourself.  ``clock`` defaults to the engine's
    wall tick ``engine.t``."""

    def __init__(self, engine, visit_source: VisitSource | None = None,
                 policy: RecalibrationPolicy = RecalibrationPolicy(),
                 clock: Callable[[], int] | None = None):
        self.engine = engine
        self.visit_source = visit_source if visit_source is not None \
            else match_log_source(engine)
        self.policy = policy
        self.clock = clock if clock is not None else (lambda: engine.t)
        self.events: list[dict] = []   # one dict per completed swap
        # recent score history, bounded: a long-running engine polls forever
        self.polls: collections.deque[dict] = collections.deque(maxlen=512)
        self._last_poll: int | None = None
        self._last_swap: int | None = None
        # profiler call accounting: rows re-profiled (a full rebuild books
        # all C), swaps per mode, the host seconds inside the profiling
        # step, and (profile s, swap s) of each swap, the swap's seconds
        # covering the model's copy to the engine's device
        self.rows_reprofiled = 0
        self.full_rebuilds = 0
        self.targeted_swaps = 0
        self.profile_wall = 0.0
        self.walls: list[tuple[float, float]] = []

    # -- the drift signal --------------------------------------------------
    def score(self) -> np.ndarray:
        """(C, C) drift score of the engine's live rescue matrix against its
        current model (``profiler.drift_score``)."""
        return drift_score(self.engine.model, self.engine.rescue_pairs,
                           self.policy.smoothing)

    # -- the trigger -------------------------------------------------------
    def on_tick(self) -> dict | None:
        """Per-tick hook: polls every ``poll_every`` ticks; returns the swap
        event when a recalibration fired, else None."""
        t = int(self.clock())
        if self._last_poll is not None and \
                t - self._last_poll < self.policy.poll_every:
            return None
        self._last_poll = t
        return self.maybe_recalibrate(t)

    def maybe_recalibrate(self, t: int | None = None) -> dict | None:
        """One trigger evaluation (hysteresis included) at time ``t``."""
        p = self.policy
        t = int(self.clock()) if t is None else t
        rescues = int(np.asarray(self.engine.rescue_pairs).sum())
        score_mat = self.score()
        score = float(score_mat.max())
        self.polls.append(dict(t=t, score=score, rescues=rescues))
        if rescues < p.min_rescues:            # small-sample guard
            return None
        if score < p.drift_threshold:          # no drift evidence
            return None
        if self._last_swap is not None and t - self._last_swap < p.cooldown:
            return None                        # cooling down: no thrash
        return self._recalibrate(t, score, rescues, score_mat)

    # -- the re-profile + hot-swap ----------------------------------------
    def _recalibrate(self, t: int, score: float, rescues: int,
                     score_mat: np.ndarray | None = None) -> dict | None:
        p = self.policy
        lo, hi = max(t - p.window, 0), t
        ent, cam, t_in, t_out = self.visit_source(lo, hi)
        if len(ent) == 0:
            return None                        # nothing to profile from
        old = self.engine.model
        if p.targeted:
            # re-profile only the source rows the drift score implicates
            if score_mat is None:
                score_mat = self.score()
            thr = p.drift_threshold if p.row_threshold is None \
                else p.row_threshold
            row_max = np.asarray(score_mat).max(axis=1)
            rows = np.flatnonzero(row_max >= thr)
            if len(rows) == 0:                 # trigger fired: take the worst
                rows = np.array([int(row_max.argmax())], np.int64)
            t_prof = time.perf_counter()
            fresh = merge_reprofiled_rows(old, ent, cam, t_in, t_out, rows)
            self.targeted_swaps += 1
            mode = "targeted"
        else:
            t_prof = time.perf_counter()
            fresh = build_model(ent, cam, t_in, t_out, self.engine.C,
                                n_bins=old.n_bins, bin_width=old.bin_width,
                                device=self.engine.device)
            self.full_rebuilds += 1
            rows = np.arange(self.engine.C, dtype=np.int64)
            mode = "full"
        t_swap = time.perf_counter()
        self.profile_wall += t_swap - t_prof
        self.rows_reprofiled += int(len(rows))
        epoch = self.engine.swap_model(fresh)
        self.walls.append((t_swap - t_prof, time.perf_counter() - t_swap))
        if p.reset_rescues:
            self.engine.rescue_pairs[:] = 0
        self._last_swap = t
        event = dict(t=t, epoch=epoch, score=score, rescues=rescues,
                     window=(lo, hi), visits=int(len(ent)), mode=mode,
                     rows=int(len(rows)),
                     row_ids=[int(r) for r in rows] if mode == "targeted"
                     else None)
        self.events.append(event)
        return event
