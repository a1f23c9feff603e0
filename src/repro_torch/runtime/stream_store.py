"""Per-camera ring buffer of recent frames — the replay substrate (paper §5.3).

The paper: "Implicit to replay search is also the ability to store videos in
the past.  However, this only needs to be for the last few minutes."  The
store keeps a bounded window per camera; replay reads are range queries into
it, and reads past the retention window raise (that replay would have to fall
back to cold storage — surfaced to the caller as a miss).

The *embedding plane* is delegated: alongside the raw frames the store
fronts a ``runtime.gallery.GalleryStore`` (injected; a per-engine
``LocalGalleryStore`` by default).  The serving engine writes each (camera, frame)
batch's backbone embeddings back via ``put_emb`` after the first (live)
pass, so a phase-2 replay re-read of a still-retained frame skips
re-embedding entirely — the single largest avoidable cost in the replay
path.  ``put_emb`` returns whether the write was actually cached: a frame
never appended (or already evicted) is refused, not silently dropped.
Embeddings are evicted together with their frames (``gallery.drop`` on
every frame eviction).

Eviction is O(1) amortized: appended keys go on a per-camera monotonic
deque, and each append pops only the keys that just crossed the retention
horizon.  Appends are expected in nondecreasing
``t`` order per camera (the engine's wall clock guarantees this); an
out-of-order append stays correct — ``get`` re-checks the horizon — but its
eviction may be deferred until the deque head reaches it.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np

from repro_torch.runtime.gallery import GalleryStore, LocalGalleryStore


class FrameStore:
    def __init__(self, n_cams: int, retention: int,
                 gallery: GalleryStore | None = None):
        self.n_cams = n_cams
        self.retention = retention
        self.gallery = gallery if gallery is not None \
            else LocalGalleryStore(n_cams, retention)
        self._buf: list[dict[int, Any]] = [dict() for _ in range(n_cams)]
        # per-detection flat tile ids riding alongside each frame (the
        # sub-frame admission plane's labels) — evicted in lockstep
        self._tiles: list[dict[int, Any]] = [dict() for _ in range(n_cams)]
        self._keys: list[collections.deque] = [collections.deque()
                                               for _ in range(n_cams)]
        self._latest = np.full(n_cams, -1, np.int64)

    def _horizon(self, cam: int) -> int:
        return int(self._latest[cam]) - self.retention

    def _evict(self, cam: int) -> None:
        horizon = self._horizon(cam)
        keys, buf, tiles = self._keys[cam], self._buf[cam], self._tiles[cam]
        while keys and keys[0] < horizon:
            key = keys.popleft()
            buf.pop(key, None)
            tiles.pop(key, None)
            self.gallery.drop(cam, key)   # embeddings never outlive frames

    def append(self, cam: int, t: int, frame: Any, tile: Any = None) -> None:
        if t not in self._buf[cam]:
            self._keys[cam].append(t)
        self._buf[cam][t] = frame
        if tile is not None:
            self._tiles[cam][t] = tile
        if t > self._latest[cam]:
            self._latest[cam] = t
        self._evict(cam)

    def get(self, cam: int, t: int) -> Any:
        if t < self._horizon(cam):
            raise KeyError(f"frame ({cam}, {t}) evicted (retention {self.retention})")
        return self._buf[cam].get(t)

    def get_tile(self, cam: int, t: int) -> Any:
        """Per-detection flat tile ids for a retained (cam, t) frame, or
        None when the frame carried no tile labels (tile-mode ingest makes
        labels mandatory, so a None here past ingest is a bookkeeping bug
        the engine surfaces as a RuntimeError — unlabeled gallery rows
        would carry cell -1 and silently match nothing)."""
        if t < self._horizon(cam):
            return None
        return self._tiles[cam].get(t)

    def range(self, cam: int, t0: int, t1: int) -> list[tuple[int, Any]]:
        """Frames in [t0, t1] still retained (replay read)."""
        horizon = self._horizon(cam)
        return [(t, self._buf[cam][t]) for t in range(max(t0, horizon), t1 + 1)
                if t in self._buf[cam]]

    # -- embedding plane (delegated to the gallery store) ------------------
    def put_emb(self, cam: int, t: int, emb: Any) -> bool:
        """Cache the backbone embeddings for a retained (cam, t) frame.
        Returns False (write refused, NOT silently dropped) when the frame
        was never appended or is already behind the retention horizon."""
        if t < self._horizon(cam) or t not in self._buf[cam]:
            self.gallery.rejected += 1   # refusals stay visible fleet-wide
            return False
        return self.gallery.put(cam, t, emb)

    def emb_cached(self, cam: int, t: int) -> bool:
        """Whether a retained embedding block for (cam, t) is resident —
        the prefetch plane's issue/consume validity check (no counters)."""
        return t >= self._horizon(cam) and self.gallery.cached(cam, t)

    def fetch_emb_async(self, cam: int, t: int):
        """Issue an async fetch for a cached (cam, t) embedding block: a
        handle for ``wait_emb``, or None when uncached / behind the frame
        horizon.  Counter-neutral at issue time — the prefetch consumer
        accounts hits and misspeculation exactly."""
        if t < self._horizon(cam):
            return None
        return self.gallery.fetch_async(cam, t)

    def wait_emb(self, handle) -> Any:
        return self.gallery.wait_fetch(handle)

    def get_emb(self, cam: int, t: int) -> Any:
        """Cached embeddings for (cam, t), or None (uncached / evicted).
        The frame horizon is re-checked here too: an out-of-order append
        whose eviction is deferred never serves a stale embedding."""
        if t < self._horizon(cam):
            self.gallery.misses += 1     # a lookup that found nothing
            return None
        return self.gallery.get(cam, t)

    def memory_frames(self) -> int:
        return sum(len(b) for b in self._buf)

    def cached_embeddings(self) -> int:
        return self.gallery.cached_embeddings()
