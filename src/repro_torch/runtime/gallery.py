"""The gallery/embedding plane: the (camera, frame) -> embedding-block
cache the serving engine consults before calling ``embed_fn``.

``LocalGalleryStore`` keeps host-resident per-camera dicts.  The base
class's retention bookkeeping mirrors ``FrameStore``: a per-camera
monotonic key deque gives O(1) amortized retention-horizon eviction on
``put``; an out-of-order ``put`` stays correct (``get`` re-checks the
horizon) but its eviction may be deferred until the deque head catches up
to it.  ``FrameStore`` calls ``drop`` for every frame key it evicts, so
embeddings never outlive their frames.  The fleet-wide sharded store is
not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np

from repro_torch.runtime.transport import LocalFetchHandle


def pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1) — the shared padding rule for the
    round batch and the round gallery."""
    return 1 << max(n - 1, 0).bit_length()


def l2_normalize(a: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Row-unit-normalize 1-D or 2-D embeddings (zero rows stay zero).

    The embedding plane's ONE normalization rule: the engines call this at
    ingest/update time so the hot round bodies never run host-numpy
    reductions per round."""
    a = np.asarray(a, np.float32)
    if a.ndim == 1:
        return a / max(float(np.linalg.norm(a)), eps)
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), eps)


class GalleryStore:
    """The embedding-plane contract both engines program to.

    ``put(cam, t, emb) -> bool`` caches one (camera, frame) embedding block
    (False = rejected: already behind the retention horizon), ``get`` returns
    the cached block or None (miss / evicted), ``drop`` removes one key (the
    frame-eviction driven path).  Subclasses implement the storage backend
    (``_store`` / ``_fetch`` / ``_drop``); retention bookkeeping and the
    hit/miss/eviction/put/rejected counters live here so every backend
    behaves identically.
    """

    kind = "base"

    def __init__(self, n_cams: int, retention: int):
        self.n_cams = n_cams
        self.retention = retention
        self._keys: list[collections.deque] = [collections.deque()
                                               for _ in range(n_cams)]
        self._latest = np.full(n_cams, -1, np.int64)
        self.hits = 0        # get() served from the store
        self.misses = 0      # get() found nothing (uncached or evicted)
        self.evictions = 0   # cached blocks dropped (horizon or frame-evict)
        self.puts = 0        # blocks accepted
        self.rejected = 0    # puts refused (behind the retention horizon)
        self.prefetch_hits = 0    # blocks served from the prefetch buffer
        self.prefetch_wasted = 0  # prefetched blocks discarded (misspeculation)

    # -- retention bookkeeping (FrameStore-identical) ----------------------
    def _horizon(self, cam: int) -> int:
        return int(self._latest[cam]) - self.retention

    def _evict_horizon(self, cam: int) -> None:
        horizon = self._horizon(cam)
        keys = self._keys[cam]
        while keys and keys[0] < horizon:
            key = keys.popleft()
            if self._drop(cam, key):
                self.evictions += 1

    # -- the contract ------------------------------------------------------
    def put(self, cam: int, t: int, emb: Any) -> bool:
        """Cache one embedding block; False when t is already behind the
        retention horizon (the write would be dead on arrival)."""
        if t > self._latest[cam]:
            self._latest[cam] = t
        if t < self._horizon(cam):
            self.rejected += 1
            return False
        if not self._has(cam, t):
            self._keys[cam].append(t)
        self._store(cam, t, emb)
        self.puts += 1
        self._evict_horizon(cam)
        return True

    def get(self, cam: int, t: int) -> Any:
        """Cached block for (cam, t), or None.  Re-checks the horizon so an
        out-of-order put whose eviction is deferred never serves stale data."""
        if t < self._horizon(cam):
            self.misses += 1
            return None
        emb = self._fetch(cam, t)
        if emb is None:
            self.misses += 1
        else:
            self.hits += 1
        return emb

    def cached(self, cam: int, t: int) -> bool:
        """Whether a retained block for (cam, t) is resident right now —
        the prefetch plane's validity check, no counters tick."""
        return t >= self._horizon(cam) and self._has(cam, t)

    def fetch_async(self, cam: int, t: int):
        """Issue an async fetch for a CACHED (cam, t) block: a handle for
        ``wait_fetch``, or None when the block is uncached / behind the
        horizon.  No hit/miss counters tick at issue time — the consumer
        accounts at consume time (``PrefetchPipeline``), so speculation
        never skews the cache statistics."""
        if t < self._horizon(cam) or not self._has(cam, t):
            return None
        return self._fetch_async(cam, t)

    def wait_fetch(self, handle) -> Any:
        """Deliver an async fetch.  May return None (the block vanished
        between issue and wait) or raise ``PeerDeadError`` (remote owner
        lost mid-fetch); the caller falls back to the blocking path."""
        if isinstance(handle, LocalFetchHandle):
            if handle.t < self._horizon(handle.cam):
                return None
            return self._fetch(handle.cam, handle.t)
        raise TypeError(f"unknown fetch handle {handle!r}")

    def drop(self, cam: int, t: int) -> bool:
        """Remove one key (frame-eviction driven: ``FrameStore`` calls this
        for every frame it evicts so embeddings never outlive frames).  The
        deque entry stays; popping it later is a no-op."""
        removed = self._drop(cam, t)
        if removed:
            self.evictions += 1
        return removed

    # -- backend hooks -----------------------------------------------------
    def _store(self, cam: int, t: int, emb: Any) -> None:
        raise NotImplementedError

    def _fetch(self, cam: int, t: int) -> Any:
        raise NotImplementedError

    def _drop(self, cam: int, t: int) -> bool:
        raise NotImplementedError

    def _has(self, cam: int, t: int) -> bool:
        raise NotImplementedError

    def _fetch_async(self, cam: int, t: int) -> Any:
        """Backend async fetch for a known-resident key.  The base path is
        the degenerate immediate handle (re-reads the store at wait time);
        a transport-backed store returns a real in-flight handle."""
        return LocalFetchHandle(cam, t)

    # -- accounting --------------------------------------------------------
    def cached_embeddings(self) -> int:
        raise NotImplementedError

    def memory_bytes(self) -> int:
        raise NotImplementedError

    def counters(self) -> dict:
        # transport-era keys are zeros here; a transport-backed store
        # overrides them with the live fetch-plane stats
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions, puts=self.puts,
                    rejected=self.rejected, cached=self.cached_embeddings(),
                    bytes=self.memory_bytes(),
                    prefetch_hits=self.prefetch_hits,
                    prefetch_wasted=self.prefetch_wasted,
                    remote_fetches=0, retries=0, timeouts=0)


class LocalGalleryStore(GalleryStore):
    """Host-resident per-camera dicts — today's per-engine semantics."""

    kind = "local"

    def __init__(self, n_cams: int, retention: int):
        super().__init__(n_cams, retention)
        self._emb: list[dict[int, Any]] = [dict() for _ in range(n_cams)]

    def _store(self, cam, t, emb):
        self._emb[cam][t] = emb

    def _fetch(self, cam, t):
        return self._emb[cam].get(t)

    def _drop(self, cam, t):
        return self._emb[cam].pop(t, None) is not None

    def _has(self, cam, t):
        return t in self._emb[cam]

    def cached_embeddings(self):
        return sum(len(e) for e in self._emb)

    def memory_bytes(self):
        return sum(getattr(e, "nbytes", 0)
                   for d in self._emb for e in d.values())


def assemble_round_gallery(batch_keys: list[tuple[int, int]],
                           key_emb: dict[tuple[int, int], np.ndarray]):
    """One round's deduplicated gallery, engine-ready: concatenate the
    per-key embedding blocks IN ``batch_keys`` ORDER (the engines pass
    camera-major sorted keys, which is what keeps the kernel's flat-argmin
    tie-breaking bit-identical to the tracker), tag every row with its
    (camera, frame), and pad rows to a power of two so the kernel sees
    few distinct shapes — padded rows carry cam/frame -1 and rank to
    (NEG_INF, -1) inside the kernels, so they never win a tie.  Returns
    (gallery (Gp, D), gal_cam (Gp,), gal_frame (Gp,))."""
    counts = [len(key_emb[k]) for k in batch_keys]
    gal = np.concatenate([key_emb[k] for k in batch_keys]).astype(np.float32)
    gal_cam = np.repeat([k[0] for k in batch_keys], counts).astype(np.int32)
    gal_frame = np.repeat([k[1] for k in batch_keys], counts).astype(np.int32)
    G = gal.shape[0]
    Gp = pow2(G)
    if Gp > G:
        gal = np.concatenate(
            [gal, np.zeros((Gp - G, gal.shape[1]), np.float32)])
        gal_cam = np.concatenate([gal_cam, np.full(Gp - G, -1, np.int32)])
        gal_frame = np.concatenate([gal_frame, np.full(Gp - G, -1, np.int32)])
    return gal, gal_cam, gal_frame
