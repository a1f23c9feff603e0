"""The gallery/embedding plane: the (camera, frame) -> embedding-block
cache the serving engines consult before calling ``embed_fn``.

Two implementations of one ``GalleryStore`` contract:

* ``LocalGalleryStore`` — host-resident per-camera dicts: the single
  engine's default and the fleet's replicated baseline.
* ``ShardedGalleryStore`` — one gallery for the whole fleet: each camera
  hashes to an owner worker and that camera's blocks live as torch tensors
  on the owner's device, rows padded to a power of two.  A cache hit reads
  the block back to the host (one device-to-host copy a hit on the card),
  because the round gallery is assembled on the host
  (``assemble_round_gallery``).  With a transport (``runtime.transport``)
  every such read goes through the fetch plane addressed to the owner.

The base class's retention bookkeeping mirrors ``FrameStore``: a
per-camera monotonic key deque gives O(1) amortized retention-horizon
eviction on ``put``; an out-of-order ``put`` stays correct (``get``
re-checks the horizon) but its eviction may be deferred until the deque
head catches up to it.  ``FrameStore`` calls ``drop`` for every frame key
it evicts, so embeddings never outlive their frames.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np
import torch

from repro_torch.runtime.transport import LocalFetchHandle, PeerDeadError


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


def _cam_hash(cam: int) -> int:
    """Stable camera hash (Knuth multiplicative) for owner-shard choice —
    spreads consecutive camera ids instead of striping them."""
    return ((cam + 1) * 2654435761) & 0xFFFFFFFF


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


class ShardedGalleryStore(GalleryStore):
    """One fleet-wide gallery: camera-hash owner shards over the workers.

    Every camera maps to one owner worker (``_cam_hash(cam) % live``) and
    that camera's blocks are torch tensors on the owner's device, rows
    padded to a power of two.  ``rehome`` migrates a lost worker's cameras
    (and their resident blocks) onto the survivors; surviving owners keep
    their cameras, so only the lost shard moves.

    Blocks are the engines' (n, D) float32 numpy embedding batches; values
    round-trip the device bit for bit, which keeps the sharded-gallery
    fleet trace-identical to the single engine.

    With a ``transport`` every fetch of an owner-resident block goes
    through the fetch plane addressed to the block's owner.  A
    ``PeerDeadError`` during a blocking fetch re-resolves ownership: if the
    dead-peer signal re-homed the camera (the fleet's ``on_dead`` wiring),
    the fetch retries against the new owner; otherwise it surfaces.
    """

    kind = "sharded"

    def __init__(self, n_cams: int, retention: int, workers: list[str],
                 device_of: dict[str, Any], transport: Any = None):
        super().__init__(n_cams, retention)
        if not workers:
            raise ValueError("sharded gallery needs at least one worker")
        missing = [w for w in workers if w not in device_of]
        if missing:
            raise ValueError(f"workers {missing} have no device mapping")
        self._device_of = dict(device_of)
        self._owner = {cam: workers[_cam_hash(cam) % len(workers)]
                       for cam in range(n_cams)}
        # (cam, t) -> (padded block on the owner's device, valid row count)
        self._blocks: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
        self.rehomed_blocks = 0
        self.transport = transport

    def owner_of(self, cam: int) -> str:
        return self._owner[cam]

    def _store(self, cam, t, emb):
        emb = np.asarray(emb)
        n = emb.shape[0]
        rows = pow2(n)
        if rows > n:
            emb = np.concatenate(
                [emb, np.zeros((rows - n,) + emb.shape[1:], emb.dtype)])
        self._blocks[(cam, t)] = (
            torch.tensor(emb, device=self._device_of[self._owner[cam]]), n)

    @staticmethod
    def _read_block(blk):
        """The block's valid rows as a fresh host array (a device-to-host
        copy on the card)."""
        arr, n = blk
        return arr[:n].to("cpu", copy=True).numpy()

    def _fetch(self, cam, t):
        while True:
            blk = self._blocks.get((cam, t))
            if blk is None:
                return None
            if self.transport is None:
                return self._read_block(blk)
            owner = self._owner[cam]
            try:
                return self.transport.fetch(owner, (cam, t),
                                            lambda b=blk: self._read_block(b))
            except PeerDeadError:
                if self._owner[cam] == owner:
                    raise          # nobody re-homed the camera: surface it
                # the dead-peer signal re-homed it mid-fetch — retry against
                # the new owner (the block moved with the camera)

    def _fetch_async(self, cam, t):
        if self.transport is None:
            return super()._fetch_async(cam, t)
        blk = self._blocks[(cam, t)]
        return self.transport.fetch_async(self._owner[cam], (cam, t),
                                          lambda: self._read_block(blk))

    def wait_fetch(self, handle):
        if isinstance(handle, LocalFetchHandle):
            return super().wait_fetch(handle)
        return self.transport.wait(handle)

    def _drop(self, cam, t):
        return self._blocks.pop((cam, t), None) is not None

    def _has(self, cam, t):
        return (cam, t) in self._blocks

    def rehome(self, lost: str, survivors: list[str]) -> int:
        """Re-home the lost worker's cameras onto the survivors (camera-hash
        over the surviving list) and migrate their resident blocks to the
        new owners' devices (no copy where the device is the same).
        Returns the number of blocks moved."""
        if not survivors:
            raise RuntimeError("cannot re-home the gallery: no survivors")
        remap = {cam: survivors[_cam_hash(cam) % len(survivors)]
                 for cam, w in self._owner.items() if w == lost}
        self._owner.update(remap)
        moved = 0
        for key, (arr, n) in list(self._blocks.items()):
            if key[0] in remap:
                self._blocks[key] = (
                    arr.to(self._device_of[remap[key[0]]]), n)
                moved += 1
        self.rehomed_blocks += moved
        return moved

    def cached_embeddings(self):
        return len(self._blocks)

    def memory_bytes(self):
        return sum(arr.numel() * arr.element_size()
                   for arr, _ in self._blocks.values())

    def counters(self):
        c = dict(super().counters(), rehomed_blocks=self.rehomed_blocks)
        if self.transport is not None:
            c.update(self.transport.counters())
        return c

    def per_worker_report(self) -> dict[str, dict]:
        """Owner-resident cache memory, per worker: cameras owned, resident
        blocks/rows/bytes, plus the fetch plane's per-peer traffic when a
        transport is attached.  Lost workers report zeros after ``rehome``."""
        rep = {w: dict(cameras=0, blocks=0, rows=0, bytes=0,
                       remote_fetches=0, retries=0, timeouts=0)
               for w in self._device_of}
        for w in self._owner.values():
            rep[w]["cameras"] += 1
        for (cam, _t), (arr, n) in self._blocks.items():
            r = rep[self._owner[cam]]
            r["blocks"] += 1
            r["rows"] += n
            r["bytes"] += arr.numel() * arr.element_size()
        if self.transport is not None:
            for w, st in self.transport.peer_counters().items():
                if w in rep:
                    rep[w]["remote_fetches"] = st["fetches"]
                    rep[w]["retries"] = st["retries"]
                    rep[w]["timeouts"] = st["timeouts"]
        return rep


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
