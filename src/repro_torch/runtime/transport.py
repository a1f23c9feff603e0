"""The gallery fetch plane: transports behind the sharded gallery.

The counterpart of ``repro.runtime.transport``.  The serving fleet keeps
embedding blocks on their owner worker's device
(``runtime.gallery.ShardedGalleryStore``).  On one card the owner's
buffer is directly addressable and a fetch is a device-to-host read; with
owners on remote hosts every fetch crosses the network and its latency
sits on the round's critical path.  This module is that fetch plane:

* ``Transport`` — the contract: ``fetch_async(peer, key, payload_fn)``
  issues a fetch against an owner peer and returns a ``FetchHandle``;
  ``wait(handle)`` delivers the payload (or raises ``PeerDeadError`` once
  the retry budget is exhausted or the peer was marked dead); ``fetch`` is
  the blocking composition.  Per-peer counters (fetches / retries /
  timeouts) keep the plane observable.
* ``InProcTransport`` — the single-controller behaviour, named: delivery
  is immediate (the payload thunk runs at ``wait`` time).
* ``FakeRpcTransport`` — remote owners with per-peer injected latency /
  jitter / drop / reorder (``FaultProfile``), timeout + retry with
  exponential backoff, and a dead-peer signal (``on_dead``) the fleet
  wires into its quarantine-and-rehome machinery.  Every draw is seeded by
  a (seed, peer, key, attempt) hash, so a run replays exactly, and the
  clock/sleep pair is injectable (``manual_clock``) so virtual time
  advances instead of the process sleeping.  The payload is snapshotted at
  issue time (serialize-at-send).
* ``PrefetchPipeline`` — the double buffer: at the end of round N the
  engine speculates round N+1's admitted (camera, frame) keys and issues
  async fetches for the cached ones; round N+1 consumes delivered blocks
  (``prefetch_hits``) and falls back to a blocking fetch on any
  misspeculation (``prefetch_wasted`` accounts every discarded handle).

A transport never changes what is ranked, only when it arrives: delivered
bytes equal the direct read, which is what keeps every transport and fault
configuration trace-identical to the single engine.

Under ``REPRO_SANITIZE=1`` a fetch issued from inside the dead-peer
callback raises (the rehome callback must only re-home bookkeeping).
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Any, Callable

import numpy as np


class TransportError(RuntimeError):
    """Base class for fetch-plane failures."""


class PeerDeadError(TransportError):
    """The owner peer is unreachable: the retry budget is exhausted, or the
    peer was already marked dead (e.g. the fleet lost the worker while this
    fetch was in flight)."""

    def __init__(self, peer: str, detail: str = ""):
        super().__init__(f"peer {peer!r} is dead{': ' + detail if detail else ''}")
        self.peer = peer


def _sanitize_enabled() -> bool:
    """The ``REPRO_SANITIZE`` switch (the same variable the reference's
    analysis plane reads): on for 1 / true / yes / on."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


def manual_clock(start: float = 0.0):
    """A (clock, sleep) pair over virtual time: ``sleep`` advances the clock
    instead of blocking, so injected seconds of latency cost none.  Pass
    both into ``FakeRpcTransport``."""
    state = [float(start)]

    def clock() -> float:
        return state[0]

    def sleep(dt: float) -> None:
        state[0] += max(float(dt), 0.0)

    return clock, sleep


def _stable_hash(x: Any) -> int:
    """Process-stable 32-bit hash (python's ``hash`` is salted per run)."""
    return zlib.crc32(repr(x).encode())


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Injected fault model for one peer (all times in seconds).

    ``latency`` is the base RTT of a successful fetch; ``jitter`` adds a
    uniform [0, jitter) extra; with probability ``drop`` an attempt is lost
    entirely (the requester only learns via its timeout); with probability
    ``reorder`` a response is held back ``reorder_delay`` extra seconds, so
    responses overtake each other."""

    latency: float = 0.0
    jitter: float = 0.0
    drop: float = 0.0
    reorder: float = 0.0
    reorder_delay: float = 0.0


@dataclasses.dataclass
class FetchHandle:
    """One in-flight fetch.  ``payload_fn`` (lazy) or ``payload``
    (snapshot) carries the data; ``_sched`` caches the resolved fault
    schedule so counters tick exactly once per fetch."""

    peer: str
    key: Any
    issued_at: float
    payload_fn: Callable | None = None
    payload: Any = None
    _sched: Any = None

    def _deliver(self):
        return self.payload if self.payload_fn is None else self.payload_fn()


@dataclasses.dataclass
class LocalFetchHandle:
    """Handle for a transport-less gallery: ``wait_fetch`` re-reads the
    store directly (the degenerate immediate path)."""

    cam: int
    t: int


@dataclasses.dataclass
class _Schedule:
    """Resolved delivery schedule for one fetch: ``ready`` is the delivery
    time (None = every attempt failed), ``failed_at`` the time the final
    timeout fires when dead."""

    ready: float | None
    attempts: int
    retries: int
    timeouts: int
    failed_at: float


class Transport:
    """The fetch-plane contract the gallery programs to.

    ``on_dead(peer)`` fires exactly once, the first time a peer's retry
    budget exhausts — the fleet wires it to quarantine + gallery rehome so
    a blocked fetch can retry against the block's new owner.  ``mark_dead``
    is the external direction (the fleet lost a worker): in-flight handles
    to that peer fail fast at ``wait`` instead of timing out.
    """

    kind = "base"

    def __init__(self, on_dead: Callable[[str], None] | None = None):
        self.on_dead = on_dead
        self._dead: set[str] = set()
        self._peer_stats: dict[str, dict] = {}
        self.remote_fetches = 0
        self.retries = 0
        self.timeouts = 0
        # True while the on_dead callback runs (checked under
        # REPRO_SANITIZE=1: the callback must not issue fetches)
        self._in_on_dead = False

    # -- the contract ------------------------------------------------------
    def fetch_async(self, peer: str, key: Any,
                    payload_fn: Callable) -> FetchHandle:
        raise NotImplementedError

    def wait(self, handle: FetchHandle) -> Any:
        raise NotImplementedError

    def fetch(self, peer: str, key: Any, payload_fn: Callable) -> Any:
        """Blocking fetch: issue + wait."""
        return self.wait(self.fetch_async(peer, key, payload_fn))

    # -- peer liveness -----------------------------------------------------
    def is_dead(self, peer: str) -> bool:
        return peer in self._dead

    def mark_dead(self, peer: str) -> None:
        """External death notice (the fleet already removed the worker):
        fail this peer's fetches fast.  Does NOT fire ``on_dead`` — the
        caller is the rehome machinery itself."""
        self._dead.add(peer)

    def _fail_peer(self, peer: str) -> None:
        """Internal death discovery (retry budget exhausted): mark dead and
        fire the dead-peer signal exactly once."""
        if peer in self._dead:
            return
        self._dead.add(peer)
        if self.on_dead is not None:
            self._in_on_dead = True
            try:
                self.on_dead(peer)
            finally:
                self._in_on_dead = False

    def _check_reentry(self, op: str) -> None:
        """Under REPRO_SANITIZE=1: refuse fetch-plane entry from inside the
        dead-peer callback (re-home first, retry after it returns)."""
        if self._in_on_dead and _sanitize_enabled():
            raise AssertionError(
                f"transport.{op} re-entered from inside the on_dead "
                "callback — the rehome callback must not issue fetches "
                "(the blocked fetch retries after it returns)")

    # -- accounting --------------------------------------------------------
    def _stats(self, peer: str) -> dict:
        if peer not in self._peer_stats:
            self._peer_stats[peer] = dict(fetches=0, retries=0, timeouts=0)
        return self._peer_stats[peer]

    def counters(self) -> dict:
        return dict(remote_fetches=self.remote_fetches, retries=self.retries,
                    timeouts=self.timeouts, dead_peers=len(self._dead))

    def peer_counters(self) -> dict[str, dict]:
        return {w: dict(st) for w, st in self._peer_stats.items()}


class InProcTransport(Transport):
    """Single-controller behaviour, named: delivery is immediate (the
    payload thunk runs at ``wait``; nothing is snapshotted).  Counters
    still tick, so the fetch plane stays observable."""

    kind = "inproc"

    def fetch_async(self, peer, key, payload_fn):
        self._check_reentry("fetch_async")
        if peer in self._dead:
            raise PeerDeadError(peer, "fetch issued to a dead peer")
        self.remote_fetches += 1
        self._stats(peer)["fetches"] += 1
        return FetchHandle(peer=peer, key=key, issued_at=0.0,
                           payload_fn=payload_fn)

    def wait(self, handle):
        self._check_reentry("wait")
        if handle.peer in self._dead:
            raise PeerDeadError(handle.peer, "peer died while fetch in flight")
        return handle._deliver()


class FakeRpcTransport(Transport):
    """Remote owners with injected faults, deterministic and clock-injectable.

    ``faults`` maps peer -> ``FaultProfile`` (``default`` covers unlisted
    peers).  Attempt k (0-based) is issued, and if it is dropped or its
    delivery would land past ``timeout``, the requester waits out the
    timeout, backs off ``backoff * 2**k`` and re-issues; after
    ``max_retries`` re-issues the peer is declared dead (``on_dead`` fires,
    ``PeerDeadError`` raises).  Every random draw is seeded by (seed, peer,
    key, attempt), so a fetch's schedule is a pure function.
    """

    kind = "fake_rpc"

    def __init__(self, faults: dict[str, FaultProfile] | None = None, *,
                 default: FaultProfile = FaultProfile(),
                 timeout: float = 1.0, max_retries: int = 3,
                 backoff: float = 0.05, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 on_dead: Callable[[str], None] | None = None):
        super().__init__(on_dead=on_dead)
        if timeout <= 0:
            raise ValueError(f"timeout={timeout} must be > 0 (a dropped "
                             f"attempt is only detected by its timeout)")
        self.faults = dict(faults or {})
        self.default = default
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.seed = seed
        self._clock = clock
        self._sleep = sleep

    def profile(self, peer: str) -> FaultProfile:
        return self.faults.get(peer, self.default)

    def _draws(self, peer: str, key: Any, attempt: int) -> np.ndarray:
        rng = np.random.default_rng(
            [self.seed, _stable_hash(peer), _stable_hash(key), attempt])
        return rng.random(3)

    def _schedule(self, peer: str, key: Any, issued_at: float) -> _Schedule:
        """Resolve the full (deterministic) fate of one fetch: attempt
        times, drops, timeouts, backoffs, and either a delivery time or the
        time the final timeout declares the peer dead."""
        prof = self.profile(peer)
        t = issued_at
        retries = timeouts = 0
        for attempt in range(self.max_retries + 1):
            r = self._draws(peer, key, attempt)
            if r[0] >= prof.drop:               # the attempt got through
                delay = prof.latency + prof.jitter * r[1]
                if r[2] < prof.reorder:
                    delay += prof.reorder_delay
                if delay <= self.timeout:
                    return _Schedule(ready=t + delay, attempts=attempt + 1,
                                     retries=retries, timeouts=timeouts,
                                     failed_at=t + delay)
            # dropped, or delivery past the deadline: wait out the timeout
            timeouts += 1
            if attempt < self.max_retries:
                retries += 1
                t += self.timeout + self.backoff * (2 ** attempt)
        return _Schedule(ready=None, attempts=self.max_retries + 1,
                         retries=retries, timeouts=timeouts,
                         failed_at=t + self.timeout)

    def fetch_async(self, peer, key, payload_fn):
        self._check_reentry("fetch_async")
        if peer in self._dead:
            raise PeerDeadError(peer, "fetch issued to a dead peer")
        self.remote_fetches += 1
        self._stats(peer)["fetches"] += 1
        # serialize-at-send: the RPC payload is a snapshot taken at issue
        return FetchHandle(peer=peer, key=key, issued_at=self._clock(),
                           payload=payload_fn())

    def _sleep_until(self, t: float) -> None:
        dt = t - self._clock()
        if dt > 0:
            self._sleep(dt)

    def wait(self, handle):
        self._check_reentry("wait")
        if handle.peer in self._dead:
            raise PeerDeadError(handle.peer, "peer died while fetch in flight")
        sched = handle._sched
        if sched is None:
            sched = handle._sched = self._schedule(handle.peer, handle.key,
                                                   handle.issued_at)
            st = self._stats(handle.peer)
            st["retries"] += sched.retries
            st["timeouts"] += sched.timeouts
            self.retries += sched.retries
            self.timeouts += sched.timeouts
        if sched.ready is None:
            self._sleep_until(sched.failed_at)
            self._fail_peer(handle.peer)
            raise PeerDeadError(
                handle.peer, f"retry budget exhausted "
                f"({sched.attempts} attempts, {sched.timeouts} timeouts)")
        self._sleep_until(sched.ready)
        return handle._deliver()


class PrefetchPipeline:
    """Double-buffered speculative fetch over a ``FrameStore``-fronted
    gallery: ``issue`` starts async fetches for the next round's predicted
    keys; ``consume`` serves a delivered block (checking the key is still
    cached — a block evicted between issue and use is discarded, never
    served stale) and returns None on any miss so the caller falls back to
    the blocking path.  ``prefetch_hits`` / ``prefetch_wasted`` on the
    gallery account every handle exactly: consumed, or discarded (evicted /
    dead owner / stale in ``sweep``)."""

    def __init__(self, store):
        self.store = store              # runtime.stream_store.FrameStore
        self._inflight: dict[Any, Any] = {}

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def issue(self, keys) -> int:
        """Start async fetches for every cached, not-already-in-flight key.
        Returns the number of fetches actually issued."""
        n = 0
        for key in keys:
            if key in self._inflight:
                continue
            try:
                h = self.store.fetch_emb_async(*key)
            except PeerDeadError:       # owner already dead: nothing to hide
                continue
            if h is not None:
                self._inflight[key] = h
                n += 1
        return n

    def pending(self, cam: int, t: int) -> bool:
        """Whether a fetch for (cam, t) is in flight and its block still
        cached: ``consume`` will wait for it.  No counters tick."""
        return (cam, t) in self._inflight and self.store.emb_cached(cam, t)

    def consume(self, cam: int, t: int):
        """The prefetched block for (cam, t), or None (not speculated /
        evicted since issue / owner died mid-fetch) — the caller falls back
        to the blocking fetch, which re-resolves ownership."""
        h = self._inflight.pop((cam, t), None)
        if h is None:
            return None
        g = self.store.gallery
        if not self.store.emb_cached(cam, t):   # evicted between issue & use
            g.prefetch_wasted += 1
            return None
        try:
            emb = self.store.wait_emb(h)
        except PeerDeadError:                   # mid-fetch worker loss
            g.prefetch_wasted += 1
            return None
        if emb is None:
            g.prefetch_wasted += 1
            return None
        g.prefetch_hits += 1
        g.hits += 1       # counter parity with the blocking get path
        return emb

    def sweep(self) -> int:
        """Drop in-flight handles whose block got evicted (stale
        speculation) so the buffer stays bounded by the cache size.
        Returns the number dropped."""
        g = self.store.gallery
        stale = [k for k in self._inflight if not self.store.emb_cached(*k)]
        for k in stale:
            del self._inflight[k]
            g.prefetch_wasted += 1
        return len(stale)
