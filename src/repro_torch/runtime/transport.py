"""The gallery fetch plane's handles and errors.

Only what the local gallery store needs is ported so far; the transports
(in-process and fake RPC) and the prefetch pipeline are still to be ported
with the fleet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


class TransportError(RuntimeError):
    """Base class for fetch-plane failures."""


class PeerDeadError(TransportError):
    """The owner peer is unreachable: the retry budget is exhausted, or the
    peer was already marked dead (e.g. the fleet lost the worker while this
    fetch was in flight)."""

    def __init__(self, peer: str, detail: str = ""):
        super().__init__(f"peer {peer!r} is dead{': ' + detail if detail else ''}")
        self.peer = peer


@dataclasses.dataclass
class FetchHandle:
    """One in-flight fetch.  ``payload_fn`` (lazy, zero-copy) or
    ``payload`` (snapshot) carries the data; ``_sched`` caches a
    transport's resolved fault schedule so counters tick exactly once per
    fetch."""

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
