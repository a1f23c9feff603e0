"""Sharded serving fleet: the live query axis partitioned over workers.

The counterpart of ``repro.runtime.fleet``.  Cross-camera inference
spreads across a worker fleet while the tiny correlation model M stays
replicated on every worker:

  * the per-query search state is partitioned: each worker owns the batch
    rows of the queries placed on it,
  * M, the phase windows, the geo adjacency and the round's deduplicated
    gallery are replicated (a few small dense tensors),
  * the embedding plane is fleet-shared: by default the fleet puts a
    ``runtime.gallery.ShardedGalleryStore`` behind its ``FrameStore``
    (camera-hash owner shards, blocks on the owner's device), so a frame
    embedded for a query on one worker is cache-hot for every other,
  * every round runs the same step bodies as the single ``ServingEngine``
    (``policy.admit`` / ``admit_tiles``, ``rank_advance_round[_seg|
    _tiles]``, ``advance_round``), so the fleet is trace-identical to one
    engine.

How a fleet maps onto the card.  The reference shards the query axis with
``shard_map`` over a JAX device mesh.  Here a worker ``w{i}`` is a logical
partition of the query axis mapped to a torch device from ``devices=``; by
default there are ``shards`` workers, all on the engine's ``device`` (the
one card).  Each round the fleet groups the batch rows by placement, in
worker order (``_layout``), and runs each worker's contiguous block of rows
through the step bodies on the worker's device, against the replicated
model and windows and the round's gallery; the blocks' outputs are joined
back in batch-row order.  A worker with no rows in a round launches
nothing, so a ranked round launches the re-id kernel once per worker that
holds a row — counted in ``worker_dispatches``.  There are no padding
rows and no per-shard block high-water mark: those (with ``prime_batch``
and the recompile guard) only keep JAX shapes fixed, and eager PyTorch has
none to keep.  ``_replicate_control_plane`` keeps one copy of M and the
windows per distinct worker device (``swap_model`` refreshes them); with
every worker on one card nothing is copied.  ``shards`` past
``len(devices)`` raises, as in the reference.

Placement is the controller's job: a query goes to the least-loaded worker
at submit time (O(1), from per-worker live counters kept on submit /
completion / rebalance), and ``lose_worker`` shrinks the data axis
(``runtime.cluster.ElasticMesh``), re-scatters only the orphaned queries
and re-homes the lost worker's gallery shards onto the survivors.  A
``HeartbeatMonitor`` drives the same path through ``poll_health``; a
transport's dead-peer signal re-homes the gallery at once and defers the
scale-down to the end of the tick.  Placement never changes results.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch.core.policy import admit, admit_tiles
from repro_torch.device import resolve_device
from repro_torch.runtime.cluster import ElasticMesh, HeartbeatMonitor
from repro_torch.runtime.engine import (EngineConfig, QueryState, RoundPlan,
                                        ServingEngine, advance_round,
                                        rank_advance_round,
                                        rank_advance_round_seg,
                                        rank_advance_round_tiles)
from repro_torch.runtime.gallery import (GalleryStore, LocalGalleryStore,
                                         ShardedGalleryStore)


class _Replica(NamedTuple):
    """The control plane one worker device reads: M, the phase windows and
    the geo adjacency."""

    model: object
    windows: object
    geo_adj: torch.Tensor


def _to(x, device):
    """A tensor, or a dataclass of tensors, on ``device`` (no copy where
    it already lives there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).to(device)
        for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def _rows(x, a: int, b: int, device):
    """Batch rows [a, b) of a tensor or of a ``PhaseState`` on ``device``
    (a view where the device is the same)."""
    if isinstance(x, torch.Tensor):
        return x[a:b].to(device)
    return type(x)(*(_rows(getattr(x, f.name), a, b, device)
                     for f in dataclasses.fields(x)))


class ShardedServingEngine(ServingEngine):
    """A serving fleet: one controller, ``n_shards`` workers, one trace."""

    _waits_per_block = True

    def __init__(self, model, embed_fn, cfg: EngineConfig, geo_adj=None, *,
                 shards: int | None = None, devices: Iterable | None = None,
                 monitor: HeartbeatMonitor | None = None,
                 cluster: ElasticMesh | None = None, device="cuda"):
        dev = resolve_device(device)
        if devices is None:
            devs = [dev] * max(shards if shards is not None else 1, 1)
        else:
            devs = [resolve_device(d) for d in devices]
        if shards is not None:
            if shards < 1 or shards > len(devs):
                raise ValueError(
                    f"shards={shards} infeasible: {len(devs)} devices visible")
            devs = devs[:shards]
        if monitor is not None:
            # fail at construction, not as a silent poll_health no-op:
            # every fleet worker id must be a name the monitor tracks
            missing = [f"w{i}" for i in range(len(devs))
                       if f"w{i}" not in monitor.workers]
            if missing:
                raise ValueError(
                    f"HeartbeatMonitor does not track fleet workers "
                    f"{missing} — fleet worker ids are 'w0'..'w{len(devs)-1}'")
        # stable worker identities: position in the original device list.
        # The topology exists before super().__init__, which calls
        # _make_gallery(), and the fleet's gallery shards over it.
        self._device_of = {f"w{i}": d for i, d in enumerate(devs)}
        self._all_workers = list(self._device_of)
        self._workers = list(self._all_workers)        # live, data-axis order
        super().__init__(model, embed_fn, cfg, geo_adj=geo_adj, device=dev)
        self.cluster = cluster or ElasticMesh(model_parallel=1)
        self.monitor = monitor
        self._placement: dict[int, str] = {}           # qid -> worker
        # live (not-done) query count per worker, kept on submit_query /
        # _on_query_done / lose_worker — never recounted from the map
        self._live_load = {w: 0 for w in self._all_workers}
        # query_rounds = per-query rounds dispatched for this worker's
        # queries (skip-mode rounds short-circuited on the host never reach
        # a worker, so sum(query_rounds) == content_steps - skipped_steps);
        # unique_frames is the worker's shard-local deduplicated demand,
        # owned_frames its slice of the fleet-global dedup set
        self._shard_stats = {w: dict(admitted_steps=0, unique_frames=0,
                                     owned_frames=0, query_rounds=0)
                             for w in self._all_workers}
        self.rebalances = 0
        # rank step bodies launched, one per worker holding a row of a
        # ranked round: the re-id kernel's launches on the card
        self.worker_dispatches = 0
        # (worker, first row, end row) of the current batch, per worker
        # that holds a row, in worker order
        self._row_blocks: list[tuple[str, int, int]] = []
        # transport dead-peer signal: the gallery re-homes at once (so the
        # blocked fetch retries against the new owner) and the scale-down
        # waits for the end of the tick (not while a round is in flight)
        self._pending_loss: list[str] = []
        tr = getattr(self.gallery, "transport", None)
        if tr is not None:
            tr.on_dead = self._on_transport_dead
        self._refresh_mesh()

    # -- the gallery plane -------------------------------------------------
    def _make_gallery(self) -> GalleryStore:
        """gallery="auto"/"sharded": one fleet-wide embedding plane,
        partitioned over the workers (camera-hash owner shards, blocks on
        the owner's device).  gallery="local" keeps the replicated
        baseline (a private host-side cache)."""
        if self.cfg.gallery in ("auto", "sharded"):
            return ShardedGalleryStore(self.C, self.cfg.retention,
                                       self._all_workers, self._device_of,
                                       transport=self.cfg.transport)
        if self.cfg.gallery == "local":
            if self.cfg.transport is not None:
                raise ValueError(
                    "transport= requires the sharded gallery "
                    "(gallery='auto'/'sharded'): the replicated-local "
                    "baseline has no remote owners to fetch from")
            return LocalGalleryStore(self.C, self.cfg.retention)
        raise ValueError(f"unknown gallery mode {self.cfg.gallery!r} "
                         f"(expected 'auto', 'local' or 'sharded')")

    def gallery_report(self) -> dict:
        rep = super().gallery_report()
        if isinstance(self.gallery, ShardedGalleryStore):
            rep["per_worker"] = self.gallery.per_worker_report()
        return rep

    # -- fleet topology ----------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self._workers)

    def _refresh_mesh(self) -> None:
        """(Re)build the grid over the surviving workers (the data axis
        shrinks to the live count, ``ElasticMesh.grid_for``) and re-place
        the replicated control plane."""
        if not self._workers:
            raise RuntimeError("serving fleet has no surviving workers")
        self.mesh = self.cluster.make_mesh(
            [self._device_of[w] for w in self._workers])
        self._shard_of = {w: i for i, w in enumerate(self._workers)}
        self._replicate_control_plane()

    def _replicate_control_plane(self) -> None:
        """One copy of M, the windows and the geo adjacency per distinct
        live worker device; the engine's own device reads the engine's
        (nothing is copied when every worker is on it)."""
        self._replicas: dict[torch.device, _Replica] = {}
        for w in self._workers:
            d = self._device_of[w]
            if d in self._replicas:
                continue
            if d == self.device:
                self._replicas[d] = _Replica(self.model, self._windows,
                                             self._geo_adj)
            else:
                self._replicas[d] = _Replica(self.model.to(d),
                                             _to(self._windows, d),
                                             self._geo_adj.to(d))

    def swap_model(self, model) -> int:
        """Fleet hot-swap: the base swap (atomic between rounds, so every
        worker sees one M a round), then the new M and windows are
        re-placed on every live worker device."""
        epoch = super().swap_model(model)
        self._replicate_control_plane()
        return epoch

    def _load(self, worker: str) -> int:
        """Live (not-done) queries placed on ``worker`` — O(1), from the
        maintained counters."""
        return self._live_load.get(worker, 0)

    def _least_loaded(self) -> str:
        return min(self._workers, key=lambda w: (self._load(w),
                                                 self._shard_of[w]))

    def submit_query(self, qid: int, feat, cam: int, frame: int):
        if qid in self._placement:     # resubmission: retire the old count
            old = self._placement[qid]
            q_old = self.queries.get(qid)
            if q_old is not None and not q_old.done:
                self._live_load[old] -= 1
        super().submit_query(qid, feat, cam, frame)
        w = self._least_loaded()
        self._placement[qid] = w
        self._live_load[w] += 1

    def _on_query_done(self, q: QueryState) -> None:
        self._live_load[self._placement[q.qid]] -= 1

    def lose_worker(self, worker: str | int) -> list[int]:
        """Elastic scale-down: drop one worker, shrink the data axis,
        re-scatter its orphaned queries over the survivors (least-loaded
        first, round-robin via ``ElasticMesh.rebalance_streams``) and
        re-home its gallery shards.  Returns the re-placed qids."""
        w = f"w{worker}" if isinstance(worker, int) else worker
        if w not in self._workers:
            raise KeyError(f"{w!r} is not a live worker (live: {self._workers})")
        if len(self._workers) == 1:
            raise RuntimeError("cannot lose the last worker of the fleet")
        self._workers.remove(w)
        self._refresh_mesh()
        tr = getattr(self.gallery, "transport", None)
        if tr is not None:
            # in-flight fetches (prefetch handles included) to the lost
            # worker now fail fast with PeerDeadError
            tr.mark_dead(w)
        if isinstance(self.gallery, ShardedGalleryStore):
            self.gallery.rehome(w, list(self._workers))
        orphans = sorted(qid for qid, pw in self._placement.items() if pw == w)
        self._live_load[w] = 0
        targets = sorted(self._workers,
                         key=lambda t: (self._load(t), self._shard_of[t]))
        for tw, group in zip(targets,
                             self.cluster.rebalance_streams(orphans,
                                                            len(targets))):
            for qid in group:
                self._placement[qid] = tw
                q = self.queries.get(qid)
                if q is not None and not q.done:
                    self._live_load[tw] += 1
        self.rebalances += 1
        return orphans

    def _on_transport_dead(self, w: str) -> None:
        """The transport's dead-peer signal: a fetch to ``w`` exhausted its
        retry budget.  Mid-round the gallery re-homes at once (so the
        blocked fetch retries against the new owner) and the scale-down
        runs at the end of the tick."""
        if w not in self._workers or len(self._workers) == 1:
            return
        if self.monitor is not None and w in self.monitor.workers:
            self.monitor.quarantine(w)
        if self._in_round:
            if w not in self._pending_loss:
                self._pending_loss.append(w)
                self.gallery.rehome(
                    w, [x for x in self._workers if x != w])
        else:
            self.lose_worker(w)

    def tick(self, record_trace: list | None = None) -> dict:
        stats = super().tick(record_trace)
        # drain transport-discovered deaths: the gallery already re-homed
        # mid-round; now the data axis shrinks and queries re-scatter
        while self._pending_loss:
            w = self._pending_loss.pop(0)
            if w in self._workers and len(self._workers) > 1:
                self.lose_worker(w)
        return stats

    def poll_health(self) -> list[str]:
        """Drive elastic scale-down from the HeartbeatMonitor: dead workers
        and (quarantined) stragglers leave the fleet, their queries
        re-scatter.  No-op without a monitor."""
        if self.monitor is None:
            return []
        removed = []
        for w in self.monitor.stragglers():
            # quarantine only workers this fleet removes — the monitor may
            # track a superset, and the last worker stays
            if w in self._workers and len(self._workers) > 1:
                self.monitor.quarantine(w)
                self.lose_worker(w)
                removed.append(w)
        for w in self.monitor.dead():
            if w in self._workers and len(self._workers) > 1:
                self.lose_worker(w)
                removed.append(w)
        return removed

    # -- per-worker layout and dispatch -----------------------------------
    def _layout(self, qs: list[QueryState]) -> tuple[int, np.ndarray]:
        """Group the batch rows by placement, in worker order: worker s
        owns one contiguous block of rows, its queries in ``qs`` order.
        No padding rows; a worker with no query gets no block."""
        groups: list[list[int]] = [[] for _ in self._workers]
        for i, q in enumerate(qs):
            groups[self._shard_of[self._placement[q.qid]]].append(i)
        slots = np.empty(len(qs), np.int64)
        self._row_blocks = []
        pos = 0
        for w, g in zip(self._workers, groups):
            if g:
                slots[g] = np.arange(pos, pos + len(g))
                self._row_blocks.append((w, pos, pos + len(g)))
                pos += len(g)
        return len(qs), slots

    def _join(self, outs: list):
        """The blocks' outputs (tensors, tuples of them, or dataclasses of
        them) joined in batch-row order on the engine's device."""
        first = outs[0]
        if isinstance(first, tuple):
            return tuple(self._join([o[i] for o in outs])
                         for i in range(len(first)))
        if not isinstance(first, torch.Tensor):
            return dataclasses.replace(first, **{
                f.name: self._join([getattr(o, f.name) for o in outs])
                for f in dataclasses.fields(first)})
        if len(outs) == 1:
            return first.to(self.device)
        return torch.cat([o.to(self.device) for o in outs])

    def _per_worker(self, body, rows: list, shared: tuple = (),
                    rank: bool = False):
        """Run ``body(replica, *rows, *shared)`` once per worker block: the
        block's rows of each row-aligned input and the shared (replicated)
        inputs, on the worker's device.  ``rank`` counts the launches in
        ``worker_dispatches``; a rank also runs the blocks whose rows admit
        no in-flight prefetched block first (``_late_rows``), waits for
        those blocks (``_resolve_late``) and then runs the rest, so the
        fetches stay in flight while the first blocks rank.  The outputs
        are joined in row order whatever the order of the runs."""
        blocks = self._row_blocks
        order = list(range(len(blocks)))
        late = self._late_rows if rank else None
        if late is not None:
            needs = [bool(late[a:b].any()) for _, a, b in blocks]
            order.sort(key=lambda i: needs[i])
        outs = [None] * len(blocks)
        moved: dict[tuple[int, torch.device], torch.Tensor] = {}
        for i in order:
            w, a, b = blocks[i]
            if late is not None and needs[i]:
                self._resolve_late()
                late = None
                moved.clear()      # a copy made before the wait is stale
            d = self._device_of[w]
            args = [_rows(x, a, b, d) for x in rows]
            for x in shared:
                if (id(x), d) not in moved:
                    moved[(id(x), d)] = x.to(d)
                args.append(moved[(id(x), d)])
            outs[i] = body(self._replicas[d], *args)
            if rank:
                self.worker_dispatches += 1
        return self._join(outs)

    def _dispatch_admit(self, ps):
        return self._per_worker(
            lambda r, ps: admit(r.model, self.policy, ps, r.geo_adj), [ps])

    def _dispatch_admit_tiles(self, ps, tile_q):
        return self._per_worker(
            lambda r, ps, tq: admit_tiles(r.model, self.policy, ps,
                                          r.geo_adj, tq), [ps, tile_q])

    def _dispatch_rank_advance(self, ps, q_feat, mask, gallery, gal_cam,
                               gal_frame):
        k, rr = self.cfg.topk, self.cfg.topk_rerank
        return self._per_worker(
            lambda r, ps, qf, m, g, gc, gf: rank_advance_round(
                self.policy, r.windows, ps, qf, m, g, gc, gf, k=k,
                topk_rerank=rr),
            [ps, q_feat, mask], (gallery, gal_cam, gal_frame), rank=True)

    def _dispatch_rank_advance_seg(self, ps, q_feat, q_seg, mask, gallery,
                                   gal_cam, gal_frame, gal_seg):
        k, rr = self.cfg.topk, self.cfg.topk_rerank
        return self._per_worker(
            lambda r, ps, qf, qs, m, g, gc, gf, gs: rank_advance_round_seg(
                self.policy, r.windows, ps, qf, qs, m, g, gc, gf, gs, k=k,
                topk_rerank=rr),
            [ps, q_feat, q_seg, mask], (gallery, gal_cam, gal_frame, gal_seg),
            rank=True)

    def _dispatch_rank_advance_tiles(self, ps, q_feat, q_seg, mask_ct,
                                     gallery, gal_ct, gal_cam, gal_frame,
                                     gal_seg):
        k, rr, C = self.cfg.topk, self.cfg.topk_rerank, self.C
        return self._per_worker(
            lambda r, ps, qf, qs, m, g, gct, gc, gf, gs:
                rank_advance_round_tiles(self.policy, r.windows, ps, qf, qs,
                                         m, g, gct, gc, gf, gs, k=k,
                                         n_cams=C, topk_rerank=rr),
            [ps, q_feat, q_seg, mask_ct],
            (gallery, gal_ct, gal_cam, gal_frame, gal_seg), rank=True)

    def _dispatch_advance(self, ps):
        return self._per_worker(
            lambda r, ps: advance_round(self.policy, r.windows, ps), [ps])

    # -- per-worker cost accounting ---------------------------------------
    def _account_round(self, plan: RoundPlan) -> None:
        """Per-worker view of the round in both cost conventions:
        ``unique_frames`` is the worker's shard-local deduplicated
        (cam, frame) demand (what a private per-worker cache would embed);
        ``owned_frames`` the worker's slice of ``plan.work``, the round's
        fleet-global dedup set, which tiles the engine's ``unique_frames``
        exactly."""
        qs, cams_by_q = plan.qs, plan.cams_by_q
        by_worker: dict[str, list[int]] = {}
        for i, q in enumerate(qs):
            by_worker.setdefault(self._placement[q.qid], []).append(i)
        for w, idxs in by_worker.items():
            st = self._shard_stats[w]
            st["query_rounds"] += len(idxs)
            st["admitted_steps"] += sum(len(cams_by_q[i]) for i in idxs)
            pairs = {(int(cam), qs[i].f_curr)
                     for i in idxs for cam in cams_by_q[i]}
            st["unique_frames"] += len(pairs)
        if isinstance(self.gallery, ShardedGalleryStore):
            for cam, _f in plan.work:
                owner = self.gallery.owner_of(cam)
                self._shard_stats[owner]["owned_frames"] += 1

    def shard_report(self) -> list[dict]:
        """One row per worker (lost ones too, stats frozen): placement load
        and the cost conventions — ``admitted_steps`` (tiles the engine
        total), ``unique_frames`` (shard-local demand) and
        ``owned_frames`` (the worker's slice of the fleet-global dedup set;
        sums to the engine's ``unique_frames`` with the sharded gallery)."""
        live = set(self._workers)
        rows = [dict(worker=w, alive=w in live,
                     queries=self._load(w) if w in live else 0,
                     **self._shard_stats[w])
                for w in self._all_workers]
        if getattr(self.gallery, "transport", None) is not None:
            # fetch-plane traffic per owner peer
            per_w = self.gallery.per_worker_report()
            for row in rows:
                st = per_w[row["worker"]]
                row["remote_fetches"] = st["remote_fetches"]
                row["retries"] = st["retries"]
                row["timeouts"] = st["timeouts"]
        return rows
