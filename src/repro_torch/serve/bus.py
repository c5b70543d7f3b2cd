"""Publication bus: fan-out of (params, pa, version) triples from one
trainer to N ``serve.engine.Engine`` replicas, with per-replica fault
isolation; this package's port of the JAX package's ``serve/bus.py``.

The bus presents the engine's publication surface (``publish_params``,
``publish_drops``, ``_closed``), so ``train_loop(publish_engine=)`` cannot
tell one replica from a fleet.  Like the engine's, its ``publish_params``
only stages: it records the newest triple and wakes the broadcast worker.

Each registered replica is in one state::

    HEALTHY ──(staged build age >= build_deadline_s)──▶ LAGGING
    HEALTHY/LAGGING ──(send retries exhausted, engine closed,
                       or build age >= evict_deadline_s)──▶ EVICTED
    LAGGING ──(build finally completed)──▶ HEALTHY  (caught up to the
                                                     newest version)
    EVICTED ──(rejoin())──▶ REJOINING ──(catch-up promoted)──▶ HEALTHY

* HEALTHY replicas receive every publication and are routable.
* LAGGING: the staged build passed ``build_deadline_s`` (read from the
  engine's lock-free ``health()``).  ``route()`` drains it and the bus
  sends it nothing new; its promoted version keeps serving, since a decode
  step never waits for a build.
* EVICTED: the fleet moves on without it.
* REJOINING: ``rejoin`` replays the newest published triple into it and
  waits for the build, so it serves what the other replicas serve.

Same-host dedup: the replicas of one ``host`` tag share one slot build
per publication, as in the JAX package.  The broadcast worker builds the
slots once per host group, on a CUDA stream and (on a process grid) on
process groups of the bus's own (``launch.mesh.private_grid``, made when
the first replica on a grid is added, destroyed by ``close``), and hands every replica of the
group the same slots (``Engine.publish_params(slots=)``), whose staged
build is then a hand-off; each replica still promotes on its own.
``dedup_hits`` counts the builds avoided (the group's size less one, per
group and publication).  If the host build fails, the replicas build
their own slots.  A rejoin or a lagging replica's catch-up is handed the
newest host build of its group, so it costs no collective.

On a grid of more than one rank every rank runs its own bus over its own
engines, in lockstep, and the worker broadcasts every publication in
order (elsewhere the newest staged publication supersedes an
unbroadcast one): each publication's host build is a collective, so every
rank must build the same ones.  The worker stages a publication into the
engines at its own moment on each rank; the engines' boundaries agree
over the ranks before a triple promotes (``Engine._agree``).  A replica's
transitions (LAGGING, EVICTED, a lagging replica's catch-up) are decided
once over the ranks: each rank proposes from its own view (its clock, its
fault sites) and one MAX all-reduce on the bus's own groups picks the
most severe proposal, so a replica evicted on one rank is evicted on
every rank.  The agreement runs on the broadcast worker only, at the end
of each broadcast and for each ``poll``, which on a grid is collective
and queued behind the publications staged before it.

Fault sites (``repro_torch.common.faults``): ``bus.broadcast_drop`` and
``replica.crash`` in the per-replica send path, ``replica.build_hang`` on
the engine's builder thread; each carries the replica's name, for
``only=``-targeted injection.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.common import faults
from repro_torch.launch.mesh import destroy_grid, private_grid

HEALTHY = "HEALTHY"
LAGGING = "LAGGING"
EVICTED = "EVICTED"
REJOINING = "REJOINING"

_KEEP = object()            # publication without a plan: keep bus.pa
_SELF_BUILD = object()      # host build failed: replicas build their own
_POLL = object()            # a poll queued on a grid's broadcast worker

# a replica's proposed transition at a poll; a grid agrees on the most
# severe (the maximum) over its ranks
_CAUGHT_UP, _IN_FLIGHT, _LAGS, _EVICTS = range(4)


class ReplicaHandle:
    """One registered replica: its engine, host tag, and bus-side state."""

    def __init__(self, name: str, engine, host: str = "host-0"):
        self.name = name
        self.engine = engine
        self.host = host
        self.state = HEALTHY
        self.sent_version: Optional[int] = None   # newest version sent
        self.last_error: Optional[BaseException] = None


@dataclasses.dataclass(frozen=True)
class ReplicaStatus:
    """One replica's row in ``PublicationBus.health()``: bus state plus the
    engine's own lock-free snapshot."""
    name: str
    host: str
    state: str
    version: int                      # promoted version
    staged_version: Optional[int]
    staged_pending: bool
    staged_age_s: float
    publish_drops: int
    last_error: Optional[str]
    # the replica's request-scheduler load (zeros without a scheduler);
    # route() sorts by it
    queue_depth: int = 0
    kv_used_frac: float = 0.0


class PublicationBus:
    """Broadcasts trainer publications to a fleet of decode replicas.

    ``publish_params`` stages (latest wins) and wakes a daemon worker that
    sends to each replica with retry and backoff: a slow or failing fleet
    never blocks the training step, and a wedged broadcast never blocks
    interpreter exit.

    Cumulative counters (``train_loop`` reads them as deltas into its
    ``RobustnessCounters``): ``publications``, ``publish_drops`` (sends
    that failed after their retries), ``replica_evictions``,
    ``replica_rejoins``, ``dedup_hits``, ``broadcast_retries``."""

    def __init__(self, replicas=(), *, build_deadline_s: float = 5.0,
                 evict_deadline_s: Optional[float] = None,
                 max_retries: int = 2, backoff_s: float = 0.05,
                 pa=None):
        self._replicas: "OrderedDict[str, ReplicaHandle]" = OrderedDict()
        self.build_deadline_s = build_deadline_s
        self.evict_deadline_s = (evict_deadline_s
                                 if evict_deadline_s is not None
                                 else 2.0 * build_deadline_s)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.pa = pa                    # newest published plan tables
        self.version = 0                # newest fully broadcast version
        self._latest = None             # (params, pa, version) for rejoin
        self._latest_slots = {}         # host -> its newest host build
        self._jobs = deque()            # staged publications, oldest first
        self._keep_all = False          # a grid: broadcast every one
        self._grid = None               # the host builds' groups on a grid
        self._stream = None             # the host builds' CUDA stream
        self._evt = threading.Event()
        self._lock = threading.Lock()       # small shared state
        self._fleet_lock = threading.Lock()  # broadcast/poll/rejoin body
        self._worker: Optional[threading.Thread] = None
        self._busy = False              # worker is mid-broadcast
        self._closed = False
        self._next_version = 0
        self.publications = 0
        self.publish_drops = 0
        self.broadcast_retries = 0
        self.replica_evictions = 0
        self.replica_rejoins = 0
        self.dedup_hits = 0
        self.last_publish_error: Optional[BaseException] = None
        for rep in replicas:            # (name, engine[, host])
            self.add_replica(*rep)

    # ---- registration / routing ---------------------------------------
    def add_replica(self, name: str, engine, host: str = "host-0"
                    ) -> ReplicaHandle:
        if self._closed:
            raise RuntimeError("PublicationBus is closed")
        h = ReplicaHandle(name, engine, host)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = h
            if self.pa is None:         # adopt the fleet's plan tables
                self.pa = getattr(engine, "pa", None)
        # the host builds' stream and, on a grid, groups: made here, off
        # the publication path (making a first side stream waits for the
        # card's queue; making groups is collective)
        buf = engine._buf_of(engine.params)
        if buf is not None and buf.is_cuda and self._stream is None:
            self._stream = torch.cuda.Stream(device=buf.device)
        if engine._build_grid is not None and self._grid is None:
            self._grid = private_grid(engine.rt.grid)
            self._grid.comm_stream = self._stream
            self._keep_all = engine.rt.grid.size > 1
        return h

    def healthy(self) -> List[ReplicaHandle]:
        return [h for h in self._replicas.values() if h.state == HEALTHY]

    def route(self) -> List[Any]:
        """The engines safe to hand requests to, least loaded first (queue
        depth, then KV page occupancy; a stable sort, so unloaded replicas
        keep registration order).  LAGGING and EVICTED replicas are
        drained."""
        def _load(h):
            try:
                hs = h.engine.health()
                return (hs.queue_depth, hs.kv_used_frac)
            except Exception:
                return (0, 0.0)
        return [h.engine for h in sorted(self.healthy(), key=_load)]

    # ---- the train_loop-facing surface --------------------------------
    def publish_params(self, params, version: Optional[int] = None, *,
                       pa=None, wait: bool = False) -> int:
        """Stage a publication for the whole fleet and return (latest
        wins: an unbroadcast staged triple is superseded).  ``wait``
        blocks until the worker has drained, then flushes every healthy
        engine."""
        if self._closed:
            raise RuntimeError("PublicationBus is closed")
        staged_ev = None
        buf = params.get("moe_buffer")
        if buf is not None and buf.is_cuda:
            staged_ev = torch.cuda.Event()
            # the publisher's stream, as of now: the host build reads the
            # published tree as it stood here
            staged_ev.record(torch.cuda.current_stream(buf.device))
        with self._lock:
            if version is None:
                version = self._next_version + 1
            self._next_version = max(self._next_version, version)
            if not self._keep_all:
                self._jobs.clear()      # latest wins
            self._jobs.append((params, pa if pa is not None else _KEEP,
                               version, staged_ev))
            self.publications += 1
            self._ensure_worker()
            self._evt.set()
        if wait:
            self.flush()
        return version

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait until every staged publication has been broadcast, then
        promote it on every HEALTHY replica (a replica whose flush raises
        is evicted)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = (not self._jobs and not self._busy
                        and not self._evt.is_set())
            if idle:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("PublicationBus.flush timed out")
            time.sleep(0.002)
        with self._fleet_lock:
            for h in list(self._replicas.values()):
                if h.state != HEALTHY:
                    continue
                try:
                    h.engine.flush(timeout=timeout)
                except Exception as e:
                    self._evict(h, e)

    # ---- the broadcast worker ------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run,
                                            name="publication-bus",
                                            daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            self._evt.wait()
            with self._lock:
                job = self._jobs.popleft() if self._jobs else None
                if not self._jobs:
                    self._evt.clear()
                closed = self._closed
                self._busy = job is not None
            if job is not None:
                try:
                    with self._fleet_lock:
                        if job[0] is _POLL:
                            self._poll_locked()
                        else:
                            self._broadcast(*job)
                except Exception as e:      # never kill the worker
                    if job[0] is _POLL:
                        job[2].append(e)    # raised by the poll
                    else:
                        self.last_publish_error = e
                        self.publish_drops += 1
                finally:
                    with self._lock:
                        self._busy = False
                    if job[0] is _POLL:
                        job[1].set()
            elif closed:
                return

    def _broadcast(self, params, pa, version, staged_ev) -> None:
        if pa is _KEEP:
            pa = self.pa
        groups: "OrderedDict[str, List[ReplicaHandle]]" = OrderedDict()
        for h in self.healthy():
            groups.setdefault(h.host, []).append(h)
        built = {}
        for host, group in groups.items():
            slots = self._host_build(group[0].engine, params, pa,
                                     staged_ev)
            if slots is not _SELF_BUILD:
                self.dedup_hits += len(group) - 1
            built[host] = slots
            for h in group:
                self._send(h, params, pa, version, slots)
        with self._lock:
            self._latest = (params, pa, version)
            self._latest_slots = built
            self.version = max(self.version, version)
            self.pa = pa
        self._poll_locked()

    def _host_build(self, engine, params, pa, staged_ev):
        """One slot build for every replica of a host group, as
        ``(slots, event marking their end or None)`` (``(None, None)``
        when the triple has no slots), on the bus's stream and groups;
        ``_SELF_BUILD`` if it failed, so the replicas build their own: a
        broken shared build degrades, it does not drop the
        publication."""
        try:
            buf = engine._buf_of(params)
            if buf is None or pa is None:
                return None, None
            return engine._build_async(pa, buf, staged_ev, self._stream,
                                       self._grid)
        except Exception as e:
            self.last_publish_error = e
            return _SELF_BUILD

    def _send(self, h: ReplicaHandle, params, pa, version,
              slots=_SELF_BUILD) -> bool:
        """Deliver one triple to one replica, with retry and backoff; a
        send that exhausts its retries evicts the replica.  ``slots``: the
        host group's build to hand over, or ``_SELF_BUILD``."""
        for attempt in range(self.max_retries + 1):
            try:
                faults.fire("bus.broadcast_drop", h.name)
                faults.fire("replica.crash", h.name)
                kw: Dict[str, Any] = {} if pa is None else {"pa": pa}
                if slots is not _SELF_BUILD:
                    kw["slots"] = slots
                h.engine.publish_params(params, version=version, **kw)
                h.sent_version = version
                h.last_error = None
                return True
            except Exception as e:
                h.last_error = e
                self.last_publish_error = e
                if attempt < self.max_retries:
                    self.broadcast_retries += 1
                    time.sleep(self.backoff_s * (2 ** attempt))
        self.publish_drops += 1
        self._evict(h, h.last_error)
        return False

    # ---- the replica state machine ------------------------------------
    def _evict(self, h: ReplicaHandle, err: Optional[BaseException] = None
               ) -> None:
        if h.state == EVICTED:
            return
        h.state = EVICTED
        if err is not None:
            h.last_error = err
        self.replica_evictions += 1
        warnings.warn(
            f"PublicationBus: replica {h.name!r} evicted "
            f"({h.last_error!r}); fleet continues with "
            f"{len(self.healthy())} healthy replicas", RuntimeWarning)

    def poll(self) -> Dict[str, ReplicaStatus]:
        """Apply the state machine from each replica's lock-free health
        snapshot; returns the fleet health.  The fleet lock only
        serializes against an in-flight broadcast.

        On a grid of more than one rank ``poll`` is collective: every rank
        calls it at the same point of its sequence of publications.  It
        runs on the broadcast worker after every publication staged before
        it, so its agreement meets the other ranks' in the same order."""
        if not self._keep_all:
            with self._fleet_lock:
                self._poll_locked()
            return self.health()
        done, raised = threading.Event(), []
        with self._lock:
            if self._closed:
                raise RuntimeError("PublicationBus is closed")
            self._jobs.append((_POLL, done, raised))
            self._ensure_worker()
            self._evt.set()
        done.wait()
        if raised:
            raise raised[0]
        return self.health()

    def _proposal(self, h: ReplicaHandle):
        """(this rank's proposed transition for ``h``, the error an
        eviction records): the engine closed or its staged build past
        ``evict_deadline_s`` evicts, past ``build_deadline_s`` lags; a
        build in flight within its deadline changes nothing, and with none
        a LAGGING replica has caught up."""
        if h.state == EVICTED:
            return _EVICTS, None
        hs = h.engine.health()
        if hs.closed:
            return _EVICTS, RuntimeError("engine closed")
        if not hs.staged_pending:
            return _CAUGHT_UP, None
        if hs.staged_age_s >= self.evict_deadline_s:
            return _EVICTS, RuntimeError(
                f"staged build hung {hs.staged_age_s:.2f}s "
                f"(> evict deadline {self.evict_deadline_s}s)")
        if hs.staged_age_s >= self.build_deadline_s:
            return _LAGS, None
        return _IN_FLIGHT, None

    def _agree(self, codes: List[int]) -> List[int]:
        """The replicas' proposals agreed over a grid's ranks: one MAX
        all-reduce on the bus's own world group (the codes as they are
        off a grid of more than one rank)."""
        if not self._keep_all or not codes:
            return codes
        group = self._grid.world_group
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.tensor(codes, dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t.tolist()

    def _poll_locked(self) -> None:
        reps = list(self._replicas.values())
        props = [self._proposal(h) for h in reps]
        agreed = self._agree([code for code, _ in props])
        for h, (mine, err), code in zip(reps, props, agreed):
            if h.state == EVICTED:
                continue
            if code == _EVICTS:
                self._evict(h, err if mine == _EVICTS else RuntimeError(
                    "evicted on another rank of the grid"))
            elif code == _LAGS and h.state == HEALTHY:
                h.state = LAGGING           # drained, old version serves
            elif code == _CAUGHT_UP and h.state == LAGGING:
                # the build completed after all (on every rank): catch the
                # replica up to the newest published triple, then route to
                # it again
                h.state = HEALTHY
                with self._lock:
                    latest = self._latest
                    slots = self._latest_slots.get(h.host, _SELF_BUILD)
                if latest is not None and h.sent_version != latest[2]:
                    self._send(h, *latest, slots)

    def rejoin(self, name: str, engine=None, *,
               timeout: Optional[float] = None) -> bool:
        """Re-admit an evicted replica (optionally with a fresh engine):
        replay the newest published triple and wait for its build, so on
        success it serves what the never-failed replicas serve.  Returns
        False (the replica stays EVICTED) if the catch-up fails."""
        if self._closed:
            raise RuntimeError("PublicationBus is closed")
        with self._fleet_lock:
            h = self._replicas[name]
            if engine is not None:
                h.engine = engine
            h.state = REJOINING
            h.last_error = None
            with self._lock:
                latest = self._latest
                slots = self._latest_slots.get(h.host, _SELF_BUILD)
            if latest is not None:
                if not self._send(h, *latest, slots):
                    return False        # _send evicted it again
                try:
                    h.engine.flush(timeout=timeout)
                except Exception as e:
                    self._evict(h, e)
                    return False
            h.state = HEALTHY
            self.replica_rejoins += 1
            return True

    # ---- observability --------------------------------------------------
    def health(self) -> Dict[str, ReplicaStatus]:
        """Fleet snapshot keyed by replica name; takes no lock (engine
        health is lock-free, bus state is read without the fleet lock)."""
        out = {}
        for h in self._replicas.values():
            hs = h.engine.health()
            out[h.name] = ReplicaStatus(
                name=h.name, host=h.host, state=h.state,
                version=hs.version, staged_version=hs.staged_version,
                staged_pending=hs.staged_pending,
                staged_age_s=hs.staged_age_s,
                publish_drops=hs.publish_drops,
                last_error=(repr(h.last_error) if h.last_error else None),
                queue_depth=hs.queue_depth,
                kv_used_frac=hs.kv_used_frac)
        return out

    # ---- lifecycle ------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Stop the broadcast worker after it drains a staged publication.
        Idempotent; the replica engines belong to the caller and stay
        open.  The worker is a daemon: a wedged broadcast delays this join
        at most ``timeout``.  The host builds' process groups are destroyed
        once the worker has ended."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._evt.set()             # wake the worker so it can exit
            w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout=timeout)
        with self._lock:
            self._latest_slots = {}     # the engines keep what they serve
        if self._grid is not None and not (w is not None and w.is_alive()):
            destroy_grid(self._grid)
            self._grid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
