"""Deterministic fault injection: this package's own copy of the JAX
package's registry (``repro/common/faults.py``), standard library and
numpy only.

Every failure mode the serving path defends against has a NAMED injection
point in the production code.  Tests arm a site with :func:`inject`;
production code calls :func:`fire` at the site.  When nothing is armed
``fire`` is a single module-global boolean check (``_ARMED``).  Injection
is count-based (``after`` / ``times`` hit windows), never random.

The sites of the ported serving path (``serve.scheduler``):

``serve.page_exhausted``
    Fired before every KV page-pool allocation.  An armed hit makes the
    allocation report exhaustion: arrivals wait at admission, and a
    mid-decode page fault preempts the youngest sequence.

``serve.request_hang``
    Fired once per active sequence per decode tick, payload = the request
    id (arm with ``only=<rid>``).  A hung request stops advancing but keeps
    its slot until its TTL reaps it.

``serve.prefill_crash``
    Fired at the head of a prefill, payload = the request id.  The
    request's pages are freed and it is re-queued for a bounded number of
    retries, then REJECTED with ``finish_reason="prefill_crash"``.

The sites of publication (``serve.engine``, ``serve.bus``):

``engine.publish_build``
    Fired on an engine's background builder thread before a staged slot
    build.  Arm with ``exc=...``.  The staged publication is dropped at
    the next step boundary or ``flush``: the engine keeps serving the
    previous state, no decode call raises, ``publish_drops`` increments
    and ``last_publish_error`` holds the exception.

``bus.broadcast_drop``
    Fired by ``PublicationBus`` once per (publication, replica) send,
    payload = the replica's name.  Arm with a ``times`` budget for a
    transient drop: the bus retries with backoff and the replica stays
    HEALTHY if a retry lands.

``replica.build_hang``
    Fired on a replica engine's builder thread (payload = the engine's
    name) before the staged build.  Arm with ``hang_s=...``: the build's
    age grows past the bus's deadlines (LAGGING, then EVICTED) while no
    decode step on any replica waits.  ``clear()`` releases the hang.

``replica.crash``
    Fired in the bus's per-replica send path (payload = the replica's
    name).  Arm with ``times=None`` for a dead replica: its retries
    exhaust, it is EVICTED without blocking the fleet, and a later
    ``rejoin`` catches it up to the newest published version.

The site of the ported training path (``train.trainer.train_loop``):

``train.nan_grads``
    Fired by ``train_loop`` with the step's batch as payload.  Arm with
    ``mutate=faults.poison_grads`` to scale the step's gradients by NaN
    (the batch grows a ``GRAD_SCALE_KEY`` entry that ``build_train_step``
    multiplies into the grads).  The step-health guard skips the optimizer
    update (params bit-identical across the step), ``skipped_steps``
    increments and training continues; after ``tc.max_bad_steps``
    consecutive bad steps ``train_loop`` aborts (``TrainAbortError``).

The sites of the plan-ahead worker (``train.trainer.HecateScheduler``):

``scheduler.plan_job``
    Fired at the head of every background Algorithm 1 job.  Arm with
    ``exc=...`` (or nothing, for :class:`FaultError`): the job raises,
    ``plan()`` answers synchronously with the identical plan (Algorithm 1
    on the job's own snapshot of the prediction), ``plan_fallbacks``
    increments and plan-ahead stays on.

``scheduler.plan_job_hang``
    Fired right after ``scheduler.plan_job``.  Arm with ``hang_s=...``:
    the job hangs, ``plan()`` waits at most ``plan_timeout_s`` before it
    plans synchronously from the job's snapshot, the background thread is
    off for the scheduler's life (the worker is wedged; each later plan is
    made on the caller's thread from the snapshot ``plan_ahead()`` takes,
    so it is still the prefetched plan), and ``close()`` returns without
    joining it.
    ``clear()`` releases the hang.

The sites of checkpointing (``checkpoint.store``, ``train.trainer``):

``checkpoint.save_crash``
    Fired inside ``store.save`` after the arrays are written and before
    the atomic rename.  Arm with ``exc=...``: the half-written checkpoint
    is never visible under ``step_*`` (the tmp dir is removed, and an
    orphan left by a hard kill is removed by ``store.gc``); resume falls
    back to the previous intact step.  On a process grid rank 0 writes
    and tells every rank whether the save landed, so every rank raises.

``checkpoint.corrupt``
    Fired by ``store.save`` with the final ``arrays.npz`` path after the
    rename.  Arm with ``mutate=faults.truncate_file`` or
    ``mutate=faults.bitflip_file``: ``store.restore`` checks each array's
    CRC32 and raises ``CheckpointCorruptError``; ``latest_step(verify=
    True)`` and ``train_loop``'s auto-resume fall back to the newest
    intact checkpoint.

``restore.mesh_mismatch``
    Fired by ``resume_train_state`` at the head of the elastic restore
    (a checkpoint saved under another EP size), payload ``(saved_ep,
    current_ep)``.  Arm with ``exc=...``: the failed re-layout degrades to
    a fresh start with a warning, never a crash.

The sites of the elastic supervisor (``train.supervisor``), each turned
into a typed ``DeviceLossError`` or a degradation by its probe:

``mesh.device_lost``
    Fired once per step per live device, payload the device's EP index.
    Arm with ``only=<dev>``: the loss is declared, ``train_loop`` shrinks
    to the surviving ep' and rolls back to the newest intact checkpoint;
    while armed the device is down, and ``clear()`` lets it rejoin at the
    next checkpoint boundary (grow-back).

``host.heartbeat_miss``
    Fired once per step per live device, payload the device index.  Arm
    with ``mutate=faults.drop_heartbeat`` and ``only=<dev>``: a transient
    miss degrades the supervisor; ``heartbeat_misses`` consecutive misses
    declare the device lost.

``collective.timeout``
    Fired once per step, payload ``(step, dt_s)``.  Arm with ``exc=...``
    for a wedged collective (the wall-clock watchdog takes the same path):
    the slowest device by step-time EMA is declared lost.

``mesh.slow_device``
    Fired once per step with the per-device step-time vector.  Arm with
    ``mutate=faults.slow_device(dev, factor)``: the EMA de-weights the
    straggler after ``calibration_steps`` samples and the next reshard
    gives it fewer expert slots.

Usage::

    from repro_torch.common import faults
    with faults.injected("serve.page_exhausted", times=3):
        ...  # run the scheduler
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np


class FaultError(RuntimeError):
    """Default exception raised by an armed ``exc``-less injection."""


class CheckpointCorruptError(RuntimeError):
    """An integrity check failed on restore (see ``checkpoint.store``).
    It lives here so the store and its consumers share one import-light
    home for failure types."""


@dataclasses.dataclass
class _Fault:
    site: str
    times: Optional[int] = 1            # fire budget; None = unlimited
    after: int = 0                      # skip the first `after` hits
    exc: Optional[Callable[[], BaseException]] = None
    hang_s: float = 0.0
    mutate: Optional[Callable[[Any], Any]] = None
    only: Any = None                    # fire only when payload == only
    hits: int = 0
    fired: int = 0
    release: threading.Event = dataclasses.field(
        default_factory=threading.Event)


# batch key of the ``train.nan_grads`` gradient scale (see poison_grads)
GRAD_SCALE_KEY = "__fault_grad_scale"

_ARMED = False                          # the zero-overhead fast path
_LOCK = threading.Lock()
_SITES: Dict[str, _Fault] = {}


def inject(site: str, *, times: Optional[int] = 1, after: int = 0,
           exc: Optional[Callable[[], BaseException]] = None,
           hang_s: float = 0.0,
           mutate: Optional[Callable[[Any], Any]] = None,
           only: Any = None) -> None:
    """Arm ``site``.  The fault fires on hits ``after < n <= after+times``
    (unlimited when ``times`` is None).  Exactly one of the behaviours
    applies per firing, in order: hang (``hang_s``), payload mutation
    (``mutate``), raise (``exc()``, default :class:`FaultError`).  A
    mutating fault returns the mutated payload without raising.

    ``only`` restricts the site to firings whose PAYLOAD equals it (e.g.
    a replica name) — non-matching hits pass through uncounted, which is
    what makes per-replica injection deterministic when N replicas race
    through the same site."""
    global _ARMED
    with _LOCK:
        _SITES[site] = _Fault(site, times=times, after=after, exc=exc,
                              hang_s=hang_s, mutate=mutate, only=only)
        _ARMED = True


@contextlib.contextmanager
def injected(site: str, **kw):
    """Context-manager form of :func:`inject`: arms ``site`` on entry and
    disarms exactly that site on exit (releasing any in-flight hang), so
    chaos tests stop hand-rolling try/finally ``clear()`` blocks.  Takes
    the same keyword arguments as ``inject``.  Other armed sites are left
    alone — contexts nest."""
    inject(site, **kw)
    try:
        yield
    finally:
        clear(site)


def clear(site: Optional[str] = None) -> None:
    """Disarm one site (or all).  Releases any in-flight hangs."""
    global _ARMED
    with _LOCK:
        if site is None:
            victims = list(_SITES.values())
            _SITES.clear()
        else:
            victims = [_SITES.pop(site)] if site in _SITES else []
        for f in victims:
            f.release.set()
        _ARMED = bool(_SITES)


def fired(site: str) -> int:
    """How many times ``site`` has actually fired (not just been hit)."""
    with _LOCK:
        f = _SITES.get(site)
        return f.fired if f is not None else 0


def armed(site: Optional[str] = None) -> bool:
    if not _ARMED:
        return False
    with _LOCK:
        return site in _SITES if site is not None else bool(_SITES)


def fire(site: str, payload: Any = None) -> Any:
    """The injection point.  Returns ``payload`` (possibly mutated).

    Disarmed (the common case): one global-boolean check, nothing else.
    Armed: counts the hit; if inside the fire window, hangs / mutates /
    raises per the site's spec."""
    if not _ARMED:                      # zero-overhead fast path
        return payload
    with _LOCK:
        f = _SITES.get(site)
        if f is None:
            return payload
        if f.only is not None and payload != f.only:
            return payload              # targeted at another payload
        f.hits += 1
        due = (f.hits > f.after
               and (f.times is None or f.fired < f.times))
        if not due:
            return payload
        f.fired += 1
        release, hang_s = f.release, f.hang_s
        mutate, exc = f.mutate, f.exc
    # act OUTSIDE the lock — a hang must not wedge the registry
    if hang_s > 0:
        release.wait(timeout=hang_s)
        return payload
    if mutate is not None:
        return mutate(payload)
    raise (exc() if exc is not None
           else FaultError(f"injected fault at {site!r}"))


def poison_grads(batch: dict) -> dict:
    """``train.nan_grads`` mutator: make this step's gradients NaN."""
    batch = dict(batch)
    batch[GRAD_SCALE_KEY] = float("nan")
    return batch


def drop_heartbeat(device: Any) -> None:
    """``host.heartbeat_miss`` mutator: swallow the beat; the supervisor
    sees None and counts a consecutive miss for ``device``."""
    return None


def slow_device(device: int, factor: float = 4.0) -> Callable:
    """``mesh.slow_device`` mutator factory: inflate one device's entry of
    the per-device step-time vector by ``factor`` (a persistent straggler
    when armed with ``times=None``)."""
    def mut(times):
        t = np.array(times, np.float64, copy=True)
        t[device] *= factor
        return t
    return mut


def truncate_file(path: str, keep_frac: float = 0.5) -> str:
    """``checkpoint.corrupt`` mutator: a torn write, the file's tail
    dropped."""
    n = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(n * keep_frac), 1))
    return path


def bitflip_file(path: str, offset: Optional[int] = None) -> str:
    """``checkpoint.corrupt`` mutator: flip one byte (mid-file by
    default)."""
    n = os.path.getsize(path)
    off = (n // 2) if offset is None else min(offset, n - 1)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return path
