"""Deterministic fault injection: this package's own copy of the JAX
package's registry (``repro/common/faults.py``), standard library only.

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

The site of the ported training path (``train.trainer.train_loop``):

``train.nan_grads``
    Fired by ``train_loop`` with the step's batch as payload.  Arm with
    ``mutate=faults.poison_grads`` to scale the step's gradients by NaN
    (the batch grows a ``GRAD_SCALE_KEY`` entry that ``build_train_step``
    multiplies into the grads).  The step-health guard skips the optimizer
    update (params bit-identical across the step), ``skipped_steps``
    increments and training continues; after ``tc.max_bad_steps``
    consecutive bad steps ``train_loop`` aborts (``TrainAbortError``).

Usage::

    from repro_torch.common import faults
    with faults.injected("serve.page_exhausted", times=3):
        ...  # run the scheduler
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional


class FaultError(RuntimeError):
    """Default exception raised by an armed ``exc``-less injection."""


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
