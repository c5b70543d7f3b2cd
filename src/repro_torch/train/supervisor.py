"""In-run elastic recovery supervisor for ``train_loop``: the port of the
JAX package's ``repro/train/supervisor.py``.

A lost or wedged device becomes a typed, recoverable event instead of a
dead run, and a device that only slows down is de-weighted instead of
declared dead.

State machine (mirrored in ``train.trainer``)::

    RUNNING --(heartbeat miss / straggler seen)--> DEGRADED
    DEGRADED --(beats return, stragglers clear)--> RUNNING
    RUNNING|DEGRADED --(device loss declared)----> [DeviceLossError]
    [train_loop shrinks + rolls back] -----------> SHRUNK
    SHRUNK --(fault cleared, checkpoint boundary,
              train_loop grows back)  -----------> RECOVERED
    RECOVERED --(next loss / straggler)----------> ... (cycle)

``TrainSupervisor.probe(step, dt)`` runs once per step on the host, after
the step's metrics were read back (so ``dt`` covers the whole step).  It
fires the four elastic-trainer fault sites (``common.faults``), turns any
armed failure into ``DeviceLossError``, keeps the per-device step-time
EMA, and publishes straggler speed weights through
:meth:`device_weights`, which ``HecateScheduler`` hands to Algorithm 2
(``schedule.heterogeneous_sharding(device_weights=)``) at the next
reshard.

Detection is on the host: every device failure here is simulated, so the
probe is driven by the fault registry and the wall-clock watchdog
(``step_timeout_s``).  On a process grid ``train_loop`` gives every rank
the same ``dt`` (the slowest rank's) and merges the ranks' verdicts, so
every rank's supervisor walks the same states.  The counterpart of the
reference's ``surviving_mesh`` is ``launch.mesh.surviving_grid``: the
grid over the first ``data * ep'`` ranks, whose groups
``attach_grid`` makes up front on every rank (``new_group`` is collective
over the world).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.common import faults

# Supervisor states
RUNNING = "RUNNING"        # all devices healthy, full speed
DEGRADED = "DEGRADED"      # transient misses or de-weighted stragglers
SHRUNK = "SHRUNK"          # training on the surviving ep' after a loss
RECOVERED = "RECOVERED"    # grown back to the full ep after a rejoin


class DeviceLossError(RuntimeError):
    """A device on the EP axis was declared lost.

    ``train_loop`` catches this, shrinks the mesh to the surviving ep',
    rolls state back from the newest intact checkpoint, and continues
    in-process.  ``lost`` is the sorted tuple of lost device indices
    (positions on the CURRENT mesh's EP axis); ``site`` names the fault
    site (or real watchdog) that declared the loss.
    """

    def __init__(self, lost, site: str):
        self.lost = tuple(sorted(lost))
        self.site = site
        super().__init__(
            f"device(s) {list(self.lost)} lost (declared by {site})")


@dataclasses.dataclass
class TrainSupervisor:
    """Per-step health probe + recovery bookkeeping for ``train_loop``.

    ep:               current EP-axis size (updated by on_shrunk/grow_back).
    runtime_factory:  ep' -> Runtime for the surviving grid; called by
                      ``train_loop`` on shrink and grow-back (on a grid,
                      build it over ``grid_for(ep')``; a rank outside
                      that grid gets None there and is a spare).  For
                      runs without a grid it may return the same runtime
                      regardless of ep'.
    min_ep:           floor below which a loss aborts instead of shrinking.
    step_timeout_s:   real wall-clock watchdog — a step slower than this
                      is treated as a wedged collective (0 disables).
    heartbeat_misses: consecutive missed beats that declare a loss.
    ema_alpha:        per-device step-time EMA smoothing factor.
    calibration_steps: EMA samples required before de-weighting.
    straggler_ratio:  EMA/median ratio beyond which a device is a straggler.
    weight_floor:     lower clamp on the published speed weight.
    """

    ep: int
    runtime_factory: Callable[[int], Any]
    min_ep: int = 1
    step_timeout_s: float = 0.0
    heartbeat_misses: int = 3
    ema_alpha: float = 0.4
    calibration_steps: int = 5
    straggler_ratio: float = 1.5
    weight_floor: float = 0.25

    def __post_init__(self):
        self.state: str = RUNNING
        self.full_ep: int = self.ep
        self.lost: Set[int] = set()
        self.deweight_events: int = 0
        # MTTR records: {site, lost, ep_from, ep_to, steps_lost, mttr_s}
        self.recoveries: List[Dict[str, Any]] = []
        self._miss: Dict[int, int] = {}
        self._ema: Optional[np.ndarray] = None
        self._samples: int = 0
        self._weights: Optional[np.ndarray] = None
        self._deweighted: Set[int] = set()
        self._loss_site: str = "mesh.device_lost"
        self._loss_t: float = 0.0
        self._pending_recovery: Optional[Dict[str, Any]] = None
        self._grids: Dict[int, Any] = {}

    # -- process grids ---------------------------------------------------
    def attach_grid(self, grid) -> None:
        """Make, on every rank of ``grid``'s world and in the same order,
        the grids over the first ``grid.data * ep'`` ranks for every
        ``ep'`` from ``min_ep`` up to the full EP size (the full one is
        ``grid`` itself).  Collective: every rank calls it, once, before
        training."""
        from repro_torch.launch.mesh import surviving_grid
        if self._grids:
            return
        for ep in range(max(self.min_ep, 1), self.full_ep):
            self._grids[ep] = surviving_grid(grid, ep)
        self._grids[self.full_ep] = grid

    def grid_for(self, ep: int):
        """This rank's grid at EP size ``ep`` (None: a spare there)."""
        return self._grids[ep]
    # -- per-step probe --------------------------------------------------
    def probe(self, step: int, dt: float) -> None:
        """Run all health checks for one completed step of duration
        ``dt`` seconds.  Raises :class:`DeviceLossError` when a device is
        declared lost; otherwise updates DEGRADED/RUNNING state and the
        straggler weights in place."""
        if self._pending_recovery is not None:
            # first step completed on the shrunken mesh: recovery done
            rec = self._pending_recovery
            rec["mttr_s"] = time.monotonic() - self._loss_t
            self.recoveries.append(rec)
            self._pending_recovery = None

        for d in range(self.ep):
            try:
                faults.fire("mesh.device_lost", d)
            except BaseException:
                self._declare_loss({d}, "mesh.device_lost")

        missing = []
        for d in range(self.ep):
            beat = faults.fire("host.heartbeat_miss", d)
            if beat is None:                      # mutated away = missed
                missing.append(d)
                self._miss[d] = self._miss.get(d, 0) + 1
                if self._miss[d] >= self.heartbeat_misses:
                    self._declare_loss({d}, "host.heartbeat_miss")
            else:
                self._miss[d] = 0
        if missing and self.state == RUNNING:
            self.state = DEGRADED

        try:
            faults.fire("collective.timeout", (step, dt))
            if self.step_timeout_s > 0 and dt > self.step_timeout_s:
                raise faults.FaultError(
                    f"step {step} overran the {self.step_timeout_s}s "
                    f"watchdog ({dt:.3f}s)")
        except BaseException:
            self._declare_loss({self._slowest()}, "collective.timeout")

        times = faults.fire("mesh.slow_device",
                            np.full(self.ep, max(dt, 1e-9), np.float64))
        self._observe_times(np.asarray(times, np.float64))

        if (self.state == DEGRADED and not missing
                and not self._deweighted):
            self.state = RUNNING

    def _slowest(self) -> int:
        if self._ema is None:
            return self.ep - 1
        return int(np.argmax(self._ema))

    def _declare_loss(self, lost: Set[int], site: str) -> None:
        self.lost |= lost
        self._loss_site = site
        self._loss_t = time.monotonic()
        self.state = DEGRADED
        raise DeviceLossError(lost, site)

    def _observe_times(self, times: np.ndarray) -> None:
        if times.shape != (self.ep,):
            times = np.resize(times, self.ep)
        if self._ema is None:
            self._ema = times.copy()
        else:
            a = self.ema_alpha
            self._ema = (1.0 - a) * self._ema + a * times
        self._samples += 1
        if self._samples < self.calibration_steps:
            return
        med = float(np.median(self._ema))
        ratio = self._ema / max(med, 1e-12)
        w = np.ones(self.ep, np.float64)
        slow = ratio > self.straggler_ratio
        w[slow] = np.clip(1.0 / ratio[slow], self.weight_floor, 1.0)
        now_slow = set(np.nonzero(slow)[0].tolist())
        new = now_slow - self._deweighted
        if new:
            self.deweight_events += len(new)
            if self.state == RUNNING or self.state == RECOVERED:
                self.state = DEGRADED
        self._deweighted = now_slow
        self._weights = w if now_slow else None
        if not now_slow and self.state == DEGRADED and not any(
                self._miss.values()):
            self.state = RUNNING

    # -- consumed by the scheduler / cost model --------------------------
    def device_weights(self) -> Optional[np.ndarray]:
        """Per-device speed weights on the CURRENT ep, or None while
        uncalibrated / all devices at full speed."""
        return self._weights

    # -- shrink / grow-back transitions (driven by train_loop) -----------
    def on_shrunk(self, ep_new: int, steps_lost: int) -> None:
        """The loop finished rolling back and re-laying-out onto ep_new;
        MTTR is finalized when the first post-shrink step completes."""
        self._pending_recovery = {
            "site": self._loss_site,
            "lost": sorted(self.lost),
            "ep_from": self.ep,
            "ep_to": ep_new,
            "steps_lost": int(steps_lost),
            "mttr_s": None,
        }
        self.ep = ep_new
        self.state = SHRUNK
        # the surviving devices' history no longer lines up — recalibrate
        self._ema = None
        self._samples = 0
        self._weights = None
        self._miss.clear()
        self._deweighted.clear()

    def can_grow_back(self) -> bool:
        """True at a checkpoint boundary when the lost device has
        rejoined (the declaring fault site is no longer armed)."""
        return (self.state == SHRUNK
                and self.ep < self.full_ep
                and not faults.armed(self._loss_site))

    def on_grow_back(self) -> None:
        self.lost.clear()
        self.ep = self.full_ep
        self.state = RECOVERED
        self._ema = None
        self._samples = 0
        self._weights = None
        self._miss.clear()
        self._deweighted.clear()
