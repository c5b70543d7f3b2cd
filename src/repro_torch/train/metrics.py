"""Training metrics: the port of the JAX package's ``train/metrics.py``.
The robustness counters (``RobustnessCounters``) of the training loop and
the serving scheduler, the FSSDP load-balance observables that the
paper's Figure 3 tracks (``expert_stats``: the entropy and imbalance of
the expert counts; ``device_stats``: the straggler factor of the device
loads), and ``MetricLogger``, a JSONL sink with a windowed mean of the
loss."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class RobustnessCounters:
    """Cumulative fault-tolerance observables, surfaced in every
    ``train_loop`` history record (and therefore in the JSONL sink via
    ``MetricLogger``) so benches and e2e examples can assert on them.

    skipped_steps:  optimizer updates skipped by the step-health guard
                    (non-finite loss/grad norm; params bit-identical
                    across the skip).
    plan_fallbacks: plan-ahead jobs that raised or hung, answered by the
                    synchronous Alg-1 path (HecateScheduler).
    publish_drops:  parameter publications dropped at the engine boundary
                    (failed slot build, or a publish call that raised) —
                    the engine keeps serving the previous version.
    resumes:        automatic restarts from the newest intact checkpoint.
    rollbacks:      aborts that rolled state back to the last intact
                    checkpoint after the consecutive-bad-step budget.

    Fleet counters (``serve.bus.PublicationBus`` feeding N replicas):

    replica_evictions: replicas EVICTED by the bus (send retries
                    exhausted, engine closed, or a staged build hung past
                    the evict deadline) — the fleet kept serving.
    replica_rejoins: evicted replicas re-admitted and caught up to the
                    newest published version.
    dedup_hits:     staged slot builds AVOIDED by same-host dedup (one
                    stacked gather per host per publication instead of
                    one per replica).
    elastic_restores: resumes that re-laid-out the chunk buffer (params
                    + AdamW moments) from a checkpoint saved under a
                    different mesh shape (mesh-shape-elastic restore).

    Elastic-recovery counters (``train.supervisor.TrainSupervisor``
    riding inside ``train_loop`` — device failure is a typed, in-process
    event, never a dead run):

    device_losses:  devices declared lost by the supervisor (an armed
                    ``mesh.device_lost`` / ``collective.timeout`` raise,
                    or ``heartbeat_misses`` consecutive missed beats).
    elastic_shrinks: in-process mesh shrinks — state rolled back from
                    the newest intact checkpoint and re-laid-out onto
                    the surviving ep' without a process restart.
    grow_backs:     re-expansions to the original ep at a checkpoint
                    boundary after the lost device rejoined (inverse
                    row remap — layout restored bit-exactly).
    stragglers_deweighted: devices de-weighted by the step-time EMA
                    probe — the next reshard assigns them proportionally
                    fewer expert slots instead of declaring them dead.

    Serving counters (``serve.scheduler.RequestScheduler`` — overload is
    a typed per-request outcome, never an exception on the decode path):

    requests_rejected: requests refused with a typed REJECTED result
                    (bounded queue full, prompt that can never fit the
                    KV pool, or prefill crashes past the retry budget).
    requests_preempted: decoding sequences preempted under KV page-pool
                    exhaustion (youngest first; pages freed, requeued
                    with prompt + generated so far — lossless resume).
    requests_timed_out: requests reaped by their TTL deadline in any
                    non-terminal state (queued or wedged mid-decode).
    """

    skipped_steps: int = 0
    plan_fallbacks: int = 0
    publish_drops: int = 0
    resumes: int = 0
    rollbacks: int = 0
    replica_evictions: int = 0
    replica_rejoins: int = 0
    dedup_hits: int = 0
    elastic_restores: int = 0
    device_losses: int = 0
    elastic_shrinks: int = 0
    grow_backs: int = 0
    stragglers_deweighted: int = 0
    requests_rejected: int = 0
    requests_preempted: int = 0
    requests_timed_out: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def expert_stats(counts: np.ndarray) -> Dict[str, float]:
    """counts: (L, E) tokens per expert per layer."""
    counts = np.asarray(counts, np.float64)
    p = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1e-9)
    ent = -(p * np.log(np.maximum(p, 1e-12))).sum(1)
    e = counts.shape[1]
    return {
        "expert_entropy_frac": float((ent / np.log(e)).mean()),
        "expert_imbalance_max": float(
            (counts.max(1) / np.maximum(counts.mean(1), 1e-9)).max()),
    }


def device_stats(loads: np.ndarray) -> Dict[str, float]:
    """loads: (L, M) real tokens per EP device (``MoEAux.device_loads``)."""
    loads = np.asarray(loads, np.float64)
    return {
        "device_straggler_factor": float(
            (loads.max(1) / np.maximum(loads.mean(1), 1e-9)).max()),
    }


class MetricLogger:
    """``log(step, metrics)`` -> one record: the step, the seconds since
    the previous call, every scalar metric, ``expert_stats`` and
    ``device_stats`` where the counts and loads are given, tokens per
    second when ``tokens_per_step`` is set, and ``loss_avg``, the mean
    loss over the last ``window`` records.  With a ``path`` each record is
    appended to it as a JSON line.  ``train_loop(metric_logger=)`` merges
    the record into the step's history record."""

    def __init__(self, path: Optional[str] = None, window: int = 20,
                 tokens_per_step: float = 0.0):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self.window = deque(maxlen=window)
        self.tokens_per_step = tokens_per_step
        self._t_last = time.perf_counter()

    def log(self, step: int, metrics: Dict[str, Any]) -> Dict[str, Any]:
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        rec: Dict[str, Any] = {"step": step, "time_s": dt}
        for k, v in metrics.items():
            a = np.asarray(v)
            if a.ndim == 0:
                rec[k] = float(a)
        if "expert_counts" in metrics:
            rec.update(expert_stats(np.asarray(metrics["expert_counts"])))
        if "device_loads" in metrics:
            rec.update(device_stats(np.asarray(metrics["device_loads"])))
        if self.tokens_per_step:
            rec["tokens_per_s"] = self.tokens_per_step / max(dt, 1e-9)
        self.window.append(rec.get("loss", 0.0))
        rec["loss_avg"] = float(np.mean(self.window))
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
