"""The robustness counters (``RobustnessCounters``) that the serving
scheduler mirrors its overload outcomes into: this package's own copy of
the counters of the JAX reference's ``train/metrics.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict


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
