"""Hecate training loop: the port of the JAX package's
``repro/train/trainer.py`` control loop.

Per iteration (paper Fig. 5): the predictor estimates the next
iteration's expert loads, the scheduler emits the materialization plan
(runtime tables; Algorithm 1 for the ``ring``, ``a2a`` and ``dense``
plans), the train step runs, the observed per-layer expert counts feed
back into the predictor, and every ``resharding.interval`` steps
Algorithm 2 re-shards the chunk buffer (``apply_reshard`` moves the rows
of the parameters and both AdamW moments to their new owners).  Planning
runs off the critical path: while step i runs, the scheduler's
background thread plans step i+1 (``HecateScheduler.plan_ahead``), and
the calibration stage (§4.2) overrides that plan when the freshest loads
say it loses.  On a process grid every rank runs this loop on its rows of
each global batch; the counts are summed over the world inside the step,
so every rank plans the same
(``launch.distributed.assert_scheduler_coherence`` checks it).
Checkpointing and the elastic supervisor are not yet ported: asking for
them raises.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import faults
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.params import snapshot
from repro_torch.core import moe as moe_core
from repro_torch.core.costs import (CostContext, calibration_gain,
                                    placement_latency)
from repro_torch.core.placement import (MaterializationPlan, ShardingPlan,
                                        ep_materialization,
                                        homogeneous_sharding)
from repro_torch.core.schedule import (LoadPredictor, ReshardingPolicy,
                                       sparse_materialization)
from repro_torch.data.pipeline import microbatch_rows
from repro_torch.launch.distributed import assert_scheduler_coherence
from repro_torch.train import metrics as metrics_lib
from repro_torch.train import step as step_lib


class TrainAbortError(RuntimeError):
    """Raised by ``train_loop`` when the consecutive-bad-step budget
    (``tc.max_bad_steps``) is exhausted.  ``state`` carries the live
    training state (no checkpoint to roll back to), ``history`` the
    per-step records up to the abort, ``step`` the global step that
    aborted."""

    def __init__(self, msg: str, state=None, history=None, step: int = -1):
        super().__init__(msg)
        self.state = state
        self.history = history or []
        self.step = step


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to repro_torch")


def placement_latency_safe(ctx, plan, loads, layer, device_weights=None):
    """``costs.placement_latency``, or 0.0 where the model cannot price the
    plan (the calibration stage then keeps the current plan)."""
    try:
        return placement_latency(ctx, plan, loads, layer,
                                 device_weights=device_weights)
    except Exception:
        return 0.0


def reshard_perm(old: ShardingPlan, new: ShardingPlan) -> np.ndarray:
    """perm[new_global_row] = old_global_row (identity on pad rows)."""
    rows = old.rows_per_device * old.num_devices
    perm = np.arange(rows, dtype=np.int32)
    perm[new.global_rows().reshape(-1)] = old.global_rows().reshape(-1)
    return perm


class _PlanWorker:
    """One background DAEMON thread running plan-ahead jobs.  Not a
    ``ThreadPoolExecutor``: its threads are joined at interpreter exit, so
    a hung Algorithm 1 job would wedge shutdown even after the scheduler
    routed around it; a daemon thread can be abandoned."""

    def __init__(self):
        self._q = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run,
                                        name="hecate-plan", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue                # cancelled before it started
            try:
                fut.set_result(fn())
            except Exception as e:          # read by _take_pending
                fut.set_exception(e)

    def submit(self, fn) -> Future:
        fut = Future()
        self._q.put((fut, fn))
        return fut

    def stop(self) -> None:
        """Ask the thread to exit after the job in flight (never blocks; a
        wedged job leaves the daemon parked until the process exits)."""
        self._q.put(None)


@dataclasses.dataclass
class HecateScheduler:
    """Owns the sharding plan and the load predictor, hands the train step
    its plan tables, and runs the calibration stage (§4.2) and the
    plan-ahead thread, as the JAX package's scheduler does.  ``impl``:
    ``ep`` (every expert in its owner's slots), or Algorithm 1's ``ring``,
    ``a2a`` or ``dense`` plan over ``ep`` expert-parallel ranks with
    overlap degree ``t`` and ``cfg.moe.slots_per_device`` extra slots.

    Calibration happens at the iteration boundary: when the freshly
    observed loads show that the plan in use lost more than
    ``calibration_margin`` of modelled latency against a plan made from
    those loads (``costs.calibration_gain``, the new plan's gather charged
    to the critical path), the next step uses the new plan.

    Plan-ahead (``async_plan``): ``plan_ahead()`` snapshots the prediction
    and runs Algorithm 1 and the table build on a background thread while
    the step runs; ``plan()`` takes the result.  It is one observation
    stale; calibration overrides it, and a reshard invalidates it.  A job
    that raises is answered by Algorithm 1 run now on the same snapshot
    (``plan_fallbacks``), so the plan is the prefetched one bit for bit;
    one that hangs past ``plan_timeout_s`` also turns the background
    thread off, and from then on ``plan_ahead()`` only takes the snapshot
    that ``plan()`` plans from.  On a process grid every rank therefore
    plans from the same loads whichever rank's planner failed.
    ``resharding``: a ``ReshardingPolicy`` (Algorithm 2) or None.
    ``device_weights`` (per-device speed) stays None: the elastic
    supervisor that sets it is not yet ported."""

    cfg: ModelConfig
    ep: int = 1
    impl: str = "ep"
    t: int = 8
    window: int = 5
    device: str = "cuda"
    resharding: Optional[ReshardingPolicy] = None
    calibrate: bool = True
    calibration_margin: float = 0.05
    tokens_per_step: float = 0.0    # for the latency model; 0 = estimate
    async_plan: bool = True         # plan step i+1 while step i runs
    plan_timeout_s: float = 30.0    # bound on joining a plan-ahead job

    def __post_init__(self):
        if self.impl not in ("ep", "ring", "a2a", "dense"):
            raise ValueError(f"HecateScheduler impl={self.impl!r}")
        L = moe_core.num_moe_layers(self.cfg)
        E = self.cfg.moe.num_experts
        self.predictor = LoadPredictor(L, E, self.window)
        self.sharding = homogeneous_sharding(L, E, self.ep)
        self._calibrated: Optional[MaterializationPlan] = None
        self._last_plan: Optional[MaterializationPlan] = None
        self._executor: Optional[_PlanWorker] = None
        self._pending = None        # (future or None, sharding, prediction)
        self._prefetched_tables = None
        self.calibration_events = 0
        self.plan_ahead_hits = 0
        self.device_weights: Optional[np.ndarray] = None
        self.plan_fallbacks = 0
        self._fallback_warned = False
        self._worker_poisoned = False   # a job hung; the worker is wedged

    # ---- plan-ahead ---------------------------------------------------
    def _pool(self) -> _PlanWorker:
        if self._executor is None:
            self._executor = _PlanWorker()
        return self._executor

    def _alg1(self, sharding, loads) -> MaterializationPlan:
        return sparse_materialization(sharding, loads, t=self.t,
                                      m=self.cfg.moe.slots_per_device,
                                      impl=self.impl)

    def plan_ahead(self) -> None:
        """Start planning the next step, and building its tables, on the
        background thread.  Call right after issuing the train step.  The
        prediction is taken here, on the caller's thread."""
        if self.impl == "ep" or self._pending is not None:
            return                          # one in flight is enough
        if not self.async_plan and not self._worker_poisoned:
            return
        pred = self.predictor.predict()
        sh = self.sharding
        if self._worker_poisoned:
            # a job hung: no thread, but plan() plans from this snapshot,
            # the loads the other ranks' prefetch plans from
            self._pending = (None, sh, pred)
            return

        def job():
            # fault sites: a job that raises or hangs must degrade to the
            # synchronous plan, never stop training
            faults.fire("scheduler.plan_job")
            faults.fire("scheduler.plan_job_hang")
            plan = self._alg1(sh, pred)
            return plan, moe_core.plan_tables(plan)

        self._pending = (self._pool().submit(job), sh, pred)

    def _warn_fallback_once(self, msg: str) -> None:
        if not self._fallback_warned:
            self._fallback_warned = True
            warnings.warn(f"HecateScheduler: {msg}", RuntimeWarning,
                          stacklevel=3)

    def _take_pending(self):
        """(plan, numpy tables or None) from the snapshot in flight, or
        None when there is none or it was taken for a sharding since
        replaced.  The job's result when it finished (a hit); else
        Algorithm 1 now on the same snapshot: the job raised (counted in
        ``plan_fallbacks``), or it did not finish within
        ``plan_timeout_s`` (counted too; the worker is then wedged, so
        the thread is off for good and ``close()`` does not join it), or
        the thread is off."""
        if self._pending is None:
            return None
        fut, sh, pred = self._pending
        self._pending = None
        if sh is not self.sharding:         # resharded since: stale
            if fut is not None:
                fut.cancel()
            return None
        if fut is not None:
            try:
                got = fut.result(timeout=self.plan_timeout_s)
                self.plan_ahead_hits += 1
                return got
            except _FutTimeout:
                self._worker_poisoned = True
                self.async_plan = False
                self.plan_fallbacks += 1
                self._warn_fallback_once(
                    f"plan-ahead job hung (> {self.plan_timeout_s:.1f}s); "
                    "disabling plan-ahead and falling back to synchronous "
                    "planning")
            except Exception as e:
                self.plan_fallbacks += 1
                self._warn_fallback_once(
                    f"plan-ahead job failed ({e!r}); falling back to "
                    "synchronous planning")
        return self._alg1(sh, pred), None

    def _drop_pending(self) -> None:
        """Discard the job in flight without joining it."""
        if self._pending is not None:
            if self._pending[0] is not None:
                self._pending[0].cancel()
            self._pending = None

    def close(self) -> None:
        """Release the plan-ahead worker.  Never blocks: a wedged worker
        is a daemon thread and is abandoned."""
        self._drop_pending()
        if self._executor is not None:
            self._executor.stop()
            self._executor = None

    # ---- planning -----------------------------------------------------
    def plan(self) -> MaterializationPlan:
        """The next step's plan: the calibrated one if calibration fired,
        else the one from ``plan_ahead``'s snapshot, else Algorithm 1 now
        on the current prediction."""
        self._prefetched_tables = None
        if self.impl == "ep":
            plan = ep_materialization(self.sharding)
        elif self._calibrated is not None:
            plan, self._calibrated = self._calibrated, None
            self._drop_pending()
        else:
            got = self._take_pending()
            if got is not None:
                plan, self._prefetched_tables = got
            else:
                plan = self._alg1(self.sharding, self.predictor.predict())
        self._last_plan = plan
        return plan

    def plan_arrays(self) -> moe_core.PlanArrays:
        """Device tables of the next step's plan; a prefetched plan's
        numpy tables were built on the worker, so only the transfer is
        left here."""
        plan = self.plan()
        tables, self._prefetched_tables = self._prefetched_tables, None
        if tables is None:
            tables = moe_core.plan_tables(plan)
        return moe_core.tables_to_device(tables, self.device)

    def observe(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts, np.float64)
        self.predictor.observe(counts)
        if (self.calibrate and self.impl in ("ring", "a2a")
                and self._last_plan is not None):
            self._maybe_calibrate(counts)

    def _maybe_calibrate(self, real_loads: np.ndarray) -> None:
        tokens = self.tokens_per_step or float(
            real_loads[0].sum() / max(self.cfg.moe.experts_per_token, 1))
        ctx = CostContext(self.cfg, tokens_per_step=tokens)
        cand = self._alg1(self.sharding, real_loads)
        # judge on the most imbalanced layer; a layer whose tokens were
        # all dropped (mean 0) ranks last
        means = real_loads.mean(1)
        ratio = np.where(means > 0,
                         real_loads.max(1) / np.maximum(means, 1e-12), 0.0)
        layer = int(np.argmax(ratio))
        base = placement_latency_safe(ctx, self._last_plan, real_loads,
                                      layer, self.device_weights)
        gain = calibration_gain(ctx, self._last_plan, cand, real_loads,
                                layer, device_weights=self.device_weights)
        if base > 0 and gain / base > self.calibration_margin:
            self._calibrated = cand
            self.calibration_events += 1

    def maybe_reshard(self, step: int):
        """The row permutation to apply to the buffer (``apply_reshard``)
        when the resharding policy moves experts at ``step``, else None."""
        if self.resharding is None or self.impl in ("ep", "dense"):
            return None
        w = self.device_weights
        if w is not None and np.asarray(w).reshape(-1).shape[0] \
                != self.sharding.num_devices:
            w = None
        self.resharding.device_weights = w
        new, changed = self.resharding.maybe_reshard(
            step, self.sharding, self.predictor)
        if not changed:
            return None
        perm = reshard_perm(self.sharding, new)
        self.sharding = new                 # _take_pending sees the swap
        return perm


def _move_rows(t, perm: np.ndarray, grid):
    """``t[perm]`` of the global (rows, cols) buffer, on this rank's
    (rows_local, cols_local) shard ``t``: one all-to-all over the EP group
    moves each row from its old owner to its new one (the column shard
    stays within its data index).  At EP size 1 it is a local gather."""
    rows_local = t.shape[0]
    if grid is None or grid.model == 1:
        idx = torch.as_tensor(perm[:rows_local], dtype=torch.long,
                              device=t.device)
        return t.index_select(0, idx)
    M, me = grid.model, grid.e
    perm = np.asarray(perm, np.int64).reshape(M, rows_local)
    src_dev, src_row = perm // rows_local, perm % rows_local
    # rows this rank sends to each destination, in the destination's row
    # order, and the rows it receives from each source, in its own order
    send_rows = [src_row[dst][src_dev[dst] == me] for dst in range(M)]
    recv_pos = [np.nonzero(src_dev[me] == src)[0] for src in range(M)]
    idx = torch.as_tensor(np.concatenate(send_rows), dtype=torch.long,
                          device=t.device)
    send = t.index_select(0, idx)
    recv = torch.empty_like(t)
    dist.all_to_all_single(
        recv, send, output_split_sizes=[len(r) for r in recv_pos],
        input_split_sizes=[len(r) for r in send_rows], group=grid.ep_group)
    out = torch.empty_like(t)
    out[torch.as_tensor(np.concatenate(recv_pos), dtype=torch.long,
                        device=t.device)] = recv
    return out


def apply_reshard(state: step_lib.TrainState, perm: np.ndarray,
                  grid=None) -> step_lib.TrainState:
    """Move the chunk buffer's rows (parameters and both AdamW moments) to
    their new owners: ``perm[new_global_row] = old_global_row``
    (``reshard_perm``).  On a process grid each tensor takes one
    all-to-all over the EP group, none gathers the whole buffer.  The
    tensors are updated in place."""
    with torch.no_grad():
        for tree in (state.params, state.opt.mu, state.opt.nu):
            t = tree["moe_buffer"]
            if perm.shape[0] != t.shape[0] * (grid.model if grid else 1):
                raise ValueError(f"perm of {perm.shape[0]} rows for a "
                                 f"buffer of {t.shape[0]} rows per rank")
            t.copy_(_move_rows(t, perm, grid))
    return state


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy of every metric (the step's readback)."""
    names = list(metrics)
    flat = [metrics[k].detach().float().reshape(-1) for k in names]
    host = torch.cat(flat).cpu().numpy()
    out, at = {}, 0
    for k, t in zip(names, flat):
        out[k] = host[at:at + t.numel()].reshape(metrics[k].shape)
        at += t.numel()
    return out


def train_loop(cfg: ModelConfig, rt, tc: TrainConfig,
               stream: Iterable[Dict[str, np.ndarray]],
               *, scheduler: Optional[HecateScheduler] = None,
               train_step_fn: Optional[Callable] = None,
               state: Optional[step_lib.TrainState] = None,
               num_steps: Optional[int] = None,
               log_every: int = 10,
               callback: Optional[Callable] = None,
               metric_logger=None,
               publish_engine=None, publish_every: int = 0,
               supervisor=None, device="cuda"):
    """Single-device training loop: plan -> step -> observe -> skip
    policy -> history, as the JAX package's ``train_loop``.

    Batches from ``stream`` (numpy) move to ``device``; the state is made
    from ``tc.seed`` unless given.  Each history record holds the step's
    loss, xent, wall time (dispatch to metrics readback), ``step_ok``, the
    robustness counters, and ``dropped_frac`` / ``pad_frac``.  A step the
    guard skipped counts in ``skipped_steps``; ``tc.max_bad_steps``
    consecutive skips abort with ``TrainAbortError``.

    Training-while-serving: with ``publish_engine`` (a live
    ``serve.engine.Engine``, or a ``serve.bus.PublicationBus`` with the
    same surface) and ``publish_every = k``, every k-th step publishes the
    updated parameters, versioned by the global step.  The optimizer
    updates the tensors in place, so the loop publishes a snapshot made on
    the step's stream right after the update and before the next step
    issues.  Versions rise with the step (nothing here rolls the state
    back).  A failing engine never stops
    training: the failure counts in ``publish_drops`` (with the engine's
    or bus's own drops, and a bus's fleet counters read as deltas), and a
    closed engine ends publication for the run.  At world size 1 nothing
    reshards, so the plan is never published with the params.
    Checkpointing (``tc.checkpoint_dir``), the elastic supervisor and
    ``metric_logger`` are not yet ported and raise.

    The scheduler's part of each iteration runs in the JAX package's
    order: ``maybe_reshard`` and ``apply_reshard``, ``plan_arrays``, the
    step, ``plan_ahead`` for the next step (right after the step is
    issued, before the metrics readback), then ``observe``.  Each record
    also holds ``plan_fallbacks`` (this run's planner fallbacks).

    On a process grid (``rt.grid``) every rank runs this loop: ``stream``
    yields the global batch and each rank takes its rows
    (``data.pipeline.microbatch_rows``: under gradient accumulation its
    share of each microbatch, so microbatch i is the JAX package's); the
    state is made from the seed and sharded
    (``models.model.shard_params``); the expert counts every rank
    observes are checked equal across ranks.  Publication from a grid of
    more than one rank is not yet ported and raises."""
    grid = getattr(rt, "grid", None)
    if grid is not None and grid.size > 1 and publish_engine is not None:
        raise _not_ported("publication into a live engine from a process "
                          "grid")
    if tc.checkpoint_dir or tc.checkpoint_every:
        raise _not_ported("checkpointing (tc.checkpoint_dir)")
    if supervisor is not None:
        raise _not_ported("the elastic recovery supervisor")
    if metric_logger is not None:
        raise _not_ported("MetricLogger")
    num_steps = num_steps or tc.total_steps
    counters = metrics_lib.RobustnessCounters()
    if state is None:
        state = step_lib.init_state(cfg, tc.seed,
                                    scheduler.ep if scheduler else 1,
                                    device, grid)
    if train_step_fn is None:
        train_step_fn = step_lib.build_train_step(cfg, rt, tc)
    # the engine's or bus's counters are read as deltas from here, so a
    # pre-used engine's history does not leak into this run's counters
    eng_drops0 = getattr(publish_engine, "publish_drops", 0) or 0
    fleet = ("replica_evictions", "replica_rejoins", "dedup_hits")
    fleet0 = {k: getattr(publish_engine, k, 0) or 0 for k in fleet}
    plan_fb0 = scheduler.plan_fallbacks if scheduler is not None else 0
    history = []
    it = iter(stream)
    step_base = int(state.step)
    bad_streak = 0
    publish_warned = False
    loop_pub_failures = 0
    eng_drops = 0
    try:
        for i in range(num_steps):
            gstep = step_base + i + 1               # global step AFTER i
            raw = next(it)
            if grid is not None:
                raw = {k: v[microbatch_rows(v.shape[0], grid.rank,
                                            grid.size, tc.microbatch)]
                       for k, v in raw.items()}
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in raw.items()}
            # chaos site: tests arm this with faults.poison_grads to make
            # THIS step's gradients NaN (see repro_torch.common.faults)
            batch = faults.fire("train.nan_grads", batch)
            pa = None
            if scheduler is not None and cfg.moe.enabled:
                perm = scheduler.maybe_reshard(i)
                if perm is not None:
                    state = apply_reshard(state, perm, grid)
                pa = scheduler.plan_arrays()
            t0 = time.perf_counter()
            state, metrics = train_step_fn(state, batch, pa)
            if (publish_engine is not None and publish_every
                    and (i + 1) % publish_every == 0):
                try:
                    publish_engine.publish_params(snapshot(state.params),
                                                  version=gstep)
                except Exception as e:
                    loop_pub_failures += 1
                    if not publish_warned:
                        publish_warned = True
                        warnings.warn(
                            f"train_loop: parameter publication failed "
                            f"({e!r}); training continues unpublished",
                            RuntimeWarning)
                    if getattr(publish_engine, "_closed", False):
                        publish_engine = None
            if scheduler is not None and cfg.moe.enabled and i + 1 < num_steps:
                scheduler.plan_ahead()              # plan i+1 while i runs
            metrics = _to_host(metrics)             # blocks on the step
            dt = time.perf_counter() - t0
            if scheduler is not None and "expert_counts" in metrics:
                counts = metrics["expert_counts"]
                if grid is not None:
                    counts = assert_scheduler_coherence(counts,
                                                        grid.world_group)
                scheduler.observe(counts)
            # ---- step-health skip policy (rides the readback above) ----
            step_ok = float(metrics.get("step_ok", 1.0)) >= 0.5
            if not step_ok:
                counters.skipped_steps += 1
                bad_streak += 1
            else:
                bad_streak = 0
            if scheduler is not None:
                counters.plan_fallbacks = scheduler.plan_fallbacks - plan_fb0
            if publish_engine is not None:
                eng_drops = (getattr(publish_engine, "publish_drops", 0)
                             or 0) - eng_drops0
                for k in fleet:
                    setattr(counters, k,
                            (getattr(publish_engine, k, 0) or 0) - fleet0[k])
            counters.publish_drops = loop_pub_failures + eng_drops
            rec = {"step": i, "loss": float(metrics["loss"]),
                   "xent": float(metrics["xent"]), "time_s": dt,
                   "step_ok": float(step_ok), **counters.as_dict()}
            if "dropped_frac" in metrics:
                rec["dropped_frac"] = float(metrics["dropped_frac"])
            if "pad_frac" in metrics:
                rec["pad_frac"] = float(metrics["pad_frac"])
            history.append(rec)
            if callback:
                callback(i, state, metrics)
            if bad_streak >= tc.max_bad_steps > 0:
                raise TrainAbortError(
                    f"aborting: {bad_streak} consecutive bad steps "
                    f"(tc.max_bad_steps={tc.max_bad_steps}) at global "
                    f"step {gstep}; no checkpoint to roll back to",
                    state=state, history=history, step=gstep)
            if log_every and i % log_every == 0:
                print(f"step {i:5d}  loss {rec['loss']:.4f}  "
                      f"xent {rec['xent']:.4f}  {dt*1e3:.0f} ms")
    finally:
        if scheduler is not None:
            # the worker is made again at the next plan_ahead, so a
            # scheduler reused across calls keeps working
            scheduler.close()
    return state, history
