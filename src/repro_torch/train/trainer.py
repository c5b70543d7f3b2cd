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

Recovery, as in the reference: periodic checkpoints of the whole training
state with the scheduler's predictor history and ShardingPlan
(``save_train_state``), resume from the newest intact one
(``resume_train_state``, elastic across EP sizes), rollback after
``tc.max_bad_steps`` bad steps, and an elastic supervisor
(``train.supervisor``) whose probe de-weights stragglers and whose device
losses shrink the run in-process and grow it back::

    RUNNING --(heartbeat miss / straggler seen)--> DEGRADED
    DEGRADED --(beats return, stragglers clear)--> RUNNING
    RUNNING|DEGRADED --(loss declared)-----------> DeviceLossError
        caught by train_loop: shrink to the surviving ep', roll back to
        the newest intact checkpoint (elastic_row_remap), rebuild the
        step, replay the rolled-back batches ----------------> SHRUNK
    SHRUNK --(fault cleared; next checkpoint boundary: grow back to the
              full ep through the inverse remap) -----------> RECOVERED
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.common import faults
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.params import snapshot, torch_dtype
from repro_torch.common.sharding import elastic_row_remap, remap_buffer_rows
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
from repro_torch.models import model as mdl
from repro_torch.optim import adamw
from repro_torch.train import metrics as metrics_lib
from repro_torch.train import step as step_lib
from repro_torch.train.supervisor import (DEGRADED, DeviceLossError,
                                          TrainSupervisor)


class TrainAbortError(RuntimeError):
    """Raised by ``train_loop`` when the consecutive-bad-step budget
    (``tc.max_bad_steps``) is exhausted, or on a device loss it cannot
    recover from.  ``state`` carries the training state after the
    rollback to the newest intact checkpoint (the live state when no
    checkpointing was configured), ``history`` the per-step records up
    to the abort, ``step`` the global step that aborted."""

    def __init__(self, msg: str, state=None, history=None, step: int = -1):
        super().__init__(msg)
        self.state = state
        self.history = history or []
        self.step = step


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
    ``device_weights``: per-device speed weights (None: all at full
    speed), which ``train_loop`` takes from the elastic supervisor before
    each reshard and which Algorithm 2 and the calibration stage read."""

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


# ---------------------------------------------------------------------------
# Checkpoints: save, resume, elastic re-layout
# ---------------------------------------------------------------------------
def _world(grid):
    """The group a grid's decisions are agreed over (None: no grid)."""
    return None if grid is None or grid.size == 1 else grid.world_group


def _from_rank0(obj, grid):
    """``obj`` as rank 0 has it, on every rank of ``grid`` (a decision
    made once)."""
    group = _world(grid)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def _everyone(obj, grid) -> list:
    """Every rank's ``obj``, in rank order, on every rank of ``grid``."""
    group = _world(grid)
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _state_tree(state: step_lib.TrainState) -> Dict:
    """The checkpointed tree: parameters, the whole optimizer state and
    the step, everything a bit-exact resume needs."""
    return {"params": state.params, "opt": state.opt, "step": state.step}


def _sharding_tree(sh: ShardingPlan) -> Dict[str, np.ndarray]:
    """The saved form of a ShardingPlan (``_sharding_from_tree``)."""
    return {"owner_dev": np.asarray(sh.owner_dev, np.int32),
            "owner_row": np.asarray(sh.owner_row, np.int32),
            "num_devices": np.int64(sh.num_devices),
            "rows_per_device": np.int64(sh.rows_per_device),
            "k_local": np.int64(sh.k_local)}


def _sharding_from_tree(shard: Dict[str, np.ndarray]) -> ShardingPlan:
    od = np.asarray(shard["owner_dev"], np.int32)
    plan = ShardingPlan(
        num_layers=od.shape[0], num_experts=od.shape[1],
        num_devices=int(shard["num_devices"]),
        rows_per_device=int(shard["rows_per_device"]),
        owner_dev=od, owner_row=np.asarray(shard["owner_row"], np.int32),
        k_local=int(shard["k_local"]))
    plan.validate()
    return plan


def _is_buffer(key: str) -> bool:
    return key.rsplit("/", 1)[-1] == "moe_buffer"


def _global_arrays(tree, grid):
    """(key, host array) of every leaf of ``tree``, one at a time, in the
    checkpoint's order.  On a process grid each chunk-buffer leaf (the
    parameters' and both moments') is assembled from every rank's (rows /
    model, cols / data) shard into the global array, in the live
    ShardingPlan's row order, on rank 0 (other ranks get None): one
    ``gather`` over the grid per leaf, so every rank must drain this
    generator."""
    for key, leaf in store._walk(tree):
        if grid is None or grid.size == 1 or not _is_buffer(key):
            yield key, (store.to_numpy(leaf) if grid is None or
                        grid.rank == 0 else None)
            continue
        t = leaf.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(grid.size)] \
            if grid.rank == 0 else None
        dist.gather(t, parts, dst=0, group=grid.world_group)
        if grid.rank != 0:
            yield key, None
            continue
        rl, cl = t.shape
        out = np.empty((rl * grid.model, cl * grid.data),
                       store.to_numpy(t[:0]).dtype)
        for r, piece in enumerate(parts):
            d, e = r // grid.model, r % grid.model
            out[e * rl:(e + 1) * rl, d * cl:(d + 1) * cl] = \
                store.to_numpy(piece)
            parts[r] = None
        yield key, out


def save_train_state(tc: TrainConfig, gstep: int,
                     state: step_lib.TrainState,
                     scheduler: Optional[HecateScheduler] = None,
                     grid=None) -> None:
    """One crash-safe checkpoint: the train state (atomic, checksummed),
    and when a scheduler is live and has planned, its plan tables, its
    predictor history and its ShardingPlan as the serving state, then
    keep-last retention of both.  The ShardingPlan is needed, not
    advisory: ``apply_reshard`` moved the buffer rows, and only this
    record says where (``resume_train_state``).

    On a process grid the checkpoint holds global arrays, as the
    reference's does: rank 0 assembles and writes them, and then tells
    every rank whether the save landed, so a failed save raises on every
    rank and no rank goes on to read a step directory before its
    rename."""
    err = None
    items = _global_arrays(_state_tree(state), grid)
    if grid is None or grid.rank == 0:
        try:
            store.save(tc.checkpoint_dir, gstep, None, arrays=items)
            if scheduler is not None and scheduler._last_plan is not None:
                calib = ({"load_history": np.stack(
                    scheduler.predictor.history)}
                    if scheduler.predictor.history else None)
                store.save_serving_state(
                    tc.checkpoint_dir, gstep,
                    moe_core.plan_tables(scheduler._last_plan),
                    version=gstep, calibration=calib,
                    sharding=_sharding_tree(scheduler.sharding))
            if tc.keep_checkpoints > 0:
                store.gc(tc.checkpoint_dir, keep_last=tc.keep_checkpoints)
                store.gc(os.path.join(tc.checkpoint_dir, "serving"),
                         keep_last=tc.keep_checkpoints)
        except BaseException as e:      # told to the other ranks below
            err = e
    for _ in items:                     # the gathers a failed write left
        pass
    failed = _from_rank0(err is not None, grid)
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"checkpoint step {gstep}: the save on rank 0 "
                           f"failed")


def state_spec(cfg: ModelConfig, ep: int, grid=None) -> step_lib.TrainState:
    """The train state's shapes and dtypes as ``meta`` tensors (no
    memory): a restore target.  On a grid the chunk buffer's leaves are
    this rank's shards."""
    def spec(p, dtype=None):
        return torch.empty(p.shape, device="meta",
                           dtype=dtype or torch_dtype(p.dtype
                                                      or cfg.param_dtype))

    def tree(decl, dtype=None):
        return {k: tree(v, dtype) for k, v in decl.items()} \
            if isinstance(decl, dict) else spec(decl, dtype)
    decls = mdl.param_decls(cfg, ep)
    params, mu, nu = (tree(decls), tree(decls, torch.float32),
                      tree(decls, torch.float32))
    if grid is not None and "moe_buffer" in params:
        for t in (params, mu, nu):
            b = t["moe_buffer"]
            t["moe_buffer"] = b.new_empty((b.shape[0] // grid.model,
                                           b.shape[1] // grid.data))
    scalar = torch.empty((), device="meta", dtype=torch.int32)
    moments = (mu, nu)
    return step_lib.TrainState(
        params, adamw.OptState(moments[0], moments[1], scalar), scalar)


def _shard_rows(grid):
    """Host transform taking a global buffer array to this rank's shard."""
    def take(a):
        rl, cl = a.shape[0] // grid.model, a.shape[1] // grid.data
        return a[grid.e * rl:(grid.e + 1) * rl,
                 grid.d * cl:(grid.d + 1) * cl]
    return take


def _elastic_remap(cfg: ModelConfig, old_plan: ShardingPlan, ep: int):
    """The ``store.restore(remap=...)`` transform and the new
    ShardingPlan for a checkpoint saved under another EP size: the saved
    arrays are global host copies, so the re-layout is a numpy row gather
    and the restore's device put is the reshard."""
    new_plan = homogeneous_sharding(old_plan.num_layers,
                                    old_plan.num_experts, ep)
    rows = moe_core.buffer_rows(cfg, ep)
    src, valid = elastic_row_remap(old_plan, new_plan, out_rows=rows)
    remap = {"moe_buffer": lambda a: remap_buffer_rows(a, src, valid)}
    return remap, new_plan


def _pick_checkpoint(cfg, tc, ep, tried):
    """Rank 0's half of a resume: the newest step not in ``tried``, its
    serving state, and the elastic decision.  Returns ``(step, serving
    state or None, old plan or None, failure)``; step None when nothing
    is left.  The step's arrays are verified as they are restored."""
    for cand in reversed(store.list_steps(tc.checkpoint_dir)):
        if cand in tried:
            continue
        try:
            ss = store.restore_serving_state(tc.checkpoint_dir, step=cand)
        except store.CheckpointCorruptError:
            ss = None                   # params intact, serving state torn
        old_plan = None
        shard = (ss or {}).get("sharding") or {}
        if shard:
            try:
                old_plan = _sharding_from_tree(shard)
            except Exception:
                old_plan = None         # unreadable record: treat as none
        failure = None
        if old_plan is not None and old_plan.num_devices != ep:
            try:
                faults.fire("restore.mesh_mismatch",
                            (old_plan.num_devices, ep))
                _elastic_remap(cfg, old_plan, ep)
            except Exception as e:
                failure = repr(e)
        return cand, ss, old_plan, failure
    return None, None, None, None


def resume_train_state(cfg: ModelConfig, tc: TrainConfig,
                       scheduler: Optional[HecateScheduler] = None,
                       ep: int = 1,
                       counters: Optional[metrics_lib.RobustnessCounters]
                       = None, *, device="cuda", grid=None):
    """(TrainState, global step) from the newest restorable checkpoint in
    ``tc.checkpoint_dir``, or (None, 0) when there is none.

    The walk goes newest-first and skips (a) corrupt or truncated
    checkpoints (the per-array checksums, checked as each array is
    restored) and (b) intact ones that cannot restore into today's tree
    (an older format), with a warning.  Each array goes straight onto
    ``device`` in its dtype, one leaf at a time.

    Elastic: when the candidate's saved ShardingPlan was made for another
    EP size (read from the record, never from array shapes, which can
    agree across EP sizes), the chunk buffer and both AdamW moments are
    re-laid-out row by row onto this run's homogeneous sharding
    (``common.sharding.elastic_row_remap``); ``counters.elastic_restores``
    counts it, and a failed re-layout (fault site
    ``restore.mesh_mismatch``) starts fresh with a warning.

    The scheduler gets the predictor history and the ShardingPlan saved
    beside the step (or the elastic re-layout's new plan).  With
    resharding on and no sharding record saved, resume is refused (fresh
    start, with a warning), since the rows may have been moved.

    On a process grid rank 0 walks and broadcasts its choice; every rank
    reads and checks the same file and takes its own rows and columns; a
    step that fails on any rank is skipped on every rank."""
    if not _from_rank0(os.path.isdir(tc.checkpoint_dir), grid):
        return None, 0
    target = _state_tree(state_spec(cfg, ep, grid))
    tried = set()
    while True:
        pick = _pick_checkpoint(cfg, tc, ep, tried) \
            if grid is None or grid.rank == 0 else None
        cand, ss, old_plan, failure = _from_rank0(pick, grid)
        if cand is None:
            return None, 0
        tried.add(cand)
        if failure is not None:
            warnings.warn(
                f"resume: elastic restore of step {cand} (saved ep="
                f"{old_plan.num_devices}, running ep={ep}) failed "
                f"({failure}); starting fresh", RuntimeWarning)
            return None, 0
        remap, elastic_plan = {}, None
        if old_plan is not None and old_plan.num_devices != ep:
            remap, elastic_plan = _elastic_remap(cfg, old_plan, ep)
        if grid is not None:
            take, fn = _shard_rows(grid), remap.get("moe_buffer")
            remap = {"moe_buffer": (lambda a: take(fn(a))) if fn else take}
        data = err = None
        try:
            data = store.restore(tc.checkpoint_dir, cand, target,
                                 remap=remap, device=device)
        except store.CheckpointCorruptError as e:
            err = e
        errs = _everyone(None if err is None else (
            isinstance(err, store.CheckpointShapeError), str(err)), grid)
        if any(errs):
            del data
            shape_err = next(e for e in errs if e)
            if shape_err[0]:
                warnings.warn(
                    f"resume: checkpoint step {cand} is intact but not "
                    f"restorable into the current train state "
                    f"({shape_err[1]}); trying an older one", RuntimeWarning)
            continue                    # torn / bit-rotted: skip
        break
    state = step_lib.TrainState(data["params"], data["opt"], data["step"])
    if elastic_plan is not None:
        warnings.warn(
            f"resume: checkpoint step {cand} was saved on ep="
            f"{int(old_plan.num_devices)}; chunk buffer and AdamW moments "
            f"re-laid-out onto ep={ep}", RuntimeWarning)
        if counters is not None:
            counters.elastic_restores += 1
    if scheduler is not None:
        shard = (ss or {}).get("sharding") or {}
        if elastic_plan is not None or shard:
            scheduler._drop_pending()   # planned against the old sharding
            scheduler.sharding = (elastic_plan if elastic_plan is not None
                                  else _sharding_from_tree(shard))
            scheduler._calibrated = None
            scheduler._last_plan = None
            scheduler._prefetched_tables = None
        elif (scheduler.resharding is not None
              and scheduler.impl not in ("ep", "dense")):
            warnings.warn(
                f"resume: checkpoint step {cand} carries no sharding plan "
                f"but resharding is enabled: its buffer rows may have been "
                f"moved by a reshard this process cannot reconstruct; "
                f"refusing to resume (fresh init)", RuntimeWarning)
            return None, 0
        hist = (ss or {}).get("calibration", {}).get("load_history")
        if hist is not None:
            scheduler.predictor.history = [np.asarray(h) for h in hist]
    return state, int(state.step)


def _probe(supervisor: TrainSupervisor, i: int, dt: float, step_ok,
           grid):
    """Run the supervisor's probe for step ``i``.  On a process grid every
    rank sees the same ``dt`` (the slowest rank's) and ``step_ok`` (all
    ranks that stepped), and the ranks' verdicts are merged, so every
    rank's supervisor walks the same states and raises the same
    ``DeviceLossError``.  Returns the agreed ``step_ok``."""
    if _world(grid) is not None:
        got = _everyone((dt, step_ok), grid)
        dt = max(g[0] for g in got)
        oks = [g[1] for g in got if g[1] is not None]
        step_ok = all(oks) if oks else True
    lost, site = (), None
    try:
        supervisor.probe(i, dt)
    except DeviceLossError as e:
        lost, site = e.lost, e.site
    if _world(grid) is not None:
        verdicts = _everyone((lost, site), grid)
        lost = tuple(sorted({d for v in verdicts for d in v[0]}))
        site = next((v[1] for v in verdicts if v[1] is not None), site)
        if lost:
            supervisor.lost |= set(lost)
            supervisor._loss_site = site
            supervisor.state = DEGRADED
    if lost:
        raise DeviceLossError(lost, site)
    return step_ok


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
               supervisor: Optional[TrainSupervisor] = None,
               device="cuda"):
    """The Hecate training loop: plan -> step -> observe -> skip policy ->
    checkpoint -> history, as the JAX package's ``train_loop``.

    Batches from ``stream`` (numpy) move to ``device``; the state is
    resumed or made from ``tc.seed`` unless given.  Each history record
    holds the step's loss, xent, wall time (dispatch to metrics
    readback), ``step_ok``, the robustness counters, ``dropped_frac`` /
    ``pad_frac``, and with a ``metric_logger`` (``train.metrics.
    MetricLogger``) its record.

    The scheduler's part of each iteration runs in the JAX package's
    order: the supervisor's straggler weights, ``maybe_reshard`` and
    ``apply_reshard``, ``plan_arrays``, the step, ``plan_ahead`` for the
    next step (right after the step is issued, before the metrics
    readback), then ``observe``.

    Fault tolerance (knobs on ``tc``; counters in every record):

    * **Skip policy** (``tc.step_guard``): a step with a non-finite loss
      or gradient norm leaves the state bit-identical
      (``skipped_steps``); after ``tc.max_bad_steps`` consecutive bad
      steps the loop raises ``TrainAbortError``, first rolling the state
      back to the newest intact checkpoint when checkpointing is on
      (``rollbacks``).  The poisoned state and any pending plan-ahead job
      are dropped before the restore, so a rollback holds one state.
    * **Crash-safe resume**: with ``tc.checkpoint_dir`` and
      ``tc.checkpoint_every`` the loop checkpoints the parameters, both
      moments and the step (``save_train_state``), with keep-last
      retention, and, started without a ``state`` and with
      ``tc.auto_resume``, resumes from the newest intact checkpoint
      (``resume_train_state``, ``resumes``): ``num_steps`` counts from the
      run's start, so a run resumed at step k runs steps k..num_steps-1
      and skips the k batches the first run consumed.
    * **Publication** (``publish_engine``, an engine or a
      ``PublicationBus``, every ``publish_every`` steps): a snapshot of
      the updated parameters, made on the step's stream, versioned by the
      global step; versions stay monotone across rollbacks.  Once the
      buffer's rows have moved (a reshard, an elastic shrink or a
      grow-back) the next publication carries the fresh plan with the
      params as one pair (``publish_params(pa=)``): the engine's old plan
      tables point at the rows' old owners.  A failing engine never stops
      training (``publish_drops``, and a bus's fleet counters as deltas);
      a closed engine ends publication for the run.
    * **Elastic recovery** (``supervisor``, a ``train.supervisor.
      TrainSupervisor``): its probe runs after every readback.  On
      ``DeviceLossError`` the loop shrinks in-process to the surviving
      ep' (a runtime from ``supervisor.runtime_factory``), rolls back
      through ``resume_train_state``'s elastic restore, replays the
      rolled-back batches from an in-memory buffer and trims the history
      (``device_losses``, ``elastic_shrinks``); once the lost device
      rejoins (its fault site cleared) it grows back to the full ep at
      the next checkpoint boundary through the inverse remap
      (``grow_backs``).  The straggler weights reach the scheduler before
      each reshard (``stragglers_deweighted``).  A loss below ``min_ep``
      or with no checkpoint to roll back to raises ``TrainAbortError``.

    On a process grid (``rt.grid``) every rank runs this loop: ``stream``
    yields the global batch and each rank takes its rows
    (``data.pipeline.microbatch_rows``); the state is made from the seed
    and sharded; the expert counts every rank observes are checked equal.
    Checkpoints hold global arrays (rank 0 writes them), and each
    decision (the step to resume, a save's success) is made once and
    broadcast.  With a supervisor the grid's groups for every smaller EP
    size are made up front (``TrainSupervisor.attach_grid``); after a
    shrink the ranks outside the surviving grid stay in the loop as
    spares (the same stream, probe and checkpoint boundaries, no step)
    and rejoin at grow-back.  Every rank publishes its own shard's
    snapshot at the same step into its own engine or bus (serving on a
    grid runs in lockstep: ``serve.engine``); while a shrunk grid trains,
    the spares publish nothing, and neither does the grid."""
    grid = getattr(rt, "grid", None)
    full_grid = grid
    if supervisor is not None and grid is not None:
        supervisor.attach_grid(grid)
    num_steps = num_steps or tc.total_steps
    counters = metrics_lib.RobustnessCounters()
    ep0 = scheduler.ep if scheduler else 1
    start = 0
    if state is None and tc.checkpoint_dir and tc.auto_resume:
        state, start = resume_train_state(cfg, tc, scheduler, ep0,
                                          counters=counters, device=device,
                                          grid=grid)
        if state is not None:
            counters.resumes += 1
    if state is None:
        state = step_lib.init_state(cfg, tc.seed, ep0, device, grid)
    if train_step_fn is None:
        train_step_fn = step_lib.build_train_step(cfg, rt, tc)
    # the engine's or bus's counters are read as deltas from here, so a
    # pre-used engine's history does not leak into this run's counters
    eng_drops0 = getattr(publish_engine, "publish_drops", 0) or 0
    fleet = ("replica_evictions", "replica_rejoins", "dedup_hits")
    fleet0 = {k: getattr(publish_engine, k, 0) or 0 for k in fleet}
    plan_fb0 = scheduler.plan_fallbacks if scheduler is not None else 0
    sup_dw0 = supervisor.deweight_events if supervisor is not None else 0
    history = []
    it = iter(stream)
    for _ in range(start):          # align the data with the first run
        next(it)
    # publications are versioned by the global step, monotone across
    # resumed runs and rollbacks
    step_base = int(state.step)
    bad_streak = 0
    publish_warned = False
    loop_pub_failures = 0
    eng_drops = 0
    last_pub_version = 0
    pending_replan = False          # rows moved since the last publication?
    # elastic recovery: the raw batches consumed since a little before the
    # last checkpoint, replayed in order after a rollback
    replay = deque(maxlen=max(2 * (tc.checkpoint_every or 1), 8)) \
        if supervisor is not None else None
    pending = deque()
    try:
        i = start
        while i < num_steps:
            gstep = step_base + (i - start) + 1     # global step after i
            raw = pending.popleft() if pending else next(it)
            if replay is not None:
                replay.append((i, raw))
            spare = full_grid is not None and grid is None
            dt, step_ok, metrics = 0.0, None, None
            if not spare:
                if grid is not None:
                    raw = {k: v[microbatch_rows(v.shape[0], grid.rank,
                                                grid.size, tc.microbatch)]
                           for k, v in raw.items()}
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in raw.items()}
                # chaos site: tests arm this with faults.poison_grads to
                # make THIS step's gradients NaN (see common.faults)
                batch = faults.fire("train.nan_grads", batch)
                pa = None
                if scheduler is not None and cfg.moe.enabled:
                    if supervisor is not None:
                        scheduler.device_weights = \
                            supervisor.device_weights()
                    perm = scheduler.maybe_reshard(i)
                    if perm is not None:
                        state = apply_reshard(state, perm, grid)
                        pending_replan = True
                    pa = scheduler.plan_arrays()
                t0 = time.perf_counter()
                state, metrics = train_step_fn(state, batch, pa)
                del batch
                if (publish_engine is not None and publish_every
                        and (i + 1) % publish_every == 0
                        # replayed steps revisit old gsteps: never hand
                        # the engine a version it has seen
                        and gstep > last_pub_version
                        # a shrunk grid's spares cannot take part
                        and grid is full_grid):
                    try:
                        kw = {}
                        if pending_replan and pa is not None:
                            kw["pa"] = pa
                        publish_engine.publish_params(
                            snapshot(state.params), version=gstep, **kw)
                        pending_replan = False
                        last_pub_version = gstep
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
                if (scheduler is not None and cfg.moe.enabled
                        and i + 1 < num_steps):
                    scheduler.plan_ahead()          # plan i+1 while i runs
                metrics = _to_host(metrics)         # blocks on the step
                dt = time.perf_counter() - t0
                step_ok = float(metrics.get("step_ok", 1.0)) >= 0.5
            if supervisor is not None:
                try:
                    step_ok = _probe(supervisor, i, dt, step_ok, full_grid)
                except DeviceLossError as e:
                    box, state = [state], None
                    state, rt, grid, train_step_fn, i = _shrink(
                        e, cfg, tc, supervisor, scheduler, counters, box,
                        history, replay, pending, gstep, i, start,
                        step_base, full_grid, device)
                    bad_streak = 0
                    pending_replan = True
                    continue
            if spare:
                rec = None
            else:
                if scheduler is not None and "expert_counts" in metrics:
                    counts = metrics["expert_counts"]
                    if grid is not None:
                        counts = assert_scheduler_coherence(
                            counts, grid.world_group)
                    scheduler.observe(counts)
                rec = _record(i, metrics, dt, step_ok, counters)
            # ---- step-health skip policy (rides the readback above) ----
            if not step_ok:
                counters.skipped_steps += 1
                bad_streak += 1
            else:
                bad_streak = 0
            if scheduler is not None:
                counters.plan_fallbacks = scheduler.plan_fallbacks - plan_fb0
            if supervisor is not None:
                counters.stragglers_deweighted = (
                    supervisor.deweight_events - sup_dw0)
            if publish_engine is not None:
                eng_drops = (getattr(publish_engine, "publish_drops", 0)
                             or 0) - eng_drops0
                for k in fleet:
                    setattr(counters, k,
                            (getattr(publish_engine, k, 0) or 0) - fleet0[k])
            counters.publish_drops = loop_pub_failures + eng_drops
            if rec is not None:
                rec.update(counters.as_dict())
                if metric_logger is not None:
                    rec.update(metric_logger.log(i, metrics))
                history.append(rec)
                if callback:
                    callback(i, state, metrics)
            if bad_streak >= tc.max_bad_steps > 0:
                # the loop lets go of the state, so a rollback can free it
                # before it restores
                box, state = [state], None
                _rollback_or_abort(cfg, tc, scheduler, counters, box,
                                   history, bad_streak, gstep, grid, spare,
                                   device)
            if (tc.checkpoint_dir and tc.checkpoint_every
                    and step_ok and gstep % tc.checkpoint_every == 0):
                _save(tc, gstep, state, scheduler, grid, full_grid)
                if supervisor is not None and _from_rank0(
                        supervisor.can_grow_back(), full_grid):
                    grown = counters.grow_backs
                    state, rt, grid, train_step_fn = _grow_back(
                        cfg, tc, supervisor, scheduler, counters, state, rt,
                        grid, train_step_fn, gstep, full_grid, device)
                    pending_replan |= counters.grow_backs > grown
            if log_every and rec is not None and i % log_every == 0:
                print(f"step {i:5d}  loss {rec['loss']:.4f}  "
                      f"xent {rec['xent']:.4f}  {dt*1e3:.0f} ms")
            i += 1
    finally:
        if scheduler is not None:
            # the worker is made again at the next plan_ahead, so a
            # scheduler reused across calls keeps working
            scheduler.close()
    return state, history


def _record(i, metrics, dt, step_ok, counters) -> dict:
    rec = {"step": i, "loss": float(metrics["loss"]),
           "xent": float(metrics["xent"]), "time_s": dt,
           "step_ok": float(step_ok), **counters.as_dict()}
    if "dropped_frac" in metrics:
        rec["dropped_frac"] = float(metrics["dropped_frac"])
    if "pad_frac" in metrics:
        rec["pad_frac"] = float(metrics["pad_frac"])
    return rec


def _save(tc, gstep, state, scheduler, grid, full_grid) -> None:
    """``save_train_state`` on the grid that trains; when spares sit
    beside it (after a shrink) they learn from rank 0 whether it
    landed."""
    if full_grid is None or grid is full_grid:
        save_train_state(tc, gstep, state, scheduler, grid)
        return
    err = None
    if grid is not None:
        try:
            save_train_state(tc, gstep, state, scheduler, grid)
        except BaseException as e:
            err = e
    failed = _from_rank0(err is not None, full_grid)
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"checkpoint step {gstep}: the save on rank 0 "
                           f"failed")


def _rollback_or_abort(cfg, tc, scheduler, counters, box, history,
                       bad_streak, gstep, grid, spare, device):
    """The bad-step budget ran out: roll back to the newest intact
    checkpoint and raise ``TrainAbortError`` with the rolled-back state
    (the live one, ``box``'s only item, when there is no checkpoint).
    The poisoned state and any pending plan-ahead job are dropped before
    the restore, so the rollback holds one state at a time."""
    state = box.pop()
    if tc.checkpoint_dir and not spare and _from_rank0(
            bool(store.list_steps(tc.checkpoint_dir)), grid):
        if scheduler is not None:
            scheduler._drop_pending()
        state = None
        state, _ = resume_train_state(
            cfg, tc, scheduler, scheduler.ep if scheduler else 1,
            counters=counters, device=device, grid=grid)
        if state is not None:
            counters.rollbacks += 1
            if history:
                history[-1].update(counters.as_dict())
    tail = ("state rolled back to last intact checkpoint"
            if counters.rollbacks else "no checkpoint to roll back to")
    raise TrainAbortError(
        f"aborting: {bad_streak} consecutive bad steps "
        f"(tc.max_bad_steps={tc.max_bad_steps}) at global step {gstep}; "
        f"{tail}", state=state, history=history, step=gstep)


def _shrink(e: DeviceLossError, cfg, tc, supervisor, scheduler, counters,
            box, history, replay, pending, gstep, i, start, step_base,
            full_grid, device):
    """A device was declared lost: shrink in-process to the surviving
    ep', roll back through ``resume_train_state``'s elastic restore (the
    trajectory a kill-and-restart onto ep' would take), queue the
    rolled-back batches for replay, trim the history and rebuild the
    step.  Returns ``(state, runtime, grid, step fn, index to resume
    at)``; a rank outside the surviving grid gets no state (a spare).
    ``box`` holds the live state, dropped before the restore."""
    state = box.pop()
    counters.device_losses += len(e.lost)
    new_ep = supervisor.ep - len(e.lost)
    if new_ep < max(supervisor.min_ep, 1) or not tc.checkpoint_dir:
        reason = (f"surviving ep={new_ep} would fall below min_ep="
                  f"{supervisor.min_ep}" if tc.checkpoint_dir else
                  "no checkpoint_dir to roll back from")
        raise TrainAbortError(
            f"unrecoverable device loss at global step {gstep} ({e}): "
            f"{reason}", state=state, history=history, step=gstep)
    warnings.warn(
        f"train_loop: {e} at global step {gstep}; shrinking in-process to "
        f"ep={new_ep} and rolling back to the newest intact checkpoint",
        RuntimeWarning)
    rt_new = supervisor.runtime_factory(new_ep)
    grid = getattr(rt_new, "grid", None) if full_grid is not None else None
    if scheduler is not None:
        scheduler.ep = new_ep
        scheduler._drop_pending()
    state = rolled = None
    rstep = -1
    if full_grid is None or grid is not None:
        rolled, rstep = resume_train_state(cfg, tc, scheduler, new_ep,
                                           counters=counters, device=device,
                                           grid=grid)
        if rolled is None:
            rstep = -1
    rstep = _from_rank0(rstep, full_grid)
    if rstep < 0:
        raise TrainAbortError(
            f"device loss at global step {gstep} ({e}) but no intact "
            f"checkpoint to roll back to", state=None, history=history,
            step=gstep)
    i_resume = start + (rstep - step_base)
    if replay and replay[0][0] > i_resume:
        raise TrainAbortError(
            f"device loss at global step {gstep} ({e}): the replay buffer "
            f"no longer covers rollback target step {i_resume} (oldest "
            f"kept: {replay[0][0]})", state=rolled, history=history,
            step=gstep)
    # re-queue the rolled-back batches (oldest first) ahead of any still
    # pending from an earlier rollback, and prune the window to match
    tail = [r for idx, r in replay if idx >= i_resume]
    kept = [(idx, r) for idx, r in replay if idx < i_resume]
    pending.extendleft(reversed(tail))
    replay.clear()
    replay.extend(kept)
    history[:] = [h for h in history if h["step"] < i_resume]
    step_fn = step_lib.build_train_step(cfg, rt_new, tc)
    counters.elastic_shrinks += 1
    supervisor.on_shrunk(new_ep, steps_lost=i - i_resume + 1)
    return rolled, rt_new, grid, step_fn, i_resume


def _grow_back(cfg, tc, supervisor, scheduler, counters, state, rt, grid,
               step_fn, gstep, full_grid, device):
    """The lost device rejoined: at this checkpoint boundary restore the
    step just saved onto the full ep through the inverse elastic remap
    (the row layout round-trips bit-exactly), so no data or history
    rewinds.  A failed grow-back stays shrunk.  Returns ``(state,
    runtime, grid, step fn)``."""
    full_ep, shrunk_ep = supervisor.full_ep, supervisor.ep
    try:
        rt_new = supervisor.runtime_factory(full_ep)
        if scheduler is not None:
            scheduler.ep = full_ep
            scheduler._drop_pending()
        regrown, rstep = resume_train_state(cfg, tc, scheduler, full_ep,
                                            counters=counters, device=device,
                                            grid=full_grid)
        if regrown is None or rstep != gstep:
            raise RuntimeError(f"grow-back restore yielded step {rstep}, "
                               f"expected {gstep}")
    except Exception as ge:
        if scheduler is not None:
            scheduler.ep = shrunk_ep
            if full_grid is None or grid is not None:
                # a partial restore may have set the scheduler up for the
                # full ep: restore it at the ep still running
                resume_train_state(cfg, tc, scheduler, shrunk_ep,
                                   device=device, grid=grid)
        warnings.warn(f"train_loop: grow-back to ep={full_ep} failed "
                      f"({ge!r}); staying on ep={shrunk_ep}", RuntimeWarning)
        return state, rt, grid, step_fn
    counters.grow_backs += 1
    supervisor.on_grow_back()
    warnings.warn(f"train_loop: grew back to ep={full_ep} at global step "
                  f"{gstep}", RuntimeWarning)
    return (regrown, rt_new, full_grid,
            step_lib.build_train_step(cfg, rt_new, tc))
