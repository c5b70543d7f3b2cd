"""Hecate training loop: the port of the JAX package's
``repro/train/trainer.py`` control loop.

Per iteration (paper Fig. 5): the predictor estimates the next
iteration's expert loads, the scheduler emits the materialization plan
(runtime tables; Algorithm 1 for the ``ring``, ``a2a`` and ``dense``
plans, run synchronously every step), the train step runs, and the
observed per-layer expert counts feed back into the predictor.  On a
process grid every rank runs this loop on its rows of each global batch;
the counts are summed over the world inside the step, so every rank plans
the same (``launch.distributed.assert_scheduler_coherence`` checks it).
Calibration, resharding and the plan-ahead thread, checkpointing and the
elastic supervisor are not yet ported: asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.common import faults
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.params import snapshot
from repro_torch.core import moe as moe_core
from repro_torch.core.placement import (MaterializationPlan,
                                        ep_materialization,
                                        homogeneous_sharding)
from repro_torch.core.schedule import LoadPredictor, sparse_materialization
from repro_torch.data.pipeline import host_slice
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


@dataclasses.dataclass
class HecateScheduler:
    """Owns the sharding plan and the load predictor, and hands the train
    step its plan tables: the JAX package's scheduler with
    ``async_plan=False, calibrate=False`` and no resharding.  ``impl``:
    ``ep`` (every expert in its owner's slots), or Algorithm 1's ``ring``,
    ``a2a`` or ``dense`` plan over ``ep`` expert-parallel ranks with
    overlap degree ``t`` and ``cfg.moe.slots_per_device`` extra slots."""

    cfg: ModelConfig
    ep: int = 1
    impl: str = "ep"
    t: int = 8
    window: int = 5
    device: str = "cuda"

    def __post_init__(self):
        if self.impl not in ("ep", "ring", "a2a", "dense"):
            raise ValueError(f"HecateScheduler impl={self.impl!r}")
        L = moe_core.num_moe_layers(self.cfg)
        E = self.cfg.moe.num_experts
        self.predictor = LoadPredictor(L, E, self.window)
        self.sharding = homogeneous_sharding(L, E, self.ep)

    def plan(self) -> MaterializationPlan:
        if self.impl == "ep":
            return ep_materialization(self.sharding)
        return sparse_materialization(
            self.sharding, self.predictor.predict(), t=self.t,
            m=self.cfg.moe.slots_per_device, impl=self.impl)

    def plan_arrays(self) -> moe_core.PlanArrays:
        return moe_core.plan_to_arrays(self.plan(), self.device)

    def observe(self, counts: np.ndarray) -> None:
        self.predictor.observe(np.asarray(counts, np.float64))


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

    On a process grid (``rt.grid``) every rank runs this loop: ``stream``
    yields the global batch and each rank takes its rows
    (``data.pipeline.host_slice``); the state is made from the seed and
    sharded (``models.model.shard_params``); the expert counts every rank
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
    history = []
    it = iter(stream)
    step_base = int(state.step)
    bad_streak = 0
    publish_warned = False
    loop_pub_failures = 0
    # the engine's or bus's counters are read as deltas from here, so a
    # pre-used engine's history does not leak into this run's counters
    eng_drops0 = getattr(publish_engine, "publish_drops", 0) or 0
    eng_drops = 0
    fleet = ("replica_evictions", "replica_rejoins", "dedup_hits")
    fleet0 = {k: getattr(publish_engine, k, 0) or 0 for k in fleet}
    for i in range(num_steps):
        gstep = step_base + i + 1               # global step AFTER i
        raw = next(it)
        if grid is not None:
            raw = {k: v[host_slice(v.shape[0], grid.rank, grid.size)]
                   for k, v in raw.items()}
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in raw.items()}
        # chaos site: tests arm this with faults.poison_grads to make
        # THIS step's gradients NaN (see repro_torch.common.faults)
        batch = faults.fire("train.nan_grads", batch)
        pa = None
        if scheduler is not None and cfg.moe.enabled:
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
    return state, history
