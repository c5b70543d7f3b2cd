"""Hecate training loop at world size 1: the port of the JAX package's
``repro/train/trainer.py`` control loop.

Per iteration (paper Fig. 5): the predictor estimates the next
iteration's expert loads, the scheduler emits the materialization plan
(runtime tables), the train step runs, and the observed per-layer expert
counts feed back into the predictor.  At world size 1 the plan is the
``ep`` plan (every expert in its own slot), so Algorithm 1, calibration,
resharding and the plan-ahead thread have nothing to do; they come with
the distributed layer.  Checkpointing, parameter publication and the
elastic supervisor are not yet ported: asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.common import faults
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.core import moe as moe_core
from repro_torch.core.placement import (MaterializationPlan,
                                        ep_materialization,
                                        homogeneous_sharding)
from repro_torch.core.schedule import LoadPredictor
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
    step its plan tables.  Only ``impl="ep"`` at ``ep=1`` is ported."""

    cfg: ModelConfig
    ep: int = 1
    impl: str = "ep"
    window: int = 5
    device: str = "cuda"

    def __post_init__(self):
        if self.impl != "ep":
            raise _not_ported(f"HecateScheduler impl={self.impl!r}")
        if self.ep != 1:
            raise _not_ported(f"HecateScheduler at ep={self.ep}")
        L = moe_core.num_moe_layers(self.cfg)
        E = self.cfg.moe.num_experts
        self.predictor = LoadPredictor(L, E, self.window)
        self.sharding = homogeneous_sharding(L, E, self.ep)

    def plan(self) -> MaterializationPlan:
        return ep_materialization(self.sharding)

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
    Checkpointing (``tc.checkpoint_dir``), publication
    (``publish_engine``), the elastic supervisor and ``metric_logger`` are
    not yet ported and raise."""
    if tc.checkpoint_dir or tc.checkpoint_every:
        raise _not_ported("checkpointing (tc.checkpoint_dir)")
    if publish_engine is not None or publish_every:
        raise _not_ported("training-while-serving publication")
    if supervisor is not None:
        raise _not_ported("the elastic recovery supervisor")
    if metric_logger is not None:
        raise _not_ported("MetricLogger")
    num_steps = num_steps or tc.total_steps
    counters = metrics_lib.RobustnessCounters()
    if state is None:
        state = step_lib.init_state(cfg, tc.seed,
                                    scheduler.ep if scheduler else 1,
                                    device)
    if train_step_fn is None:
        train_step_fn = step_lib.build_train_step(cfg, rt, tc)
    history = []
    it = iter(stream)
    step_base = int(state.step)
    bad_streak = 0
    for i in range(num_steps):
        gstep = step_base + i + 1               # global step AFTER i
        raw = next(it)
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
        metrics = _to_host(metrics)             # blocks on the step
        dt = time.perf_counter() - t0
        if scheduler is not None and "expert_counts" in metrics:
            scheduler.observe(metrics["expert_counts"])
        # ---- step-health skip policy (rides the readback above) ----
        step_ok = float(metrics.get("step_ok", 1.0)) >= 0.5
        if not step_ok:
            counters.skipped_steps += 1
            bad_streak += 1
        else:
            bad_streak = 0
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
