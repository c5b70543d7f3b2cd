"""The port's latency model, calibration stage and plan-ahead thread
against the JAX package: the port of ``tests/test_costs_calibration.py``
and of the planner cases of ``tests/test_fault_tolerance.py``.

Both packages price the same plans under the same loads from the same
hardware constants: the test builds the port's ``HardwareConfig`` from the
fields of the JAX package's ``TPU_V5E`` (the port itself holds only the
H100's).  No verdict reads a clock: the hung planner job is released by
an event.
"""
import dataclasses
import functools
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.common import faults as jfaults  # noqa: E402
from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.common.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.common.config import TPU_V5E  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import (H100, HardwareConfig,  # noqa: E402
                                       ModelConfig, MoEConfig)
from repro_torch.core import costs  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

HW = HardwareConfig(**dataclasses.asdict(TPU_V5E))


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def same_hw(monkeypatch):
    """The scheduler's cost model on the JAX package's constants."""
    monkeypatch.setattr(trainer, "CostContext",
                        functools.partial(costs.CostContext, hw=HW))


def _cfgs():
    kw = dict(name="t", arch_type="moe", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
              dtype="float32")
    moe = dict(num_experts=8, experts_per_token=2, d_ff=64,
               slots_per_device=2)
    return (ModelConfig(moe=MoEConfig(**moe), **kw),
            JModelConfig(moe=JMoEConfig(**moe), **kw))


def _plans(loads, impl):
    """The same plan made by each package."""
    sh, jsh = (placement.homogeneous_sharding(2, 8, 4),
               jplacement.homogeneous_sharding(2, 8, 4))
    if impl == "ep":
        return placement.ep_materialization(sh), \
            jplacement.ep_materialization(jsh)
    return (schedule.sparse_materialization(sh, loads, t=8, m=2, impl=impl),
            jschedule.sparse_materialization(jsh, loads, t=8, m=2,
                                             impl=impl))


def _skew():
    loads = np.full((2, 8), 0.01)
    loads[:, 0] = 1.0
    return loads


def test_h100_is_the_default_hardware():
    cfg, _ = _cfgs()
    assert costs.CostContext(cfg, tokens_per_step=1.0).hw is H100
    assert (H100.peak_flops_bf16, H100.hbm_bw, H100.ici_bw,
            H100.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)


@pytest.mark.parametrize("impl", ["ring", "a2a", "ep"])
def test_device_loads_match_jax(impl):
    loads = _skew() + np.random.default_rng(0).random((2, 8))
    plan, jplan = _plans(loads, impl)
    for layer in range(2):
        np.testing.assert_array_equal(
            costs.device_loads_for(plan, loads, layer, 1000, 2),
            jcosts.device_loads_for(jplan, loads, layer, 1000, 2))


def test_replicas_flatten_the_hot_expert():
    loads = _skew()
    plan, _ = _plans(loads + 0.01, "a2a")
    dev = costs.device_loads_for(plan, loads[0] + 0.01, 0, tokens=1000,
                                 top_k=2)
    assert dev.max() < 0.9 * 2000


@pytest.mark.parametrize("impl", ["ring", "a2a", "ep"])
@pytest.mark.parametrize("on_path", [False, True])
@pytest.mark.parametrize("weights", [None, (1.0, 0.5, 1.0, 0.25)])
def test_placement_latency_matches_jax(impl, on_path, weights):
    cfg, jcfg = _cfgs()
    loads = _skew()
    plan, jplan = _plans(loads, impl)
    ctx = costs.CostContext(cfg, tokens_per_step=4096, hw=HW,
                            attn_time_s=1e-6)
    jctx = jcosts.CostContext(jcfg, tokens_per_step=4096, hw=TPU_V5E,
                              attn_time_s=1e-6)
    for layer in range(2):
        got = costs.placement_latency(ctx, plan, loads, layer, on_path,
                                      weights)
        want = jcosts.placement_latency(jctx, jplan, loads, layer, on_path,
                                        weights)
        assert got == want and got > 0


def test_balanced_plan_is_faster_under_skew():
    cfg, _ = _cfgs()
    ctx = costs.CostContext(cfg, tokens_per_step=4096)
    loads = _skew()
    bal, _ = _plans(loads, "a2a")
    ep, _ = _plans(loads, "ep")
    assert costs.placement_latency(ctx, bal, loads[0]) \
        < costs.placement_latency(ctx, ep, loads[0])


@pytest.mark.parametrize("kind", ["skew", "uniform"])
def test_calibration_gain_matches_jax(kind):
    cfg, jcfg = _cfgs()
    ctx = costs.CostContext(cfg, tokens_per_step=4096, hw=HW)
    jctx = jcosts.CostContext(jcfg, tokens_per_step=4096, hw=TPU_V5E)
    if kind == "skew":
        loads = _skew()
        cur, jcur = _plans(loads, "ep")         # the plan made blind
    else:
        loads = np.ones((2, 8))
        cur, jcur = _plans(loads, "a2a")
    cand, jcand = _plans(loads, "a2a")
    got = costs.calibration_gain(ctx, cur, cand, loads)
    assert got == jcosts.calibration_gain(jctx, jcur, jcand, loads)
    # a re-plan pays off under skew; under uniform loads it cannot pay for
    # its gather on the critical path
    assert got > 0 if kind == "skew" else got <= 1e-9


def _sequence(kind):
    """(warm-up loads, the load observed after the first plan)."""
    rng = np.random.default_rng(0)
    if kind == "shift":
        shifted = np.full((2, 8), 1.0)
        shifted[:, 3] = 1000.0
        return [np.ones((2, 8)) * 100] * 5, shifted
    if kind == "stable":
        loads = np.abs(rng.normal(100, 1, (2, 8)))
        return [loads] * 5, loads
    if kind == "one_layer_dropped":
        dead = np.ones((2, 8)) * 100
        dead[1] = 0.0
        return [np.ones((2, 8)) * 100] * 5, dead
    return [np.ones((2, 8)) * 100] * 5, np.zeros((2, 8))


@pytest.mark.parametrize("kind", ["shift", "stable", "one_layer_dropped",
                                  "all_dropped"])
@pytest.mark.parametrize("impl", ["ring", "a2a"])
def test_calibration_decisions_match_jax(same_hw, kind, impl):
    """On the same load sequence both schedulers calibrate, or do not, at
    the same observation, and the next plan is the same; a layer whose
    tokens were all dropped divides by nothing."""
    cfg, jcfg = _cfgs()
    s = trainer.HecateScheduler(cfg, ep=4, impl=impl, device="cpu",
                                calibration_margin=0.01, async_plan=False)
    js = jtrainer.HecateScheduler(jcfg, ep=4, impl=impl,
                                  calibration_margin=0.01, async_plan=False)
    warm, then = _sequence(kind)
    for loads in warm:
        s.observe(loads)
        js.observe(loads)
    s.plan()
    js.plan()
    with np.errstate(all="raise"):
        s.observe(then)
        js.observe(then)
    assert s.calibration_events == js.calibration_events
    a, b = s.plan(), js.plan()
    np.testing.assert_array_equal(a.extra_experts, b.extra_experts)
    np.testing.assert_array_equal(a.ring_send_rows, b.ring_send_rows)
    if kind == "shift":
        assert s.calibration_events == 1
        _, expert_slot = a.slot_tables()
        assert (expert_slot[0, :, 3] >= 0).sum() >= 2   # hot expert copied
    elif kind == "stable":
        assert s.calibration_events == 0
    js.close()


def _warm(sched, seed=1, sigma=5.0):
    loads = np.abs(np.random.default_rng(seed).normal(100, sigma, (2, 8)))
    for _ in range(5):
        sched.observe(loads)
    return loads


def test_plan_ahead_gives_the_synchronous_plan_bit_for_bit():
    cfg, _ = _cfgs()
    sched = trainer.HecateScheduler(cfg, ep=4, impl="ring", calibrate=False,
                                    device="cpu")
    sync = trainer.HecateScheduler(cfg, ep=4, impl="ring", calibrate=False,
                                   async_plan=False, device="cpu")
    _warm(sched)
    _warm(sync)
    sched.plan_ahead()
    a_tables = sched.plan_arrays()          # the prefetched tables
    assert sched.plan_ahead_hits == 1
    b_tables = sync.plan_arrays()
    for x, y in zip(a_tables, b_tables):
        assert torch.equal(x, y)
    c = sched.plan()                        # nothing in flight: synchronous
    assert sched.plan_ahead_hits == 1
    np.testing.assert_array_equal(c.extra_experts, sync.plan().extra_experts)
    sched.close()


def test_a_reshard_invalidates_the_prefetched_plan():
    cfg, _ = _cfgs()
    sched = trainer.HecateScheduler(cfg, ep=4, impl="ring", calibrate=False,
                                    device="cpu")
    loads = _warm(sched, seed=2, sigma=40.0)
    sched.plan_ahead()
    sched._pending[0].result()              # let the worker finish
    sched.sharding = schedule.heterogeneous_sharding(loads, 4, t=2)
    plan = sched.plan()
    assert sched.plan_ahead_hits == 0
    assert plan.sharding is sched.sharding
    sched.close()


def test_planner_job_exception_falls_back_and_recovers():
    """A job that raises: ``plan()`` answers synchronously with the same
    plan, counts the fallback, warns once, and plan-ahead stays on."""
    cfg, _ = _cfgs()
    sched = trainer.HecateScheduler(cfg, ep=4, impl="ring", calibrate=False,
                                    device="cpu")
    sync = trainer.HecateScheduler(cfg, ep=4, impl="ring", calibrate=False,
                                   async_plan=False, device="cpu")
    _warm(sched)
    _warm(sync)
    with faults.injected("scheduler.plan_job"):
        sched.plan_ahead()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            plan = sched.plan()
    assert sched.plan_fallbacks == 1
    assert any("plan-ahead job failed" in str(x.message) for x in w)
    ref = sync.plan()
    np.testing.assert_array_equal(plan.extra_experts, ref.extra_experts)
    np.testing.assert_array_equal(plan.ring_send_rows, ref.ring_send_rows)
    assert sched.async_plan
    sched.plan_ahead()
    sched.plan()
    assert sched.plan_ahead_hits == 1
    sched.close()


def test_planner_job_hang_disables_plan_ahead_and_close_does_not_join():
    """A job that hangs: ``plan()`` gives up after ``plan_timeout_s`` and
    plans synchronously, plan-ahead is off for good, and ``close()``
    returns while the job still hangs; clearing the site releases it."""
    cfg, _ = _cfgs()
    sched = trainer.HecateScheduler(cfg, ep=4, impl="ring", calibrate=False,
                                    device="cpu", plan_timeout_s=0.2)
    _warm(sched, seed=2)
    faults.inject("scheduler.plan_job_hang", hang_s=3600)
    sched.plan_ahead()
    worker = sched._executor._thread
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = sched.plan()
    assert plan is not None and sched.plan_fallbacks == 1
    assert not sched.async_plan and sched._worker_poisoned
    assert worker.daemon
    sched.plan_ahead()                      # degraded: a snapshot, no job
    assert sched._pending[0] is None
    sched.close()
    assert faults.fired("scheduler.plan_job_hang") == 1
    assert worker.is_alive()                # close() did not wait for it
    faults.clear("scheduler.plan_job_hang")   # the event releases the job
    worker.join(timeout=60)
    assert not worker.is_alive()


def test_train_loop_reports_this_runs_plan_fallbacks():
    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    cfg = configs.get_smoke("gpt-moe-s")
    sched = trainer.HecateScheduler(cfg, device="cpu")
    sched.plan_fallbacks = 7                # an earlier run's
    stream = make_stream(cfg.vocab_size, 16, 4, kind="bytes", seed=0)
    _, hist = trainer.train_loop(
        cfg, mdl.Runtime(use_pallas=False), TrainConfig(learning_rate=3e-3),
        stream, scheduler=sched, num_steps=2, log_every=0, device="cpu")
    assert all(h["plan_fallbacks"] == 0 for h in hist)
