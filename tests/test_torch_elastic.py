"""The port's elastic recovery against the JAX package's, on the CPU: the
counterparts of ``tests/test_elastic_recovery.py`` and of the elastic
restore cases of ``tests/test_serve_fleet.py``.

1. The supervisor (``train.supervisor``): each fault script of the
   reference's unit tests drives both packages' supervisors, which must
   walk the same states, declare the same losses and publish the same
   straggler weights.
2. Straggler weights through ``ReshardingPolicy`` into Algorithm 2: the
   same owners as the JAX package's.
3. The in-process shrink without a grid (the smollm smoke config, f32): a
   device loss at step 5 rolls back to the step-4 checkpoint, replays the
   rolled-back batches, and grows back at the next checkpoint; the losses
   equal the uninterrupted run's bit for bit, and JAX's over the same
   scenario within 1e-5 for steps 0 and 1 and 3% after (the packages'
   runs part after two AdamW steps: see ``test_torch_fault_tolerance``).
   A loss with no checkpoint directory, or below ``min_ep``, aborts typed
   in both.
4. The elastic restore at world size 1: a checkpoint the JAX package
   saved on ep 2 restores in the port on ep 4 with the buffer and both
   moments equal, bitwise, to the JAX package's own elastic restore; the
   ``restore.mesh_mismatch`` fault starts both fresh.
5. On gloo ranks (``tests/torch_dist_cases.py``): a (2, 2) checkpoint
   resumed on (1, 4) continues the unresized run's losses; on (1, 4) an
   in-process shrink to ep 3 (rank 3 a spare) and the grow-back give the
   kill-and-restart run's losses within 1e-5, with the reference's
   counters and the JAX supervisor's walk; on (1, 3) a slow EP rank gets
   the JAX supervisor's weight and fewer expert slots at the reshard.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.common import faults as jfaults  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.schedule import ReshardingPolicy as JPolicy  # noqa: E402
from repro.core.schedule import heterogeneous_sharding as jhetero  # noqa
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.train import metrics as jmetrics  # noqa: E402
from repro.train import step as jst  # noqa: E402
from repro.train import supervisor as jsup  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import (ModelConfig, MoEConfig,  # noqa: E402
                                       SSMConfig, TrainConfig)
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core.schedule import (ReshardingPolicy,  # noqa: E402
                                       heterogeneous_sharding)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import metrics  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import supervisor as sup_mod  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many do, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the supervisor, one fault script through both packages
# ---------------------------------------------------------------------------
def _walk(mod, flt, script, **kw):
    """Run ``script`` (a list of ("probe", step, dt) | ("arm", site, kw) |
    ("clear", site) | ("shrunk", ep) | ("grow",) | ("can",)) against a
    supervisor of ``mod``; returns what was observed after each event."""
    kw.setdefault("ep", 4)
    sup = mod.TrainSupervisor(runtime_factory=lambda ep: None, **kw)
    seen = []
    for ev in script:
        got = None
        if ev[0] == "probe":
            try:
                sup.probe(ev[1], ev[2])
            except mod.DeviceLossError as e:
                got = ("loss", e.lost, e.site)
        elif ev[0] == "arm":
            kwargs = dict(ev[2])
            if "mutate" in kwargs:      # each package's own mutator
                kwargs["mutate"] = kwargs["mutate"](flt)
            flt.inject(ev[1], **kwargs)
        elif ev[0] == "clear":
            flt.clear(ev[1])
        elif ev[0] == "shrunk":
            sup.on_shrunk(ev[1], steps_lost=1)
        elif ev[0] == "grow":
            sup.on_grow_back()
        elif ev[0] == "can":
            got = sup.can_grow_back()
        w = sup.device_weights()
        seen.append((got, sup.state, sup.ep, sorted(sup.lost),
                     sup.deweight_events,
                     None if w is None else [round(float(x), 12) for x in w]))
    flt.clear()
    return seen


SCRIPTS = {
    "device_lost": ([("arm", "mesh.device_lost", dict(only=2, times=None)),
                     ("probe", 0, 0.01), ("shrunk", 3), ("can",),
                     ("clear", "mesh.device_lost"), ("can",), ("grow",)],
                    {}),
    "heartbeat_streak": (
        [("arm", "host.heartbeat_miss",
          dict(only=1, mutate=lambda f: f.drop_heartbeat, times=2)),
         ("probe", 0, 0.01), ("probe", 1, 0.01), ("probe", 2, 0.01),
         ("clear", None),
         ("arm", "host.heartbeat_miss",
          dict(only=1, mutate=lambda f: f.drop_heartbeat, times=None)),
         ("probe", 3, 0.01), ("probe", 4, 0.01), ("probe", 5, 0.01)],
        dict(heartbeat_misses=3)),
    "collective_timeout": (
        [("arm", "mesh.slow_device",
          dict(mutate=lambda f: f.slow_device(3, 8.0), times=None)),
         ("probe", 0, 0.01), ("probe", 1, 0.01), ("clear", None),
         ("arm", "collective.timeout", dict(times=1)), ("probe", 2, 0.01)],
        dict(calibration_steps=2)),
    "watchdog": ([("probe", 0, 2.0), ("probe", 1, 0.01)],
                 dict(step_timeout_s=0.5)),
    "straggler_ema": (
        [("arm", "mesh.slow_device",
          dict(mutate=lambda f: f.slow_device(1, 6.0), times=None))]
        + [("probe", s, 0.01) for s in range(5)] + [("clear", None)]
        + [("probe", s, 0.01) for s in range(5, 12)],
        dict(calibration_steps=3, straggler_ratio=1.5, weight_floor=0.25)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_walks_like_jax(name):
    """``test_elastic_recovery.py``'s supervisor cases (device loss and
    rejoin, heartbeat streaks, collective timeout and the watchdog
    blaming the slowest device, the straggler EMA's weights counted
    once): the same observations after every event in both packages."""
    script, kw = SCRIPTS[name]
    got = _walk(sup_mod, faults, script, **kw)
    want = _walk(jsup, jfaults, script, **kw)
    assert got == want
    if name == "device_lost":
        assert got[1][0] == ("loss", (2,), "mesh.device_lost")
        assert got[-1][1] == sup_mod.RECOVERED and got[-1][2] == 4
    if name == "straggler_ema":
        assert got[4][5] == [1.0, 0.25, 1.0, 1.0] and got[4][4] == 1
        assert got[-1][5] is None and got[-1][1] == sup_mod.RUNNING


def test_deweighted_device_loses_slot_share_through_policy():
    """Supervisor weights reach Algorithm 2 through the policy and shrink
    the straggler's owned slots (L·E = 16 on M = 3), with the JAX
    package's owners; weights of the wrong length raise in both."""
    L, E, M = 2, 8, 3
    loads = np.ones((L, E))

    class _Pred:
        def predict(self):
            return loads
    outs = []
    for het, pol in ((heterogeneous_sharding, ReshardingPolicy),
                     (jhetero, JPolicy)):
        base = het(loads, M, 2, k_local=6)
        p = pol(interval=1, t=2)
        p.device_weights = np.array([1.0, 1.0, 0.25])
        new, changed = p.maybe_reshard(3, base, _Pred())
        outs.append((changed, new.owner_dev, new.owner_row,
                     [(base.owner_dev == d).sum() for d in range(M)]))
        with pytest.raises(ValueError):
            het(loads, M, 2, device_weights=np.ones(M + 1))
    (c, od, orow, base_counts), (jc, jod, jorow, _) = outs
    assert c and jc
    np.testing.assert_array_equal(od, jod)
    np.testing.assert_array_equal(orow, jorow)
    counts = [(od == d).sum() for d in range(M)]
    assert counts[2] < min(counts[0], counts[1]) and counts[2] < \
        base_counts[2] and sum(counts) == L * E


# ---------------------------------------------------------------------------
# in-process shrink without a grid
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dense():
    """The dense config in both packages, JAX's initial weights, and one
    jitted JAX step at ``_tcs``'s hyperparameters, which the JAX runs
    share (its shrink and grow-back build their own, as in the
    reference)."""
    jcfg = jconfigs.get_smoke("smollm-360m")
    d = dataclasses.asdict(jcfg)
    cfg = ModelConfig(moe=MoEConfig(**d.pop("moe")),
                      ssm=SSMConfig(**d.pop("ssm")), **d)
    np_tree = jax.tree.map(np.asarray,
                           jmdl.init_params(jcfg, jax.random.PRNGKey(0)))
    jstep = jax.jit(jst.build_train_step(jcfg, jmdl.Runtime(),
                                         _tcs("")[1]))
    return jcfg, cfg, np_tree, jstep


def _tcs(d, **kw):
    kw = dict(dict(learning_rate=3e-3, warmup_steps=2, total_steps=8,
                   checkpoint_every=2), **kw)
    return TrainConfig(checkpoint_dir=d, seed=0, **kw), \
        JTrainConfig(checkpoint_dir=d, seed=0, **kw)


def _state(np_tree):
    p = params_from_jax(np_tree, "cpu")
    return st.TrainState(p, adamw.init(p), torch.zeros((), dtype=torch.int32))


def _streams():
    return (pipeline.make_stream(512, 32, 2, kind="synthetic", seed=0),
            jpipeline.make_stream(512, 32, 2, kind="synthetic", seed=0))


def test_in_process_shrink_replays_to_parity_then_grows_back(dense,
                                                            tmp_path):
    """A device loss at step 5 rolls back to the step-4 checkpoint and
    replays batches 4 and 5; the cleared fault grows the run back at the
    next checkpoint (RECOVERED, the counters in every record); the losses
    equal the uninterrupted run's bit for bit, and the JAX package's run
    of the same script reaches the same states, counters and recovery
    record."""
    jcfg, cfg, np_tree, jstep = dense
    rt = mdl.Runtime(use_pallas=False)
    tca, _ = _tcs(str(tmp_path / "a"))
    _, h_ref = trainer.train_loop(cfg, rt, tca, _streams()[0],
                                  state=_state(np_tree), num_steps=8,
                                  log_every=0, device="cpu")
    runs = []
    for mod, flt, sub in ((trainer, faults, "b"), (jtrainer, jfaults, "c")):
        tc, jtc = _tcs(str(tmp_path / sub))
        s = (sup_mod if mod is trainer else jsup).TrainSupervisor(
            ep=2, runtime_factory=lambda ep: None, min_ep=1)
        flt.inject("mesh.device_lost", only=1, after=5, times=None)

        def clear_when_shrunk(i, state, m, s=s, flt=flt):
            if s.state == "SHRUNK":
                flt.clear("mesh.device_lost")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if mod is trainer:
                s.runtime_factory = lambda ep: rt
                out = trainer.train_loop(
                    cfg, rt, tc, _streams()[0], state=_state(np_tree),
                    num_steps=8, log_every=0, device="cpu", supervisor=s,
                    callback=clear_when_shrunk)
            else:
                jrt = jmdl.Runtime()
                s.runtime_factory = lambda ep: jrt
                out = jtrainer.train_loop(
                    jcfg, jrt, jtc, _streams()[1], num_steps=8, log_every=0,
                    supervisor=s, callback=clear_when_shrunk,
                    train_step_fn=jstep)
        flt.clear()
        runs.append((out, s))
    ((state, h), sup), ((_, jh), jsupv) = runs
    assert sup.state == jsupv.state == sup_mod.RECOVERED and sup.ep == 2
    keys = ("device_losses", "elastic_shrinks", "grow_backs", "rollbacks",
            "elastic_restores")
    assert {k: h[-1][k] for k in keys} == {k: jh[-1][k] for k in keys}
    assert h[-1]["device_losses"] == h[-1]["grow_backs"] == 1
    assert int(state.step) == 8
    ref = {r["step"]: r["loss"] for r in h_ref}
    assert {r["step"]: r["loss"] for r in h} == ref   # the replay, bitwise
    assert [r["step"] for r in jh] == list(range(8))
    got, want = np.asarray([r["loss"] for r in h]), np.asarray(
        [r["loss"] for r in jh])
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=3e-2)
    (rec,), (jrec,) = sup.recoveries, jsupv.recoveries
    for k in ("steps_lost", "ep_from", "ep_to", "site", "lost"):
        assert rec[k] == jrec[k], k
    assert rec["steps_lost"] == 2 and rec["mttr_s"] > 0.0


@pytest.mark.parametrize("case", ["no_checkpoint_dir", "below_min_ep"])
def test_unrecoverable_loss_aborts_typed(case, dense, tmp_path):
    """``test_loss_without_checkpoint_dir_aborts_typed`` and
    ``test_loss_below_min_ep_aborts_typed``: a loss with no checkpoint to
    roll back to, or one that would go below ``min_ep``, raises
    ``TrainAbortError`` naming the reason, in both packages, at the same
    step."""
    jcfg, cfg, np_tree, jstep = dense
    d = "" if case == "no_checkpoint_dir" else str(tmp_path)
    kw = dict(after=1 if d == "" else 3)
    min_ep = 1 if d == "" else 2
    match = "no checkpoint_dir" if d == "" else "min_ep"
    tc, _ = _tcs(d and d + "/port", checkpoint_every=2 if d else 0)
    _, jtc = _tcs(d and d + "/jax", checkpoint_every=2 if d else 0)
    steps = []
    for mod, flt in ((trainer, faults), (jtrainer, jfaults)):
        s = (sup_mod if mod is trainer else jsup).TrainSupervisor(
            ep=2, runtime_factory=lambda ep: None, min_ep=min_ep)
        flt.inject("mesh.device_lost", only=0 if d == "" else 1,
                   times=None, **kw)
        with pytest.raises(mod.TrainAbortError, match=match) as ei:
            if mod is trainer:
                trainer.train_loop(cfg, mdl.Runtime(use_pallas=False), tc,
                                   _streams()[0], state=_state(np_tree),
                                   num_steps=8, log_every=0, device="cpu",
                                   supervisor=s)
            else:
                jtrainer.train_loop(jcfg, jmdl.Runtime(), jtc,
                                    _streams()[1], num_steps=8, log_every=0,
                                    supervisor=s, train_step_fn=jstep)
        flt.clear()
        steps.append(ei.value.step)
    assert steps[0] == steps[1]


# ---------------------------------------------------------------------------
# elastic restore at world size 1
# ---------------------------------------------------------------------------
def _jax_ckpt_on_ep2(tmp_path):
    """The JAX package's ``_ckpt_on_ep``: a checkpoint of a state made on
    ep 2 (moments offset so they differ from the parameters) at step 5."""
    jcfg = jconfigs.get_smoke("gpt-moe-s")
    jtc = JTrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=1,
                       keep_checkpoints=0)
    sched = jtrainer.HecateScheduler(jcfg, ep=2, impl="ep")
    sched.plan_arrays()
    state = jst.init_state(jcfg, jax.random.PRNGKey(7), ep=2)
    state = state._replace(opt=state.opt._replace(
        mu=jax.tree.map(lambda a: a + 1.0, state.opt.mu),
        nu=jax.tree.map(lambda a: a + 2.0, state.opt.nu)),
        step=np.int64(5))
    jtrainer.save_train_state(jtc, 5, state, sched)
    sched.close()
    return jcfg, jtc, state


def test_elastic_restore_remaps_buffer_and_moments(tmp_path):
    """``test_serve_fleet.py::test_elastic_restore_remaps_buffer_and_
    moments``: a checkpoint saved on ep 2 restores on ep 4 (found from
    the saved plan: the shapes agree here), the buffer and both moments
    bitwise equal to the JAX package's own elastic restore and at the new
    plan's rows, every other leaf verbatim, one ``elastic_restores``; a
    same-EP resume stays verbatim."""
    jcfg, jtc, jstate2 = _jax_ckpt_on_ep2(tmp_path)
    cfg = configs.get_smoke("gpt-moe-s")
    tc = TrainConfig(checkpoint_dir=str(tmp_path), keep_checkpoints=0)
    sched4 = trainer.HecateScheduler(cfg, ep=4, impl="ep", device="cpu")
    counters = metrics.RobustnessCounters()
    with pytest.warns(RuntimeWarning, match="re-laid-out"):
        state4, gstep = trainer.resume_train_state(cfg, tc, sched4, 4,
                                                   counters=counters,
                                                   device="cpu")
    jsched4 = jtrainer.HecateScheduler(jcfg, ep=4, impl="ep")
    jcounters = jmetrics.RobustnessCounters()
    with pytest.warns(RuntimeWarning, match="re-laid-out"):
        jstate4, _ = jtrainer.resume_train_state(jcfg, jtc, jsched4, ep=4,
                                                 counters=jcounters)
    assert gstep == 5 and int(state4.step) == 5
    assert counters.elastic_restores == jcounters.elastic_restores == 1
    np.testing.assert_array_equal(sched4.sharding.owner_row,
                                  jsched4.sharding.owner_row)
    got = trainer._state_tree(state4)
    want = jstore._flatten_with_paths(jtrainer._state_tree(jstate4))
    for k, t in store._walk(got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    og = jtrainer.HecateScheduler(jcfg, ep=2, impl="ep").sharding \
        .global_rows().reshape(-1)
    ng = sched4.sharding.global_rows().reshape(-1)
    np.testing.assert_array_equal(
        state4.opt.nu["moe_buffer"].numpy()[ng],
        np.asarray(jstate2.opt.nu["moe_buffer"])[og])
    sched2 = trainer.HecateScheduler(cfg, ep=2, impl="ep", device="cpu")
    c2 = metrics.RobustnessCounters()
    state2, _ = trainer.resume_train_state(cfg, tc, sched2, 2, counters=c2,
                                           device="cpu")
    assert c2.elastic_restores == 0
    np.testing.assert_array_equal(state2.params["moe_buffer"].numpy(),
                                  np.asarray(jstate2.params["moe_buffer"]))
    for s in (sched4, jsched4, sched2):
        s.close()


def test_restore_mesh_mismatch_fault_degrades_to_fresh_init(tmp_path):
    """An armed ``restore.mesh_mismatch`` starts fresh with a warning in
    both packages; ``only=`` passes another (saved, running) pair
    through."""
    jcfg, jtc, _ = _jax_ckpt_on_ep2(tmp_path)
    cfg = configs.get_smoke("gpt-moe-s")
    tc = TrainConfig(checkpoint_dir=str(tmp_path), keep_checkpoints=0)
    for mod, flt, c, t in ((trainer, faults, cfg, tc),
                           (jtrainer, jfaults, jcfg, jtc)):
        kw = {"device": "cpu"} if mod is trainer else {}

        def sched():
            return (mod.HecateScheduler(c, ep=4, impl="ep", device="cpu")
                    if mod is trainer else
                    mod.HecateScheduler(c, ep=4, impl="ep"))
        with flt.injected("restore.mesh_mismatch", times=1):
            with pytest.warns(RuntimeWarning, match="starting fresh"):
                state, gstep = mod.resume_train_state(c, t, sched(), 4, **kw)
            assert state is None and gstep == 0
            assert flt.fired("restore.mesh_mismatch") == 1
        with flt.injected("restore.mesh_mismatch", only=(8, 4), times=1):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                state, gstep = mod.resume_train_state(c, t, sched(), 4, **kw)
            assert state is not None and gstep == 5
            assert flt.fired("restore.mesh_mismatch") == 0


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------
def test_elastic_restore_and_in_process_shrink_on_a_grid(tmp_path):
    """4 gloo ranks (``torch_dist_cases.elastic_rank``).  A (2, 2)
    checkpoint at step 4 resumes on (1, 4): one elastic restore, and steps
    4..7 give the unresized run's losses within 1e-5 (measured: bitwise).
    On (1, 4), EP rank 3 lost at step 4: the run shrinks in-process to ep
    3, rank 3 stays a spare, and the cleared fault grows it back at the
    step-6 checkpoint; every step's loss is the kill-and-restart run's
    within 1e-5 (measured: bitwise), with no token dropped, the
    reference's counters, and the JAX supervisor's walk of the same
    events."""
    ranks = spawn(cases.elastic_rank, (1, 4), "cpu",
                  workdir=str(tmp_path / "ranks"), args=(str(tmp_path),),
                  timeout=600)
    # the JAX supervisor through the same events: a loss of device 3 at
    # the fifth probe, the shrink, the fault cleared, the grow-back
    jfaults.inject("mesh.device_lost", only=3, after=4, times=None)
    js = jsup.TrainSupervisor(ep=4, runtime_factory=lambda ep: None)
    for i in range(6):                  # the sixth finishes the recovery
        try:
            js.probe(i, 0.01)
        except jsup.DeviceLossError:
            js.on_shrunk(3, steps_lost=1)
    jfaults.clear()
    assert js.can_grow_back()
    js.on_grow_back()
    for r in ranks:
        assert r["restore_at"] == 4 and r["restore_events"] == 1
        assert r["restore_ep"] == 4 and r["restore_dropped"] == 0.0
        np.testing.assert_allclose(r["restore_b"], r["restore_a"][4:],
                                   rtol=0, atol=1e-5)
        assert r["sup_state"] == js.state and r["sup_ep"] == js.ep
        assert r["recoveries"] == [{k: js.recoveries[0][k] for k in (
            "ep_from", "ep_to", "steps_lost", "site")}]
        assert r["final_step"] == 8 and r["buf_rows"] == 4
    for r in ranks[:3]:
        assert sorted(r["got"]) == sorted(r["ref"]) == list(range(8))
        for k in range(8):
            assert abs(r["got"][k] - r["ref"][k]) <= 1e-5, k
        assert r["last"] == {"device_losses": 1, "elastic_shrinks": 1,
                             "grow_backs": 1, "elastic_restores": 2}
        assert max(r["dropped"]) == 0.0
    # the spare took no step while the grid was shrunk
    assert sorted(ranks[3]["got"]) == [0, 1, 2, 3, 6, 7]
    for k in ranks[3]["got"]:
        assert ranks[3]["got"][k] == ranks[0]["got"][k]


def test_slow_device_loses_slot_share_on_a_grid(tmp_path):
    """3 gloo ranks (``torch_dist_cases.straggler_rank``): the slow EP
    rank gets the JAX supervisor's weight for the same step times, counts
    once, and owns fewer expert slots after the step-4 reshard than before
    and than its peers, with no token dropped."""
    ranks = spawn(cases.straggler_rank, (1, 3), "cpu",
                  workdir=str(tmp_path / "ranks"), timeout=600)
    jfaults.inject("mesh.slow_device", mutate=jfaults.slow_device(0, 6.0),
                   times=None)
    js = jsup.TrainSupervisor(ep=3, runtime_factory=lambda ep: None,
                              calibration_steps=3, straggler_ratio=1.5)
    for i in range(8):
        js.probe(i, 0.01)
    jfaults.clear()
    for r in ranks:
        np.testing.assert_array_equal(r["weights"], js.device_weights())
        assert r["deweighted"] == js.deweight_events == 1
        assert r["share1"] < r["share0"] and r["share1"] < min(r["peers1"])
        assert r["dropped"] == 0.0
        np.testing.assert_array_equal(r["owner_dev"], ranks[0]["owner_dev"])
        assert r["losses"] == ranks[0]["losses"]
