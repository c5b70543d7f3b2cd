"""The port's publication bus against the JAX package's, on the gpt-moe-s
smoke config (f32) on the CPU: the fleet cases of the JAX package's
``tests/test_serve_fleet.py``.

1. One broadcast promotes every replica to the same version, serving what
   a fresh engine at that version serves.
2. Under targeted fault injection (``replica.crash``,
   ``replica.build_hang``, ``bus.broadcast_drop``), a crashing replica is
   evicted without blocking the others and rejoins bit-exact, a hung build
   goes LAGGING and then EVICTED while decode never waits, and a transient
   drop is retried in place.
3. Publications coalesce to the latest, a closed bus refuses them, and
   ``train_loop`` publishes through the bus and counts the fleet's events.
4. ``Engine.health`` takes no lock.

Each case runs one script through both packages' stacks; the fault
sequences are deterministic, so their counters, states and versions must
be equal, and so must the tokens, since the weights come from JAX's init.
No verdict rests on the wall clock: the engines' build ages read a clock
the test sets (``time`` in each engine module is replaced), a held build
waits on an event the test releases, and every wait for a state polls
with a ceiling of 30 s.
"""
import dataclasses
import functools
import threading
import time
import types
from typing import Any, Callable

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common import faults as jfaults  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve import bus as jbus  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import bus  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCH = "gpt-moe-s"
PROMPTS = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
WAIT_S = 30.0           # ceiling of every wait for a state


@functools.lru_cache(maxsize=None)
def _jax_params(seed: int):
    return jmdl.init_params(jconfigs.get_smoke(ARCH),
                            jax.random.PRNGKey(seed))


def _torch_params(seed: int):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(seed)),
                           "cpu")


@dataclasses.dataclass
class Side:
    """One package's serving stack, so a test runs one script through
    both: ``params(seed)`` gives the same weights on either side."""
    name: str
    cfg: Any
    rt: Any
    pa: Any
    params: Callable[[int], Any]
    Engine: Any
    bus: Any
    faults: Any
    engine_mod: Any


@pytest.fixture(scope="module")
def sides():
    jcfg = jconfigs.get_smoke(ARCH)
    js = jtrainer.HecateScheduler(jcfg, ep=1, impl="ep")
    jpa = js.plan_arrays()
    js.close()
    cfg = configs.get_smoke(ARCH)
    L = moe.num_moe_layers(cfg)
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")
    return [Side("jax", jcfg, jmdl.Runtime(), jpa, _jax_params,
                 jengine.Engine, jbus, jfaults, jengine),
            Side("torch", cfg, mdl.Runtime(), pa, _torch_params,
                 engine.Engine, bus, faults, engine)]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def make_fleet():
    """fleet(side, n, **bus_kw) -> (params, engines, bus); every bus and
    engine made is closed at teardown."""
    made = []

    def make(s, n=3, params_seed=0, **bus_kw):
        params = s.params(params_seed)
        engines = [s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa,
                            name=f"r{i}") for i in range(n)]
        made.extend(engines)
        b = s.bus.PublicationBus([(e.name, e) for e in engines], **bus_kw)
        made.append(b)
        return params, engines, b
    yield make
    for x in reversed(made):
        x.close()


@pytest.fixture
def clocks(monkeypatch, sides):
    """Each engine module reads ``time.monotonic`` from a clock the test
    sets: {side name: clock}, starting at 0."""
    out = {}
    for s in sides:
        clock = types.SimpleNamespace(t=0.0)
        clock.monotonic = lambda c=clock: c.t
        monkeypatch.setattr(s.engine_mod, "time", clock)
        out[s.name] = clock
    return out


def _wait_for(cond, what: str):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"not reached within {WAIT_S} s: {what}")
        time.sleep(0.005)


def _bus_idle(b) -> bool:
    """No staged publication and no broadcast in flight (what
    ``PublicationBus.flush`` waits for)."""
    with b._lock:
        staged = (b._jobs if hasattr(b, "_jobs")       # the port's queue
                  else b._pending is not None)
        return not staged and not b._busy and not b._evt.is_set()


def _run(sides, script):
    """The script's record from the JAX stack and from the port's."""
    return [script(s) for s in sides]


def _fresh_tokens(s, params, version, steps=3):
    with s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa,
                  version=version) as fresh:
        return fresh.generate(PROMPTS, steps=steps)


def test_broadcast_promotes_every_replica_bit_exact(sides, make_fleet):
    """One publish lands the same (params, version) on every replica, each
    serving a fresh engine's tokens.  The three replicas share one host
    build, so both buses count two deduplicated builds (the JAX bus's
    shared build is empty without a mesh, the port's holds the slots)."""
    def script(s):
        _, engines, b = make_fleet(s, 3)
        params2 = s.params(1)
        assert b.publish_params(params2, version=7, wait=True) == 7
        assert b.version == 7
        ref = _fresh_tokens(s, params2, 7)
        for e in engines:
            assert e.version == 7 and e.params is params2
            np.testing.assert_array_equal(e.generate(PROMPTS, steps=3), ref)
        assert b.replica_evictions == 0 and len(b.route()) == 3
        return ref, b.dedup_hits
    (want, jdedup), (got, dedup) = _run(sides, script)
    np.testing.assert_array_equal(got, want)
    assert (jdedup, dedup) == (2, 2)


def test_crash_evicts_one_replica_fleet_serves_rejoin_bit_exact(
        sides, make_fleet):
    """A replica that raises through every send retry is evicted; the
    others promote; once the fault clears, ``rejoin`` catches it up to the
    newest published version, bit-exact."""
    def script(s):
        _, engines, b = make_fleet(s, 4, max_retries=1, backoff_s=0.005)
        params2, params3 = s.params(2), s.params(3)
        rec = {}
        with s.faults.injected("replica.crash", only="r2", times=None):
            with pytest.warns(RuntimeWarning, match="evicted"):
                b.publish_params(params2, version=3, wait=True)
            rec["states"] = {n: h.state for n, h in b.poll().items()}
            rec["after_crash"] = (b.replica_evictions, b.publish_drops,
                                  b.broadcast_retries)
            assert engines[2].version == 0      # crashed before its send
            survivors = b.route()
            assert len(survivors) == 3 and engines[2] not in survivors
            for e in (engines[0], engines[1], engines[3]):
                assert e.version == 3 and e.params is params2
            b.publish_params(params3, version=4, wait=True)
            assert engines[2].version == 0 and b.replica_evictions == 1
        assert b.rejoin("r2")
        assert b.poll()["r2"].state == s.bus.HEALTHY
        assert engines[2].version == 4 and engines[2].params is params3
        rec["after_rejoin"] = (b.replica_rejoins, len(b.route()),
                               b.replica_evictions, b.publish_drops,
                               b.broadcast_retries)
        ref = engines[0].generate(PROMPTS, steps=3)
        np.testing.assert_array_equal(engines[2].generate(PROMPTS, steps=3),
                                      ref)
        return rec, ref
    (want, wref), (got, gref) = _run(sides, script)
    assert got == want
    assert got["states"]["r2"] == bus.EVICTED
    assert got["after_crash"] == (1, 1, 1)
    assert got["after_rejoin"] == (1, 4, 1, 1, 1)
    np.testing.assert_array_equal(gref, wref)


def test_build_hang_goes_lagging_then_evicted_without_blocking(
        sides, make_fleet, clocks):
    """A hung staged build blocks nothing: past ``build_deadline_s`` on
    the engine's clock the replica is LAGGING (drained, still serving its
    old version), past ``evict_deadline_s`` EVICTED, while the rest of the
    fleet promotes."""
    def script(s):
        clock = clocks[s.name]
        _, engines, b = make_fleet(s, 3, build_deadline_s=0.2,
                                   evict_deadline_s=3.0)
        out_old = engines[1].generate(PROMPTS, steps=2)
        states = []

        def poll():
            states.append(tuple(h.state for h in b.poll().values()))
        with s.faults.injected("replica.build_hang", only="r1",
                               hang_s=WAIT_S, times=None):
            b.publish_params(s.params(4), version=2)
            _wait_for(lambda: _bus_idle(b) and not any(
                engines[i].health().staged_pending for i in (0, 2)),
                "the broadcast sent and the healthy replicas built")
            assert engines[1].health().staged_pending     # held
            poll()
            clock.t = 1.0
            poll()
            assert engines[1] not in b.route()
            # the LAGGING replica decodes its old version; a boundary
            # never waits for the held build
            np.testing.assert_array_equal(
                engines[1].generate(PROMPTS, steps=2), out_old)
            assert engines[1].version == 0
            assert engines[1].deferred_boundaries >= 1
            for e in (engines[0], engines[2]):
                e.flush()
                assert e.version == 2
            clock.t = 10.0
            with pytest.warns(RuntimeWarning, match="evicted"):
                poll()
            assert b.replica_evictions == 1
        return states, out_old
    (want, wout), (got, gout) = _run(sides, script)
    H, L, E = bus.HEALTHY, bus.LAGGING, bus.EVICTED
    assert got == want == [(H, H, H), (H, L, H), (H, E, H)]
    np.testing.assert_array_equal(gout, wout)


def test_transient_broadcast_drop_is_retried_in_place(sides, make_fleet):
    """One ``bus.broadcast_drop`` firing is absorbed by a retry: the
    replica promotes and stays HEALTHY, nothing is evicted."""
    def script(s):
        _, engines, b = make_fleet(s, 2, max_retries=2, backoff_s=0.005)
        with s.faults.injected("bus.broadcast_drop", only="r0", times=1):
            b.publish_params(s.params(5), version=1, wait=True)
        return (b.broadcast_retries, b.replica_evictions, b.publish_drops,
                [e.version for e in engines],
                sorted({h.state for h in b.poll().values()}))
    want, got = _run(sides, script)
    assert got == want == (1, 0, 0, [1, 1], [bus.HEALTHY])


def test_bus_coalesces_to_latest_and_rejects_after_close(sides, make_fleet):
    """Back-to-back publishes coalesce latest-wins; a closed bus refuses
    publishing and rejoining but leaves the engines open."""
    def script(s):
        params, engines, b = make_fleet(s, 2)
        for k in range(5):
            b.publish_params(s.params(10 + k), version=k + 1)
        b.flush()
        versions = (b.version, [e.version for e in engines])
        b.close()
        with pytest.raises(RuntimeError):
            b.publish_params(params)
        with pytest.raises(RuntimeError):
            b.rejoin("r0")
        assert not engines[0]._closed       # the caller owns the engines
        return versions
    want, got = _run(sides, script)
    assert got == want == (5, [5, 5])


def _train_through_bus(s, b):
    kw = dict(num_steps=8, log_every=0, publish_engine=b, publish_every=3)
    if s.name == "jax":
        tc = JTrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=8)
        sched = jtrainer.HecateScheduler(s.cfg, ep=1, impl="ep")
        try:
            return jtrainer.train_loop(
                s.cfg, s.rt, tc, jpipeline.make_stream(
                    s.cfg.vocab_size, 32, 8, kind="bytes", seed=0),
                scheduler=sched, **kw)[1]
        finally:
            sched.close()
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=8)
    params = s.params(0)
    state = st.TrainState(params, adamw.init(params),
                          torch.zeros((), dtype=torch.int32))
    return trainer.train_loop(
        s.cfg, mdl.Runtime(use_pallas=False), tc,
        pipeline.make_stream(s.cfg.vocab_size, 32, 8, kind="bytes", seed=0),
        scheduler=trainer.HecateScheduler(s.cfg, device="cpu"),
        state=state, device="cpu", **kw)[1]


def test_train_loop_publishes_through_bus_and_counts_fleet_events(
        sides, make_fleet):
    """``train_loop`` publishes into a bus as into one engine: versions
    are the global step, a replica dying mid-run is evicted (training
    neither blocks nor raises), the fleet counters land in the history,
    and the dead replica rejoins at the newest version."""
    def script(s):
        _, engines, b = make_fleet(s, 2, max_retries=0, backoff_s=0.001)
        with s.faults.injected("replica.crash", only="r1", times=None):
            with pytest.warns(RuntimeWarning, match="evicted"):
                hist = _train_through_bus(s, b)
                b.flush()
        last = hist[-1]
        rec = dict(versions=(b.version, engines[0].version),
                   counters={k: last[k] for k in (
                       "replica_evictions", "replica_rejoins",
                       "publish_drops", "elastic_restores")},
                   has_dedup="dedup_hits" in last)
        out = engines[0].generate(PROMPTS, steps=3)
        np.testing.assert_array_equal(
            out, _fresh_tokens(s, engines[0].params, 6))
        assert b.rejoin("r1")
        np.testing.assert_array_equal(engines[1].generate(PROMPTS, steps=3),
                                      out)
        rec["rejoined"] = (engines[1].version, b.replica_rejoins)
        return rec
    want, got = _run(sides, script)
    assert got == want
    assert got["versions"] == (6, 6) and got["rejoined"] == (6, 1)
    assert got["counters"]["replica_evictions"] == 1
    assert got["counters"]["replica_rejoins"] == 0 and got["has_dedup"]


def test_engine_health_snapshot_is_lock_free_and_accurate(
        sides, make_fleet, clocks):
    """``health()`` answers while another thread holds the engine's lock,
    and tracks the staged build: pending with its age on the engine's
    clock, cleared by the promotion; ``closed`` after close."""
    def script(s):
        clock = clocks[s.name]
        _, engines, b = make_fleet(s, 1)
        eng = engines[0]
        h0 = eng.health()
        assert (h0.name, h0.version, h0.staged_pending) == ("r0", 0, False)
        gate = threading.Event()
        orig = eng._build_slots
        eng._build_slots = lambda *a, **k: (gate.wait(WAIT_S),
                                            orig(*a, **k))[1]
        try:
            eng.publish_params(s.params(8), version=2)
            clock.t = 0.5
            got = []
            with eng._lock:
                t = threading.Thread(target=lambda: got.append(eng.health()))
                t.start()
                t.join(WAIT_S)
            assert got, "health() waited for the engine's lock"
            h1 = got[0]
        finally:
            gate.set()
        eng.flush()
        h2 = eng.health()
        b.close()
        eng.close()
        assert eng.health().closed
        return ((h1.staged_pending, h1.staged_version, h1.staged_age_s),
                (h2.staged_pending, h2.version, h2.promotions,
                 h2.staged_age_s))
    want, got = _run(sides, script)
    assert got == want == ((True, 2, 0.5), (False, 2, 1, 0.0))
