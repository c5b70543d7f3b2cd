"""The port's dense decode path and training-while-serving publication
against the JAX package, on the gpt-moe-s smoke config (2 layers, d_model
128, 4 experts, f32) on the CPU.

1. The dense ``decode_attention`` and ``decode_step`` match JAX's at 1e-5
   of the largest |value| (at least 1), and greedy ``Engine.generate``
   gives JAX's tokens; a sampled generation is deterministic for a seed
   (the two packages draw from different generators).
2. The continuous-batching laws of the JAX package's
   ``tests/test_serve_batching.py`` hold in the port: the paged decode
   step matches the dense one, the scheduler's trace equals
   ``generate``'s, a prefill that straddles a publication reads one
   version, and the bus routes by scheduler load.
3. The publication protocol of ``tests/test_serve_publish.py``: promotion
   at step boundaries, staging that composes with plan swaps, a direct
   ``eng.params`` assignment that wins, a pending build that a boundary
   never waits for and ``close`` joins, a failed build that is dropped,
   and ``train_loop(publish_engine=)`` publishing the same versions as
   JAX's (served tokens that do not change when the optimizer then
   updates the parameters in place) and training on past a closed or
   failing engine.

Each protocol test runs one script through both packages' engines and
compares what the scripts return.  Weights come from JAX's init and cross
with the weight bridge.  No verdict rests on the wall clock: a build that
must stay in flight blocks on a ``threading.Event`` the test releases, with
a ceiling of 30 s.
"""
import dataclasses
import functools
import threading
from typing import Any, Callable

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common import faults as jfaults  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve import bus as jbus  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import (params_from_jax,  # noqa: E402
                                       params_to_numpy)
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import bus  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.kv_pool import PageTable  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCH = "gpt-moe-s"
PROMPTS = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
WAIT_S = 30.0           # ceiling of every wait for a state


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else a, np.float32)


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|), as in
    tests/test_torch_model.py."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_params(seed: int):
    """JAX's smoke parameters from PRNGKey(seed) (immutable, so shared)."""
    return jmdl.init_params(jconfigs.get_smoke(ARCH),
                            jax.random.PRNGKey(seed))


def _torch_params(seed: int):
    """The same parameters in the port, as fresh tensors."""
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(seed)),
                           "cpu")


@dataclasses.dataclass
class Side:
    """One package's serving stack, so a test runs one script through
    both: ``params(seed)`` gives the same weights on either side."""
    cfg: Any
    rt: Any
    pa: Any
    params: Callable[[int], Any]
    Engine: Any
    sched: Any
    bus: Any
    fresh_pa: Callable[[], Any]
    faults: Any


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
    return {
        "jax": Side(jcfg, jmdl.Runtime(), jpa, _jax_params, jengine.Engine,
                    jsched, jbus,
                    lambda: jax.tree.map(lambda a: a + 0, jpa), jfaults),
        "torch": Side(cfg, mdl.Runtime(), pa, _torch_params, engine.Engine,
                      sched, bus, lambda: moe.tables_to_device(pa, "cpu"),
                      faults),
    }


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()


def _both(sides, script):
    """``script`` run through the JAX package's stack, then the port's."""
    return script(sides["jax"]), script(sides["torch"])


def _attn_params(side_params, j: int = 0):
    return {k: v[0] for k, v in side_params["blocks"][f"l{j}"]["attn"]
            .items()}


# ---------------------------------------------------------------------------
# 1. the dense decode path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,pos", [("attn", 3), ("attn", 11),
                                      ("local", 3), ("local", 11)])
def test_decode_attention_dense_matches_jax(kind, pos):
    """One decode token against a random dense cache: the output and the
    in-place cache write, with a window of 5 for ``local``."""
    jcfg = jconfigs.get_smoke(ARCH).replace(sliding_window=5)
    cfg = configs.get_smoke(ARCH).replace(sliding_window=5)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shape = (2, 16, cfg.num_kv_heads, cfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    want, wc = jattn.decode_attention(
        _attn_params(_jax_params(0)), jcfg, jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.int32(pos),
        kind=kind)
    tc = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, gc = attn.decode_attention(_attn_params(_torch_params(0)), cfg,
                                    torch.from_numpy(x), tc, pos, kind=kind)
    assert gc["k"] is tc["k"]            # updated in place
    _close(got, want, 1e-5)
    for kv in ("k", "v"):
        _close(gc[kv], wc[kv], 1e-5)


def test_dense_decode_step_matches_jax(sides):
    """Six decode steps through the whole model with the engine's slot
    cache: logits and caches at 1e-5."""
    js, ts = sides["jax"], sides["torch"]
    jp, tp = js.params(0), ts.params(0)
    jc = jmdl.init_cache(js.cfg, 2, 16)
    tc = mdl.init_cache(ts.cfg, 2, 16, "cpu")
    premat = moe.materialize_chunks(ts.cfg, tp["moe_buffer"], ts.pa)
    rng = np.random.default_rng(8)
    for i in range(6):
        t = rng.integers(0, ts.cfg.vocab_size, (2, 1)).astype(np.int32)
        wl, jc = jmdl.decode_step(js.cfg, js.rt, jp, jc, jnp.asarray(t),
                                  jnp.int32(i), js.pa)
        gl, tc = mdl.decode_step(ts.cfg, ts.rt, tp, tc, torch.from_numpy(t),
                                 i, ts.pa, premat)
        _close(gl, wl, 1e-5)
        for n in jc:
            for kv in ("k", "v"):
                _close(tc[n][kv], jc[n][kv], 1e-5)


@pytest.mark.parametrize("prompts,steps", [(PROMPTS, 12),
                                           (np.asarray([[7, 1, 4, 9, 2]],
                                                       np.int32), 8)])
def test_generate_greedy_matches_jax(sides, prompts, steps):
    """Loop prefill, then greedy steps: JAX's tokens exactly (the JAX
    package's test_train_e2e.py::test_serve_engine_generates, held to
    its tokens)."""
    def script(s):
        with s.Engine(s.cfg, s.rt, s.params(0), max_len=32,
                      pa=s.pa) as eng:
            out = eng.generate(prompts, steps=steps)
        assert out.shape == (prompts.shape[0], prompts.shape[1] + steps)
        assert (out[:, :prompts.shape[1]] == prompts).all()
        return out
    want, got = _both(sides, script)
    np.testing.assert_array_equal(got, want)


def test_generate_sampling_is_deterministic_per_seed(sides):
    """Temperature sampling draws from a ``torch.Generator``: the same
    seed gives the same tokens; the draws cannot match JAX's."""
    s = sides["torch"]
    with s.Engine(s.cfg, s.rt, s.params(0), max_len=32, pa=s.pa) as eng:
        a = eng.generate(PROMPTS, steps=8, temperature=1.0, seed=3)
        b = eng.generate(PROMPTS, steps=8, temperature=1.0, seed=3)
        c = eng.generate(PROMPTS, steps=8, temperature=1.0, seed=4)
        greedy = eng.generate(PROMPTS, steps=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) or not np.array_equal(a, greedy)
    assert ((a >= 0) & (a < s.cfg.vocab_size)).all()


# ---------------------------------------------------------------------------
# 2. the continuous-batching laws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["attn", "local"])
def test_paged_decode_step_parity_vs_dense(variant):
    """The same trace through the dense cache and the paged pool: every
    decode step's logits within 1e-5 (the paged reduction is the plain
    version of the paged kernel: only the order of its sums differs), and
    the dense ones within 1e-5 of JAX's dense step."""
    def mutate(c):
        return c if variant == "attn" else c.replace(
            layer_pattern=("attn", "local"), sliding_window=5)
    jcfg, cfg = mutate(jconfigs.get_smoke(ARCH)), mutate(
        configs.get_smoke(ARCH))
    jp = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    L = moe.num_moe_layers(cfg)
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")
    jpa = jmoe.plan_to_arrays(jplacement.ep_materialization(
        jplacement.homogeneous_sharding(L, jcfg.moe.num_experts, 1)))
    premat = moe.materialize_chunks(cfg, params["moe_buffer"], pa)
    dense_step = engine.build_serve_step(cfg, mdl.Runtime())
    paged_step = engine.build_paged_serve_step(cfg, mdl.Runtime(),
                                               page_size=4)
    dense = mdl.init_cache(cfg, 1, 16, "cpu")
    paged = mdl.init_paged_cache(cfg, 1, 5 * 4, "cpu")
    jdense = jmdl.init_cache(jcfg, 1, 16)
    row_idx = torch.from_numpy(
        PageTable(page_size=4, max_kv=16, pages=[1, 2, 3, 4]).row_idx()[None])
    for i, t in enumerate([3, 1, 4, 1, 5, 9, 2, 6]):
        tt = torch.tensor([[t]], dtype=torch.int32)
        ld, dense = dense_step(params, dense, tt, i, pa, premat)
        lp, paged = paged_step(params, paged, tt,
                               torch.tensor([i], dtype=torch.int32), row_idx,
                               pa, premat)
        wl, jdense = jmdl.decode_step(jcfg, jmdl.Runtime(), jp, jdense,
                                      jnp.asarray([[t]], jnp.int32),
                                      jnp.int32(i), jpa)
        np.testing.assert_allclose(ld.numpy(), lp.numpy(), atol=1e-5,
                                   rtol=1e-5)
        _close(ld, wl, 1e-5)


def test_scheduler_matches_engine_generate(sides):
    """A single request's trace through the scheduler equals the fixed
    batch engine's, in both packages, and the two packages agree."""
    def script(s):
        with s.Engine(s.cfg, s.rt, s.params(0), max_len=32,
                      pa=s.pa) as eng:
            base = eng.generate(np.asarray([[1, 2, 3]], np.int32), steps=6)
            with s.sched.RequestScheduler(eng, max_slots=2, num_pages=9,
                                          page_size=4, max_kv=32) as rs:
                r = rs.submit([1, 2, 3], max_new_tokens=6)
                rs.run(max_ticks=100)
                assert r.state == s.sched.DONE
                assert r.finish_reason == "length"
                np.testing.assert_array_equal(r.output(), base[0])
                assert rs.pool.free_pages == rs.pool.usable_pages
        return base
    want, got = _both(sides, script)
    np.testing.assert_array_equal(got, want)


def test_prefill_straddling_publication_reads_one_version(sides):
    """A request admitted while a publication is staged prefills against
    one snapshot, the promoted one: its trace equals a fresh engine's at
    the published version."""
    def script(s):
        params2 = s.params(7)
        with s.Engine(s.cfg, s.rt, s.params(0), max_len=32,
                      pa=s.pa) as eng:
            eng.publish_params(params2, wait=True)
            assert eng.version == 0 and eng._staged is not None
            with s.sched.RequestScheduler(eng, max_slots=1, num_pages=9,
                                          page_size=4, max_kv=32) as rs:
                r = rs.submit([1, 2, 3], max_new_tokens=6)
                rs.run(max_ticks=50)
                assert r.state == s.sched.DONE
                assert eng.version == 1     # the prefill promoted it
        with s.Engine(s.cfg, s.rt, params2, max_len=32, pa=s.pa,
                      version=1) as fresh:
            base = fresh.generate(np.asarray([[1, 2, 3]], np.int32),
                                  steps=6)
        np.testing.assert_array_equal(r.output(), base[0])
        return base
    want, got = _both(sides, script)
    np.testing.assert_array_equal(got, want)


def test_route_orders_replicas_by_scheduler_load(sides):
    """Scheduler load (queue depth, KV occupancy) reaches the bus through
    ``EngineHealth``; ``route()`` puts the loaded replica last and returns
    to registration order once it drains."""
    def script(s):
        params = s.params(0)
        eng_a = s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa,
                         name="a")
        eng_b = s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa,
                         name="b")
        fleet = s.bus.PublicationBus([("a", eng_a), ("b", eng_b)])
        names = {id(eng_a): "a", id(eng_b): "b"}
        order = []
        try:
            order.append([names[id(e)] for e in fleet.route()])
            with s.sched.RequestScheduler(eng_a, max_slots=1, num_pages=9,
                                          page_size=4, max_kv=16,
                                          max_queue=8) as rs:
                for _ in range(4):
                    rs.submit([1, 2], max_new_tokens=2)
                h = eng_a.health()
                assert h.queue_depth == 4 and h.kv_used_frac == 0.0
                order.append([names[id(e)] for e in fleet.route()])
                health = fleet.health()
                assert health["a"].queue_depth == 4
                assert health["b"].queue_depth == 0
                rs.run(max_ticks=200)
                order.append([names[id(e)] for e in fleet.route()])
            assert eng_a.health().queue_depth == 0   # probe detached
        finally:
            fleet.close()
            eng_a.close()
            eng_b.close()
        return order
    want, got = _both(sides, script)
    assert got == want == [["a", "b"], ["b", "a"], ["a", "b"]]


# ---------------------------------------------------------------------------
# 3. the publication protocol
# ---------------------------------------------------------------------------
def test_publish_swaps_at_boundary_and_matches_fresh_engine(sides):
    """A publication promotes only at a step boundary, and the promoted
    engine serves what a fresh engine at the published version serves."""
    def script(s):
        params, params2 = s.params(0), s.params(1)
        with s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa) as eng:
            out0 = eng.generate(PROMPTS, steps=4)
            assert eng.publish_params(params2, wait=True) == 1
            # staged, not live: no boundary has passed yet
            assert eng.version == 0 and eng.params is params
            assert eng._staged is not None
            out1 = eng.generate(PROMPTS, steps=4)  # the first boundary
            assert eng.version == 1 and eng.params is params2
            assert eng._staged is None and eng.promotions == 1
        with s.Engine(s.cfg, s.rt, params2, max_len=32, pa=s.pa,
                      version=1) as fresh:
            np.testing.assert_array_equal(out1,
                                          fresh.generate(PROMPTS, steps=4))
        assert not np.array_equal(out0, out1)   # the params did change
        return out0, out1
    want, got = _both(sides, script)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_publish_composes_with_plan_swap_and_closes(sides):
    """A plan staged on top of a pending publication keeps its params; a
    (pa, params) pair staged in one call swaps as one; ``close`` is
    idempotent and every public entry point raises after it."""
    def script(s):
        params, params2 = s.params(0), s.params(2)
        eng = s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa)
        try:
            eng.generate(PROMPTS, steps=2)          # build the live slots
            eng.publish_params(params2, version=5)
            eng.set_plan(s.pa)                      # plan swap on top
            eng.flush()
            assert eng.version == 5 and eng.params is params2
            out = eng.generate(PROMPTS, steps=2)
            with s.Engine(s.cfg, s.rt, params2, max_len=32, pa=s.pa,
                          version=5) as fresh:
                np.testing.assert_array_equal(
                    out, fresh.generate(PROMPTS, steps=2))
            pa2 = s.fresh_pa()
            eng.publish_params(params, version=6, pa=pa2, wait=True)
            assert eng.pa is s.pa and eng.version == 5  # staged only
            eng.flush()
            assert eng.pa is pa2 and eng.version == 6
            assert eng.params is params
        finally:
            eng.close()
        eng.close()                                 # idempotent
        for call in (lambda: eng.publish_params(params2),
                     lambda: eng.set_plan(s.pa),
                     lambda: eng.flush(),
                     lambda: eng.generate(PROMPTS, steps=1)):
            with pytest.raises(RuntimeError):
                call()
        return out
    want, got = _both(sides, script)
    np.testing.assert_array_equal(got, want)


def test_direct_params_assignment_wins_over_staged_promotion(sides):
    """``eng.params = tree`` after a staged publish is not reverted by the
    promotion: the staged params, version and slots are dropped."""
    def script(s):
        params2, params3 = s.params(4), s.params(5)
        with s.Engine(s.cfg, s.rt, s.params(0), max_len=32,
                      pa=s.pa) as eng:
            eng.generate(PROMPTS, steps=1)
            eng.publish_params(params2, version=3, wait=True)
            eng.params = params3            # the backdoor, after staging
            eng.flush()
            assert eng.params is params3 and eng.version == 0
            out = eng.generate(PROMPTS, steps=2)
        with s.Engine(s.cfg, s.rt, params3, max_len=32,
                      pa=s.pa) as fresh:
            np.testing.assert_array_equal(out,
                                          fresh.generate(PROMPTS, steps=2))
        return out
    want, got = _both(sides, script)
    np.testing.assert_array_equal(got, want)


def test_pending_build_joins_on_close_and_never_blocks_boundaries(sides):
    """With the staged build held on an event: ``publish_params`` returns
    and a boundary defers while the build is in flight; ``close`` waits
    for the build (it is still running while the event is clear), then
    drops the staged state unpromoted."""
    def script(s):
        eng = s.Engine(s.cfg, s.rt, s.params(0), max_len=32, pa=s.pa)
        gate, done = threading.Event(), []
        try:
            eng.generate(PROMPTS, steps=1)
            orig = eng._build_slots

            def held_build(*a, **kw):
                gate.wait(WAIT_S)
                out = orig(*a, **kw)
                done.append(gate.is_set())
                return out
            eng._build_slots = held_build
            eng.publish_params(s.params(3), version=9)   # returns at once
            assert not eng._staged["fut"].done()         # build held
            eng._step_boundary()                         # defers
            assert eng.version == 0 and eng.deferred_boundaries >= 1
            closer = threading.Thread(target=eng.close)
            closer.start()
            closer.join(0.2)
            assert closer.is_alive()        # close waits for the build
            assert done == []
        finally:
            gate.set()
        closer.join(WAIT_S)
        assert not closer.is_alive()
        assert done == [True]               # ran to its end first
        assert eng._staged is None and eng.version == 0
        return eng.version, eng.promotions, done
    want, got = _both(sides, script)
    assert got == want


def test_failed_build_is_dropped_and_decode_keeps_serving(sides):
    """A staged build that raises (``engine.publish_build``) is dropped at
    the boundary, by a decode step and by ``flush`` alike: the old version
    keeps serving, nothing raises, and a later publication promotes."""
    def script(s):
        params = s.params(0)
        with s.Engine(s.cfg, s.rt, params, max_len=32, pa=s.pa) as eng:
            out0 = eng.generate(PROMPTS, steps=4)
            with s.faults.injected("engine.publish_build", times=None):
                eng.publish_params(s.params(6))
                fut = eng._staged["fut"]
                fut.exception(timeout=WAIT_S)       # the build has raised
                out1 = eng.generate(PROMPTS, steps=4)   # drops, no raise
                eng.publish_params(s.params(6))
                eng.flush()                             # drops, no raise
            np.testing.assert_array_equal(out0, out1)
            assert isinstance(eng.last_publish_error, s.faults.FaultError)
            rec = (eng.publish_drops, eng.version)
            eng.publish_params(s.params(6), wait=True)
            eng.flush()
            return rec + (eng.version, eng.promotions)
    want, got = _both(sides, script)
    assert got == want == (2, 0, 1, 1)


def _train(s, publish_engine, steps, every, jax_side: bool):
    """``train_loop(publish_engine=, publish_every=)`` of the smoke config
    from JAX's init on the bytes stream: (state, history)."""
    kw = dict(num_steps=steps, log_every=0, publish_engine=publish_engine,
              publish_every=every)
    if jax_side:
        tc = JTrainConfig(learning_rate=3e-3, warmup_steps=2,
                          total_steps=steps)
        stream = jpipeline.make_stream(s.cfg.vocab_size, 32, 8,
                                       kind="bytes", seed=0)
        sch = jtrainer.HecateScheduler(s.cfg, ep=1, impl="ep")
        try:
            return jtrainer.train_loop(s.cfg, s.rt, tc, stream,
                                       scheduler=sch, **kw)
        finally:
            sch.close()
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=steps)
    stream = pipeline.make_stream(s.cfg.vocab_size, 32, 8, kind="bytes",
                                  seed=0)
    params = s.params(0)
    state = st.TrainState(params, adamw.init(params),
                          torch.zeros((), dtype=torch.int32))
    return trainer.train_loop(
        s.cfg, mdl.Runtime(use_pallas=False), tc, stream,
        scheduler=trainer.HecateScheduler(s.cfg, device="cpu"),
        state=state, device="cpu", **kw)


def _publish_script(s, steps, every, jax_side: bool):
    """``_train`` into a live engine: the engine after ``flush``, the
    versions published, the final state and the history."""
    versions = []
    eng = s.Engine(s.cfg, s.rt, s.params(0), max_len=32, pa=s.pa)
    publish = eng.publish_params

    def recorded(params, version=None, **kw):
        versions.append(version)
        return publish(params, version=version, **kw)
    eng.publish_params = recorded
    state, hist = _train(s, eng, steps, every, jax_side)
    eng.flush()
    return eng, versions, state, hist


def test_train_loop_publishes_versioned_params_into_engine(sides):
    """Every k-th step publishes the updated tree, versioned by step: the
    same versions as the JAX run's; after ``flush`` the engine serves what
    a fresh engine on the final params serves."""
    got = {}
    for name, s in sides.items():
        eng, versions, _, hist = _publish_script(s, 8, 3, name == "jax")
        try:
            assert eng.publications == 2 and eng.version == 6
            assert hist[-1]["publish_drops"] == 0
            out = eng.generate(PROMPTS, steps=3)
            with s.Engine(s.cfg, s.rt, eng.params, max_len=32, pa=eng.pa,
                          version=eng.version) as fresh:
                np.testing.assert_array_equal(
                    out, fresh.generate(PROMPTS, steps=3))
        finally:
            eng.close()
        got[name] = versions
    assert got["torch"] == got["jax"] == [3, 6]


def test_published_snapshot_survives_in_place_optimizer_step(sides):
    """The port's AdamW updates the parameters in place, so ``train_loop``
    publishes a snapshot: one more training step, unpublished, leaves the
    engine's parameters and tokens as they were, and a JAX engine on the
    published tree serves the same tokens."""
    s = sides["torch"]
    eng, versions, state, _ = _publish_script(s, 2, 2, False)
    try:
        assert versions == [2] and eng.version == 2
        served = params_to_numpy(eng.params)
        out = eng.generate(PROMPTS, steps=4)
        tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=4)
        live = state.params["moe_buffer"]
        before = live.clone()
        state, _ = trainer.train_loop(
            s.cfg, mdl.Runtime(use_pallas=False), tc,
            pipeline.make_stream(s.cfg.vocab_size, 32, 8, kind="bytes",
                                 seed=1),
            scheduler=trainer.HecateScheduler(s.cfg, device="cpu"),
            state=state, num_steps=1, log_every=0, device="cpu")
        assert state.params["moe_buffer"] is live       # updated in place
        assert not torch.equal(live, before)
        np.testing.assert_array_equal(eng.generate(PROMPTS, steps=4), out)
        for (k, a), (_, b) in zip(sorted(_flat(served)),
                                  sorted(_flat(params_to_numpy(eng.params)))):
            np.testing.assert_array_equal(a, b, err_msg=k)
    finally:
        eng.close()
    js = sides["jax"]
    with js.Engine(js.cfg, js.rt, jax.tree.map(jnp.asarray, served),
                   max_len=32, pa=js.pa, version=2) as jeng:
        np.testing.assert_array_equal(jeng.generate(PROMPTS, steps=4), out)


@pytest.mark.parametrize("fault", ["closed", "failing_build"])
def test_train_loop_survives_a_failing_engine(sides, fault):
    """Training never stops for its engine: a closed engine fails the
    first publication (counted, warned) and ends publication for the run;
    builds that raise are dropped by the engine, and the history counts
    each drop the engine has seen (the last one shows at ``flush``)."""
    got = {}
    for name, s in sides.items():
        eng = s.Engine(s.cfg, s.rt, s.params(0), max_len=32, pa=s.pa)
        try:
            if fault == "closed":
                eng.close()
                with pytest.warns(RuntimeWarning, match="publication failed"):
                    _, hist = _train(s, eng, 6, 2, name == "jax")
            else:
                with s.faults.injected("engine.publish_build", times=None):
                    _, hist = _train(s, eng, 6, 2, name == "jax")
                    eng.flush()
        finally:
            eng.close()
        got[name] = ([h["publish_drops"] for h in hist], eng.publish_drops,
                     all(np.isfinite(h["loss"]) for h in hist))
    want = (([0, 1, 1, 1, 1, 1], 0, True) if fault == "closed"
            else ([0, 0, 0, 1, 1, 2], 3, True))
    assert got["torch"] == got["jax"] == want


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree
