"""The port's copy of the Hecate scheduler (``repro_torch.core.schedule``)
against the JAX package's (``repro.core.schedule``), differentially.

Both run on the same fixed list of numpy-seeded problems over the ranges of
``tests/test_placement.py`` (L 1–4, E in {4, 8, 16, 40, 64}, M in {2, 4,
8, 16}, t 0–8, m 0–6, loads 0–1000): Algorithm 1 (``ring``, ``a2a``,
``dense``, vectorized and the loop references), Algorithm 2 with and
without ``device_weights``, ``calibrate``, ``overlap_degree`` and
``ReshardingPolicy``.  Each pair must give byte-identical tables, or raise
the same exception type with the same message.  No property of
``test_placement.py`` is asserted here: the reference breaks some of them
on some inputs (ROADMAP C11), and the port copies the reference as it is,
so a differential test is the one that holds on every input.  The two
known counterexamples are explicit cases.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import placement as jplacement
from repro.core import schedule as jschedule
from repro_torch.core import placement
from repro_torch.core import schedule

N_PROBLEMS = 240
CHUNK = 12


def _problems():
    rng = np.random.default_rng(20261017)
    out = []
    for i in range(N_PROBLEMS):
        L = int(rng.integers(1, 5))
        E = int(rng.choice([4, 8, 16, 40, 64]))
        M = int(rng.choice([2, 4, 8, 16]))
        loads = rng.uniform(0.0, 1000.0, (L, E))
        if i % 3 == 1:
            loads = np.floor(loads)             # integer token counts
        elif i % 3 == 2:                        # one hot expert per layer
            loads = np.full((L, E), 1e-3)
            loads[np.arange(L), rng.integers(0, E, L)] = 1000.0
        out.append(dict(L=L, E=E, M=M, loads=loads + 1e-3,
                        t=int(rng.integers(0, 9)), m=int(rng.integers(0, 7)),
                        w=rng.choice([0.25, 0.5, 1.0], M),
                        node_size=int(rng.choice([0, 2, 3])),
                        q=int(rng.integers(0, 3))))
    return out


PROBLEMS = _problems()
CHUNKS = [PROBLEMS[i:i + CHUNK] for i in range(0, N_PROBLEMS, CHUNK)]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:                     # noqa: BLE001 - compared
        return "raise", type(e).__name__, str(e)


def _fields(x):
    """Every field of a plan as (name, dtype, shape, bytes) or its value."""
    if x is None or isinstance(x, (int, float, str, np.integer)):
        return x
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, tuple):
        return tuple(_fields(a) for a in x)
    return tuple((f.name, _fields(getattr(x, f.name)))
                 for f in dataclasses.fields(x))


def _same(port_fn, ref_fn):
    a, b = _outcome(port_fn), _outcome(ref_fn)
    assert a[0] == b[0], (a if a[0] == "raise" else b)
    if a[0] == "raise":
        assert a[1:] == b[1:]
    else:
        assert _fields(a[1]) == _fields(b[1])
    return a


def _both_shardings(p):
    return (placement.homogeneous_sharding(p["L"], p["E"], p["M"]),
            jplacement.homogeneous_sharding(p["L"], p["E"], p["M"]))


@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_alg1_byte_identical(chunk):
    """Algorithm 1 on every impl, vectorized and loop reference, and the
    replica tables the layer derives from its plan."""
    for p in CHUNKS[chunk]:
        sh, jsh = _both_shardings(p)
        for impl in ("ring", "a2a", "dense"):
            for vec in (True, False):
                kw = dict(impl=impl, vectorized=vec)
                if impl == "a2a":
                    kw.update(node_size=p["node_size"], q_rounds=p["q"])
                got = _same(
                    lambda: schedule.sparse_materialization(
                        sh, p["loads"], p["t"], p["m"], **kw),
                    lambda: jschedule.sparse_materialization(
                        jsh, p["loads"], p["t"], p["m"], **kw))
                if got[0] == "ok" and vec:
                    plan = got[1]
                    jplan = jschedule.sparse_materialization(
                        jsh, p["loads"], p["t"], p["m"], **kw)
                    _same(lambda: plan.replica_tables(plan.m + 1),
                          lambda: jplan.replica_tables(jplan.m + 1))


@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_alg2_byte_identical(chunk):
    """Algorithm 2 with and without device weights, vectorized and loop
    reference, and Algorithm 1 over the heterogeneous ownership it gives."""
    for p in CHUNKS[chunk]:
        for kw in (dict(), dict(device_weights=p["w"]),
                   dict(node_size=p["node_size"]),
                   dict(vectorized=False),
                   dict(k_local=p["E"], device_weights=p["w"])):
            got = _same(
                lambda: schedule.heterogeneous_sharding(p["loads"], p["M"],
                                                        p["t"], **kw),
                lambda: jschedule.heterogeneous_sharding(p["loads"], p["M"],
                                                         p["t"], **kw))
        if got[0] != "ok":
            continue
        jsh = jschedule.heterogeneous_sharding(
            p["loads"], p["M"], p["t"], k_local=p["E"],
            device_weights=p["w"])
        _same(lambda: schedule.sparse_materialization(
                  got[1], p["loads"], p["t"], p["m"], impl="a2a"),
              lambda: jschedule.sparse_materialization(
                  jsh, p["loads"], p["t"], p["m"], impl="a2a"))


def _cost(plan, loads, extra_on_path):
    """A deterministic stand-in cost model: the hottest device's modeled
    load plus a charge per moved chunk."""
    _, expert_slot = plan.slot_tables()
    hosted = (expert_slot >= 0).sum(1).clip(min=1)       # (L, E)
    per_dev = ((expert_slot >= 0) * (loads / hosted)[:, None, :]).sum(2)
    moved = float((plan.extra_experts >= 0).sum())
    return float(per_dev.max()) + 0.01 * moved * (2.0 if extra_on_path
                                                  else 1.0)


@pytest.mark.parametrize("chunk", range(0, len(CHUNKS), 4))
def test_calibrate_overlap_degree_and_resharding_byte_identical(chunk):
    for p in CHUNKS[chunk]:
        sh, jsh = _both_shardings(p)
        real = np.flip(p["loads"], axis=1).copy()
        for impl in ("ring", "a2a"):
            base = schedule.sparse_materialization(sh, p["loads"], p["t"],
                                                   p["m"], impl=impl)
            jbase = jschedule.sparse_materialization(jsh, p["loads"], p["t"],
                                                     p["m"], impl=impl)
            _same(lambda: schedule.calibrate(base, real, p["t"], p["m"],
                                             _cost, impl=impl),
                  lambda: jschedule.calibrate(jbase, real, p["t"], p["m"],
                                              _cost, impl=impl))
        assert schedule.overlap_degree(p["t"] * 1e-3, 2e11, p["E"] * 1e6) \
            == jschedule.overlap_degree(p["t"] * 1e-3, 2e11, p["E"] * 1e6)
        pred = schedule.LoadPredictor(p["L"], p["E"])
        jpred = jschedule.LoadPredictor(p["L"], p["E"])
        for obs in (p["loads"], real):
            pred.observe(obs)
            jpred.observe(obs)
        for step in (0, 50, 100):
            pol = schedule.ReshardingPolicy(interval=50, t=p["t"],
                                            device_weights=p["w"])
            jpol = jschedule.ReshardingPolicy(interval=50, t=p["t"],
                                              device_weights=p["w"])
            _same(lambda: pol.maybe_reshard(step, sh, pred),
                  lambda: jpol.maybe_reshard(step, jsh, jpred))


def test_c11_one_hot_load_raises_the_same_error():
    """ROADMAP C11: L = E = M = 4, t = 0 on a one-hot load dead-ends the
    reference's Algorithm 2; the port raises the same RuntimeError."""
    loads = np.full((4, 4), 1e-3)
    loads[0, 0] = 1000.0
    got = _same(lambda: schedule.heterogeneous_sharding(loads, 4, 0),
                lambda: jschedule.heterogeneous_sharding(loads, 4, 0))
    assert got == ("raise", "RuntimeError", "no free slot — k_local too tight")


def test_c11_tied_loads_give_the_same_replica_counts():
    """ROADMAP C11: on the tied loads ``[[1.001, 3.001, 1.001, 3.001]]``
    the reference gives a hotter expert fewer replicas at M = 2; the port
    gives the same counts, at both device counts."""
    loads = np.asarray([[1.001, 3.001, 1.001, 3.001]])
    for M in (2, 4):
        plan = schedule.sparse_materialization(
            placement.homogeneous_sharding(1, 4, M), loads, t=4, m=2,
            impl="a2a")
        jplan = jschedule.sparse_materialization(
            jplacement.homogeneous_sharding(1, 4, M), loads, t=4, m=2,
            impl="a2a")
        _, n_rep = plan.replica_tables(r_max=M)
        _, jn_rep = jplan.replica_tables(r_max=M)
        np.testing.assert_array_equal(n_rep, jn_rep)
        if M == 2:
            np.testing.assert_array_equal(n_rep, [[1, 1, 2, 2]])


def test_scheduler_plans_match_the_reference_step_by_step():
    """``HecateScheduler(ep=4, impl)`` against the JAX scheduler with
    ``async_plan=False, calibrate=False``: the same observed counts give
    the same plan at every step."""
    import repro.configs as jconfigs
    from repro.core import moe as jmoe
    from repro.train import trainer as jtrainer
    import repro_torch.configs as configs
    from repro_torch.core import moe
    from repro_torch.train import trainer

    cfg, jcfg = configs.get_smoke("gpt-moe-s"), jconfigs.get_smoke(
        "gpt-moe-s")
    L, E = moe.num_moe_layers(cfg), cfg.moe.num_experts
    rng = np.random.default_rng(3)
    for impl in ("ring", "a2a", "dense", "ep"):
        s = trainer.HecateScheduler(cfg, ep=4, impl=impl, t=4, device="cpu",
                                    async_plan=False, calibrate=False)
        js = jtrainer.HecateScheduler(jcfg, ep=4, t=4, impl=impl,
                                      async_plan=False, calibrate=False)
        for _ in range(7):
            a = moe.plan_tables(s.plan())
            b = jmoe.plan_tables(js.plan())
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            counts = rng.integers(0, 64, (L, E)).astype(np.float64)
            s.observe(counts)
            js.observe(counts)
        js.close()
