"""Publication on a process grid: the bus's same-host dedup, the
continuous-batching scheduler in lockstep, and ``train_loop`` publishing
the fresh plan after the buffer's rows moved (a reshard, an elastic
shrink, a grow-back), against the JAX engine and the world-size-1 port.

The JAX side (one ``run_distributed`` subprocess, 8 host devices) makes
the smoke gpt-moe-s weights (``PRNGKey(0..2)``, ``ep=4``) and serves the
prompts from fresh engines on a (2, 4) mesh (ring plan, ``m = 1``,
``capacity = 16``).  The port runs 8 gloo ranks of a 2 x 4 grid
(``tests/torch_dist_cases.py::serve_fleet_rank``) and 4 of a 1 x 4 grid
(``elastic_publish_rank``).  Four replicas on one host share one stacked
build per publication (``dedup_hits == 3``) and serve JAX's tokens bit
for bit; the scheduler's traces on the grid equal the world-size-1
port's on the same weights; a publication after the rows moved carries
the plan, so the engine serves a fresh engine's tokens at the trainer's
``(params, pa, version)`` (on the parent tree the grid loop raised, and
the world-size-1 engine kept the stale plan).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import params_from_jax, snapshot  # noqa
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.scheduler import DONE, RequestScheduler  # noqa
from repro_torch.train.trainer import HecateScheduler, train_loop  # noqa

SKEW = [[100.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 100.0]]
REQ_LENS, REQ_NEW = (3, 9, 5, 7, 4), (5, 4, 6, 3, 5)

JAX_SCRIPT = r"""
import numpy as np, jax
from repro.configs.gpt_moe_s import smoke
from repro.core.placement import homogeneous_sharding
from repro.core.schedule import sparse_materialization
from repro.core import moe as moe_core
from repro.models import model as mdl
from repro.serve.engine import Engine

cfg = smoke()
EP = 4
mesh = jax.make_mesh((2, EP), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,)*2)
L = moe_core.num_moe_layers(cfg)
E = cfg.moe.num_experts
sh = homogeneous_sharding(L, E, EP)
plan = sparse_materialization(sh, np.ones((L, E)), t=4, m=1, impl="ring")
pa = moe_core.plan_to_arrays(plan)
rt = mdl.Runtime(mesh=mesh, moe=moe_core.MoERuntime(
    mesh=mesh, batch_axes=("data",), impl="ring", m=1, capacity=16))
trees = {name: mdl.init_params(cfg, jax.random.PRNGKey(seed), ep=EP)
         for seed, name in enumerate(("params", "params2", "params3"))}
rng = np.random.default_rng(1)
prompts = rng.integers(0, cfg.vocab_size, (8, 3)).astype(np.int32)
out = {"prompts": prompts, "homog_owner_dev": sh.owner_dev,
       "loop_tokens": rng.integers(0, cfg.vocab_size,
                                   (2, 8, 17)).astype(np.int32),
       "skew": np.asarray(%(skew)r), "req_new": np.asarray(%(new)r)}
for i, n in enumerate(%(lens)r):
    out[f"req{i}"] = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
for name in ("params2", "params3"):
    eng = Engine(cfg, rt, trees[name], max_len=32, pa=pa)
    out[f"tokens/{name}"] = eng.generate(prompts, steps=3)
    eng.close()


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    else:
        yield prefix, np.asarray(tree)


for name, tree in trees.items():
    out.update(dict(flat(tree, name)))
np.savez(%(out)r, **out)
print("JAX FLEET ORACLE WRITTEN")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory, dist):
    d = tmp_path_factory.mktemp("serve_grid_fleet")
    npz = str(d / "jax.npz")
    out = dist(JAX_SCRIPT % {"out": npz, "skew": SKEW, "new": REQ_NEW,
                             "lens": REQ_LENS}, n_devices=8)
    assert "JAX FLEET ORACLE WRITTEN" in out
    ranks = spawn(cases.serve_fleet_rank, (2, 4), "cpu",
                  workdir=str(d / "ranks"), args=(npz,), timeout=300)
    return dict(np.load(npz)), ranks


def test_four_same_host_replicas_share_one_stacked_build(both):
    """One publication: one stacked build (L·m ring hops, L all-gathers)
    for four replicas, ``dedup_hits == 3``, every replica at the version
    and serving JAX's tokens bit for bit."""
    jx, ranks = both
    for r in ranks:
        builds, calls, hits, versions = r["dedup"]
        assert (builds, hits, versions) == (1, 3, [1, 1, 1, 1])
        assert calls == {"spag_ring": 2, "spag_fsdp": 2}
        assert r["dedup_equal"]
        np.testing.assert_array_equal(r["dedup_tokens"], jx["tokens/params2"])


def test_crash_evicts_one_replica_and_rejoin_reuses_the_host_build(both):
    """A replica crashing in the send is evicted, the other three serve
    v2; the rejoin hands it the host's newest build (no collective) and
    it serves what they serve."""
    from repro_torch.serve.bus import EVICTED
    jx, ranks = both
    for r in ranks:
        assert r["crash"] == (EVICTED, 3, [2, 1, 2, 2])
        assert r["rejoin"] == (True, 2, 0, {})
        assert r["rejoin_equal"]
        np.testing.assert_array_equal(r["rejoin_tokens"],
                                      jx["tokens/params3"])
        # the crash comes in the send, after the v2 host build for all 4
        assert r["fleet_dedup_hits"] == 6


def test_a_build_hung_on_one_rank_moves_the_replica_on_every_rank(both):
    """C16: a replica's build hangs on rank 0 only, its age read from a
    clock the test sets.  Each poll decides the transitions once over the
    ranks, so every rank reports the same states after every poll: the
    replica lags at t = 1 on every rank (drained everywhere), catches up
    on every rank once the build is released, lags and is evicted on
    every rank at the same polls on the next publication's hang, and the
    other replica promotes the publication after that on every rank.  On
    a bus that moved a replica on its own rank's view, rank 0 alone
    lagged it and the ranks' states parted (the rank function raises at
    the first such poll)."""
    from repro_torch.serve.bus import EVICTED, HEALTHY, LAGGING
    H, L, E = HEALTHY, LAGGING, EVICTED
    _, ranks = both
    for r in ranks:
        c = r["c16"]
        assert [every[0] for every in c["polls"]] == \
            [(H, H), (H, L), (H, H), (H, L), (H, E)]
        assert all(every == [every[0]] * len(ranks)
                   for every in c["polls"])
        assert c["routed"] == ["h0"]
        assert c["versions"] == [3, 0] and c["evictions"] == 1


def _ws1_params(jx, name, cfg):
    """The JAX tree of ``name`` with its buffer in the world-size-1
    layout (homogeneous sharding on one device)."""
    tree = {}
    for k, a in jx.items():
        if k.startswith(name + "/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    L, E = moe.num_moe_layers(cfg), cfg.moe.num_experts
    g4 = placement.homogeneous_sharding(L, E, 4).global_rows()
    g1 = placement.homogeneous_sharding(L, E, 1).global_rows()
    buf = np.empty_like(tree["moe_buffer"])
    buf[g1.reshape(-1)] = tree["moe_buffer"][g4.reshape(-1)]
    tree["moe_buffer"] = buf
    return params_from_jax(tree, "cpu")


def test_scheduler_on_the_grid_matches_world_size_one(both):
    """Every rank drives the same scheduler in lockstep (ranks 5..7 own
    only idle slots and still run every step): the same traces on every
    rank, equal to the world-size-1 port's."""
    jx, ranks = both
    cfg = configs.get_smoke("gpt-moe-s")
    L, E = moe.num_moe_layers(cfg), cfg.moe.num_experts
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, E, 1)), "cpu")
    with Engine(cfg, mdl.Runtime(use_pallas=False),
                _ws1_params(jx, "params", cfg), max_len=32, pa=pa) as eng:
        with RequestScheduler(eng, max_slots=8, num_pages=40, page_size=4,
                              max_kv=32) as rs:
            reqs = [rs.submit(jx[f"req{i}"], max_new_tokens=int(n))
                    for i, n in enumerate(jx["req_new"])]
            rs.run(max_ticks=200)
    assert all(r.state == DONE for r in reqs)
    for r in ranks:
        s = r["sched"]
        assert s["states"] == [DONE] * len(reqs)
        for got, want in zip(s["outputs"], reqs):
            np.testing.assert_array_equal(got, want.output())
        assert s["ticks"] == ranks[0]["sched"]["ticks"]


def test_scheduler_ticks_in_lockstep_while_a_bus_publication_is_in_flight(
        both):
    """A bus publication lands while the scheduler ticks, with no flush:
    ranks 0..3 stage it before the first tick, ranks 4..7 after the
    third.  Every boundary agrees over the ranks, so ranks 0..3 defer
    until all have staged it, every rank promotes it at the same tick and
    serves the same tokens, and a flush leaves both replicas at v1 (on a
    boundary that ran its all-reduce only when something was staged, the
    ranks' collectives paired wrongly)."""
    _, ranks = both
    for r in ranks:
        f = r["inflight"]
        assert f["states"] == [DONE] * len(REQ_LENS)
        assert f["versions"][:3] == [0, 0, 0] and f["final"] == [1, 1]
        assert f["versions"] == ranks[0]["inflight"]["versions"]
        assert f["ticks"] == ranks[0]["inflight"]["ticks"]
        for got, want in zip(f["outputs"], ranks[0]["inflight"]["outputs"]):
            np.testing.assert_array_equal(got, want)
    for r in ranks[:4]:
        assert r["inflight"]["deferred"] >= 3


def test_train_loop_publishes_the_fresh_plan_from_the_grid(both):
    """F1 on 2 x 4: Algorithm 2 moves experts at step 1 and the loop
    publishes after every step; the publication after the reshard carries
    the plan, so the engine holds a fresh engine's slots at the trainer's
    (params, pa, version) and serves its tokens.  The stale plan's slots
    hold other experts' weights."""
    _, ranks = both
    for r in ranks:
        f = r["f1"]
        assert f["moved"] and f["drops"] == 0
        assert f["versions"] == [1, 2] and f["with_plan"] == [False, True]
        assert f["engine_pa_is_published"] and f["version"] == 2
        np.testing.assert_array_equal(f["slots"], f["fresh_slots"])
        np.testing.assert_array_equal(f["tokens"], f["fresh"])
        assert not np.array_equal(f["slots"], f["stale_slots"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["f1"]["tokens"],
                                      ranks[0]["f1"]["tokens"])


class _PermuteRowsAt:
    """A resharding policy that permutes the buffer's rows at ``step``:
    at EP size 1 no expert changes owner, but every row moves."""

    def __init__(self, at: int):
        self.at = at

    def maybe_reshard(self, step, current, predictor):
        if step != self.at:
            return current, False
        perm = np.random.default_rng(0).permutation(
            current.rows_per_device).astype(np.int32)
        return dataclasses.replace(current,
                                   owner_row=perm[current.owner_row]), True


def test_train_loop_publishes_the_plan_after_a_reshard_world_size_one():
    """F1 at world size 1: a reshard that moves every row at step 0; the
    publication after it carries the plan, so the engine holds a fresh
    engine's slots at the trainer's (params, pa, version) and serves its
    tokens; the stale plan's slots hold other experts' weights."""
    cfg = configs.get_smoke("gpt-moe-s")
    rt = mdl.Runtime(use_pallas=False)
    params = mdl.init_params(cfg, 0, "cpu")
    pa0 = cases._ring_pa(cfg, 1)
    sched = HecateScheduler(cfg, ep=1, impl="ring", device="cpu",
                            calibrate=False, resharding=_PermuteRowsAt(0))
    prompts = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    published = []
    with Engine(cfg, rt, snapshot(params), max_len=32, pa=pa0) as eng:
        eng.generate(prompts, steps=1)
        publish = eng.publish_params

        def recorded(p, version=None, **kw):
            published.append((version, kw.get("pa")))
            return publish(p, version=version, **kw)
        eng.publish_params = recorded
        state, _ = train_loop(
            cfg, rt, TrainConfig(learning_rate=3e-3, warmup_steps=1,
                                 total_steps=3),
            pipeline.make_stream(cfg.vocab_size, 16, 4, kind="bytes",
                                 seed=0),
            scheduler=sched, state=cases._fresh_state(params), num_steps=3,
            log_every=0, device="cpu", publish_engine=eng, publish_every=1)
        eng.flush()
        assert [v for v, _ in published] == [1, 2, 3]
        # the plan rides the first publication after the reshard only
        assert [p is not None for _, p in published] == [True, False, False]
        assert eng.pa is published[0][1] and eng.version == 3
        got = eng.generate(prompts, steps=4)
        slots = eng._materialized()
        del eng.publish_params
    with Engine(cfg, rt, snapshot(state.params), max_len=32,
                pa=published[0][1], version=3) as fresh:
        np.testing.assert_array_equal(fresh.generate(prompts, steps=4), got)
        assert torch.equal(fresh._materialized(), slots)
    with Engine(cfg, rt, snapshot(state.params), max_len=32, pa=pa0,
                version=3) as stale:
        assert not torch.equal(stale._materialized(), slots)


def test_publication_after_shrink_and_grow_back_carries_the_plan(tmp_path):
    """F1 through elastic recovery on 1 x 4: EP rank 3 is lost at step 4
    (v5 is published first), the grid shrinks to 3 ranks and rolls back,
    publishing nothing while shrunk (the spare cannot take part), grows
    back at the step-6 checkpoint, and the next publication (v7) carries
    the plan; the engine then serves a fresh engine's tokens at the
    trainer's (params, pa, version)."""
    ranks = spawn(cases.elastic_publish_rank, (1, 4), "cpu",
                  workdir=str(tmp_path / "ranks"), args=(str(tmp_path),),
                  timeout=300)
    for r in ranks:
        assert r["versions"] == [1, 2, 3, 4, 5, 7, 8]
        assert r["with_plan"] == [False] * 5 + [True, False]
        assert r["last"] == {"elastic_shrinks": 1, "grow_backs": 1,
                             "publish_drops": 0}
        assert r["engine_pa_is_published"] and r["version"] == 8
        np.testing.assert_array_equal(r["tokens"], r["fresh"])
        np.testing.assert_array_equal(r["tokens"], ranks[0]["tokens"])
