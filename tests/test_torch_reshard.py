"""Resharding (Algorithm 2) in the port against the JAX package.

``reshard_perm`` against the JAX package's, in this process.  The JAX side
of the rest (one ``run_distributed`` subprocess, 8 host devices) applies
its ``apply_reshard`` on a (2, 4) mesh to random buffer, ``mu`` and ``nu``
arrays, and runs two steps of its Hecate loop on smoke gpt-moe-s with
``ReshardingPolicy(interval=1, t=2)`` after skewed loads.  The port side
(8 gloo ranks, ``tests/torch_dist_cases.py::reshard_rank``) does the
same from the same arrays and weights.  At world size 1 the port of the
JAX package's ``_ForcedPermuteReshard`` checks that a row permutation of
the parameters and both moments leaves training where it was.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402

SKEW = [[100.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 100.0]]

JAX_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.gpt_moe_s import smoke
from repro.common.config import TrainConfig
from repro.core import moe as moe_core
from repro.core.placement import homogeneous_sharding
from repro.core.schedule import ReshardingPolicy, heterogeneous_sharding
from repro.models import model as mdl
from repro.optim import adamw
from repro.train import step as jst
from repro.train.trainer import HecateScheduler, apply_reshard, reshard_perm
from repro.train.trainer import train_loop

cfg = smoke()
EP = 4
mesh = jax.make_mesh((2, EP), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,)*2)
skew = np.asarray(%(skew)r)
L = moe_core.num_moe_layers(cfg)
E = cfg.moe.num_experts
old = homogeneous_sharding(L, E, EP)
perm = reshard_perm(old, heterogeneous_sharding(skew, EP, t=2,
                                                k_local=old.k_local))
rng = np.random.default_rng(5)
rows, cols = moe_core.buffer_rows(cfg, EP), moe_core.chunk_len(cfg)
arrs = {k: rng.standard_normal((rows, cols)).astype(np.float32)
        for k in ("buf", "mu", "nu")}
on_mesh = {k: jax.device_put(a, NamedSharding(mesh, P("model", "data")))
           for k, a in arrs.items()}
state = jst.TrainState({"moe_buffer": on_mesh["buf"]},
                       adamw.OptState(mu={"moe_buffer": on_mesh["mu"]},
                                      nu={"moe_buffer": on_mesh["nu"]},
                                      count=jnp.zeros((), jnp.int32)),
                       jnp.zeros((), jnp.int32))
moved = apply_reshard(state, perm)
out = {"skew": skew, "rs/perm": perm,
       "rs/buf/moved": np.asarray(moved.params["moe_buffer"]),
       "rs/mu/moved": np.asarray(moved.opt.mu["moe_buffer"]),
       "rs/nu/moved": np.asarray(moved.opt.nu["moe_buffer"])}
out.update({f"rs/{k}": a for k, a in arrs.items()})

rt = mdl.Runtime(mesh=mesh, moe=moe_core.MoERuntime(
    mesh=mesh, batch_axes=("data",), impl="ring",
    m=cfg.moe.slots_per_device, capacity=16))
params = mdl.init_params(cfg, jax.random.PRNGKey(0), ep=EP)
loop_tokens = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (2, 8, 17)).astype(np.int32)
sched = HecateScheduler(cfg, ep=EP, impl="ring", t=4, calibrate=False,
                        resharding=ReshardingPolicy(interval=1, t=2))
for _ in range(3):
    sched.observe(skew)
_, hist = train_loop(cfg, rt, TrainConfig(learning_rate=3e-3, warmup_steps=1,
                                          total_steps=2),
                     iter([{"tokens": loop_tokens[i]} for i in range(2)]),
                     scheduler=sched,
                     state=jst.TrainState(params, adamw.init(params),
                                          jnp.zeros((), jnp.int32)),
                     num_steps=2, log_every=0)
out.update({"loop_tokens": loop_tokens,
            "loop_losses": np.asarray([h["loss"] for h in hist]),
            "owner_dev": sched.sharding.owner_dev,
            "owner_row": sched.sharding.owner_row})


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    else:
        yield prefix, np.asarray(tree)


out.update(dict(flat(params, "params")))
np.savez(%(out)r, **out)
print("JAX RESHARD ORACLE WRITTEN")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory, dist):
    d = tmp_path_factory.mktemp("reshard")
    npz = str(d / "jax.npz")
    out = dist(JAX_SCRIPT % {"out": npz, "skew": SKEW}, n_devices=8)
    assert "JAX RESHARD ORACLE WRITTEN" in out
    ranks = spawn(cases.reshard_rank, (2, 4), "cpu",
                  workdir=str(d / "ranks"), args=(npz,), timeout=300)
    return dict(np.load(npz)), ranks


def _shardings():
    from repro.core.placement import homogeneous_sharding as jhom
    from repro.core.schedule import heterogeneous_sharding as jhet
    from repro_torch.core.placement import homogeneous_sharding
    from repro_torch.core.schedule import heterogeneous_sharding
    loads = np.random.default_rng(0).random((2, 8))
    return ((homogeneous_sharding(2, 8, 4),
             heterogeneous_sharding(loads, 4, t=2, k_local=4)),
            (jhom(2, 8, 4), jhet(loads, 4, t=2, k_local=4)))


def test_reshard_perm_matches_jax_and_moves_every_row():
    from repro.train.trainer import reshard_perm as jreshard_perm
    from repro_torch.train.trainer import reshard_perm
    (old, new), (jold, jnew) = _shardings()
    perm = reshard_perm(old, new)
    np.testing.assert_array_equal(perm, jreshard_perm(jold, jnew))
    moved = np.arange(old.rows_per_device * old.num_devices)[perm]
    for l in range(2):
        for e in range(8):
            assert moved[new.global_rows()[l, e]] == old.global_rows()[l, e]


@pytest.mark.parametrize("what", ["buf", "mu", "nu"])
def test_apply_reshard_moves_rows_as_jax_does(both, what):
    """Every row of the parameters and of both moments lands where the
    JAX package's ``apply_reshard`` puts it on the mesh, bit for bit."""
    jx, ranks = both
    perm = jx["rs/perm"]
    assert not np.array_equal(perm, np.arange(perm.shape[0]))
    got = np.concatenate([
        np.concatenate([ranks[d * 4 + e]["moved"][what] for d in range(2)],
                       axis=1) for e in range(4)])
    np.testing.assert_array_equal(got, jx[f"rs/{what}/moved"])
    np.testing.assert_array_equal(got, jx[f"rs/{what}"][perm])


def test_resharding_loop_gives_every_rank_jax_sharding(both):
    """Two steps of the loop resharding every step: every rank holds the
    JAX scheduler's new sharding (not the homogeneous one)."""
    from repro_torch.core.placement import homogeneous_sharding
    jx, ranks = both
    hom = homogeneous_sharding(2, 4, 4)
    assert not np.array_equal(jx["owner_dev"], hom.owner_dev)
    for r in ranks:
        np.testing.assert_array_equal(r["owner_dev"], jx["owner_dev"])
        np.testing.assert_array_equal(r["owner_row"], jx["owner_row"])


def test_resharding_loop_loss_matches_jax(both):
    jx, ranks = both
    for r in ranks:
        assert r["loop_losses"] == ranks[0]["loop_losses"]
    np.testing.assert_allclose(ranks[0]["loop_losses"], jx["loop_losses"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("site", ["scheduler.plan_job",
                                  "scheduler.plan_job_hang"])
def test_planner_fault_on_one_rank_keeps_every_rank_on_one_plan(both, site):
    """A plan-ahead job that raises, or hangs past ``plan_timeout_s``, on
    rank 0 only: rank 0 falls back (and after a hang plans on its own
    thread for the rest of the run), the others take their prefetched
    plans, and every rank still uses the same plan tables at every step,
    and reaches the same losses.  On these loads the prefetched plan of
    some step differs from Algorithm 1 on the prediction at that step, so
    a fallback that planned from the fresher prediction would show."""
    _, ranks = both
    got = [r["faults"][site] for r in ranks]
    assert any(any(not np.array_equal(x, y) for x, y in zip(a, b))
               for a, b in zip(got[1]["plans"], got[1]["now"]))
    assert got[0]["fallbacks"] == 1
    assert all(g["fallbacks"] == 0 and g["hits"] == 2 for g in got[1:])
    assert got[0]["hits"] == (1 if site == "scheduler.plan_job" else 0)
    for g in got[1:]:
        assert len(g["plans"]) == len(got[0]["plans"]) == 3
        for step, (a, b) in enumerate(zip(g["plans"], got[0]["plans"])):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=str(step))
        assert g["losses"] == got[0]["losses"]


class _ForcedPermuteReshard:
    """One row-permuting reshard at step ``at`` (the JAX package's test
    policy): with one device no expert changes owner, but the buffer rows
    of the parameters and both moments move."""

    def __init__(self, at: int, seed: int = 0):
        self.at, self.seed = at, seed

    def maybe_reshard(self, step, current, predictor):
        if step != self.at:
            return current, False
        perm = np.random.default_rng(self.seed).permutation(
            current.rows_per_device).astype(np.int32)
        new = dataclasses.replace(current, owner_row=perm[current.owner_row])
        new.validate()
        return new, True


def test_forced_row_permutation_leaves_training_unchanged():
    """World size 1: a reshard that permutes the buffer rows before step
    2 (``apply_reshard``: parameters, ``mu`` and ``nu``) leaves the loss
    of that step and the next within 1e-5 of the unpermuted run's."""
    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    from repro_torch.train.trainer import HecateScheduler, train_loop
    cfg = configs.get_smoke("gpt-moe-s")
    runs = []
    for policy in (None, _ForcedPermuteReshard(at=2)):
        sched = HecateScheduler(cfg, impl="ring", calibrate=False,
                                resharding=policy, device="cpu")
        _, hist = train_loop(
            cfg, mdl.Runtime(use_pallas=False),
            TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=4),
            make_stream(cfg.vocab_size, 16, 4, kind="bytes", seed=5),
            scheduler=sched, num_steps=4, log_every=0, device="cpu")
        runs.append((sched, [h["loss"] for h in hist]))
    (plain, a), (permuted, b) = runs
    assert not np.array_equal(permuted.sharding.owner_row,
                              plain.sharding.owner_row)
    assert a[:2] == b[:2]
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
