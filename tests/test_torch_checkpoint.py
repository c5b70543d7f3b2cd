"""The port's checkpoint store against the JAX package's, on the CPU.

1. The store's cases of ``tests/test_substrates.py``,
   ``tests/test_fault_tolerance.py``, ``tests/test_serve_publish.py`` and
   ``tests/test_serve_fleet.py``, each run through both packages' stores
   in the same directory layout, with the same outcomes.
2. Checkpoints cross between the packages, bitwise: one that the JAX
   package's training loop wrote (world size 1, smoke gpt-moe-s, the ring
   plan, one row-permuting reshard before the first save, so the
   ShardingPlan record matters) restores through the port's
   ``resume_train_state`` with every array equal to JAX's, and two more
   steps match JAX's own resumed run within 1e-5; one that the port wrote
   restores through ``repro.checkpoint.store.restore`` into JAX's tree.
3. On a 2 x 2 gloo grid in ``save`` mode (``tests/torch_dist_cases.py::
   ckpt_rank``): kill-and-resume gives the uninterrupted run's losses bit
   for bit (gloo on the CPU is deterministic), a bit-flipped newest step is
   skipped alike on every rank, and a crash mid-save on rank 0 leaves no
   partial directory and raises on every rank.
"""
import dataclasses
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.common import faults as jfaults  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.common.sharding import elastic_row_remap as jremap  # noqa: E402
from repro.common.sharding import remap_buffer_rows as jremap_rows  # noqa
from repro.core import placement as jplacement  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.train import step as jst  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.common.sharding import (elastic_row_remap,  # noqa: E402
                                         remap_buffer_rows)
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

PROMPTS = np.asarray([[5, 7, 9], [1, 2, 3]], np.int32)


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
# the store, case by case, through both packages
# ---------------------------------------------------------------------------
def _roundtrip_tree(xp):
    return {"a": xp.arange(6).reshape(2, 3).astype(xp.float32),
            "b": {"c": xp.ones((4,), xp.int32)},
            "d": [xp.zeros(2), xp.full((1,), 7.0)]}


def test_checkpoint_roundtrip_matches_jax(tmp_path):
    """``tests/test_substrates.py::test_checkpoint_roundtrip``: the same
    tree saved by each store gives the same array keys and bytes, and
    each store restores the other's checkpoint."""
    jtree = _roundtrip_tree(jnp)
    ttree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jtree,
                         is_leaf=lambda a: isinstance(a, jax.Array))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(dj, 3, jtree, {"note": "x"})
    store.save(dt, 3, ttree, {"note": "x"})
    assert store.latest_step(dt) == jstore.latest_step(dj) == 3
    zj = np.load(os.path.join(dj, "step_00000003", "arrays.npz"))
    zt = np.load(os.path.join(dt, "step_00000003", "arrays.npz"))
    assert sorted(zj.files) == sorted(zt.files) == ["a", "b/c", "d/0", "d/1"]
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype
        np.testing.assert_array_equal(zj[k], zt[k])
    assert store.meta(dt, 3)["checksums"] == jstore.meta(dj, 3)["checksums"]
    assert store.meta(dt, 3)["note"] == "x"
    target = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          jtree)
    for d in (dj, dt):                  # each store reads both
        back_t = store.restore(d, 3, ttree)
        back_j = jstore.restore(d, 3, target)
        for x, y, z in zip(jax.tree.leaves(jtree), jax.tree.leaves(back_j),
                           [t for _, t in store._walk(back_t)]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            np.testing.assert_array_equal(np.asarray(x), z.numpy())


def _atomicity(st_mod, d, xp):
    st_mod.save(d, 1, {"a": xp.zeros(2)})
    st_mod.save(d, 2, {"a": xp.ones(2)})
    return (all(not f.startswith(".tmp") for f in os.listdir(d)),
            st_mod.latest_step(d))


def _crash_mid_save(st_mod, d, xp):
    flt = faults if st_mod is store else jfaults
    tree = {"w": xp.arange(6, dtype=xp.float32)}
    st_mod.save(d, 1, tree)
    with flt.injected("checkpoint.save_crash"):
        with pytest.raises(flt.FaultError):
            st_mod.save(d, 2, tree)
    return (st_mod.latest_step(d),
            [x for x in os.listdir(d) if x.startswith(".tmp_ckpt_")])


def _stray_entries(st_mod, d, xp):
    st_mod.save(d, 3, {"w": xp.ones(2)})
    os.makedirs(os.path.join(d, "step_final"))
    os.makedirs(os.path.join(d, ".tmp_ckpt_orphan"))
    out = [st_mod.latest_step(d), st_mod.latest_step(d, verify=True)]
    removed = st_mod.gc(d, keep_last=2)
    return out + [[os.path.basename(r) for r in removed],
                  os.path.isdir(os.path.join(d, "step_final")),
                  st_mod.latest_step(d)]


def _gc_retention(st_mod, d, xp):
    for s in (1, 2, 3, 4):
        st_mod.save(d, s, {"w": xp.full(3, s, xp.float32)})
    st_mod.gc(d, keep_last=2)
    return [s for s, _ in st_mod._step_dirs(d)]


def _bitflip(st_mod, d, xp):
    flt = faults if st_mod is store else jfaults
    tree = {"w": xp.arange(128, dtype=xp.float32)}
    st_mod.save(d, 1, tree)
    with flt.injected("checkpoint.corrupt", mutate=flt.bitflip_file):
        st_mod.save(d, 2, tree)
    with pytest.raises(flt.CheckpointCorruptError):
        st_mod.restore(d, 2, tree)
    back = st_mod.restore(d, 1, tree)
    return (st_mod.verify_step(d, 1), st_mod.verify_step(d, 2),
            st_mod.latest_step(d, verify=True), np.asarray(back["w"]).tolist())


def _truncated(st_mod, d, xp):
    flt = faults if st_mod is store else jfaults
    tree = {"w": xp.arange(64, dtype=xp.float32)}
    st_mod.save(d, 1, tree)
    with flt.injected("checkpoint.corrupt", mutate=flt.truncate_file):
        st_mod.save(d, 2, tree)
    return (st_mod.latest_step(d), st_mod.latest_step(d, verify=True),
            st_mod.verify_step(d, 2))


@pytest.mark.parametrize("case", [
    _atomicity, _crash_mid_save, _stray_entries, _gc_retention, _bitflip,
    _truncated], ids=lambda f: f.__name__.strip("_"))
def test_store_case_matches_jax(case, tmp_path):
    """``test_substrates.py::test_checkpoint_atomicity`` and
    ``test_fault_tolerance.py``'s crash mid-save, stray entries, keep-last
    retention, bit flip and truncation, each run through both stores: the
    same outcome, and the port's checkpoint reads in JAX's store."""
    got = case(store, str(tmp_path / "port"), np)
    want = case(jstore, str(tmp_path / "jax"), jnp)
    assert got == want
    for s in store.list_steps(str(tmp_path / "port")):
        assert jstore.verify_step(str(tmp_path / "port"), s) == \
            store.verify_step(str(tmp_path / "port"), s)


def test_gc_racing_verified_latest_step_falls_back(tmp_path, monkeypatch):
    """``tests/test_serve_fleet.py``: the newest candidate vanishing under
    a verified walk (retention racing a reader) falls back to the next
    intact step in both packages."""
    outs = []
    for st_mod, hook in ((store, "_verify_path"), (jstore, "_load_verified")):
        d = str(tmp_path / st_mod.__name__)
        for s in (1, 2, 3):
            st_mod.save(d, s, {"x": np.full(4, s, np.float32)})
        orig, raced = getattr(st_mod, hook), []

        def racing(path, orig=orig, raced=raced):
            if path.endswith("step_00000003") and not raced:
                raced.append(path)
                shutil.rmtree(path)
            return orig(path)
        monkeypatch.setattr(st_mod, hook, racing)
        first = st_mod.latest_step(d, verify=True)
        st_mod.gc(d, keep_last=1)
        outs.append((first, st_mod.latest_step(d, verify=True),
                     st_mod.list_steps(d)))
        monkeypatch.undo()
    assert outs[0] == outs[1] == (2, 2, [2])


def test_elastic_row_remap_padded_layout_matches_jax():
    """``tests/test_serve_fleet.py``: ep 2 -> 3 with E = 8 leaves pad rows,
    zero-filled; every expert row survives; the two packages' tables and
    arrays are equal; an (L, E) mismatch raises in both."""
    old = placement.homogeneous_sharding(2, 8, 2)
    new = placement.homogeneous_sharding(2, 8, 3)
    src, valid = elastic_row_remap(old, new)
    jsrc, jvalid = jremap(jplacement.homogeneous_sharding(2, 8, 2),
                          jplacement.homogeneous_sharding(2, 8, 3))
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(valid, jvalid)
    assert src.shape == (18,) and int(valid.sum()) == 16
    arr = np.arange(16 * 3, dtype=np.float32).reshape(16, 3) + 1.0
    out = remap_buffer_rows(arr, src, valid)
    np.testing.assert_array_equal(out, jremap_rows(arr, jsrc, jvalid))
    assert (out[~valid] == 0).all() and out.dtype == arr.dtype
    np.testing.assert_array_equal(out[new.global_rows().reshape(-1)],
                                  arr[old.global_rows().reshape(-1)])
    with pytest.raises(ValueError):
        elastic_row_remap(old, placement.homogeneous_sharding(2, 4, 2))


def _smoke_engine(version=0):
    cfg = configs.get_smoke("gpt-moe-s")
    jparams = jmdl.init_params(jconfigs.get_smoke("gpt-moe-s"),
                               jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    L = moe.num_moe_layers(cfg)
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")
    rt = mdl.Runtime()
    return cfg, rt, params, pa, Engine(cfg, rt, params, max_len=32, pa=pa,
                                       version=version)


def test_serving_state_roundtrip(tmp_path):
    """``tests/test_serve_publish.py::test_serving_state_roundtrip`` and
    ``::test_restore_serving_state_missing_returns_none``: the plan
    tables, version and calibration persist; the JAX package reads the
    port's serving state to the same values; an engine restarted at the
    restored state generates the same tokens; step checkpoints beside it
    are untouched; an empty directory gives None in both."""
    cfg, rt, params, pa, eng = _smoke_engine(version=4)
    calib = {"load_history": np.arange(12, dtype=np.float64).reshape(2, 6)}
    d = str(tmp_path)
    store.save_serving_state(d, 4, pa, eng.version, calib)
    assert store.latest_serving_step(d) == jstore.latest_serving_step(d) == 4
    got, jgot = store.restore_serving_state(d), jstore.restore_serving_state(d)
    assert got["version"] == jgot["version"] == 4 and got["step"] == 4
    np.testing.assert_array_equal(got["calibration"]["load_history"],
                                  calib["load_history"])
    for a, b, c in zip(got["pa"], pa, jgot["pa"]):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, np.asarray(c))
    out = eng.generate(PROMPTS, steps=3)
    with Engine(cfg, rt, params, max_len=32,
                pa=moe.tables_to_device(got["pa"], "cpu"),
                version=got["version"]) as eng2:
        np.testing.assert_array_equal(out, eng2.generate(PROMPTS, steps=3))
    store.save(d, 4, {"params": {"x": np.zeros(3)}})
    assert store.latest_step(d) == 4
    assert store.restore_serving_state(d)["version"] == 4
    eng.close()
    assert store.restore_serving_state(str(tmp_path / "none")) is None
    assert jstore.restore_serving_state(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
class _JForcedPermute:
    """The JAX side of ``torch_dist_cases.PermuteOnce``."""

    def __init__(self, at: int):
        self.at = at

    def maybe_reshard(self, step, current, predictor):
        if step != self.at:
            return current, False
        perm = np.random.default_rng(0).permutation(
            current.rows_per_device).astype(np.int32)
        return dataclasses.replace(current,
                                   owner_row=perm[current.owner_row]), True


def _tcs(d):
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=8,
              checkpoint_dir=d, checkpoint_every=2)
    return TrainConfig(**kw), JTrainConfig(**kw)


def _jstream():
    return jpipeline.make_stream(512, 16, 4, kind="bytes", seed=5)


def _tstream():
    return pipeline.make_stream(512, 16, 4, kind="bytes", seed=5)


def _leaf_dict(tree):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in store._walk(tree)}


def _jleaf_dict(tree):
    return {k: np.asarray(v) for k, v in
            jstore._flatten_with_paths(tree).items()}


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX loop wrote after a reshard (smoke gpt-moe-s,
    ring plan at ep 1, rows permuted at step 1, saves at steps 2 and 4):
    the port's ``resume_train_state`` restores every array bitwise equal
    to JAX's and the saved ShardingPlan, and two more steps of the port's
    loop match JAX's own resumed run within 1e-5."""
    jcfg, cfg = jconfigs.get_smoke("gpt-moe-s"), configs.get_smoke(
        "gpt-moe-s")
    d = str(tmp_path / "ck")
    tc, jtc = _tcs(d)

    def jsched():
        return jtrainer.HecateScheduler(jcfg, ep=1, impl="ring",
                                        calibrate=False,
                                        resharding=_JForcedPermute(at=1))

    def tsched():
        return trainer.HecateScheduler(cfg, ep=1, impl="ring", device="cpu",
                                       calibrate=False,
                                       resharding=cases.PermuteOnce(at=1))
    jstep = jax.jit(jst.build_train_step(jcfg, jmdl.Runtime(), jtc))
    jtrainer.train_loop(jcfg, jmdl.Runtime(), jtc, _jstream(),
                        scheduler=jsched(), num_steps=4, log_every=0,
                        train_step_fn=jstep)
    # the JAX package's own view of step 4
    jtarget = jtrainer._state_tree(jst.init_state(jcfg, jax.random.PRNGKey(0)))
    jdata = _jleaf_dict(jstore.restore(d, 4, jtarget))
    sched = tsched()
    state, at = trainer.resume_train_state(cfg, tc, sched, 1, device="cpu")
    assert at == 4
    got = _leaf_dict(trainer._state_tree(state))
    assert sorted(got) == sorted(jdata)
    for k in jdata:
        assert got[k].dtype == jdata[k].dtype, k
        np.testing.assert_array_equal(got[k], jdata[k], err_msg=k)
    jss = jstore.restore_serving_state(d, step=4)
    np.testing.assert_array_equal(sched.sharding.owner_row,
                                  jss["sharding"]["owner_row"])
    hom = placement.homogeneous_sharding(sched.sharding.num_layers,
                                         cfg.moe.num_experts, 1)
    assert not np.array_equal(sched.sharding.owner_row, hom.owner_row)
    assert len(sched.predictor.history) == len(jss["calibration"][
        "load_history"])
    # two more steps in each package, each resuming from the same files
    jd, td = str(tmp_path / "j2"), str(tmp_path / "t2")
    shutil.copytree(d, jd)
    shutil.copytree(d, td)
    _, jh = jtrainer.train_loop(jcfg, jmdl.Runtime(),
                                dataclasses.replace(jtc, checkpoint_dir=jd),
                                _jstream(), scheduler=jsched(), num_steps=6,
                                log_every=0, train_step_fn=jstep)
    _, th = trainer.train_loop(cfg, mdl.Runtime(use_pallas=False),
                               dataclasses.replace(tc, checkpoint_dir=td),
                               _tstream(), scheduler=tsched(), num_steps=6,
                               log_every=0, device="cpu")
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [4, 5]
    assert th[0]["resumes"] == jh[0]["resumes"] == 1
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    np.testing.assert_allclose([h["xent"] for h in th],
                               [h["xent"] for h in jh], rtol=1e-5)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's loop saves (after the same reshard); the JAX package's
    ``store.restore`` reads step 4 into its own tree bitwise equal to the
    port's live state, and its ``resume_train_state`` takes the port's
    ShardingPlan record."""
    jcfg, cfg = jconfigs.get_smoke("gpt-moe-s"), configs.get_smoke(
        "gpt-moe-s")
    d = str(tmp_path / "ck")
    tc, jtc = _tcs(d)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    s0 = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    sched = trainer.HecateScheduler(cfg, ep=1, impl="ring", device="cpu",
                                    calibrate=False,
                                    resharding=cases.PermuteOnce(at=1))
    state, _ = trainer.train_loop(cfg, mdl.Runtime(use_pallas=False), tc,
                                  _tstream(), scheduler=sched, state=s0,
                                  num_steps=4, log_every=0, device="cpu")
    live = _leaf_dict(trainer._state_tree(state))
    jtarget = jtrainer._state_tree(jst.init_state(jcfg, jax.random.PRNGKey(1)))
    back = _jleaf_dict(jstore.restore(d, 4, jtarget))
    assert sorted(back) == sorted(live)
    for k in live:
        np.testing.assert_array_equal(back[k], live[k], err_msg=k)
    js = jtrainer.HecateScheduler(jcfg, ep=1, impl="ring",
                                  resharding=_JForcedPermute(at=99))
    jstate, at = jtrainer.resume_train_state(jcfg, jtc, js, ep=1)
    assert at == 4 and int(jstate.step) == 4
    np.testing.assert_array_equal(js.sharding.owner_row,
                                  sched.sharding.owner_row)


# ---------------------------------------------------------------------------
# on a process grid
# ---------------------------------------------------------------------------
def test_grid_checkpoints_resume_skip_corrupt_and_crash(tmp_path):
    """2 x 2 gloo ranks, ``save`` mode, a row-permuting reshard at step 1
    (``torch_dist_cases.ckpt_rank``): every rank's losses after a resume
    from step 4, and from step 2 once step 4 is bit-flipped, equal the
    uninterrupted run's bit for bit; a crash mid-save on rank 0 raises on
    every rank (rank 0 the injected fault, the others the broadcast
    failure) and leaves the directory empty."""
    ranks = spawn(cases.ckpt_rank, (2, 2), "cpu",
                  workdir=str(tmp_path / "ranks"), args=(str(tmp_path),),
                  timeout=300)
    a = ranks[0]["a"]
    assert [s for s, _, _ in a] == list(range(6))
    for r in ranks:
        assert r["a"] == a
        assert r["b1"] == a[:4]
        assert r["b2"] == [(s, loss, 1) for s, loss, _ in a[4:]]
        assert r["c"] == [(s, loss, 1) for s, loss, _ in a[2:]]
        assert r["d_listing"] == []
    assert ranks[0]["d_raised"].startswith("FaultError")
    for r in ranks[1:]:
        assert r["d_raised"].startswith("RuntimeError: checkpoint step 2")
