"""The port's checkpoint, resume and rollback paths against the JAX
package's, on the CPU: the counterparts of the checkpoint, resume and
rollback cases of ``tests/test_fault_tolerance.py``, and the repair of
ROADMAP C15.

The dense model is the JAX package's smollm-360m smoke config (2 layers,
f32) carried over field by field, trained from JAX's initial weights on
the same byte stream in both packages.  Within one package a resumed run
must equal the uninterrupted one bit for bit.  Between the packages the
losses and xent of steps 0 and 1 are held at 1e-5 (relative), the
reference's tolerance, and every step at 3%, as
``tests/test_torch_train.py`` holds its trajectory: even without a router
the two runs part after two AdamW steps, because an element whose
gradient lies at the f32 noise floor moves by about lr·sign(g) either
way.  Measured on the CPU from the same initial weights: 0 at step 0,
1.4e-6 at step 1, 3.0e-4 at step 2, 6.4e-3 to 8.8e-3 at step 3, at most
2.2e-2 up to step 8.  A resumed run is held to the JAX package's resume
from a copy of the port's own checkpoints, so its first two steps start
from the same state.  The MoE cases use smoke gpt-moe-s, whose top-2
routes also flip after two steps (C10): there the port is held bit for
bit to its own uninterrupted run and to JAX on the predictor's window.

C15: a training state the caller drops must be freed at once, without the
cyclic garbage collector, as JAX frees it.  ``tools/state_cycle_probe.py``
runs a plain step and a step on a world-size-1 gloo grid, each first in a
fresh interpreter (where ``torch.utils.checkpoint``'s first call used to
import ``torch._dynamo`` with the step's frames on the stack), with the
collector off, and holds a weak reference to the chunk buffer.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.common import faults as jfaults  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.train import step as jst  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import (ModelConfig, MoEConfig,  # noqa: E402
                                       SSMConfig, TrainConfig)
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RT = dict(use_pallas=False)


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


def port_cfg(jcfg) -> ModelConfig:
    """The JAX package's ModelConfig as the port's, field by field."""
    d = dataclasses.asdict(jcfg)
    return ModelConfig(moe=MoEConfig(**d.pop("moe")),
                       ssm=SSMConfig(**d.pop("ssm")), **d)


@pytest.fixture(scope="module")
def dense():
    """The dense config in both packages, JAX's initial weights, and one
    jitted JAX step for the runs at the default hyperparameters of
    ``_tc`` (the checkpoint knobs do not reach the step), so those runs
    share one compilation."""
    jcfg = jconfigs.get_smoke("smollm-360m")
    np_tree = jax.tree.map(np.asarray,
                           jmdl.init_params(jcfg, jax.random.PRNGKey(0)))
    jstep = jax.jit(jst.build_train_step(jcfg, jmdl.Runtime(), _tc()[1]))
    return jcfg, port_cfg(jcfg), np_tree, jstep


def _tc(**kw):
    kw.setdefault("learning_rate", 3e-3)
    kw.setdefault("warmup_steps", 2)
    kw.setdefault("total_steps", 8)
    return TrainConfig(**kw), JTrainConfig(**kw)


def _tstream(seed=0):
    return pipeline.make_stream(512, 16, 4, kind="bytes", seed=seed)


def _jstream(seed=0):
    return jpipeline.make_stream(512, 16, 4, kind="bytes", seed=seed)


def _state(np_tree):
    """The port's state from JAX's initial weights (what both packages'
    loops make from seed 0 when they start fresh is each its own)."""
    p = params_from_jax(np_tree, "cpu")
    return st.TrainState(p, adamw.init(p), torch.zeros((), dtype=torch.int32))


def _run(cfg, tc, n, state=None, stream=None, **kw):
    return trainer.train_loop(cfg, mdl.Runtime(**RT), tc,
                              stream or _tstream(), state=state,
                              num_steps=n, log_every=0, device="cpu", **kw)


def _jrun(jcfg, jtc, n, stream=None, **kw):
    return jtrainer.train_loop(jcfg, jmdl.Runtime(), jtc,
                               stream or _jstream(), num_steps=n,
                               log_every=0, **kw)


def _losses(hist, key="loss"):
    return {h["step"]: h[key] for h in hist}


def _same_params(a, b):
    for (ka, x), (kb, y) in zip(store._walk(a), store._walk(b)):
        assert ka == kb
        assert torch.equal(x, y), ka


def _close_to_jax(th, jh, first=0):
    """The two steps from ``first`` (where both packages started from the
    same state) within 1e-5 of JAX's (relative), every step within 3%;
    returns the largest relative distance per step."""
    assert [h["step"] for h in th] == [h["step"] for h in jh]
    dist = {}
    for key in ("loss", "xent"):
        got = np.asarray([h[key] for h in th])
        want = np.asarray([h[key] for h in jh])
        rel = np.abs(got - want) / np.abs(want)
        for h, r in zip(th, rel):
            dist[h["step"]] = max(dist.get(h["step"], 0.0), float(r))
        early = [h["step"] < first + 2 for h in th]
        np.testing.assert_allclose(got[early], want[early], rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=3e-2)
    print("relative distance to JAX per step:", dist)
    return dist


# ---------------------------------------------------------------------------
# C15
# ---------------------------------------------------------------------------
def test_dropped_state_is_freed_without_the_collector():
    """A plain step and a grid step at world size 1 (gloo), each the first
    of its kind in a fresh interpreter, with the collector off: the
    dropped state's chunk buffer dies at once (``state_cycle_probe``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "state_cycle_probe.py"),
                        "--device", "cpu"], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if "freed at once" in ln]
    assert len(lines) == 5 and all("at once: True" in ln for ln in lines)
    assert "plain step, first in the process" in lines[0]
    assert "grid step, first on the grid" in lines[2]


# ---------------------------------------------------------------------------
# step guard, rollback
# ---------------------------------------------------------------------------
def test_guard_is_bit_exact_on_healthy_steps(dense):
    """``step_guard`` changes nothing on healthy steps (bitwise), and the
    losses match JAX's within 1e-5."""
    jcfg, cfg, np_tree, jstep = dense
    (tc1, jtc1), (tc2, _) = _tc(step_guard=True), _tc(step_guard=False)
    s1, h1 = _run(cfg, tc1, 4, _state(np_tree))
    s2, h2 = _run(cfg, tc2, 4, _state(np_tree))
    _same_params(s1.params, s2.params)
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2]
    _, jh = _jrun(jcfg, jtc1, 4, train_step_fn=jstep)
    _close_to_jax(h1, jh)


def test_abort_after_budget_with_rollback(dense, tmp_path):
    """Persistent NaNs from step 6: three skipped steps, then
    ``TrainAbortError`` at global step 9 whose state is the step-6
    checkpoint, bitwise, with ``rollbacks`` 1, as in JAX; the records
    before the abort match JAX's within 1e-5."""
    jcfg, cfg, np_tree, jstep = dense
    tc, _ = _tc(total_steps=12, checkpoint_dir=str(tmp_path / "t"),
                checkpoint_every=2, max_bad_steps=3)
    _, jtc = _tc(total_steps=12, checkpoint_dir=str(tmp_path / "j"),
                 checkpoint_every=2, max_bad_steps=3)
    with faults.injected("train.nan_grads", mutate=faults.poison_grads,
                         after=6, times=None):
        with pytest.raises(trainer.TrainAbortError) as ei:
            _run(cfg, tc, 12, _state(np_tree))
    with jfaults.injected("train.nan_grads", mutate=jfaults.poison_grads,
                          after=6, times=None):
        with pytest.raises(jtrainer.TrainAbortError) as jei:
            _jrun(jcfg, jtc, 12)
    e, je = ei.value, jei.value
    assert e.step == je.step == 9
    for k in ("skipped_steps", "rollbacks", "resumes"):
        assert e.history[-1][k] == je.history[-1][k], k
    assert e.history[-1]["rollbacks"] == 1
    assert int(e.state.step) == int(je.state.step) == 6
    ckpt = store.restore(tc.checkpoint_dir, 6, trainer._state_tree(e.state))
    _same_params(ckpt["params"], e.state.params)
    _same_params(ckpt["opt"].mu, e.state.opt.mu)
    _close_to_jax(e.history, je.history)


# ---------------------------------------------------------------------------
# crash-safe resume
# ---------------------------------------------------------------------------
def test_kill_and_resume_parity(dense, tmp_path):
    """Kill at step 5 (checkpoints at 2 and 4), auto-resume: the resumed
    steps equal the uninterrupted run's bit for bit and JAX's resumed run
    within 1e-5."""
    jcfg, cfg, np_tree, jstep = dense
    tc, jtc = _tc(checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    _, jtc = _tc(checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2)
    sA, hA = _run(cfg, _tc()[0], 8, _state(np_tree))
    _run(cfg, tc, 5, _state(np_tree))                      # "kill"
    # the JAX package resumes from a copy of the port's checkpoints
    shutil.copytree(tc.checkpoint_dir, jtc.checkpoint_dir)
    sB, hB = _run(cfg, tc, 8)
    assert hB[0]["step"] == 4 and hB[0]["resumes"] == 1
    ref = _losses(hA)
    assert _losses(hB) == {k: ref[k] for k in range(4, 8)}
    _same_params(sA.params, sB.params)
    _, jhB = _jrun(jcfg, jtc, 8, train_step_fn=jstep)
    assert jhB[0]["step"] == 4 and jhB[0]["resumes"] == 1
    _close_to_jax(hB, jhB, first=4)


def test_resume_skips_checkpoint_truncated_mid_save(dense, tmp_path):
    """A torn write of the newest checkpoint (step 6, truncated): the
    resume falls back to step 4, and the steps from there equal the
    uninterrupted run's; the JAX package, resuming from a copy of the
    same files, falls back alike and follows within 1e-5."""
    jcfg, cfg, np_tree, jstep = dense
    tc, _ = _tc(checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    _, jtc = _tc(checkpoint_dir=str(tmp_path / "j"), checkpoint_every=2)
    _, hA = _run(cfg, _tc()[0], 8, _state(np_tree))
    with faults.injected("checkpoint.corrupt", mutate=faults.truncate_file,
                         after=2, times=1):
        _run(cfg, tc, 7, _state(np_tree))
    assert store.latest_step(tc.checkpoint_dir) == 6
    assert store.latest_step(tc.checkpoint_dir, verify=True) == 4
    # the JAX package, resuming from a copy of the port's checkpoints,
    # skips the torn step alike
    shutil.copytree(tc.checkpoint_dir, jtc.checkpoint_dir)
    assert jstore.latest_step(jtc.checkpoint_dir, verify=True) == 4
    _, hB = _run(cfg, tc, 8)
    assert hB[0]["step"] == 4
    ref = _losses(hA)
    assert _losses(hB) == {k: ref[k] for k in range(4, 8)}
    _, jhB = _jrun(jcfg, jtc, 8, train_step_fn=jstep)
    assert jhB[0]["step"] == 4
    _close_to_jax(hB, jhB, first=4)


def _moe():
    jcfg = jconfigs.get_smoke("gpt-moe-s")
    return jcfg, configs.get_smoke("gpt-moe-s")


def test_moe_resume_restores_scheduler_predictor(tmp_path):
    """Smoke gpt-moe-s, ep plan: the predictor's window survives
    kill-and-resume through the serving state, observation for
    observation, and the resumed steps equal the uninterrupted run's bit
    for bit; the JAX package's run keeps a window of the same length and
    totals."""
    jcfg, cfg = _moe()

    def stream():
        return pipeline.make_stream(cfg.vocab_size, 16, 4, kind="bytes",
                                    seed=3)

    def sched():
        return trainer.HecateScheduler(cfg, ep=1, impl="ep", device="cpu")
    schedA = sched()
    _, hA = _run(cfg, _tc()[0], 8, stream=stream(), scheduler=schedA)
    tc, _ = _tc(checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    _run(cfg, tc, 5, stream=stream(), scheduler=sched())
    schedB = sched()
    _, hB = _run(cfg, tc, 8, stream=stream(), scheduler=schedB)
    assert hB[0]["step"] == 4 and hB[0]["resumes"] == 1
    ref = _losses(hA)
    assert _losses(hB) == {k: ref[k] for k in range(4, 8)}
    assert len(schedB.predictor.history) == len(schedA.predictor.history)
    for a, b in zip(schedA.predictor.history, schedB.predictor.history):
        np.testing.assert_array_equal(a, b)
    jsched = jtrainer.HecateScheduler(jcfg, ep=1, impl="ep")
    _jrun(jcfg, _tc()[1], 8, stream=jpipeline.make_stream(
        jcfg.vocab_size, 16, 4, kind="bytes", seed=3), scheduler=jsched)
    assert len(jsched.predictor.history) == len(schedB.predictor.history)
    for a, b in zip(jsched.predictor.history, schedB.predictor.history):
        np.testing.assert_array_equal(a.sum(-1), b.sum(-1))


def test_reshard_then_resume_restores_sharding(tmp_path):
    """A row-permuting reshard at step 3, a checkpoint at 4, a kill at 5:
    the resumed scheduler plans against the checkpointed (permuted)
    sharding, which is the JAX package's permutation, and the resumed
    steps and parameters equal the uninterrupted run's bit for bit."""
    jcfg, cfg = _moe()

    def stream():
        return pipeline.make_stream(cfg.vocab_size, 16, 4, kind="bytes",
                                    seed=5)

    def sched():
        return trainer.HecateScheduler(cfg, ep=1, impl="ring", device="cpu",
                                       calibrate=False,
                                       resharding=cases.PermuteOnce(at=3))
    sA, hA = _run(cfg, _tc()[0], 8, stream=stream(), scheduler=sched())
    tc, _ = _tc(checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    _run(cfg, tc, 5, stream=stream(), scheduler=sched())
    schedB = sched()
    sB, hB = _run(cfg, tc, 8, stream=stream(), scheduler=schedB)
    assert hB[0]["step"] == 4 and hB[0]["resumes"] == 1
    hom = placement.homogeneous_sharding(schedB.sharding.num_layers,
                                         cfg.moe.num_experts, 1)
    assert not np.array_equal(schedB.sharding.owner_row, hom.owner_row)
    jwant = jtrainer.HecateScheduler(jcfg, ep=1, impl="ring").sharding
    perm = np.random.default_rng(0).permutation(
        jwant.rows_per_device).astype(np.int32)
    np.testing.assert_array_equal(schedB.sharding.owner_row,
                                  perm[jwant.owner_row])
    ref = _losses(hA)
    assert _losses(hB) == {k: ref[k] for k in range(4, 8)}
    _same_params(sA.params, sB.params)


def test_resume_refuses_resharding_without_saved_sharding(tmp_path):
    """A checkpoint with no sharding record (here one the JAX package
    wrote with its own store) and a resharding scheduler: the resume is
    refused with a warning, in both packages; without resharding the
    same checkpoint resumes."""
    from repro.core.schedule import ReshardingPolicy as JReshardingPolicy
    from repro_torch.core.schedule import ReshardingPolicy
    jcfg, cfg = _moe()
    tc, jtc = _tc(checkpoint_dir=str(tmp_path))
    jstate = jst.init_state(jcfg, jax.random.PRNGKey(0), 1)
    jstore.save(str(tmp_path), 4, {"params": jstate.params,
                                   "opt": jstate.opt, "step": np.int32(4)})
    for mod, sched, pol in (
            (trainer, trainer.HecateScheduler(cfg, ep=1, impl="ring",
                                              device="cpu",
                                              resharding=ReshardingPolicy(
                                                  interval=2)), None),
            (jtrainer, jtrainer.HecateScheduler(
                jcfg, ep=1, impl="ring",
                resharding=JReshardingPolicy(interval=2)), None)):
        kw = {"device": "cpu"} if mod is trainer else {}
        with pytest.warns(RuntimeWarning, match="refusing to resume"):
            got, start = mod.resume_train_state(
                cfg if mod is trainer else jcfg,
                tc if mod is trainer else jtc, sched, 1, **kw)
        assert got is None and start == 0
    got, start = trainer.resume_train_state(
        cfg, tc, trainer.HecateScheduler(cfg, ep=1, impl="ring",
                                         device="cpu"), 1, device="cpu")
    assert got is not None and start == 4
    np.testing.assert_array_equal(got.params["moe_buffer"].numpy(),
                                  np.asarray(jstate.params["moe_buffer"]))


def test_resume_falls_back_past_old_format_checkpoint(dense, tmp_path):
    """An old-format checkpoint (``{params, opt_count}``) at the newest
    step verifies but cannot restore the full state: the resume falls
    back to the next restorable step with a warning, or starts fresh when
    there is none, as in JAX."""
    jcfg, cfg, np_tree, jstep = dense
    tc, jtc = _tc(checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    _run(cfg, tc, 5, _state(np_tree))
    params = params_from_jax(np_tree, "cpu")
    store.save(tc.checkpoint_dir, 9, {"params": params,
                                      "opt_count": np.int64(0)})
    assert store.latest_step(tc.checkpoint_dir, verify=True) == 9
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, start = trainer.resume_train_state(cfg, tc, device="cpu")
    assert got is not None and start == 4
    assert any("not restorable" in str(x.message) for x in w)
    # the JAX package falls back past the port's old-format step alike
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgot, jstart = jtrainer.resume_train_state(
            jcfg, dataclasses.replace(jtc, checkpoint_dir=tc.checkpoint_dir))
    assert jstart == 4
    d2 = str(tmp_path / "only_old")
    store.save(d2, 9, {"params": params, "opt_count": np.int64(0)})
    tc2, _ = _tc(checkpoint_dir=d2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, start = trainer.resume_train_state(cfg, tc2, device="cpu")
        assert got is None and start == 0
        _, hist = _run(cfg, tc2, 2)
    assert hist[0]["step"] == 0 and hist[0]["resumes"] == 0
