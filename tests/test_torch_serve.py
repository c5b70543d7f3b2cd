"""The port's continuous-batching serving path against the JAX package's.

Both schedulers serve the same three mixed-length prompts on the gpt-moe-s
smoke config, with parameters carried across from JAX and a page pool small
enough that one sequence is preempted and resumed; the greedy traces must
be equal token for token.  The JAX engine runs as its launcher runs it
(every expert local on one device) with its Pallas kernels in interpret
mode; the port runs its kernels' plain versions on the CPU.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]
SCHED_KW = dict(max_slots=2, num_pages=6, page_size=4, max_kv=16)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _serve(mod, eng):
    with mod.RequestScheduler(eng, **SCHED_KW) as rs:
        reqs = [rs.submit(p, max_new_tokens=9) for p in PROMPTS]
        rs.run(max_ticks=500)
        assert all(r.state == mod.DONE for r in reqs), \
            [(r.state, r.finish_reason) for r in reqs]
        assert rs.pool.free_pages == rs.pool.usable_pages
        return ([r.output() for r in reqs], [r.preemptions for r in reqs],
                rs.decode_ticks)


def test_scheduler_traces_equal_jax_with_preemption():
    jcfg = jconfigs.get_smoke("gpt-moe-s")
    cfg = configs.get_smoke("gpt-moe-s")
    L = jmoe.num_moe_layers(jcfg)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    jpa = jmoe.plan_to_arrays(jplacement.ep_materialization(
        jplacement.homogeneous_sharding(L, jcfg.moe.num_experts, 1)))
    with jengine.Engine(jcfg, jmdl.Runtime(use_pallas=True), jparams,
                        max_len=16, pa=jpa) as jeng:
        want, jpre, jticks = _serve(jsched, jeng)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")
    with engine.Engine(cfg, mdl.Runtime(), params, max_len=16,
                       pa=pa) as eng:
        got, pre, ticks = _serve(sched, eng)
    assert sum(jpre) >= 1                # the pool forced a preemption
    assert pre == jpre and ticks == jticks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_launcher_serves_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gpt-moe-s", "--smoke", "--continuous", "--device", "cpu",
         "--steps", "6", "--max-len", "64"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "continuous batching: " in r.stdout


def test_launcher_refuses_unported_modes(tmp_path):
    """Fixed-batch ``Engine.generate`` serving and ``--replicas 2`` behind a
    publication bus run on the CPU; ``--checkpoint-dir`` serves the newest
    intact checkpoint that the training launcher wrote, at the version of
    the serving state saved beside it."""
    from repro_torch.launch import train as launch_train
    ckpt = str(tmp_path / "ckpt")
    launch_train.main(["--arch", "gpt-moe-s", "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "16", "--data", "bytes",
                       "--checkpoint-dir", ckpt, "--checkpoint-every", "2"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for extra, want in ((["--continuous", "--replicas", "2"],
                         "fleet: 2/2 healthy"),
                        ([], "fixed batch: "),
                        (["--replicas", "2"], "fleet: 2/2 healthy"),
                        (["--checkpoint-dir", ckpt],
                         "restored serving state: step 2, version 2")):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "gpt-moe-s", "--smoke", "--device", "cpu", "--steps", "4",
             "--max-len", "32", *extra],
            env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        assert want in r.stdout, r.stdout
