"""Multi-rank training of smoke gpt-moe-s against the JAX package.

The JAX side (one ``run_distributed`` subprocess, 8 host devices, an
``.npz`` written once for the module) builds ``init_params(PRNGKey(0),
ep=4)`` and takes ``jax.value_and_grad`` of the loss on a (2, 4) mesh with
the ring plan, ``m = 1`` and ``capacity = 16``, as
``tests/test_fused_ffn_path.py``'s train script does.  The port side runs
8 gloo ranks of a 2 x 4 process grid (``tests/torch_dist_cases.py::
train_rank``): each rank takes its rows of the same global batch, and the
weights come over through numpy.  One step's loss is held to 1e-5 and
every gradient leaf to 1e-4 of its largest value; then two steps of the
Hecate loop must give every rank the same plan at every step.  The
launcher trains three steps on 8 spawned gloo ranks.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro_torch.launch.distributed import spawn  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

JAX_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.configs.gpt_moe_s import smoke
from repro.core.placement import homogeneous_sharding
from repro.core.schedule import sparse_materialization
from repro.core import moe as moe_core
from repro.models import model as mdl
from repro.train import step as jst

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
params = mdl.init_params(cfg, jax.random.PRNGKey(0), ep=EP)
rng = np.random.default_rng(0)
tokens = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
loop_tokens = rng.integers(0, cfg.vocab_size, (2, 8, 17)).astype(np.int32)
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p: jst.loss_fn(cfg, rt, p, {"tokens": jnp.asarray(tokens)}, pa),
    has_aux=True))(params)
out = {"loss": np.asarray(loss), "tokens": tokens,
       "loop_tokens": loop_tokens}


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + "/" + k)
    else:
        yield prefix, np.asarray(tree)


out.update(dict(flat(params, "params")))
out.update(dict(flat(grads, "grads")))
np.savez(%(out)r, **out)
print("JAX TRAIN ORACLE WRITTEN")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory, dist):
    d = tmp_path_factory.mktemp("train_dist")
    npz = str(d / "jax.npz")
    out = dist(JAX_SCRIPT % {"out": npz}, n_devices=8)
    assert "JAX TRAIN ORACLE WRITTEN" in out
    ranks = spawn(cases.train_rank, (2, 4), "cpu", workdir=str(d / "ranks"),
                  args=(npz,), timeout=300)
    return dict(np.load(npz)), ranks


def _grad(ranks, name, data=2, model=4):
    """A leaf's gradient: rank 0's for a replicated leaf (checked equal on
    every rank), the buffer assembled from its shards."""
    if name != "moe_buffer":
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["grads"][name],
                                          ranks[0]["grads"][name])
        return ranks[0]["grads"][name]
    return np.concatenate([
        np.concatenate([ranks[d * model + e]["grads"][name]
                        for d in range(data)], axis=1)
        for e in range(model)])


def test_one_step_loss_matches_jax(both):
    jx, ranks = both
    losses = [r["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - float(jx["loss"])) <= 1e-5


def test_every_gradient_leaf_matches_jax_grad_on_the_mesh(both):
    """Replicated leaves are summed over the world (equal on every rank);
    the buffer's shards come from the SparseReduceScatter."""
    jx, ranks = both
    names = sorted(ranks[0]["grads"])
    assert len(names) == len([k for k in jx if k.startswith("grads/")])
    for name in names:
        want = jx[f"grads/{name}"]
        got = _grad(ranks, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, name


def test_router_gradient_through_the_gate_all_reduce(both):
    """The router's gradient flows through the gate's statistics, summed
    over the world; JAX's transpose of that ``psum`` counts each device's
    cotangent once, and so does the port (an identity backward)."""
    jx, ranks = both
    want = jx["grads/router"]
    assert np.abs(want).max() > 0
    got = _grad(ranks, "router")
    assert np.abs(got - want).max() <= 1e-4 * float(np.abs(want).max())


def test_loop_plans_equal_on_every_rank(both):
    """Two steps of ``train_loop`` with ``HecateScheduler(ep=4,
    impl="ring")``: Algorithm 1 plans from the counts summed over the
    world, so every rank plans the same at every step, and every rank
    reports the same finite global loss."""
    _, ranks = both
    assert len(ranks[0]["plans"]) == 2
    for r in ranks[1:]:
        for a, b in zip(r["plans"], ranks[0]["plans"]):
            for ta, tb in zip(a, b):
                np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(r["predicted"], ranks[0]["predicted"])
        assert r["loop_losses"] == ranks[0]["loop_losses"]
    assert all(np.isfinite(ranks[0]["loop_losses"]))


def test_host_stream_gives_each_rank_the_reference_rows(both):
    """``launch.distributed.host_stream`` on rank r of 8 yields what the
    JAX package's stream yields for process r of 8."""
    from repro.data import pipeline as jpipeline
    _, ranks = both
    for r, rr in enumerate(ranks):
        assert rr["info"] == {"rank": r, "world_size": 8, "backend": "gloo"}
        want = jpipeline.make_stream(512, 8, 16, seed=3, process_index=r,
                                     process_count=8).next_batch()["tokens"]
        np.testing.assert_array_equal(rr["host_batch"], want)


def test_launch_train_spawns_a_grid_on_the_cpu(tmp_path):
    log = tmp_path / "hist.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt-moe-s", "--smoke", "--device", "cpu", "--spawn",
         "--mesh-data", "2", "--mesh-model", "4", "--impl", "ring",
         "--steps", "3", "--seq-len", "16", "--log-json", str(log),
         "--spawn-timeout", "240", "--spawn-dir", str(tmp_path / "ranks")],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    hist = json.loads(log.read_text())
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "final loss" in r.stdout
