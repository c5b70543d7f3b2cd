"""Overlap and re-materialization on the card, at world size 1 over a real
NCCL process group.  Every test needs a CUDA device and skips without one;
the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_overlap_gpu.py

1. Full-width gpt-moe-s cut to 2 layers in f32: each remat mode (``save``
   and ``gather`` with the one-layer-ahead prefetch, ``block``) and the
   hoisted two-microbatch step give the loss and gradients of the
   world-size-1 ``ep`` path within 1e-5 of each leaf's largest entry
   (the step through its first moment, (1 - beta1) times the gradient).
2. Two identical bf16 steps per mode give bitwise-equal parameters.
3. ``materialize_layer``'s handle, waited after other work was queued on
   the compute stream, gives the bits of a gather waited at once, and
   ``materialize_stack`` those of the per-layer gathers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import _leaves  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.schedule import sparse_materialization  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.train import step as st  # noqa: E402

B, S = 2, 128
MODES = ["save", "gather", "block"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_grid
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_grid(1, 1)
    finally:
        dist.destroy_process_group()


def _cfg(dtype, mode="save"):
    cfg = configs.get("gpt-moe-s").replace(num_layers=2, dtype=dtype)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, rematerialize=mode))


def _batch(cfg, rows=B):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (rows, S + 1)).astype(np.int32)
    return {"tokens": torch.as_tensor(toks, device="cuda")}


def _ring_pa(cfg):
    L, E = moe.num_moe_layers(cfg), cfg.moe.num_experts
    plan = sparse_materialization(placement.homogeneous_sharding(L, E, 1),
                                  np.ones((L, E)), t=8,
                                  m=cfg.moe.slots_per_device, impl="ring")
    return moe.plan_to_arrays(plan, "cuda")


def _ep_path(cfg):
    rt = mdl.Runtime(use_pallas=False, moe=moe.MoERuntime(use_pallas=True))
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(moe.num_moe_layers(cfg),
                                       cfg.moe.num_experts, 1)), "cuda")
    return rt, pa


def _grid_rt(grid, capacity=0):
    return mdl.Runtime(use_pallas=False, moe=moe.MoERuntime(
        use_pallas=True, grid=grid, impl="ring", capacity=capacity))


def _close_trees(got, want, tol=1e-5):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol * scale, path


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_world_size_one_path(grid, mode):
    cfg = _cfg("float32", mode)
    params = mdl.init_params(cfg, 0, "cuda")
    batch = _batch(cfg)
    rt1, pa1 = _ep_path(cfg)
    m1, g1 = st.loss_and_grads(cfg, rt1, params, batch, pa1)
    moe.reset_collective_counts()
    mg, gg = st.loss_and_grads(cfg, _grid_rt(grid, B * S), params, batch,
                               _ring_pa(cfg))
    hops = moe.collective_counts()["spag_ring"]["calls"] \
        + moe.collective_counts()["sprs_ring"]["calls"]
    assert hops == (2 if mode == "save" else 3) * 2 \
        * cfg.moe.slots_per_device
    assert float(mg["dropped_frac"]) == 0.0
    assert abs(float(mg["loss"]) - float(m1["loss"])) <= 1e-5 * abs(
        float(m1["loss"]))
    _close_trees(gg, g1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["save", "gather"])
def test_hoisted_step_matches_world_size_one_path(grid, mode):
    cfg = _cfg("float32", mode)
    tc = TrainConfig(microbatch=2, learning_rate=1e-3, warmup_steps=1)
    batch = _batch(cfg, 2 * B)
    rt1, pa1 = _ep_path(cfg)
    s1, m1 = st.build_train_step(cfg, rt1, tc)(
        st.init_state(cfg, 0, 1, "cuda"), batch, pa1)
    moe.enable_event_log()
    try:
        sg, mg = st.build_train_step(cfg, _grid_rt(grid, B * S), tc)(
            st.init_state(cfg, 0, 1, "cuda", grid), batch, _ring_pa(cfg))
        ev = moe.event_log()
    finally:
        moe.enable_event_log(False)
    assert [e for e in ev if e[0] == "spag" and e[2] == "fwd"] == [
        ("spag", 0, "fwd"), ("spag", 1, "fwd")]
    assert abs(float(mg["loss"]) - float(m1["loss"])) <= 1e-5 * abs(
        float(m1["loss"]))
    _close_trees(sg.opt.mu, s1.opt.mu)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_two_identical_bf16_steps_are_bitwise_equal(grid, mode):
    cfg = _cfg("bfloat16", mode)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    step = st.build_train_step(cfg, _grid_rt(grid), tc)
    batch, pa = _batch(cfg), _ring_pa(cfg)
    outs = []
    for _ in range(2):
        state = st.init_state(cfg, 0, 1, "cuda", grid)
        state, metrics = step(state, batch, pa)
        outs.append(([t.clone() for _, t in _leaves(state.params)],
                     float(metrics["loss"])))
        del state
    assert outs[0][1] == outs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))


@pytest.mark.gpu
def test_async_gather_gives_the_synchronous_bits(grid):
    cfg = _cfg("bfloat16")
    params = mdl.init_params(cfg, 0, "cuda", grid=grid)
    buf, pa = params["moe_buffer"].detach(), _ring_pa(cfg)
    rt = _grid_rt(grid).moe
    handles = [moe.materialize_layer(cfg, rt, buf, pa.layer(l), layer=l)
               for l in range(2)]
    a = torch.randn(4096, 4096, device="cuda")
    for _ in range(8):                  # compute queued behind the gathers
        a = torch.tanh(a @ a * 1e-3)
    got = [h.wait().clone() for h in handles]
    stack = moe.materialize_stack(cfg, rt, buf, pa)
    for l in range(2):
        want, pending = moe._spag_issue(buf, pa.layer(l), grid, "ring",
                                        torch.bfloat16)
        pending.wait()                  # waited at once
        assert torch.equal(got[l][0], want)
        assert torch.equal(stack[l, 0], want)
    assert bool(torch.isfinite(a).all())
