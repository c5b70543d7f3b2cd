"""The distributed FSSDP layer on the card, at world size 1 over a real
NCCL process group.  Every test needs a CUDA device and skips without one;
the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_distributed_gpu.py

1. Full-width gpt-moe-s cut to 2 layers in f32: the grid path (ring plan
   from Algorithm 1 at ep = 1, a capacity that drops nothing, every
   collective issued over NCCL) gives the loss and every gradient of the
   world-size-1 path of the single-device trainer within 1e-5.
2. Two identical bf16 train steps on the grid give bitwise-equal
   parameters: no atomics on the path.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import _leaves  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.schedule import sparse_materialization  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.train import step as st  # noqa: E402

B, S = 2, 128


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


def _cfg(dtype):
    return configs.get("gpt-moe-s").replace(num_layers=2, dtype=dtype)


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.as_tensor(toks, device="cuda")}


def _ring_plan(cfg):
    L, E = moe.num_moe_layers(cfg), cfg.moe.num_experts
    sh = placement.homogeneous_sharding(L, E, 1)
    return sparse_materialization(sh, np.ones((L, E)), t=8,
                                  m=cfg.moe.slots_per_device, impl="ring")


@pytest.mark.gpu
def test_grid_path_equals_world_size_one_path(grid):
    cfg = _cfg("float32")
    params = mdl.init_params(cfg, 0, "cuda")
    batch = _batch(cfg)
    rt1 = mdl.Runtime(use_pallas=False, moe=moe.MoERuntime(use_pallas=True))
    pa1 = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(moe.num_moe_layers(cfg),
                                       cfg.moe.num_experts, 1)), "cuda")
    m1, g1 = st.loss_and_grads(cfg, rt1, params, batch, pa1)
    plan = _ring_plan(cfg)
    assert plan.m == cfg.moe.slots_per_device
    rtg = mdl.Runtime(use_pallas=False, moe=moe.MoERuntime(
        use_pallas=True, grid=grid, impl="ring", capacity=B * S))
    ops.reset_launch_counts()
    moe.reset_collective_counts()
    mg, gg = st.loss_and_grads(cfg, rtg, params, batch,
                               moe.plan_to_arrays(plan, "cuda"))
    launched = ops.launch_counts()
    coll = moe.collective_counts()
    assert launched["grouped_mlp_dgrad"] == 2
    assert launched["grouped_mlp_wgrad"] == 2
    fwd_runs = 2 if cfg.remat else 1          # remat re-runs the forward
    assert coll["tokens_out"]["calls"] == 2 * fwd_runs
    assert coll["sprs_fsdp"]["calls"] == coll["sprs_ring"]["calls"] // plan.m \
        == 2
    assert float(mg["dropped_frac"]) == 0.0
    assert abs(float(mg["loss"]) - float(m1["loss"])) <= 1e-5 * abs(
        float(m1["loss"]))
    for (path, a), (_, b) in zip(_leaves(gg), _leaves(g1)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), path


@pytest.mark.gpu
def test_two_identical_grid_steps_are_bitwise_equal(grid):
    cfg = _cfg("bfloat16")
    rt = mdl.Runtime(use_pallas=False, moe=moe.MoERuntime(
        use_pallas=True, grid=grid, impl="ring"))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    pa = moe.plan_to_arrays(_ring_plan(cfg), "cuda")
    step = st.build_train_step(cfg, rt, tc)
    batch = _batch(cfg)
    outs = []
    for _ in range(2):
        state = st.init_state(cfg, 0, 1, "cuda", grid)
        state, metrics = step(state, batch, pa)
        outs.append(([t.clone() for _, t in _leaves(state.params)],
                      float(metrics["loss"])))
        del state
    assert outs[0][1] == outs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
