"""Serving and publication on the process grid, on the card: the grid
engine at world size 1 over a real NCCL process group.  Every test needs
a CUDA device and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve_grid_gpu.py

Full-width gpt-moe-s cut to 2 layers in f32, the ring plan from Algorithm 1
at ep = 1 and a capacity that drops nothing:

1. The grid engine's slot cache (the stacked SparseAllGather, its owned
   slots written one at a time) holds the world-size-1 builder's slots,
   bitwise; its greedy tokens through the hand-written kernels equal the
   world-size-1 engine's through the plain versions, and its first logits
   are within 1e-4; the decode steps on cached slots issue no
   SparseAllGather and launch only B1's inference form.
2. Two replicas on one host behind a ``PublicationBus``: one build per
   publication (``dedup_hits == 1``), both serving a fresh engine's
   tokens; the continuous-batching scheduler over the grid engine gives
   the world-size-1 scheduler's traces.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.schedule import sparse_materialization  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.bus import PublicationBus  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.scheduler import RequestScheduler  # noqa: E402

PROMPTS = np.asarray([[11, 7, 300, 42], [5, 9, 1000, 77]], np.int32)


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


@pytest.fixture(scope="module")
def setup(grid):
    cfg = configs.get("gpt-moe-s").replace(num_layers=2, dtype="float32")
    L, E = moe.num_moe_layers(cfg), cfg.moe.num_experts
    sh = placement.homogeneous_sharding(L, E, 1)
    ring = moe.plan_to_arrays(sparse_materialization(
        sh, np.ones((L, E)), t=8, m=cfg.moe.slots_per_device, impl="ring"),
        "cuda")
    ep = moe.plan_to_arrays(placement.ep_materialization(sh), "cuda")
    rt_grid = mdl.Runtime(moe=moe.MoERuntime(grid=grid, impl="ring",
                                             capacity=64))
    rt_plain = mdl.Runtime(use_pallas=False,
                           moe=moe.MoERuntime(use_pallas=False))
    return cfg, rt_grid, ring, rt_plain, ep


@pytest.mark.gpu
def test_grid_engine_serves_the_plain_paths_tokens(setup):
    cfg, rt, ring, rt_plain, ep = setup
    params = mdl.init_params(cfg, 0, "cuda")
    with Engine(cfg, rt, params, max_len=32, pa=ring) as eng, \
            Engine(cfg, rt_plain, params, max_len=32, pa=ep) as plain:
        moe.reset_collective_counts()
        slots = eng._materialized()
        calls = moe.collective_counts()
        kl = ring.local_rows.shape[-1]
        assert torch.equal(slots[:, :, :kl], plain._materialized())
        assert calls["spag_fsdp"]["calls"] == moe.num_moe_layers(cfg)
        ops.reset_launch_counts()
        moe.reset_collective_counts()
        got = eng.generate(PROMPTS, steps=6)
        launches = ops.launch_counts()
        assert not any(k.startswith("spag")
                       for k in moe.collective_counts())
        np.testing.assert_array_equal(got, plain.generate(PROMPTS, steps=6))
        assert launches["grouped_mlp_fwd"] > 0
        assert {k for k, v in launches.items() if v} == {"grouped_mlp_fwd"}
        with torch.inference_mode():
            tok = torch.as_tensor(PROMPTS[:, :1], device="cuda")
            a, _ = mdl.decode_step(cfg, rt, params,
                                   mdl.init_cache(cfg, 2, 32, "cuda"), tok,
                                   0, ring, premat=slots)
            b, _ = mdl.decode_step(cfg, rt_plain, params,
                                   mdl.init_cache(cfg, 2, 32, "cuda"), tok,
                                   0, ep)
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_two_same_host_replicas_and_the_scheduler_on_the_grid(setup):
    cfg, rt, ring, rt_plain, ep = setup
    p0, p1 = mdl.init_params(cfg, 0, "cuda"), mdl.init_params(cfg, 1, "cuda")
    engines = [Engine(cfg, rt, p0, max_len=32, pa=ring, name=f"r{i}")
               for i in range(2)]
    bus = PublicationBus([(e.name, e) for e in engines])
    try:
        moe.reset_collective_counts()
        bus.publish_params(p1, version=1, wait=True)
        assert bus.dedup_hits == 1
        assert moe.collective_counts()["spag_fsdp"]["calls"] == \
            moe.num_moe_layers(cfg)             # one stacked build
        outs = [e.generate(PROMPTS, steps=4) for e in engines]
    finally:
        bus.close()
        for e in engines:
            e.close()
    with Engine(cfg, rt, p1, max_len=32, pa=ring, version=1) as fresh:
        ref = fresh.generate(PROMPTS, steps=4)
    for o in outs:
        np.testing.assert_array_equal(o, ref)
    traces = []
    for r, pa in ((rt, ring), (rt_plain, ep)):
        with Engine(cfg, r, p1, max_len=32, pa=pa) as eng, \
                RequestScheduler(eng, max_slots=2, num_pages=16,
                                 page_size=8, max_kv=32) as rs:
            reqs = [rs.submit(p, max_new_tokens=5) for p in PROMPTS]
            rs.run(max_ticks=50)
            traces.append([q.output() for q in reqs])
    for a, b in zip(*traces):
        np.testing.assert_array_equal(a, b)
