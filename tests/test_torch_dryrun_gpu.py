"""On the card: the paged decode's gather path launches no paged-attention
kernel, and the dry run touches no card.  Every test needs a CUDA device
and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import ShapeConfig  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.kv_pool import PageTable  # noqa: E402

PAGE, MAX_KV = 4, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_paged_attn_kernel_off_launches_no_paged_kernel(cuda):
    """The same paged decode step with ``cfg.paged_attn_kernel`` on and
    off: on, B5 launches once per attention layer; off, never, and the
    gather path's logits lie within f32 noise of the kernel's."""
    cfg = configs.get_smoke("gpt-moe-s").replace(dtype="float32")
    params = mdl.init_params(cfg, 0, cuda)
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(moe.num_moe_layers(cfg),
                                       cfg.moe.num_experts, 1)), cuda)
    row_idx = torch.as_tensor(PageTable(PAGE, MAX_KV, [1, 2, 3, 4])
                              .row_idx()[None], device=cuda)
    tok = torch.tensor([[5]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([3], dtype=torch.int32, device=cuda)
    out = {}
    for on in (True, False):
        c = cfg.replace(paged_attn_kernel=on)
        cache = mdl.init_paged_cache(c, 1, 5 * PAGE, cuda)
        ops.reset_launch_counts()
        with torch.no_grad():
            out[on], _ = mdl.decode_step(c, mdl.Runtime(), params, cache,
                                         tok, pos, pa, row_idx=row_idx,
                                         page_size=PAGE)
        torch.cuda.synchronize()
        n = ops.launch_counts()["paged_decode_attention"]
        assert n == (cfg.num_layers if on else 0), (on, n)
    err = (out[True] - out[False]).abs().max() / out[False].abs().max()
    assert err < 1e-5


@pytest.mark.gpu
def test_dry_run_allocates_nothing_on_the_card(cuda):
    cfg = configs.get_smoke("gpt-moe-s")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    rec = dryrun.dryrun_combo(cfg, ShapeConfig("small", 32, 2, "train"),
                              grid=(1, 1))
    torch.cuda.synchronize()
    assert rec["status"] == "ok"
    assert torch.cuda.memory_allocated() == before
    assert not any(ops.launch_counts().values())


@pytest.mark.gpu
def test_one_rank_of_a_tp_grid_launches_the_kernels_at_its_shapes(cuda):
    """Rank 0 of a fake 2 x 4 grid under ``tp`` on real tensors on the
    card (the fake group moves no data, so no value is held): qwen1.5's
    smoke config, whose 2 KV heads do not divide ``model``, prefills
    through the flash kernel once a layer at the rank's 1 query head over
    its 1 KV head, and every output stays on the card."""
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.mesh import fake_grid
    from repro_torch.serve.engine import build_prefill_step
    cfg = configs.get_smoke("qwen1.5-110b").replace(dtype="bfloat16")
    shape = ShapeConfig("small_prefill", 64, 4, "prefill")
    with fake_grid(2, 4) as g:
        lay = inp.make_layout(cfg, shape, g, "tp")
        params = mdl.shard_params(mdl.init_params(cfg, 0, cuda), g, lay)
        toks = torch.randint(0, cfg.vocab_size, (4, 64), device=cuda,
                             dtype=torch.int32)
        step = build_prefill_step(cfg, inp.make_runtime(
            cfg, g, layout=lay, use_pallas=True))
        ops.reset_launch_counts()
        last, cache = step(params, {"tokens": lay.local_rows(toks)}, None)
        torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == cfg.num_layers
    assert last.shape == (2, 1, cfg.vocab_size // 4) and last.is_cuda
    assert cache["l0"]["k"].shape == (cfg.num_layers, 2, 64, 1,
                                      cfg.head_dim)
    assert all(t.is_cuda for c in cache.values() for t in c.values())
