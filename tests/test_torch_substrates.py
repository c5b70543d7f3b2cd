"""``tests/test_substrates.py``'s optimizer laws and
``tests/test_metrics_distributed_glue.py``'s single-process glue for the
port (no JAX: these are laws, not comparisons).  The rest of those files
is held elsewhere: checkpoints in ``tests/test_torch_checkpoint.py`` and
``tests/test_torch_fault_tolerance.py``, the streams in
``tests/test_torch_train.py::test_lm_stream_matches_jax`` and
``tests/test_torch_train_distributed.py``, the reshard permutation in
``tests/test_torch_reshard.py``, the metrics in
``tests/test_torch_metrics.py``."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import make_stream  # noqa: E402
from repro_torch.launch.distributed import (host_stream,  # noqa: E402
                                            process_info)
from repro_torch.optim import adamw  # noqa: E402


def test_adamw_drives_a_quadratic_to_its_optimum():
    tc = TrainConfig(learning_rate=0.05, weight_decay=0.0, warmup_steps=0,
                     total_steps=10_000, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(300):
        g = {"w": 2 * params["w"]}                  # d/dw w^2
        params, state, _ = adamw.update(g, state, params, tc)
    assert float(params["w"].abs().max()) < 0.25


def test_adamw_grad_clip_and_lr_schedule():
    tc = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                     grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    _, _, m = adamw.update({"w": torch.full((3,), 100.0)}, state, params, tc)
    assert float(m["grad_norm"]) > 1.0
    # warm-up: the first step's rate is a tenth of the peak
    assert float(m["lr"]) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("seed", range(20))
def test_adamw_step_is_bounded(seed):
    """|Δw| <= lr on the bias-corrected first step, without decay (the
    reference's property, on seeded draws in its range)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-10, 10, int(rng.integers(1, 9))).astype(np.float32)
    tc = TrainConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=0,
                     grad_clip=0.0)
    w = torch.from_numpy(vals)
    params = {"w": w.clone()}
    state = adamw.init(params)
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        len(vals)).astype(np.float32))}
    new, _, _ = adamw.update(g, state, params, tc)
    assert float((new["w"] - w).abs().max()) <= 0.1 * 1.05


def test_single_process_glue_degrades():
    """Without a process group the glue reports one process and a host
    stream gives the whole batch."""
    info = process_info()
    assert info["world_size"] == 1 and info["rank"] == 0
    it = host_stream(make_stream, vocab_size=100, seq_len=8, global_batch=4)
    assert next(it)["tokens"].shape == (4, 9)
