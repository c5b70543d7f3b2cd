"""``tests/test_train_e2e.py``'s end-to-end laws for the port, on the CPU
with one torch intra-op thread: a dense model's loss falls, and the full
Hecate loop (predictor -> Algorithm 1 plans -> step -> observe ->
Algorithm 2 re-shard with its row movement) trains an MoE model.  That
file's other laws are held to JAX elsewhere:
``tests/test_torch_train.py::test_microbatched_step_matches_full_batch``,
``::test_expert_counts_feed_predictor`` and
``tests/test_torch_publish.py::test_generate_greedy_matches_jax``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.core.schedule import ReshardingPolicy  # noqa: E402
from repro_torch.data.pipeline import make_stream  # noqa: E402
from repro_torch.launch.inputs import make_runtime  # noqa: E402
from repro_torch.train.trainer import HecateScheduler, train_loop  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dense_loss_decreases():
    cfg = configs.get_smoke("smollm-360m")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60)
    stream = make_stream(cfg.vocab_size, 32, 8, kind="bytes", seed=0)
    _, hist = train_loop(cfg, make_runtime(cfg, None), tc, stream,
                         num_steps=60, log_every=0, device="cpu")
    first = np.mean([h["xent"] for h in hist[:5]])
    last = np.mean([h["xent"] for h in hist[-5:]])
    assert last < first - 0.5, (first, last)


def test_moe_fssdp_loop_with_resharding():
    cfg = configs.get_smoke("gpt-moe-s")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=50)
    sched = HecateScheduler(cfg, ep=1, impl="ep", device="cpu",
                            resharding=ReshardingPolicy(interval=20, t=2))
    stream = make_stream(cfg.vocab_size, 32, 8, kind="bytes", seed=1)
    _, hist = train_loop(cfg, make_runtime(cfg, None), tc, stream,
                         scheduler=sched, num_steps=50, log_every=0,
                         device="cpu")
    sched.close()
    first = np.mean([h["xent"] for h in hist[:5]])
    last = np.mean([h["xent"] for h in hist[-5:]])
    assert last < first - 0.3, (first, last)
    assert len(sched.predictor.history) == 5       # window respected
