"""Checkpoints and dropped states on the card.  Every test needs a CUDA
device and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_checkpoint_gpu.py

1. ROADMAP C15: full-width gpt-moe-s cut to 2 layers, a plain step and a
   step on a world-size-1 NCCL grid, each the first of its kind in a fresh
   interpreter (``tools/state_cycle_probe.py``): with the garbage
   collector off, dropping the state and the step's outputs lowers
   ``torch.cuda.memory_allocated`` by at least the state's bytes.
2. A state on the card saved with ``save_train_state`` and restored with
   ``resume_train_state`` comes back on the card, in each leaf's dtype,
   bit for bit, and so does the scheduler's ShardingPlan.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as configs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_dropped_state_frees_device_memory_without_the_collector(cuda):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "state_cycle_probe.py"), "--device", "cuda",
        "--layers", "2", "--batch", "1", "--seq", "256"], env=env,
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    found = re.findall(r"state ([\d.]+) GB; the drop freed ([\d.]+) GB",
                       r.stdout)
    assert len(found) == 5, r.stdout
    for state_gb, freed_gb in found:
        assert float(freed_gb) >= float(state_gb) > 4.0


@pytest.mark.gpu
def test_train_state_round_trip_on_the_card(cuda, tmp_path):
    cfg = configs.get_smoke("gpt-moe-s")
    sched = trainer.HecateScheduler(cfg, ep=1, impl="ring", device="cuda")
    sched.plan_arrays()
    state = st.init_state(cfg, 0, 1, cuda)
    state.opt.mu["moe_buffer"].add_(1.0)
    tc = TrainConfig(checkpoint_dir=str(tmp_path), keep_checkpoints=1)
    trainer.save_train_state(tc, 3, state._replace(
        step=state.step + 3), sched)
    sched2 = trainer.HecateScheduler(cfg, ep=1, impl="ring", device="cuda")
    back, at = trainer.resume_train_state(cfg, tc, sched2, 1, device=cuda)
    assert at == 3 and int(back.step) == 3
    want = dict(store._walk(trainer._state_tree(state)))
    for k, t in store._walk(trainer._state_tree(back)):
        if k == "step":
            continue
        assert t.device == want[k].device and t.dtype == want[k].dtype, k
        assert torch.equal(t, want[k]), k
    assert (sched2.sharding.owner_row == sched.sharding.owner_row).all()
