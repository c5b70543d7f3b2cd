"""Publication on the card: the ordering that CUDA streams add to the
engine's (plan, version) state machine.  Every test needs a CUDA device
and skips without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_publish_gpu.py

1. The background builder issues a publication's slot build on a stream of
   its own; the promotion at a step boundary does not wait for it on the
   host, and the first decode step after it reads the new slots only
   after the build's event: the tokens equal a fresh engine's even while
   the build is held on the device.
2. ``train_loop`` publishes a snapshot: the AdamW step that follows
   updates the parameters in place and leaves the served tree and tokens
   as they were.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import _leaves  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.moe import MoERuntime  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

PROMPTS = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
HOLD_CYCLES = 2_000_000_000     # ~1 s of one SM's clock


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _smoke(dev):
    cfg = configs.get_smoke("gpt-moe-s")
    L = moe.num_moe_layers(cfg)
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), dev)
    return cfg, pa


@pytest.mark.gpu
def test_promotion_waits_for_the_build_event_on_a_side_stream(cuda):
    cfg, pa = _smoke(cuda)
    params, params2 = mdl.init_params(cfg, 0, cuda), mdl.init_params(cfg, 1,
                                                                     cuda)
    with engine.Engine(cfg, mdl.Runtime(), params2, max_len=32, pa=pa,
                       version=1) as fresh:
        want = fresh.generate(PROMPTS, steps=4)
    with engine.Engine(cfg, mdl.Runtime(), params, max_len=32,
                       pa=pa) as eng:
        eng.generate(PROMPTS, steps=1)
        orig, streams = eng._build_slots, []

        def held_build(pa_, buf):
            # the build waits ~1 s on the device before it writes the slots
            torch.cuda._sleep(HOLD_CYCLES)
            streams.append(torch.cuda.current_stream())
            return orig(pa_, buf)
        eng._build_slots = held_build
        eng.publish_params(params2, wait=True)     # issued, not finished
        _, done = eng._staged["fut"].result()
        assert streams[0] != torch.cuda.current_stream()
        assert not done.query()
        eng._step_boundary()                       # the host does not wait
        assert eng.version == 1 and eng.params is params2
        assert not done.query()
        got = eng.generate(PROMPTS, steps=4)
        assert done.query()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_published_snapshot_is_not_changed_by_a_later_in_place_step(cuda):
    cfg, pa = _smoke(cuda)
    rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(use_pallas=True))
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=4)
    stream = pipeline.make_stream(cfg.vocab_size, 32, 8, kind="bytes",
                                  seed=0)
    state = st.init_state(cfg, 0, device=cuda)
    sched = trainer.HecateScheduler(cfg, device=str(cuda))
    with engine.Engine(cfg, mdl.Runtime(), mdl.init_params(cfg, 0, cuda),
                       max_len=32, pa=pa) as eng:
        state, _ = trainer.train_loop(cfg, rt, tc, stream, scheduler=sched,
                                      state=state, num_steps=2, log_every=0,
                                      device=cuda, publish_engine=eng,
                                      publish_every=2)
        eng.flush()
        assert eng.version == 2
        served = [t.clone() for _, t in _leaves(eng.params)]
        out = eng.generate(PROMPTS, steps=4)
        live = state.params["moe_buffer"]
        before = live.clone()
        state, _ = trainer.train_loop(cfg, rt, tc, stream, scheduler=sched,
                                      state=state, num_steps=1, log_every=0,
                                      device=cuda)
        assert state.params["moe_buffer"] is live
        assert not torch.equal(live, before)       # updated in place
        np.testing.assert_array_equal(eng.generate(PROMPTS, steps=4), out)
        assert all(torch.equal(a, b) for a, (_, b) in
                   zip(served, _leaves(eng.params)))
