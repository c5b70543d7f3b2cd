"""The port's training metrics against the JAX package's, on the CPU: the
counterparts of ``tests/test_metrics_distributed_glue.py``'s metric
cases.  ``expert_stats`` and ``device_stats`` give the JAX package's
values on the same counts and loads; ``MetricLogger`` writes the same
JSONL records for the same metrics (but the wall-clock fields); and
``train_loop(metric_logger=)`` on smoke gpt-moe-s writes one record a
step with the load-balance fields, whose first-step values match JAX's
within 1e-5 from the same weights and batches."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.train import metrics as jmetrics  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import metrics  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

CLOCK = ("time_s", "tokens_per_s")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many do, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("counts", [
    [[100.0, 100, 100, 100], [400, 0, 0, 0]],
    np.random.default_rng(0).integers(0, 50, (3, 8)).tolist()])
def test_expert_stats(counts):
    """One uniform and one peaked layer (entropy fraction near 0.5,
    imbalance 4), and random counts: the JAX package's values."""
    got, want = metrics.expert_stats(counts), jmetrics.expert_stats(counts)
    assert got == want
    if counts[0][0] == 100.0:
        assert 0.4 < got["expert_entropy_frac"] < 0.6
        assert got["expert_imbalance_max"] == 4.0


def test_device_stats():
    loads = np.array([[10.0, 10, 10, 50]])
    assert metrics.device_stats(loads) == jmetrics.device_stats(loads)
    assert metrics.device_stats(loads)["device_straggler_factor"] == 2.5


def test_metric_logger_jsonl(tmp_path):
    """The same records, on disk and returned, as the JAX package's logger
    for the same metrics, a window of the loss included."""
    recs = []
    for mod, loss in ((metrics, torch.tensor(2.0)), (jmetrics,
                                                      jnp.float32(2.0))):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        ml = mod.MetricLogger(path, window=2, tokens_per_step=1024)
        out = [ml.log(i, {"loss": loss * (i + 1),
                          "expert_counts": np.ones((2, 4)),
                          "device_loads": np.ones((2, 2))})
               for i in range(3)]
        ml.close()
        on_disk = [json.loads(line) for line in open(path)]
        assert on_disk == out
        recs.append([{k: v for k, v in r.items() if k not in CLOCK}
                     for r in out])
    assert recs[0] == recs[1]
    assert recs[0][0]["loss"] == 2.0 and recs[0][2]["loss_avg"] == 5.0
    assert recs[0][0]["expert_entropy_frac"] > 0.99


def test_train_loop_with_metric_logger(tmp_path):
    """``train_loop(metric_logger=)`` writes one JSONL record a step with
    the load-balance fields and merges it into the history, as the JAX
    package's does; from the same weights and batches the first step's
    loss and expert statistics match JAX's within 1e-5."""
    jcfg, cfg = jconfigs.get_smoke("gpt-moe-s"), configs.get_smoke(
        "gpt-moe-s")
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=4)
    out = []
    for pkg in ("port", "jax"):
        path = str(tmp_path / f"{pkg}.jsonl")
        if pkg == "port":
            ml = metrics.MetricLogger(path, tokens_per_step=4 * 16)
            _, hist = trainer.train_loop(
                cfg, mdl.Runtime(use_pallas=False), TrainConfig(**kw),
                pipeline.make_stream(cfg.vocab_size, 16, 4, seed=0),
                scheduler=trainer.HecateScheduler(cfg, ep=1, impl="ep",
                                                  device="cpu"),
                state=st.TrainState(params, adamw.init(params),
                                    torch.zeros((), dtype=torch.int32)),
                num_steps=4, log_every=0, metric_logger=ml, device="cpu")
        else:
            ml = jmetrics.MetricLogger(path, tokens_per_step=4 * 16)
            _, hist = jtrainer.train_loop(
                jcfg, jmdl.Runtime(), JTrainConfig(**kw),
                jpipeline.make_stream(jcfg.vocab_size, 16, 4, seed=0),
                scheduler=jtrainer.HecateScheduler(jcfg, ep=1, impl="ep"),
                num_steps=4, log_every=0, metric_logger=ml)
        ml.close()
        recs = [json.loads(line) for line in open(path)]
        assert len(recs) == 4 and "device_straggler_factor" in recs[0]
        assert all(h["loss_avg"] == r["loss_avg"]
                   for h, r in zip(hist, recs))
        out.append((recs, hist))
    (recs, hist), (jrecs, jhist) = out
    assert set(recs[0]) == set(jrecs[0])
    assert set(hist[0]) == set(jhist[0])
    for k in ("loss", "xent", "expert_entropy_frac", "expert_imbalance_max",
              "device_straggler_factor"):
        np.testing.assert_allclose(recs[0][k], jrecs[0][k], rtol=1e-5,
                                   err_msg=k)
