"""The port's single-device training path against the JAX package on the
CPU: AdamW, the chunked loss and its gradients, the train step (with and
without gradient accumulation), a 10-step Hecate loop, the data stream,
the load predictor and the launcher.

gpt-moe-s smoke (2 layers, d_model 128, 4 experts, f32).  JAX initializes
the parameters, the weight bridge carries them over, and numpy makes every
other input from a seed.  JAX trains mesh-less (``Runtime()``: XLA
attention and the dense MoE oracle); the port runs its plain attention and
its sort-based MoE layer through ``GroupedMLPFunction`` with the plain
stages.  Tolerances, relative to each tensor's largest entry:

* 1e-6 for AdamW on the same inputs (the same arithmetic);
* 1e-5 for losses, 5e-4 for gradients of the whole model.  Both packages
  sum in f32 in other orders, and against a float64 run each package's
  f32 gradients lie some 1e-4 of the largest entry off;
* after one AdamW step, 0.1·lr per parameter element: AdamW moves each
  element by about lr·sign(g), so an element whose gradient is at the f32
  noise floor may move differently in the two packages;
* the 10-step trajectory: see ``test_train_loop_trajectory_matches_jax``.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jst  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common import faults  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import (params_from_jax,  # noqa: E402
                                       params_to_numpy)
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCH = "gpt-moe-s"
TRAIN_RT = dict(use_pallas=False)


def _np(a):
    return np.asarray(a.detach().float().numpy()
                      if isinstance(a, torch.Tensor) else a, np.float32)


def _close(got, want, tol):
    """Within ``tol`` of the largest entry of ``want``, for each tensor on
    its own scale."""
    want = _np(want)
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=0)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _close_trees(got, want, tol):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for k in w:
        try:
            _close(g[k], w[k], tol)
        except AssertionError as e:
            raise AssertionError(f"leaf {k}: {e}") from None


def _setup_of(arch):
    jcfg = jconfigs.get_smoke(arch)
    cfg = configs.get_smoke(arch)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    L = jmoe.num_moe_layers(jcfg)
    jpa = jmoe.plan_to_arrays(jplacement.ep_materialization(
        jplacement.homogeneous_sharding(L, jcfg.moe.num_experts, 1)))
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_tree=np_tree,
                jpa=jpa, pa=pa)


@pytest.fixture(scope="module")
def setup():
    return _setup_of(ARCH)


def _params(setup):
    """A fresh copy of the JAX-initialized parameters in the port."""
    return params_from_jax(setup["np_tree"], "cpu")


def _batch(cfg, seed, b=4, s=16):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (4, 2, 3)}, "e": (11,)}

    def mk(s):
        if isinstance(s, dict):
            return {k: mk(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return mk(shapes)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    if isinstance(t, dict):
        return {k: _ttree(v) for k, v in t.items()}
    return torch.from_numpy(t.copy())


def test_adamw_updates_match_jax():
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                     grad_clip=0.5)
    jtc = JTrainConfig(**dataclasses.asdict(tc))
    p = _opt_tree(0)
    jp, tp = _jtree(p), _ttree(p)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for i in range(4):
        g = _opt_tree(10 + i)
        jp, js, jm = jadamw.update(_jtree(g), js, jp, jtc,
                                   skip_nonfinite=True)
        tp, ts, tm = adamw.update(_ttree(g), ts, tp, tc,
                                  skip_nonfinite=True)
        _close_trees(tp, jax.tree.map(np.asarray, jp), 1e-6)
        _close_trees(ts.mu, jax.tree.map(np.asarray, js.mu), 1e-6)
        _close_trees(ts.nu, jax.tree.map(np.asarray, js.nu), 1e-6)
        assert int(ts.count) == int(js.count) == i + 1
        for k in ("grad_norm", "lr", "step_ok"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    for step in (0, 1, 2, 5, 9):
        np.testing.assert_allclose(
            float(adamw.lr_schedule(tc, step)),
            float(jadamw.lr_schedule(jtc, jnp.asarray(step))), rtol=1e-6)


def test_adamw_skip_is_bit_exact():
    """A NaN gradient (or a false extra_ok) leaves params and moments
    bit-identical and the count where it was, as in JAX."""
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1)
    tp = _ttree(_opt_tree(1))
    ts = adamw.init(tp)
    tp, ts, _ = adamw.update(_ttree(_opt_tree(2)), ts, tp, tc,
                             skip_nonfinite=True)
    before = [t.clone() for t in adamw.leaves(tp) + adamw.leaves(ts.mu)
              + adamw.leaves(ts.nu)]
    bad = _ttree(_opt_tree(3))
    bad["b"]["c"][1] = float("nan")
    for grads, extra in ((bad, None),
                         (_ttree(_opt_tree(4)), torch.tensor(False))):
        tp, ts, m = adamw.update(grads, ts, tp, tc, skip_nonfinite=True,
                                 extra_ok=extra)
        after = adamw.leaves(tp) + adamw.leaves(ts.mu) + adamw.leaves(ts.nu)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert int(ts.count) == 1 and float(m["step_ok"]) == 0.0
    jtc = JTrainConfig(learning_rate=1e-2, warmup_steps=1)
    jp = _jtree(_opt_tree(1))
    js = jadamw.init(jp)
    jp, js, _ = jadamw.update(_jtree(_opt_tree(2)), js, jp, jtc,
                              skip_nonfinite=True)
    jbad = _opt_tree(3)
    jbad["b"]["c"][1] = np.nan
    jp2, js2, _ = jadamw.update(_jtree(jbad), js, jp, jtc,
                                skip_nonfinite=True)
    _close_trees(tp, jax.tree.map(np.asarray, jp2), 1e-6)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,tied", [(None, True), (30_592, True),
                                        (49_155, True), (50_304, False)],
                         ids=["smoke", "bert-moe", "granite", "olmoe"])
def test_chunked_xent_matches_jax_and_plain_xent(setup, vocab, tied):
    """The smoke vocabulary, and bert-moe's, granite's (odd) and olmoe's
    (untied: the ``unembed`` matrix) at the smoke width."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rng = np.random.default_rng(3)
    if vocab is None:
        emb = {"embedding": setup["np_tree"]["embed"]["embedding"]}
    else:
        cfg, jcfg = (c.replace(vocab_size=vocab, tie_embeddings=tied)
                     for c in (cfg, jcfg))
        emb = {"embedding": rng.standard_normal(
            (vocab, cfg.d_model)).astype(np.float32) * 0.02}
        if not tied:
            emb["unembed"] = rng.standard_normal(
                (cfg.d_model, vocab)).astype(np.float32) * 0.02
    h = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    lab = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lab[0, :5] = -1                                   # ignored positions

    def jl(hh, e):
        return jst.chunked_xent(jcfg, e, hh, jnp.asarray(lab))
    jv, (jgh, jge) = jax.value_and_grad(jl, argnums=(0, 1))(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in emb.items()})
    th = torch.from_numpy(h).requires_grad_(True)
    te = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in emb.items()}
    tv = st.chunked_xent(cfg, te, th, torch.from_numpy(lab))
    tv.backward()
    _close(tv, jv, 1e-5)
    _close(th.grad, jgh, 1e-5)
    for k in emb:          # untied: the embedding gets no gradient here
        if te[k].grad is None:
            assert k == "embedding" and not tied and not np.asarray(
                jge[k]).any()
        else:
            _close(te[k].grad, jge[k], 1e-5)
    w = te["unembed"] if "unembed" in te else te["embedding"].t()
    full = st.cross_entropy(th @ w, torch.from_numpy(lab))
    _close(full, jv, 1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_grads_match_jax(setup, remat):
    """Loss, its terms, the routing metrics and the gradient of every
    parameter against ``jax.value_and_grad`` of the JAX loss (mesh-less
    Runtime).  ``remat`` runs the port's superblocks under checkpoint."""
    cfg, jcfg = setup["cfg"].replace(remat=remat), setup["jcfg"]
    jb, tb = _batch(cfg, 4)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jst.loss_fn(jcfg, jmdl.Runtime(), p, jb, setup["jpa"]),
        has_aux=True)(setup["jparams"])
    tm, tg = st.loss_and_grads(cfg, mdl.Runtime(**TRAIN_RT), _params(setup),
                               tb, setup["pa"])
    for k in ("loss", "xent", "aux_loss", "z_loss"):
        _close(tm[k], jm[k], 1e-5)
    np.testing.assert_array_equal(_np(tm["expert_counts"]),
                                  np.asarray(jm["expert_counts"]))
    assert float(tm["dropped_frac"]) == float(jm["dropped_frac"]) == 0.0
    np.testing.assert_array_equal(_np(tm["device_loads"]),
                                  np.asarray(jm["device_loads"]))
    # the port's layer runs the grouped FFN over a padded (E, T) buffer, so
    # it reports its real padding fraction; JAX's dense oracle reports 0
    assert 0.0 < float(tm["pad_frac"]) < 1.0
    _close_trees(tg, jax.tree.map(np.asarray, jg), 5e-4)


def _full_width_jax_grads(jcfg, jpa, jb):
    """(loss, params, grads) of JAX's loss at JAX's init, as numpy copies,
    so that no JAX buffer outlives the call."""
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    # jitted, so that XLA reuses buffers: op by op the 1-layer gpt-moe-l
    # case peaked at 17 GB of host memory
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jst.loss_fn(jcfg, jmdl.Runtime(), p, jb, jpa),
        has_aux=True))(jparams)
    return (float(jloss), jax.tree.map(np.array, jparams),
            jax.tree.map(np.array, jg))


@pytest.mark.parametrize("arch,layers,b,widths", [
    (ARCH, 2, 2, (768, 64, 2, 1536, 50_304)),
    ("gpt-moe-l", 1, 1, (1536, 64, 2, 3072, 50_304)),
    ("olmoe-1b-7b", 1, 1, (2048, 64, 8, 1024, 50_304))],
    ids=[ARCH, "gpt-moe-l", "olmoe-1b-7b"])
def test_full_width_two_layers_loss_and_grads_match_jax(arch, layers, b,
                                                        widths):
    """Full width (d_model, experts, top-k, expert d_ff, vocab) cut in
    depth, f32, batch ``b`` x 128: the loss and every gradient leaf against
    ``jax.value_and_grad`` of the JAX loss, from JAX's init.  gpt-moe-s at
    2 layers; gpt-moe-l (d_model 1,536, 16 heads of 96) and olmoe (d_model
    2,048, 16 heads of 128, GLU experts with SiLU at top-8, RMS norm,
    untied embeddings) at 1 layer, batch 1."""
    jcfg = jconfigs.get(arch).replace(num_layers=layers, dtype="float32")
    cfg = configs.get(arch).replace(num_layers=layers, dtype="float32")
    assert (cfg.d_model, cfg.moe.num_experts, cfg.moe.experts_per_token,
            cfg.moe.d_ff, cfg.vocab_size) == widths
    L = jmoe.num_moe_layers(jcfg)
    jpa = jmoe.plan_to_arrays(jplacement.ep_materialization(
        jplacement.homogeneous_sharding(L, jcfg.moe.num_experts, 1)))
    pa = moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")
    jb, tb = _batch(cfg, 12, b=b, s=128)
    jloss, np_params, jg = _full_width_jax_grads(jcfg, jpa, jb)
    params = params_from_jax(np_params, "cpu")
    del np_params
    tm, tg = st.loss_and_grads(cfg, mdl.Runtime(**TRAIN_RT), params, tb, pa)
    _close(tm["loss"], jloss, 1e-5)
    got, want = dict(_flat(tg)), dict(_flat(jg))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        # _close's criterion, a block of rows at a time: the expert buffer's
        # gradient has 302M (gpt-moe-s) to 604M (gpt-moe-l) entries
        g, w = _np(got[k]).reshape(-1), w.reshape(-1)
        scale = max(1e-12, float(np.abs(w).max()))
        for i in range(0, w.size, 1 << 22):
            np.testing.assert_allclose(g[i:i + (1 << 22)], w[i:i + (1 << 22)],
                                       atol=5e-4 * scale, rtol=0,
                                       err_msg=f"leaf {k}")


def test_remat_gives_the_same_gradients(setup):
    cfg = setup["cfg"]
    _, tb = _batch(cfg, 5)
    rt = mdl.Runtime(**TRAIN_RT)
    m0, g0 = st.loss_and_grads(cfg, rt, _params(setup), tb, setup["pa"])
    m1, g1 = st.loss_and_grads(cfg.replace(remat=True), rt, _params(setup),
                               tb, setup["pa"])
    assert float(m0["loss"]) == float(m1["loss"])
    _close_trees(g1, g0, 1e-6)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def test_train_step_matches_jax(setup):
    """One step: loss, metrics and every updated parameter and moment."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jtc = JTrainConfig(**dataclasses.asdict(tc))
    jb, tb = _batch(cfg, 6)
    js = jst.TrainState(setup["jparams"], jadamw.init(setup["jparams"]),
                        jnp.zeros((), jnp.int32))
    js, jm = jax.jit(jst.build_train_step(jcfg, jmdl.Runtime(), jtc))(
        js, jb, setup["jpa"])
    params = _params(setup)
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    ts, tm = st.build_train_step(cfg, mdl.Runtime(**TRAIN_RT), tc)(
        ts, tb, setup["pa"])
    for k in ("loss", "xent", "grad_norm", "lr", "step_ok"):
        _close(tm[k], jm[k], 1e-5)
    assert int(ts.step) == int(js.step) == 1
    got, want = dict(_flat(ts.params)), dict(_flat(js.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=0.1 * tc.learning_rate, rtol=0,
                                   err_msg=k)
    # the first moment is (1 - beta1)·g: the gradient tolerance
    _close_trees(ts.opt.mu, jax.tree.map(np.asarray, js.opt.mu), 5e-4)


@pytest.mark.parametrize("arch", [ARCH, "olmoe-1b-7b"])
def test_microbatched_step_matches_full_batch(setup, arch):
    """microbatch=4 against one full batch: the aux loss is off, since the
    load-balance term of a batch is not the mean of its microbatches'.
    Also olmoe's smoke config: GLU experts with SiLU, RMS norm, untied
    embeddings."""
    if arch != ARCH:
        setup = _setup_of(arch)
    cfg = setup["cfg"]
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, aux_loss_weight=0.0))
    _, tb = _batch(cfg, 7, b=8)
    rt = mdl.Runtime(**TRAIN_RT)
    out = {}
    for n in (1, 4):
        params = _params(setup)
        tc = TrainConfig(microbatch=n, learning_rate=1e-3, warmup_steps=1)
        s0 = st.TrainState(params, adamw.init(params),
                           torch.zeros((), dtype=torch.int32))
        out[n] = st.build_train_step(cfg, rt, tc)(s0, tb, setup["pa"])
    (s1, m1), (s4, m4) = out[1], out[4]
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    np.testing.assert_array_equal(_np(m1["expert_counts"]),
                                  _np(m4["expert_counts"]))
    # the accumulated gradient, through the first moment (1 - beta1)·g
    _close_trees(s4.opt.mu, params_to_numpy(s1.opt.mu), 1e-5)
    # AdamW moves each element by about lr·sign(g): 0.01·lr per element
    for (k, a), (_, b) in zip(_flat(s4.params), _flat(s1.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=0.01 * 1e-3, rtol=0,
                                   err_msg=k)


def test_expert_counts_feed_predictor():
    """``tests/test_train_e2e.py::test_expert_counts_feed_predictor`` on
    olmoe's smoke config: one step's expert counts are (MoE layers,
    experts) and count every (token, k) assignment once, as JAX's; two
    steps of the Hecate loop hand them to the load predictor, whose
    prediction is their mean."""
    su = _setup_of("olmoe-1b-7b")
    cfg, jcfg = su["cfg"], su["jcfg"]
    jb, tb = _batch(cfg, 3, b=4, s=16)
    js = jst.init_state(jcfg, jax.random.PRNGKey(0))
    _, jm = jax.jit(jst.build_train_step(jcfg, jmdl.Runtime(),
                                         JTrainConfig()))(js, jb, su["jpa"])
    params = _params(su)
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    _, tm = st.build_train_step(cfg, mdl.Runtime(**TRAIN_RT),
                                TrainConfig())(ts, tb, su["pa"])
    counts = _np(tm["expert_counts"])
    L = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert counts.shape == (L, cfg.moe.num_experts)
    np.testing.assert_array_equal(counts.sum(axis=1),
                                  4 * 16 * cfg.moe.experts_per_token)
    np.testing.assert_array_equal(counts, np.asarray(jm["expert_counts"]))

    sched = trainer.HecateScheduler(cfg, ep=1, impl="ep", device="cpu")
    trainer.train_loop(
        cfg, mdl.Runtime(**TRAIN_RT), TrainConfig(),
        pipeline.make_stream(cfg.vocab_size, 16, 4, seed=3),
        scheduler=sched, num_steps=2, log_every=0, device="cpu")
    seen = sched.predictor.history
    assert len(seen) == 2 and all(
        h.shape == (L, cfg.moe.num_experts)
        and (h.sum(axis=1) == 4 * 16 * cfg.moe.experts_per_token).all()
        for h in seen)
    np.testing.assert_allclose(sched.predictor.predict(),
                               (seen[0] + seen[1]) / 2)


def test_fault_poisoned_step_is_skipped_and_loop_aborts(setup):
    """``train.nan_grads``: a poisoned step leaves the parameters
    bit-identical and counts as skipped; max_bad_steps in a row abort."""
    cfg = setup["cfg"]
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                     max_bad_steps=2)
    stream = pipeline.make_stream(cfg.vocab_size, 16, 4, seed=0)
    params = _params(setup)
    s0 = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    snaps = []
    sched = trainer.HecateScheduler(cfg, device="cpu")
    with faults.injected("train.nan_grads", mutate=faults.poison_grads,
                         after=1, times=1):
        state, hist = trainer.train_loop(
            cfg, mdl.Runtime(**TRAIN_RT), tc, stream, scheduler=sched,
            state=s0, num_steps=3, log_every=0, device="cpu",
            callback=lambda i, s, m: snaps.append(
                params_to_numpy(s.params)))
    assert [h["step_ok"] for h in hist] == [1.0, 0.0, 1.0]
    assert hist[-1]["skipped_steps"] == 1
    for a, b in zip(_flat(snaps[0]), _flat(snaps[1])):
        np.testing.assert_array_equal(a[1], b[1])
    with faults.injected("train.nan_grads", mutate=faults.poison_grads,
                         times=None):
        with pytest.raises(trainer.TrainAbortError) as ei:
            trainer.train_loop(cfg, mdl.Runtime(**TRAIN_RT), tc, stream,
                               scheduler=trainer.HecateScheduler(
                                   cfg, device="cpu"),
                               state=state, num_steps=4, log_every=0,
                               device="cpu")
    assert len(ei.value.history) == 2
    assert ei.value.history[-1]["skipped_steps"] == 2


# ---------------------------------------------------------------------------
# the Hecate loop
# ---------------------------------------------------------------------------
def test_train_loop_trajectory_matches_jax(setup):
    """10 steps of the Hecate loop with the ep plan, from the same weights
    and the same byte stream.

    The first two steps agree within 1e-5 relative and route every token
    alike.  From the third step on, the top-2 gate flips the expert of a
    few tokens whose two best logits lie within the packages' f32
    difference (a handful of the 512 choices a step), and the two runs
    part like two training runs with different noise: every step within
    3% relative, with the total of each step's routed tokens
    equal and the loss falling in both."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10)
    jtc = JTrainConfig(**dataclasses.asdict(tc))
    js = jst.TrainState(setup["jparams"], jadamw.init(setup["jparams"]),
                        jnp.zeros((), jnp.int32))
    jsched = jtrainer.HecateScheduler(jcfg, ep=1, impl="ep")
    jc, tcounts = [], []
    _, jh = jtrainer.train_loop(
        jcfg, jmdl.Runtime(), jtc,
        jpipeline.make_stream(jcfg.vocab_size, 32, 8, kind="bytes", seed=1),
        scheduler=jsched, state=js, num_steps=10, log_every=0,
        callback=lambda i, s, m: jc.append(np.asarray(m["expert_counts"])))
    params = _params(setup)
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    sched = trainer.HecateScheduler(cfg, ep=1, impl="ep", device="cpu")
    _, th = trainer.train_loop(
        cfg, mdl.Runtime(**TRAIN_RT), tc,
        pipeline.make_stream(cfg.vocab_size, 32, 8, kind="bytes", seed=1),
        scheduler=sched, state=ts, num_steps=10, log_every=0, device="cpu",
        callback=lambda i, s, m: tcounts.append(m["expert_counts"]))
    jl = np.asarray([h["loss"] for h in jh])
    tl = np.asarray([h["loss"] for h in th])
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=3e-2)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    assert [h["step_ok"] for h in th] == [1.0] * 10
    for a, b in zip(tcounts[:2], jc[:2]):
        np.testing.assert_array_equal(a, b)
    # the predictors saw windows of the same totals
    assert len(sched.predictor.history) == len(jsched.predictor.history) == 5
    for a, b in zip(sched.predictor.history, jsched.predictor.history):
        np.testing.assert_array_equal(a.sum(-1), b.sum(-1))


# ---------------------------------------------------------------------------
# data, predictor, launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,skew", [("synthetic", 0.0), ("bytes", 0.0),
                                       ("synthetic", 1.2)])
def test_lm_stream_matches_jax(kind, skew):
    a = jpipeline.make_stream(512, 24, 6, kind=kind, seed=3, skew=skew)
    b = pipeline.make_stream(512, 24, 6, kind=kind, seed=3, skew=skew)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys()
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_load_predictor_matches_jax():
    a = jschedule.LoadPredictor(3, 4, window=2)
    b = schedule.LoadPredictor(3, 4, window=2)
    np.testing.assert_array_equal(a.predict(), b.predict())
    rng = np.random.default_rng(0)
    for _ in range(4):
        c = rng.integers(0, 50, (3, 4))
        a.observe(c)
        b.observe(c)
        np.testing.assert_array_equal(a.predict(), b.predict())
    assert len(b.history) == 2


def test_launch_train_on_cpu(tmp_path):
    log = tmp_path / "hist.json"
    hist = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "3", "--seq-len", "16",
                              "--data", "bytes", "--log-json", str(log)])
    assert len(hist) == 3 and log.exists()
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("flags", [["--mesh-data", "2"], ["--impl", "ring"],
                                   ["--checkpoint-dir", "x"],
                                   ["--elastic"]])
def test_launch_train_refuses_unported_flags(flags, monkeypatch):
    """A grid (``--mesh-data``) or an Algorithm 1 plan (``--impl ring``)
    reaches the multi-rank launch: with ``--spawn`` it hands the grid and
    the flags to ``launch.distributed.spawn`` (recorded here, not run), and
    without a process group or ``--spawn`` it says how to start the ranks.
    ``--checkpoint-dir`` rides along to the ranks; ``--elastic`` without
    it is refused, since the shrink path rolls back to a checkpoint."""
    from repro_torch.launch import distributed
    calls = []
    monkeypatch.setattr(distributed, "spawn",
                        lambda fn, grid, device, **kw: calls.append(
                            (fn, grid, device, kw["args"][0])) or [[]])
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", *flags]
    if flags[0] == "--elastic":
        with pytest.raises(SystemExit):
            launch_train.main(argv + ["--spawn"])
        assert not calls
        return
    if flags[0] == "--checkpoint-dir":
        argv += ["--impl", "ring", "--elastic"]
    with pytest.raises(SystemExit) as ei:
        launch_train.main(argv)
    assert "--spawn" in str(ei.value) and "torch.distributed.run" in \
        str(ei.value)
    launch_train.main(argv + ["--spawn"])
    (fn, grid, device, args), = calls
    assert fn is launch_train._rank_main and device == "cpu"
    assert grid == ((2, 1) if flags[0] == "--mesh-data" else (1, 1))
    assert args.impl == ("ep" if flags[0] == "--mesh-data" else "ring")
    if flags[0] == "--checkpoint-dir":
        assert args.checkpoint_dir == "x" and args.elastic


def test_unported_training_features_raise(setup, tmp_path):
    """Checkpointing, the elastic supervisor and a metric logger run (one
    checkpoint written, the supervisor's counters in the record); the
    Algorithm 1 scheduler is ported; publication into a live engine at
    world size 1 runs (every step publishes a version).  Publication from
    a process grid is ported too: ``tests/test_torch_serve_grid_fleet.py``
    holds it on gloo ranks."""
    from repro_torch.train.metrics import MetricLogger
    from repro_torch.train.supervisor import TrainSupervisor
    cfg = setup["cfg"]
    sched = trainer.HecateScheduler(cfg, ep=4, impl="ring", device="cpu")
    assert sched.plan().impl == "ring"
    assert sched.plan_arrays().local_rows.shape[1] == 4
    stream = pipeline.make_stream(cfg.vocab_size, 8, 2, seed=0)
    rt = mdl.Runtime(**TRAIN_RT)
    _, hist = trainer.train_loop(
        cfg, rt, TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=1),
        stream, scheduler=trainer.HecateScheduler(cfg, device="cpu"),
        num_steps=1, device="cpu", log_every=0,
        supervisor=TrainSupervisor(ep=1, runtime_factory=lambda ep: rt),
        metric_logger=MetricLogger())
    assert sorted(os.listdir(tmp_path)) == ["serving", "step_00000001"]
    assert hist[0]["device_losses"] == 0 and "loss_avg" in hist[0]
    params = _params(setup)
    state = st.TrainState(params, adamw.init(params),
                          torch.zeros((), dtype=torch.int32))
    with engine.Engine(cfg, mdl.Runtime(), _params(setup), max_len=16,
                       pa=setup["pa"]) as eng:
        _, hist = trainer.train_loop(
            cfg, mdl.Runtime(**TRAIN_RT), TrainConfig(), stream,
            scheduler=trainer.HecateScheduler(cfg, device="cpu"),
            state=state, num_steps=2, log_every=0, device="cpu",
            publish_engine=eng, publish_every=1)
        eng.flush()
        assert (eng.publications, eng.version) == (2, 2)
    assert hist[-1]["publish_drops"] == 0
    assert sum(ops.launch_counts().values()) == 0
