"""The port's MoE architectures against the JAX package on the CPU: the
counterpart of ``tests/test_arch_smoke.py`` for the configs that
``repro_torch.configs.PORTED`` lists.

Each full ``config()`` equals the JAX registry's field by field.  On each
reduced ``smoke()`` config (f32), JAX initializes the parameters, the
weight bridge carries them over and numpy makes the tokens from a seed;
then one train step (``jax.jit(build_train_step)`` against the port's
``build_train_step``, ``ep`` plan of the Hecate scheduler) and one decode
step (``decode_step`` on a dense cache) run in both packages.  bert-moe
also takes a bidirectional step (``causal=False``).  Tolerances as in
``tests/test_torch_train.py``: 1e-5 for losses, 5e-4 of each tensor's
largest entry for gradients and the gradient norm, 1e-5 of the largest
logit for decode; the parameters after one AdamW step as
``_params_after_step`` says.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jst  # noqa: E402
from repro.train.trainer import HecateScheduler as JScheduler  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import (params_from_jax,  # noqa: E402
                                       params_to_numpy)
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train.trainer import HecateScheduler  # noqa: E402

ARCHS = ["gpt-moe-s", "gpt-moe-l", "bert-moe", "bert-moe-deep",
         "olmoe-1b-7b", "granite-moe-3b-a800m"]
B, S = 2, 32
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _np(a):
    return np.asarray(a.detach().float().numpy()
                      if isinstance(a, torch.Tensor) else a, np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _close(got, want, tol, what=""):
    want = _np(want)
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=0,
                               err_msg=what)


def _params_after_step(got, want, want_mu, tc):
    """The parameters after one AdamW step, each leaf element against JAX's:
    within 0.1·lr where the gradient stands clear of the gradient
    tolerance (5e-4 of the leaf's largest entry).  The first step moves an
    element by lr·g/(|g| + eps), about lr·sign(g), so where |g| lies within
    that tolerance the two packages' f32 gradients may differ in sign, and
    such an element is held to the two updates' extent, 2·lr."""
    want_mu = dict(_flat(jax.tree.map(np.asarray, want_mu)))
    got = dict(_flat(got))
    for k, w in _flat(jax.tree.map(np.asarray, want)):
        g = np.abs(want_mu[k]) / (1 - tc.beta1)
        clear = g > 5e-4 * g.max()
        d = np.abs(_np(got[k]) - w)
        assert d[clear].max(initial=0) <= 0.1 * tc.learning_rate, k
        assert d.max() <= 2 * tc.learning_rate, k


def _setup(name):
    """Both packages' smoke config, JAX's initial parameters (numpy), the
    ``ep`` plan of each package's scheduler and a batch of tokens."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return dict(
        jcfg=jcfg, cfg=cfg, jparams=jparams,
        np_tree=jax.tree.map(np.asarray, jparams),
        jpa=JScheduler(jcfg, ep=1, impl="ep").plan_arrays(),
        pa=HecateScheduler(cfg, ep=1, impl="ep", device="cpu").plan_arrays(),
        jb={"tokens": jnp.asarray(toks)}, tb={"tokens": torch.from_numpy(toks)})


def test_ported_configs():
    assert configs.PORTED == ["gpt_moe_s", "gpt_moe_l", "bert_moe",
                              "bert_moe_deep", "olmoe_1b_7b",
                              "granite_moe_3b_a800m"]
    assert configs.PAPER == jconfigs.PAPER
    assert configs.ASSIGNED == [a for a in jconfigs.ASSIGNED
                                if jconfigs.get(a).arch_type == "moe"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        configs.get("smollm-360m")


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_equals_jax(name):
    """Every field of the full config and of its smoke config, and the
    assigned dimensions (``tests/test_arch_smoke.py``'s tables)."""
    cfg = configs.get(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get(name))
    assert dataclasses.asdict(configs.get_smoke(name)) == \
        dataclasses.asdict(jconfigs.get_smoke(name))
    assigned = {"olmoe-1b-7b": (16, 2048, 16, 16, 1024, 50_304, 64, 8),
                "granite-moe-3b-a800m": (32, 1536, 24, 8, 512, 49_155, 40,
                                         8)}
    if name in assigned:
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.moe.d_ff, cfg.vocab_size,
                cfg.moe.num_experts, cfg.moe.experts_per_token) == \
            assigned[name]


@pytest.mark.parametrize("name", ARCHS)
def test_arch_train_and_decode_match_jax(name):
    """One train step (loss, metrics, every parameter and first moment
    after it) and one decode step (logits) against the JAX package."""
    su = _setup(name)
    cfg, jcfg = su["cfg"], su["jcfg"]
    tc = TrainConfig(**TC)
    js = jst.TrainState(su["jparams"], jadamw.init(su["jparams"]),
                        jnp.zeros((), jnp.int32))
    js, jm = jax.jit(jst.build_train_step(
        jcfg, jmdl.Runtime(), JTrainConfig(**dataclasses.asdict(tc))))(
            js, su["jb"], su["jpa"])
    params = params_from_jax(su["np_tree"], "cpu")
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    ts, tm = st.build_train_step(cfg, mdl.Runtime(use_pallas=False), tc)(
        ts, su["tb"], su["pa"])
    for k in ("loss", "xent", "aux_loss"):
        _close(tm[k], jm[k], 1e-5, k)
    _close(tm["grad_norm"], jm["grad_norm"], 5e-4, "grad_norm")  # gradients
    assert float(tm["step_ok"]) == float(jm["step_ok"]) == 1.0
    np.testing.assert_array_equal(_np(tm["expert_counts"]),
                                  np.asarray(jm["expert_counts"]))
    assert sorted(dict(_flat(ts.params))) == sorted(dict(_flat(js.params)))
    _params_after_step(ts.params, js.params, js.opt.mu, tc)
    mu = dict(_flat(params_to_numpy(ts.opt.mu)))
    for k, w in _flat(jax.tree.map(np.asarray, js.opt.mu)):
        _close(mu[k], w, 5e-4, k)

    # one decode step at position 3 on a fresh dense cache, from JAX's init
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, _ = jax.jit(lambda p, c, t, a: jmdl.decode_step(
        jcfg, jmdl.Runtime(), p, c, t, jnp.int32(3), a))(
            su["jparams"], jmdl.init_cache(jcfg, B, 64), jnp.asarray(toks),
            su["jpa"])
    tl, _ = mdl.decode_step(cfg, mdl.Runtime(),
                            params_from_jax(su["np_tree"], "cpu"),
                            mdl.init_cache(cfg, B, 64, "cpu"),
                            torch.from_numpy(toks), 3, su["pa"])
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl, np.asarray(jl), 1e-5, "decode logits")


def test_bert_bidirectional_step_matches_jax():
    """bert-moe's ``causal=False`` loss and gradients against JAX's
    ``loss_fn(causal=False)`` (no mask: both packages take their plain
    attention), and one ``build_train_step(causal=False)`` step; the
    bidirectional loss differs from the causal one."""
    su = _setup("bert-moe")
    cfg, jcfg = su["cfg"], su["jcfg"]
    (_, jm), jg = jax.value_and_grad(
        lambda p: jst.loss_fn(jcfg, jmdl.Runtime(), p, su["jb"], su["jpa"],
                              causal=False), has_aux=True)(su["jparams"])
    rt = mdl.Runtime(use_pallas=False)
    tm, tg = st.loss_and_grads(cfg, rt, params_from_jax(su["np_tree"], "cpu"),
                               su["tb"], su["pa"], causal=False)
    for k in ("loss", "xent", "aux_loss", "z_loss"):
        _close(tm[k], jm[k], 1e-5, k)
    got, want = dict(_flat(tg)), dict(_flat(jax.tree.map(np.asarray, jg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _close(got[k], w, 5e-4, k)
    causal, _ = st.loss_and_grads(cfg, rt,
                                  params_from_jax(su["np_tree"], "cpu"),
                                  su["tb"], su["pa"])
    assert abs(float(causal["loss"]) - float(tm["loss"])) > 1e-3

    tc = TrainConfig(**TC)
    js = jst.TrainState(su["jparams"], jadamw.init(su["jparams"]),
                        jnp.zeros((), jnp.int32))
    js, jm = jax.jit(jst.build_train_step(
        jcfg, jmdl.Runtime(), JTrainConfig(**dataclasses.asdict(tc)),
        causal=False))(js, su["jb"], su["jpa"])
    params = params_from_jax(su["np_tree"], "cpu")
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    ts, tm = st.build_train_step(cfg, rt, tc, causal=False)(ts, su["tb"],
                                                            su["pa"])
    _close(tm["loss"], jm["loss"], 1e-5, "loss")
    _close(tm["grad_norm"], jm["grad_norm"], 5e-4, "grad_norm")
    _params_after_step(ts.params, js.params, js.opt.mu, tc)
