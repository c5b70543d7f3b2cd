"""The port's architectures against the JAX package on the CPU: the
counterpart of ``tests/test_arch_smoke.py`` for the configs that
``repro_torch.configs.PORTED`` lists (every one of the JAX registry).

Each full ``config()`` equals the JAX registry's field by field.  On each
reduced ``smoke()`` config (f32), JAX initializes the parameters, the
weight bridge carries them over and numpy makes the tokens (Qwen2-VL: the
stub frontend's embeddings and the labels; Whisper: the stand-in frames
beside the tokens) from a seed; then one train
step (``jax.jit(build_train_step)`` against the port's
``build_train_step``, ``ep`` plan of the Hecate scheduler for the MoE
archs) and one decode step (``decode_step`` on a dense cache, for
Whisper with the cross K/V of the encoded frames) run in both packages.
bert-moe also takes a bidirectional step (``causal=False``),
Qwen2-VL a forward of embeddings at distinct M-RoPE position streams.  Tolerances as in
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
         "olmoe-1b-7b", "granite-moe-3b-a800m", "smollm-360m", "minitron-8b",
         "qwen1.5-110b", "gemma2-9b", "mamba2-1.3b", "jamba-v0.1-52b",
         "qwen2-vl-72b", "whisper-medium"]
B, S = 2, 32
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
# Gradients (and first moments) against JAX's, relative to each tensor's
# largest entry.  Qwen2-VL's step on unit-normal stand-in embeddings is
# ill-conditioned in f32: JAX's own f32 gradients lie up to 3.3e-3 from
# its float64 ones there, the port's 2.1e-3, and the two packages' f32
# gradients 1.36e-3 from each other (measured on the CPU); every other
# arch is held to 5e-4.  Whisper's random-init model is ill-conditioned in
# f32 (``tests/test_torch_whisper.py``, ``tools/whisper_f32_error.py``: a
# 1e-7 perturbation of its unit-normal frames moves JAX's own gradients by
# up to 11%); the two packages' first moments lie up to 2.01e-2 apart here
# and their gradient norms 1.02e-2, their decode logits 1.98e-5 (measured
# on the CPU).
GRAD_TOL = {"qwen2-vl-72b": 2e-3, "whisper-medium": 2.5e-2}
LOGIT_TOL = {"whisper-medium": 3e-5}
# where ``_params_after_step`` holds an element to 0.1·lr: its gradient
# clear of this share of the leaf's largest (Whisper's gradients differ
# by up to GRAD_TOL between the packages)
CLEAR_TOL = {"whisper-medium": GRAD_TOL["whisper-medium"]}


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


def _params_after_step(got, want, want_mu, tc, gtol=5e-4):
    """The parameters after one AdamW step, each leaf element against JAX's:
    within 0.1·lr where the gradient stands clear of the gradient
    tolerance ``gtol`` of the leaf's largest entry.  The first step moves
    an element by lr·g/(|g| + eps), about lr·sign(g), so where |g| lies
    within that tolerance the two packages' f32 gradients may differ in
    sign, and such an element is held to the two updates' extent, 2·lr."""
    want_mu = dict(_flat(jax.tree.map(np.asarray, want_mu)))
    got = dict(_flat(got))
    for k, w in _flat(jax.tree.map(np.asarray, want)):
        g = np.abs(want_mu[k]) / (1 - tc.beta1)
        clear = g > gtol * g.max()
        d = np.abs(_np(got[k]) - w)
        assert d[clear].max(initial=0) <= 0.1 * tc.learning_rate, k
        assert d.max() <= 2 * tc.learning_rate, k


def _setup(name):
    """Both packages' smoke config, JAX's initial parameters (numpy), the
    ``ep`` plan of each package's scheduler (None without MoE) and a batch
    of tokens (Qwen2-VL: embeddings and labels)."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    if cfg.frontend == "vision":
        nb = {"embeds": rng.standard_normal((B, S, cfg.d_model), np.float32),
              "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                  np.int32)}
    elif cfg.is_encoder_decoder:
        nb = {"encoder_input": rng.standard_normal(
                  (B, cfg.encoder_seq_len, cfg.d_model), np.float32),
              "tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(
                  np.int32)}
    else:
        nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(
            np.int32)}
    moe = cfg.moe.enabled
    return dict(
        jcfg=jcfg, cfg=cfg, jparams=jparams,
        np_tree=jax.tree.map(np.asarray, jparams),
        jpa=JScheduler(jcfg, ep=1, impl="ep").plan_arrays() if moe else None,
        pa=HecateScheduler(cfg, ep=1, impl="ep", device="cpu").plan_arrays()
        if moe else None,
        jb={k: jnp.asarray(v) for k, v in nb.items()},
        tb={k: torch.from_numpy(v) for k, v in nb.items()})


def test_ported_configs():
    """The registry mirrors the JAX one's lists and ports all of them, the
    encoder-decoder whisper-medium included; the CLI ids resolve as the
    JAX registry's aliases do, and a name outside the registry raises."""
    assert configs.PAPER == jconfigs.PAPER
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert configs.PORTED == jconfigs.PAPER + jconfigs.ASSIGNED
    assert sorted(configs.canonical(a) for a in ARCHS) == \
        sorted(configs.PORTED)
    for a in ARCHS:
        assert configs.canonical(a) == jconfigs.canonical(a)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        configs.get("whisper-large")


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
    dense = {  # tests/test_arch_smoke.py's table: L, d, heads, kv, d_ff, V
        "minitron-8b": (32, 4096, 32, 8, 16384, 256000),
        "mamba2-1.3b": (48, 2048, 1, 1, 0, 50280),
        "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
        "gemma2-9b": (42, 3584, 16, 8, 14336, 256000),
        "qwen2-vl-72b": (80, 8192, 64, 8, 29568, 152064),
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865)}
    if name in dense:
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size) == dense[name]
    if cfg.is_encoder_decoder:
        assert (cfg.encoder_layers, cfg.encoder_seq_len,
                cfg.max_decoder_len) == (24, 1500, 448)


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
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "xent", "aux_loss"):
        if k in jm:
            _close(tm[k], jm[k], 1e-5, k)
    gtol = GRAD_TOL.get(name, 5e-4)
    _close(tm["grad_norm"], jm["grad_norm"], gtol, "grad_norm")  # gradients
    assert float(tm["step_ok"]) == float(jm["step_ok"]) == 1.0
    if "expert_counts" in jm:
        np.testing.assert_array_equal(_np(tm["expert_counts"]),
                                      np.asarray(jm["expert_counts"]))
    assert sorted(dict(_flat(ts.params))) == sorted(dict(_flat(js.params)))
    _params_after_step(ts.params, js.params, js.opt.mu, tc,
                       CLEAR_TOL.get(name, 5e-4))
    mu = dict(_flat(params_to_numpy(ts.opt.mu)))
    for k, w in _flat(jax.tree.map(np.asarray, js.opt.mu)):
        _close(mu[k], w, gtol, k)

    # one decode step at position 3 on a fresh dense cache, from JAX's init
    # (an encoder-decoder's cross K/V from its encoded frames)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jc = jmdl.init_cache(jcfg, B, 64)
    params = params_from_jax(su["np_tree"], "cpu")
    tc = mdl.init_cache(cfg, B, 64, "cpu")
    if cfg.is_encoder_decoder:
        jenc = jmdl._encode(jcfg, jmdl.Runtime(), su["jparams"]["encoder"],
                            su["jb"]["encoder_input"])
        jc["xk"], jc["xv"] = jmdl.precompute_cross_kv(jcfg, su["jparams"],
                                                      jenc)
        with torch.no_grad():
            enc = mdl._encode(cfg, mdl.Runtime(), params["encoder"],
                              su["tb"]["encoder_input"])
            tc["xk"], tc["xv"] = mdl.precompute_cross_kv(cfg, params, enc)
    jl, _ = jax.jit(lambda p, c, t, a: jmdl.decode_step(
        jcfg, jmdl.Runtime(), p, c, t, jnp.int32(3), a))(
            su["jparams"], jc, jnp.asarray(toks), su["jpa"])
    tl, _ = mdl.decode_step(cfg, mdl.Runtime(), params, tc,
                            torch.from_numpy(toks), 3, su["pa"])
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl, np.asarray(jl), LOGIT_TOL.get(name, 1e-5), "decode logits")


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


def test_qwen2_vl_embeds_with_distinct_position_streams_match_jax():
    """Qwen2-VL's forward of stub-frontend embeddings at distinct
    temporal, height and width position streams (B, S, 3), against JAX's;
    the logits differ from those at text positions (all three streams
    equal), so the streams reach M-RoPE.  Held at 1e-4 of the largest
    logit: on unit-normal stand-in embeddings both packages' f32 logits
    lie up to 4.7e-5 of it from JAX's float64 ones (measured on the CPU),
    and 4.6e-5 from each other."""
    su = _setup("qwen2-vl-72b")
    cfg, jcfg = su["cfg"], su["jcfg"]
    rng = np.random.default_rng(3)
    emb = su["tb"]["embeds"]
    pos = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                    rng.integers(0, 8, (B, S)), rng.integers(0, 8, (B, S))],
                   axis=-1).astype(np.int32)
    jl, _ = jmdl.forward(jcfg, jmdl.Runtime(), su["jparams"],
                         embeds=su["jb"]["embeds"], positions=jnp.asarray(pos))
    params = params_from_jax(su["np_tree"], "cpu")
    tl, _ = mdl.forward(cfg, mdl.Runtime(), params, embeds=emb,
                        positions=torch.from_numpy(pos))
    _close(tl, np.asarray(jl), 1e-4, "logits")
    text, _ = mdl.forward(cfg, mdl.Runtime(), params, embeds=emb)
    assert float((text - tl).abs().max()) > 1e-3
