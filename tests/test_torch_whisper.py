"""Whisper, the encoder-decoder, in the port against the JAX package on the
CPU, at the JAX registry's ``smoke()`` widths in f32: 2 encoder and 2
decoder layers, d_model 256, 32 encoder frames, vocabulary 512.

JAX initializes the parameters and the weight bridge carries them over;
numpy makes the stand-in frames of the stub frontend and the tokens from a
seed.  Both packages run their plain attention (the encoder's and the
cross attention have no mask, so the JAX package takes XLA there too).
Greedy tokens and checkpoints are held bit for bit.

The random-init model is ill-conditioned in f32: its attention logits
have a standard deviation near 64 (Q and K entries near 8, the ``scaled``
init's fan-in being the head count), so the softmaxes are near-argmax
over the unit-normal stand-in frames.  ``tools/whisper_f32_error.py``
measures it: a relative perturbation of 1e-7 of the frames moves JAX's
own f32 logits by 6.9e-4 of the largest and its gradients by up to 11%;
JAX's f32 logits lie 9.2e-4 and its gradients 11.6% from float64, the
port's 7.5e-4 and 13.2%, and the two packages 7.7e-4 and 1.6% from each
other; JAX's own gradients compiled whole (``jax.jit``) lie 4.8% from
its op-by-op ones.  So the tolerances, relative to each tensor's largest
entry, are set just above the port-against-JAX distances this file
measures (the reference's 1e-5 where the distance is below it):
``LOGIT_TOL`` (largest distance 7.05e-4, forward; 3.8e-4 in decode),
``CACHE_TOL`` (9.6e-5, the rotated self-attention K/V; 4.1e-5 the cross
K/V), ``GRAD_TOL`` (3.27e-2 against JAX's compiled gradients,
``blocks/l0/attn/wv``; the same with any number of torch threads), and
for the loop's losses 1e-5 at the first step
(6.8e-7), ``TRAJ2_TOL`` at the second (3.0e-4: it follows one update of
those gradients) and C10's 3% over all ten (1.22e-2).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.scheduler import RequestScheduler as JScheduler  # noqa
from repro.train import step as jst  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.scheduler import RequestScheduler  # noqa: E402
from repro_torch.train import step as st  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCH = "whisper-medium"
B, S = 2, 16
# measured limits, relative to each tensor's largest entry (module
# docstring): logits, caches, gradients, the loop's second loss
LOGIT_TOL = 1e-3
CACHE_TOL = 1.5e-4
GRAD_TOL = 4e-2
TRAJ2_TOL = 5e-4
TC = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
RT = dict(use_pallas=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many do, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def su():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model),
                              np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                np_tree=jax.tree.map(np.asarray, jparams), enc=enc,
                toks=toks)


def _params(su):
    return params_from_jax(su["np_tree"], "cpu")


@pytest.fixture(scope="module")
def jstep(su):
    """JAX's compiled train step at ``TC``, shared by the tests that step."""
    return jax.jit(jst.build_train_step(su["jcfg"], jmdl.Runtime(),
                                        JTrainConfig(**TC)))


def _shapes(tree):
    return {k: tuple(p.shape) for k, p in _flat(tree)}


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_param_tree_matches_jax(which):
    """The parameter declarations, keys and shapes: the encoder subtree
    and each decoder sublayer's ``lnx`` / ``xattn`` (no QKV bias)."""
    get = (lambda m: m.get_smoke(ARCH)) if which == "smoke" else \
        (lambda m: m.get(ARCH))
    want = _shapes(jax.tree.map(lambda p: p, jmdl.param_decls(get(jconfigs)),
                                is_leaf=lambda p: hasattr(p, "axes")))
    got = _shapes(mdl.param_decls(get(configs)))
    assert got == want
    assert "encoder/blocks/l0/attn/wq" in got
    assert "blocks/l0/xattn/wk" in got and "blocks/l0/lnx/scale" in got
    if which == "full":
        assert got["encoder/blocks/l0/attn/wq"] == (24, 1024, 16, 64)


def test_forward_and_prefill_cache_match_jax(su):
    """``forward(encoder_input=)`` logits, and with ``collect_cache`` the
    cache: each decoder layer's rotated K/V and the cross K/V ``xk`` /
    ``xv`` of the encoder states."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    toks = su["toks"][:, :S]
    jl, _, jc = jmdl.forward(jcfg, jmdl.Runtime(), su["jparams"],
                             jnp.asarray(toks),
                             encoder_input=jnp.asarray(su["enc"]),
                             collect_cache=True)
    params = _params(su)
    with torch.no_grad():
        tl, _ = mdl.forward(cfg, mdl.Runtime(**RT), params,
                            torch.from_numpy(toks),
                            encoder_input=torch.from_numpy(su["enc"]))
        tl2, _, tc = mdl.forward(cfg, mdl.Runtime(**RT), params,
                                 torch.from_numpy(toks),
                                 encoder_input=torch.from_numpy(su["enc"]),
                                 collect_cache=True)
    _close(tl, jl, LOGIT_TOL, "logits")
    _close(tl2, jl, LOGIT_TOL, "logits with the cache")
    want = dict(_flat(jax.tree.map(np.asarray, jc)))
    got = dict(_flat(tc))
    assert sorted(got) == sorted(want) == ["l0/k", "l0/v", "xk", "xv"]
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        _close(got[k], w, CACHE_TOL, k)
    with pytest.raises(ValueError, match="encoder_input"):
        mdl.forward(cfg, mdl.Runtime(**RT), params, torch.from_numpy(toks))


def _jax_cross_cache(su, batch, max_len):
    jcfg = su["jcfg"]
    cache = jmdl.init_cache(jcfg, batch, max_len)
    enc = jmdl._encode(jcfg, jmdl.Runtime(), su["jparams"]["encoder"],
                       jnp.asarray(su["enc"][:batch]))
    cache["xk"], cache["xv"] = jmdl.precompute_cross_kv(jcfg, su["jparams"],
                                                        enc)
    return cache


def test_decode_steps_match_jax(su):
    """8 decode steps on a dense cache whose cross K/V the encoder filled:
    each step's logits, then the whole cache (the cross K/V unchanged)."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    jc = _jax_cross_cache(su, B, 32)
    params = _params(su)
    tc = mdl.init_cache(cfg, B, 32, "cpu")
    assert sorted(tc) == ["l0", "xk", "xv"]
    with torch.no_grad():
        enc = mdl._encode(cfg, mdl.Runtime(**RT), params["encoder"],
                          torch.from_numpy(su["enc"]))
        tc["xk"], tc["xv"] = mdl.precompute_cross_kv(cfg, params, enc)
        step = jax.jit(lambda p, c, t, i: jmdl.decode_step(
            jcfg, jmdl.Runtime(), p, c, t, i))
        for i in range(8):
            t = su["toks"][:, i:i + 1]
            jl, jc = step(su["jparams"], jc, jnp.asarray(t), jnp.int32(i))
            tl, tc = mdl.decode_step(cfg, mdl.Runtime(**RT), params, tc,
                                     torch.from_numpy(t), i)
            _close(tl, jl, LOGIT_TOL, f"step {i} logits")
    for k, w in _flat(jax.tree.map(np.asarray, jc)):
        _close(dict(_flat(tc))[k], w, CACHE_TOL, k)


def test_prefill_step_and_generate_match_jax(su):
    """``build_prefill_step`` with the batch's ``encoder_input`` (last
    logits and cache), then greedy ``Engine.generate(encoder_input=)``:
    the same tokens as the JAX engine's; a decode after the one-shot
    prefill's cache gives the loop prefill's next token."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    toks = su["toks"][:, :8]
    jb = {"tokens": jnp.asarray(toks), "encoder_input": jnp.asarray(su["enc"])}
    jl, jc = jengine.build_prefill_step(jcfg, jmdl.Runtime())(
        su["jparams"], jb, None)
    params = _params(su)
    tb = {"tokens": torch.from_numpy(toks),
          "encoder_input": torch.from_numpy(su["enc"])}
    tl, tc = engine.build_prefill_step(cfg, mdl.Runtime(**RT))(params, tb,
                                                               None)
    _close(tl, jl, LOGIT_TOL, "prefill logits")
    for k, w in _flat(jax.tree.map(np.asarray, jc)):
        _close(dict(_flat(tc))[k], w, CACHE_TOL, k)

    with jengine.Engine(jcfg, jmdl.Runtime(), su["jparams"],
                        max_len=32) as je:
        want = je.generate(toks, steps=6, encoder_input=su["enc"])
    with engine.Engine(cfg, mdl.Runtime(**RT), params, max_len=32) as e:
        got = e.generate(toks, steps=6, encoder_input=su["enc"])
        again = e.generate(toks, steps=6,
                           encoder_input=torch.from_numpy(su["enc"]))
        with pytest.raises(ValueError, match="encoder_input"):
            e.generate(toks, steps=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, got)
    # the one-shot prefill's cache, moved into a dense cache, decodes the
    # loop prefill's next token
    cache = mdl.init_cache(cfg, B, 32, "cpu")
    cache["l0"]["k"][:, :, :8] = tc["l0"]["k"]
    cache["l0"]["v"][:, :, :8] = tc["l0"]["v"]
    cache["xk"], cache["xv"] = tc["xk"], tc["xv"]
    nxt = torch.argmax(tl[:, -1], -1)
    np.testing.assert_array_equal(nxt.numpy(), got[:, 8])
    with torch.no_grad():
        dl, _ = mdl.decode_step(cfg, mdl.Runtime(**RT), params, cache,
                                nxt[:, None].int(), 8)
    np.testing.assert_array_equal(torch.argmax(dl[:, -1], -1).numpy(),
                                  got[:, 9])


def test_loss_and_grads_match_jax(su):
    """The next-token loss of an ``{"encoder_input", "tokens"}`` batch and
    its gradients, the encoder's included (every encoder parameter gets a
    nonzero one)."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    jb = {"tokens": jnp.asarray(su["toks"]),
          "encoder_input": jnp.asarray(su["enc"])}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jst.loss_fn(jcfg, jmdl.Runtime(), p, jb, None),
        has_aux=True))(su["jparams"])
    tb = {"tokens": torch.from_numpy(su["toks"]),
          "encoder_input": torch.from_numpy(su["enc"])}
    tm, tg = st.loss_and_grads(cfg, mdl.Runtime(**RT), _params(su), tb, None)
    for k in ("loss", "xent"):
        _close(tm[k], jm[k], 1e-5, k)
    got, want = dict(_flat(tg)), dict(_flat(jax.tree.map(np.asarray, jg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _close(got[k], w, GRAD_TOL, k)
    enc = [k for k in got if k.startswith("encoder/")]
    assert enc and all(float(got[k].abs().max()) > 0 for k in enc)


def _batches(cfg, n, seed=1, batch=8, seq=S):
    stream = pipeline.EncoderStubStream(
        pipeline.make_stream(cfg.vocab_size, seq, batch, kind="bytes",
                             seed=seed), cfg.encoder_seq_len, cfg.d_model,
        seed=seed)
    return [stream.next_batch() for _ in range(n)]


def test_encoder_stub_stream():
    """The stand-in stream: seeded normal frames of the config's shape
    beside the wrapped stream's tokens."""
    cfg = configs.get_smoke(ARCH)
    a, b = _batches(cfg, 2), _batches(cfg, 2)
    toks = pipeline.make_stream(cfg.vocab_size, S, 8, kind="bytes",
                                seed=1).next_batch()["tokens"]
    assert sorted(a[0]) == ["encoder_input", "tokens"]
    assert a[0]["encoder_input"].shape == (8, 32, 256)
    assert a[0]["encoder_input"].dtype == np.float32
    np.testing.assert_array_equal(a[0]["tokens"], toks)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["encoder_input"], y["encoder_input"])
    assert not np.array_equal(a[0]["encoder_input"], a[1]["encoder_input"])


def test_train_loop_trajectory_matches_jax(su, jstep):
    """10 steps of the loop from the same weights and batches: the first
    within 1e-5 relative, the second within ``TRAJ2_TOL``, all ten within
    C10's 3%, and the loss falling in both."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    tc = TrainConfig(**TC)
    batches = _batches(cfg, 10)
    js = jst.TrainState(su["jparams"], jadamw.init(su["jparams"]),
                        jnp.zeros((), jnp.int32))
    _, jh = jtrainer.train_loop(jcfg, jmdl.Runtime(),
                                JTrainConfig(**dataclasses.asdict(tc)),
                                iter(batches), state=js, num_steps=10,
                                log_every=0, train_step_fn=jstep)
    params = _params(su)
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    _, th = trainer.train_loop(cfg, mdl.Runtime(**RT), tc, iter(batches),
                               state=ts, num_steps=10, log_every=0,
                               device="cpu")
    jl = np.asarray([h["loss"] for h in jh])
    tl = np.asarray([h["loss"] for h in th])
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], jl[1], rtol=TRAJ2_TOL)
    np.testing.assert_allclose(tl, jl, rtol=3e-2)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    assert [h["step_ok"] for h in th] == [1.0] * 10


def test_microbatched_step_matches_full_batch(su):
    """Two microbatches split ``encoder_input`` by rows with the tokens:
    the step's loss and parameters equal the full batch's within the f32
    sums' other order: 1e-5 of the loss, and 0.01·lr per parameter
    element, the bound of ``tests/test_torch_train.py``'s microbatch test
    (measured here 1.86e-5 = 0.0062·lr, on 2 of 131,072 elements of
    ``encoder/blocks/l0/attn/wk``)."""
    cfg = su["cfg"]
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    out = []
    for n in (1, 2):
        params = _params(su)
        s0 = st.TrainState(params, adamw.init(params),
                           torch.zeros((), dtype=torch.int32))
        out.append(st.build_train_step(
            cfg, mdl.Runtime(**RT), TrainConfig(**TC, microbatch=n))(
                s0, batch, None))
    (a, ma), (b, mb) = out
    _close(mb["loss"], ma["loss"], 1e-5, "loss")
    for (k, x), (_, y) in zip(_flat(b.params), _flat(a.params)):
        np.testing.assert_allclose(_np(x), _np(y),
                                   atol=0.01 * TC["learning_rate"], rtol=0,
                                   err_msg=k)


def test_checkpoints_restore_across_the_packages(su, jstep, tmp_path):
    """A train state after one step, saved by each package, restores in
    the other bit for bit: the encoder subtree and the cross-attention
    leaves of the parameters and of both moments included."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    tc = TrainConfig(**TC)
    batch = _batches(cfg, 1)[0]
    js = jst.TrainState(su["jparams"], jadamw.init(su["jparams"]),
                        jnp.zeros((), jnp.int32))
    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    params = _params(su)
    ts = st.TrainState(params, adamw.init(params),
                       torch.zeros((), dtype=torch.int32))
    ts, _ = st.build_train_step(cfg, mdl.Runtime(**RT), tc)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(dj, 1, jtrainer._state_tree(js))
    store.save(dt, 1, trainer._state_tree(ts))
    # the port restores JAX's files into its own tree, and JAX the port's
    live_j = {k: np.asarray(v) for k, v in
              jstore._flatten_with_paths(jtrainer._state_tree(js)).items()}
    live_t = {k: v.detach().numpy() for k, v in
              store._walk(trainer._state_tree(ts))}
    back_t = {k: v.detach().numpy() for k, v in store._walk(store.restore(
        dj, 1, trainer._state_tree(trainer.state_spec(cfg, 1)),
        device="cpu"))}
    back_j = {k: np.asarray(v) for k, v in jstore._flatten_with_paths(
        jstore.restore(dt, 1, jtrainer._state_tree(js))).items()}
    assert sorted(back_t) == sorted(live_j) == sorted(live_t) == \
        sorted(back_j)
    assert "params/encoder/blocks/l0/attn/wq" in live_t
    assert "opt/.mu/blocks/l0/xattn/wv" in live_t
    for k in live_j:
        np.testing.assert_array_equal(back_t[k], live_j[k], err_msg=k)
        np.testing.assert_array_equal(back_j[k], live_t[k], err_msg=k)


def test_paged_paths_refuse_the_encoder_decoder(su):
    """The scheduler, the paged cache and the paged decode step refuse an
    encoder-decoder with the JAX package's messages."""
    jcfg, cfg = su["jcfg"], su["cfg"]
    params = _params(su)
    with jengine.Engine(jcfg, jmdl.Runtime(), su["jparams"]) as je:
        with pytest.raises(AssertionError, match="continuous batching does "
                           "not support encoder-decoder models"):
            JScheduler(je)
    with engine.Engine(cfg, mdl.Runtime(**RT), params) as e:
        with pytest.raises(ValueError, match="continuous batching does not "
                           "support encoder-decoder models"):
            RequestScheduler(e)
    msg = "paged decode does not support encoder-decoder caches"
    with pytest.raises(AssertionError, match=msg):
        jmdl.init_paged_cache(jcfg, 2, 16)
    with pytest.raises(ValueError, match=msg):
        mdl.init_paged_cache(cfg, 2, 16, "cpu")
    with pytest.raises(ValueError, match="paged decode does not support "
                       "encoder-decoder models"):
        mdl.decode_step(cfg, mdl.Runtime(**RT), params,
                        mdl.init_cache(cfg, 1, 8, "cpu"),
                        torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        row_idx=torch.zeros((1, 8), dtype=torch.int32),
                        page_size=8)


@pytest.mark.parametrize("replicas", [1, 2])
def test_launch_serve_generates_from_the_encoder_stand_in(replicas, capsys):
    """``launch.serve --arch whisper-medium --smoke --device cpu`` decodes
    against the seeded stand-in frames, from one engine or from two behind
    a bus, and prints the tokens."""
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--max-len", "32",
                       "--replicas", str(replicas)])
    out = capsys.readouterr().out
    assert "fixed batch: 2 prompts" in out and "[1] " in out
    if replicas > 1:
        assert "fleet: 2/2 healthy" in out


def test_launch_serve_refuses_continuous():
    with pytest.raises(SystemExit, match="--continuous requires a "
                       "decoder-only arch"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--continuous"])


def test_launch_train_on_the_encoder_stand_in(tmp_path):
    """``launch.train --arch whisper-medium --smoke --device cpu`` trains
    on ``EncoderStubStream`` (its default length is the smoke decoder's
    cap, 64); a ``--seq-len`` above the cap is refused, naming it."""
    log = tmp_path / "hist.json"
    hist = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "3", "--global-batch", "2",
                              "--log-json", str(log)])
    assert len(hist) == 3 and log.exists()
    assert all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(SystemExit, match="capped at 64 tokens"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "1", "--seq-len", "65"])
