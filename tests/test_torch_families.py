"""The decoder-only families' modules against the JAX package on the CPU:
M-RoPE (``models/layers.py``, ``models/attention.py``), the Mamba-2 block
(``models/mamba2.py``), and serving with mamba layers (exact-length
prefill and per-slot SSM state in ``serve/scheduler.py``).  The
counterparts of ``tests/test_models.py``'s RoPE, decode and Mamba-2 tests
and of ``tests/test_serve_batching.py``'s paged-against-dense parity.

Inputs come from numpy with a fixed seed, parameters from JAX's
initializer through the weight bridge.  Tolerances are the reference
tests' own: 1e-5 for RoPE, 2e-4 / 1e-3 for decode against the full
forward, 1e-4 / 1e-3 for the SSD scan; the port against JAX on the same
function at 1e-5 (forward values) or 5e-4 of each tensor's largest entry
(gradients), as ``tests/test_torch_train.py`` holds them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.common.params import init_tree as jinit_tree  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jly  # noqa: E402
from repro.models import mamba2 as jmb  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as ly  # noqa: E402
from repro_torch.models import mamba2 as mb  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.kv_pool import PageTable  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _rel_close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=0, err_msg=what)


# ---------------------------------------------------------------- M-RoPE
def test_mrope_equals_rope_for_text():
    """M-RoPE with identical t/h/w position streams equals plain RoPE, and
    with distinct streams equals the JAX package's ``apply_rope``."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 2, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    pos3 = np.broadcast_to(pos[..., None], (2, 6, 3))
    secs = ly.default_mrope_sections(128)
    assert secs == jly.default_mrope_sections(128) == (16, 24, 24)
    a = ly.apply_rope(_t(x), _t(pos), 10_000.0)
    b = ly.apply_rope(_t(x), _t(pos3), 10_000.0, secs)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    dist = np.stack([pos, rng.integers(0, 9, (2, 6)),
                     rng.integers(0, 9, (2, 6))], axis=-1).astype(np.int32)
    for hd in (128, 64):
        xs = rng.standard_normal((2, 6, 3, hd)).astype(np.float32)
        s = ly.default_mrope_sections(hd)
        want = jly.apply_rope(jnp.asarray(xs), jnp.asarray(dist), 1e6, s)
        got = ly.apply_rope(_t(xs), _t(dist), 1e6, s)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
        assert float((got - ly.apply_rope(_t(xs), _t(pos), 1e6)).abs()
                     .max()) > 1e-2           # the streams matter


def _tiny_attn_cfg(mod, **kw):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=64, dtype="float32", remat=False)
    base.update(kw)
    return mod(**base)


@pytest.mark.parametrize("kind,window,softcap,mrope", [
    ("local", 8, 0.0, False), ("attn", 0, 30.0, False),
    ("local", 8, 50.0, False), ("attn", 0, 0.0, True)])
def test_decode_matches_full_attention(kind, window, softcap, mrope):
    """Step-by-step dense decode against the full-sequence attention
    (windowed ``local``, logit softcap, both, and M-RoPE), and the full
    attention against the JAX package's on the same weights."""
    kw = dict(sliding_window=window, attn_logit_softcap=softcap,
              mrope=mrope)
    jcfg, cfg = (_tiny_attn_cfg(JModelConfig, **kw),
                 _tiny_attn_cfg(ModelConfig, **kw))
    jp = jinit_tree(jattn.attn_params(jcfg), jax.random.PRNGKey(0))
    p = _bridge(jp)
    S = 12
    x = np.random.default_rng(3).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32) * 0.3
    pos = np.broadcast_to(np.arange(S), (2, S))
    if mrope:
        pos = np.broadcast_to(pos[..., None], (2, S, 3))
    full = attn.attention(p, cfg, _t(x), _t(pos), kind=kind, causal=True)
    want = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           kind=kind, causal=True)
    np.testing.assert_allclose(_np(full), np.asarray(want), atol=1e-5)
    cache = attn.init_kv_cache(cfg, 2, S, torch.float32, "cpu")
    outs = []
    for i in range(S):
        o, cache = attn.decode_attention(p, cfg, _t(x[:, i:i + 1]), cache,
                                         i, kind=kind)
        outs.append(o)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)),
                               atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------- Mamba-2
def _ssd_naive(x, dt, A, Bm, Cm):
    """O(L·N·P) literal recurrence oracle (tests/test_models.py's)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    S = np.zeros((Bsz, H, N, P))
    ys = np.zeros((Bsz, L, H, P))
    for t in range(L):
        a = np.exp(dt[:, t] * A[None, :])
        upd = np.einsum("bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        S = S * a[:, :, None, None] + upd
        ys[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], S)
    return ys, S


@pytest.mark.parametrize("L,chunk", [(16, 4), (13, 5), (8, 8), (7, 16)])
def test_ssd_chunked_matches_naive(L, chunk):
    """The chunked SSD scan against the literal recurrence and against the
    JAX package's ``ssd_chunked`` on the same inputs (ragged L pads the
    last chunk; chunk > L takes one chunk of L)."""
    rng = np.random.default_rng(4)
    B, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((B, L, H, P))
    dt = np.abs(rng.standard_normal((B, L, H))) * 0.5
    A = -np.abs(rng.standard_normal(H)) - 0.1
    Bm = rng.standard_normal((B, L, N))
    Cm = rng.standard_normal((B, L, N))
    args = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    y, S = mb.ssd_chunked(*map(_t, args), chunk)
    jy, jS = jmb.ssd_chunked(*map(jnp.asarray, args), chunk)
    y_ref, S_ref = _ssd_naive(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(_np(y), y_ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(S), S_ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(S), np.asarray(jS), atol=1e-4, rtol=1e-3)


def _mamba_setup(seed):
    jcfg, cfg = (jconfigs.get_smoke("mamba2-1.3b"),
                 configs.get_smoke("mamba2-1.3b"))
    jp = jinit_tree(jmb.mamba_params(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, _bridge(jp)


def test_mamba_decode_matches_forward():
    """Step-by-step recurrent decode reproduces the chunked forward, and
    the forward equals the JAX package's."""
    jcfg, cfg, jp, p = _mamba_setup(1)
    S = 10
    x = np.random.default_rng(5).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32) * 0.2
    full = mb.mamba_forward(p, cfg, _t(x))
    np.testing.assert_allclose(
        _np(full), np.asarray(jmb.mamba_forward(jp, jcfg, jnp.asarray(x))),
        atol=1e-5)
    cache = mb.init_mamba_cache(cfg, 2, "cpu")
    outs = []
    for i in range(S):
        o, cache = mb.mamba_decode_step(p, cfg, _t(x[:, i:i + 1]), cache)
        outs.append(o)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)),
                               atol=2e-4, rtol=1e-3)


def test_mamba_prefill_state_handoff():
    """The prefill's returned state (conv tail, SSM state: equal to the
    JAX package's) continues decoding as the full forward does; a prompt
    shorter than the conv's tail is left-padded as in the reference."""
    jcfg, cfg, jp, p = _mamba_setup(2)
    S = 12
    x = np.random.default_rng(6).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32) * 0.2
    _, c = mb.mamba_forward(p, cfg, _t(x[:, :8]), return_state=True)
    _, jc = jmb.mamba_forward(jp, jcfg, jnp.asarray(x[:, :8]),
                              return_state=True)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k]), atol=1e-5)
    outs = []
    for i in range(8, S):
        o, c = mb.mamba_decode_step(p, cfg, _t(x[:, i:i + 1]), c)
        outs.append(o)
    full = mb.mamba_forward(p, cfg, _t(x))[:, 8:]
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)),
                               atol=2e-4, rtol=1e-3)
    _, c2 = mb.mamba_forward(p, cfg, _t(x[:, :2]), return_state=True)
    _, jc2 = jmb.mamba_forward(jp, jcfg, jnp.asarray(x[:, :2]),
                               return_state=True)
    assert c2["conv"].shape == (1, cfg.ssm.conv_width - 1,
                                jc2["conv"].shape[-1])
    np.testing.assert_allclose(_np(c2["conv"]), np.asarray(jc2["conv"]),
                               atol=1e-5)


def test_ssd_gradients_finite_where_exp_would_overflow():
    """C4: the SSD masks the exponent before ``exp``.  With a large decay
    (A_log = log 100, dt ≈ 20: every step decays by e^-2000) the
    above-diagonal exponents cum_q - cum_s reach +3e4, where ``exp``
    overflows to inf; masking only the product would then turn every
    gradient into NaN.  The port's gradients of ``mamba_forward`` are
    finite and equal the JAX package's."""
    jcfg, cfg, jp, _ = _mamba_setup(3)
    jp = dict(jp, A_log=jnp.full_like(jp["A_log"], np.log(100.0)),
              dt_bias=jnp.full_like(jp["dt_bias"], 20.0))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32) * 0.2
    w = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    # the overflow is real: unmasked, the largest exponent is past f32
    dtv = np.log1p(np.exp(20.0))
    assert np.isinf(np.exp(np.float32(100.0 * dtv * 15)))

    def jloss(p):
        return jnp.sum(jmb.mamba_forward(p, jcfg, jnp.asarray(x)) * w)
    jg = jax.grad(jloss)(jp)
    p = {k: v.requires_grad_(True) for k, v in _bridge(jp).items()}
    (mb.mamba_forward(p, cfg, _t(x)) * _t(w)).sum().backward()
    for k, v in p.items():
        g = _np(v.grad)
        assert np.isfinite(g).all(), k
        _rel_close(g, np.asarray(jg[k]), 5e-4, k)


# ---------------------------------------------------------------- serving
def _jax_plan(jcfg):
    L = jmoe.num_moe_layers(jcfg)
    return jmoe.plan_to_arrays(jplacement.ep_materialization(
        jplacement.homogeneous_sharding(L, jcfg.moe.num_experts, 1)))


def _port_plan(cfg):
    L = moe.num_moe_layers(cfg)
    return moe.plan_to_arrays(placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1)), "cpu")


def _serve(mod, eng, prompts, kw):
    with mod.RequestScheduler(eng, **kw) as rs:
        assert all(rs._bucket(len(q)) == len(q) for q in prompts)
        reqs = [rs.submit(q, max_new_tokens=7) for q in prompts]
        rs.run(max_ticks=500)
        assert all(r.state == mod.DONE for r in reqs), \
            [(r.state, r.finish_reason) for r in reqs]
        return ([r.output() for r in reqs], [r.preemptions for r in reqs],
                rs.decode_ticks)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_paged_batching_with_mamba_layers_equals_jax(name):
    """Continuous batching of models with mamba layers: every prompt is
    prefilled at its exact length (padding would enter the SSM state), its
    state written into its slot's dense state, and a pool small enough
    that a sequence is preempted and re-prefilled (its slot's state then
    overwritten whole).  The greedy traces equal the JAX scheduler's,
    token for token (JAX's kernels in interpret mode, the port's plain
    versions)."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    moe_on = cfg.moe.enabled
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11]]
    # no deadline reaps a request: JAX compiles a prefill per exact length,
    # and the traces must not depend on how long that takes
    kw = dict(max_slots=2, num_pages=6, page_size=4, max_kv=16,
              default_ttl_s=3600.0)
    with jengine.Engine(jcfg, jmdl.Runtime(use_pallas=True), jparams,
                        max_len=16, pa=_jax_plan(jcfg) if moe_on
                        else None) as jeng:
        want, jpre, jticks = _serve(jsched, jeng, prompts, kw)
    with engine.Engine(cfg, mdl.Runtime(), _bridge(jparams), max_len=16,
                       pa=_port_plan(cfg) if moe_on else None) as eng:
        got, pre, ticks = _serve(sched, eng, prompts, kw)
    assert sum(jpre) >= 1               # the pool forced a preemption
    assert pre == jpre and ticks == jticks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_decode_after_prefill_matches_full_forward(name):
    """A prompt's prefill (``forward(collect_cache=True)``) handed to the
    dense and to the paged decode cache, then decode steps: each step's
    logits equal the full forward's at that position (2e-4 / 1e-3), and
    the full forward's logits equal the JAX package's within 1e-4 of the
    largest: on jamba's smoke config JAX's own f32 logits lie 3.3e-5 of
    it from its float64 ones, the port's 3.6e-5 from JAX's (measured on
    the CPU)."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(1))
    params = _bridge(jparams)
    pa = _port_plan(cfg) if cfg.moe.enabled else None
    rt = mdl.Runtime()
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 11)).astype(np.int32)
    full, _ = mdl.forward(cfg, rt, params, _t(toks), pa=pa)
    jfull, _ = jmdl.forward(jcfg, jmdl.Runtime(), jparams,
                            jnp.asarray(toks),
                            pa=_jax_plan(jcfg) if cfg.moe.enabled else None)
    _rel_close(_np(full), np.asarray(jfull), 1e-4, "full forward")
    n = 6
    _, _, pc = mdl.forward(cfg, rt, params, _t(toks[:, :n]), pa=pa,
                           collect_cache=True)
    dense = mdl.init_cache(cfg, 1, 16, "cpu")
    paged = mdl.init_paged_cache(cfg, 1, 5 * 4, "cpu")
    table = PageTable(page_size=4, max_kv=16, pages=[1, 2, 3, 4])
    rows = torch.as_tensor(table.row_idx()[:n]).long()
    for j, kind in enumerate(cfg.layer_pattern):
        for k, src in pc[f"l{j}"].items():
            if kind == "mamba":
                dense[f"l{j}"][k][:, 0] = src[:, 0]
                paged[f"l{j}"][k][:, 0] = src[:, 0]
            else:
                dense[f"l{j}"][k][:, 0, :n] = src[:, 0]
                paged[f"l{j}"][k][:, rows] = src[:, 0]
    row_idx = torch.as_tensor(table.row_idx()[None])
    for i in range(n, toks.shape[1]):
        t = _t(toks[:, i:i + 1])
        ld, _ = mdl.decode_step(cfg, rt, params, dense, t, i, pa)
        lp, _ = mdl.decode_step(cfg, rt, params, paged, t,
                                torch.tensor([i], dtype=torch.int32), pa,
                                row_idx=row_idx, page_size=4)
        for got in (ld, lp):
            np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, i]),
                                       atol=2e-4, rtol=1e-3)


_PARITY_VARIANTS = {
    "local": lambda c: c.replace(layer_pattern=("attn", "local"),
                                 sliding_window=5),
    "mrope": lambda c: c.replace(mrope=True),
}


@pytest.mark.parametrize("variant", sorted(_PARITY_VARIANTS))
def test_paged_decode_step_parity_vs_dense(variant):
    """Same trace, same KV width: every decode step's logits match between
    the dense cache and the paged pool (1e-5: the paged kernel's plain
    version reduces in another order than the dense path), for the
    sliding-window ``local`` and the M-RoPE variants of the gpt-moe-s
    smoke config; and the dense steps equal the JAX package's (1e-5 of
    the largest logit)."""
    mutate = _PARITY_VARIANTS[variant]
    jcfg = mutate(jconfigs.get_smoke("gpt-moe-s"))
    cfg = mutate(configs.get_smoke("gpt-moe-s"))
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    params, pa, jpa = _bridge(jparams), _port_plan(cfg), _jax_plan(jcfg)
    rt = mdl.Runtime()
    with engine.Engine(cfg, rt, params, max_len=16, pa=pa) as eng:
        premat = eng._materialized()
        dense_step = engine.build_serve_step(cfg, rt)
        paged_step = engine.build_paged_serve_step(cfg, rt, page_size=4)
        dense = mdl.init_cache(cfg, 1, 16, "cpu")
        paged = mdl.init_paged_cache(cfg, 1, 5 * 4, "cpu")
        row_idx = torch.as_tensor(
            PageTable(page_size=4, max_kv=16, pages=[1, 2, 3, 4])
            .row_idx()[None])
        jcache = jmdl.init_cache(jcfg, 1, 16)
        jstep = jax.jit(jengine.build_serve_step(jcfg, jmdl.Runtime()))
        for i, t in enumerate([3, 1, 4, 1, 5, 9, 2, 6]):
            tt = torch.tensor([[t]], dtype=torch.int32)
            ld, dense = dense_step(params, dense, tt, i, pa, premat)
            lp, paged = paged_step(params, paged, tt,
                                   torch.tensor([i], dtype=torch.int32),
                                   row_idx, pa, premat)
            jl, jcache = jstep(jparams, jcache, jnp.asarray([[t]]),
                               jnp.int32(i), jpa)
            np.testing.assert_allclose(_np(ld), _np(lp), atol=1e-5,
                                       rtol=1e-5)
            _rel_close(_np(ld), np.asarray(jl), 1e-5, f"step {i}")
