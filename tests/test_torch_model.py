"""The port's model modules against the JAX package, on the gpt-moe-s smoke
config (2 layers, d_model 128, 4 experts, f32) on the CPU.

Parameters are made by the JAX package and carried across with the weight
bridge; other inputs are made with numpy from a seed and fed to both.  JAX
runs its Pallas kernels in interpret mode (``Runtime(use_pallas=True)``);
the port runs its kernels' plain versions.  Tolerances, relative to each tensor's
largest entry: 1e-5 for single layers, 1e-4 for the whole model (f32 sums
taken in other orders).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jly  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve.kv_pool import PageTable  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.params import (params_from_jax,  # noqa: E402
                                       params_to_numpy)
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as ly  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402

ARCH = "gpt-moe-s"


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else a, np.float32)


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|): f32 sums of terms as large
    as the tensor's largest entry differ by their rounding, whatever the
    size of the entry they land in."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=0)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke(ARCH)
    cfg = configs.get_smoke(ARCH)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_tree, "cpu")
    L = jmoe.num_moe_layers(jcfg)
    jplan = jplacement.ep_materialization(
        jplacement.homogeneous_sharding(L, jcfg.moe.num_experts, 1))
    plan = placement.ep_materialization(
        placement.homogeneous_sharding(L, cfg.moe.num_experts, 1))
    jpa = jmoe.plan_to_arrays(jplan)
    pa = moe.plan_to_arrays(plan, "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_tree=np_tree,
                params=params, jpa=jpa, pa=pa)


def test_config_and_plan_tables_match(setup):
    assert setup["cfg"] == setup["cfg"].replace()
    for f in ("num_layers", "d_model", "num_heads", "head_dim", "act",
              "norm", "dtype", "vocab_size"):
        assert getattr(setup["cfg"], f) == getattr(setup["jcfg"], f)
    for a, b in zip(setup["pa"], setup["jpa"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bridge_round_trip_is_bit_exact(setup):
    back = params_to_numpy(setup["params"])
    flat_w = jax.tree_util.tree_flatten_with_path(setup["np_tree"])[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_b]
    for (_, w), (_, b) in zip(flat_w, flat_b):
        assert w.dtype == b.dtype and w.shape == b.shape
        np.testing.assert_array_equal(w, b)


def test_init_params_shapes_match_jax(setup):
    own = params_to_numpy(mdl.init_params(setup["cfg"], 0, "cpu"))
    shapes = jax.tree.map(lambda a: a.shape, setup["np_tree"])
    assert jax.tree.map(lambda a: a.shape, own) == shapes


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(64).astype(np.float32)
    want = jly.apply_norm({"scale": jnp.asarray(s)}, jnp.asarray(x), kind)
    got = ly.apply_norm({"scale": torch.from_numpy(s)}, torch.from_numpy(x),
                        kind)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu_glu"])
def test_mlp_embed_unembed_rope_match_jax(act):
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _close(ly.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), act),
           jly.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), act), 1e-5)
    table = rng.standard_normal((50, 32)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 3)).astype(np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        e_t = ly.embed({"embedding": torch.from_numpy(table)},
                       torch.from_numpy(toks), dt)
        e_j = jly.embed({"embedding": jnp.asarray(table)}, jnp.asarray(toks),
                        jdt)
        assert e_t.dtype == dt
        np.testing.assert_array_equal(_np(e_t), _np(e_j))
    _close(ly.unembed({"embedding": torch.from_numpy(table)},
                      torch.from_numpy(x), softcap=5.0),
           jly.unembed({"embedding": jnp.asarray(table)}, jnp.asarray(x),
                       softcap=5.0), 1e-5)
    xr = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    _close(ly.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos)),
           jly.apply_rope(jnp.asarray(xr), jnp.asarray(pos)), 1e-4)


def test_prefill_attention_with_kv_matches_jax(setup):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)[None]
    jp = jax.tree.map(lambda a: a[0], setup["jparams"]["blocks"]["l0"]["attn"])
    tp = {k: v[0] for k, v in setup["params"]["blocks"]["l0"]["attn"].items()}
    want, wkv = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                use_pallas=True, return_kv=True)
    got, gkv = attn.attention(tp, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), use_pallas=True,
                              return_kv=True)
    _close(got, want, 1e-5)
    _close(gkv["k"], wkv["k"], 1e-5)
    _close(gkv["v"], wkv["v"], 1e-5)


def test_decode_attention_paged_matches_jax(setup):
    """Two live sequences and two idle slots parked on the trash page: the
    outputs of the live ones and every pool row but row 0 match.  Row 0
    takes both idle slots' writes (no defined winner on CUDA) and no live
    sequence reads it."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    ps, max_kv, num_rows = 4, 16, 10 * 4
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    shape = (num_rows, cfg.num_kv_heads, cfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    ri = np.stack([PageTable(ps, max_kv, [3, 1]).row_idx(),
                   PageTable(ps, max_kv, []).row_idx(),
                   PageTable(ps, max_kv, [2, 5, 7]).row_idx(),
                   PageTable(ps, max_kv, []).row_idx()])
    pos = np.asarray([6, 0, 9, 0], np.int32)
    live = [0, 2]
    for b in live:                      # no live sequence reads row 0
        assert (ri[b, :pos[b] + 1] != 0).all()
    jp = jax.tree.map(lambda a: a[0], setup["jparams"]["blocks"]["l0"]["attn"])
    tp = {k: v[0] for k, v in setup["params"]["blocks"]["l0"]["attn"].items()}
    want, wc = jattn.decode_attention_paged(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(pos), jnp.asarray(ri), page_size=ps)
    tc = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, gc = attn.decode_attention_paged(tp, cfg, torch.from_numpy(x), tc,
                                          torch.from_numpy(pos),
                                          torch.from_numpy(ri), page_size=ps)
    assert gc["k"] is tc["k"]            # updated in place
    _close(got[live], np.asarray(want)[live], 1e-5)
    for kv in ("k", "v"):
        _close(gc[kv][1:], np.asarray(wc[kv])[1:], 1e-5)


def _gate_inputs(cfg, tie: bool):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((12, cfg.d_model)).astype(np.float32)
    wr = rng.standard_normal((cfg.d_model, cfg.moe.num_experts)) \
        .astype(np.float32) * 0.1
    if tie:
        x[:3] = 0.0                     # uniform probabilities: all tied
        wr[:, 3] = wr[:, 1]             # experts 1 and 3 tie everywhere
    valid = np.ones(12, bool)
    valid[-2:] = False
    return x, wr, valid


@pytest.mark.parametrize("tie", [False, True])
def test_gate_matches_jax_including_ties(setup, tie):
    cfg = setup["cfg"]
    x, wr, valid = _gate_inputs(cfg, tie)
    want = jmoe.gate(setup["jcfg"], jnp.asarray(wr), jnp.asarray(x),
                     jnp.asarray(valid))
    got = moe.gate(cfg, torch.from_numpy(wr), torch.from_numpy(x),
                   torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if tie:                             # lower index wins, as in top_k
        np.testing.assert_array_equal(got[0][:3].numpy(), [[0, 1]] * 3)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-6)


def test_segment_ranks_and_replica_dispatch_match_jax(setup):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 5, 40).astype(np.int32)
    np.testing.assert_array_equal(
        moe.segment_ranks(torch.from_numpy(keys)).numpy(),
        np.asarray(jmoe.segment_ranks(jnp.asarray(keys))))
    E = setup["cfg"].moe.num_experts
    e = rng.integers(0, E, 30).astype(np.int32)
    valid = rng.random(30) > 0.2
    for capacity in (30, 3):           # ample, and dropping
        jl = jax.tree.map(lambda a: a[0], setup["jpa"])
        tl = setup["pa"].layer(0)
        want = jmoe.replica_dispatch(
            jnp.asarray(e), jnp.asarray(valid), jl.expert_slot, jl.replicas,
            jl.n_replicas, 0, E, capacity, True)
        got = moe.replica_dispatch(
            torch.from_numpy(e), torch.from_numpy(valid), tl.expert_slot,
            tl.replicas, tl.n_replicas, 0, E, capacity, True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_materialize_chunks_equals_owner_rows(setup):
    cfg, pa = setup["cfg"], setup["pa"]
    buf = setup["params"]["moe_buffer"]
    slots = moe.materialize_chunks(cfg, buf, pa)
    L, E = pa.owner_row.shape
    assert slots.shape == (L, 1, E, buf.shape[1])
    for l in range(L):
        torch.testing.assert_close(slots[l, 0], buf[pa.owner_row[l].long()],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("with_slots", [False, True])
def test_moe_layer_matches_jax_meshless(setup, with_slots):
    """The world-size-1 sort-based layer equals the JAX package's mesh-less
    layer (the dense oracle) to 1e-5, and so does the port's oracle."""
    cfg = setup["cfg"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((19, cfg.d_model)).astype(np.float32)
    wr = setup["np_tree"]["router"][1]
    buf = setup["params"]["moe_buffer"]
    jl = jax.tree.map(lambda a: a[1], setup["jpa"])
    want, waux = jmoe.moe_layer(setup["jcfg"], jmoe.MoERuntime(),
                                jnp.asarray(x), jnp.asarray(wr),
                                jnp.asarray(setup["np_tree"]["moe_buffer"]),
                                jl)
    premat = moe.materialize_chunks(cfg, buf, setup["pa"])[1] \
        if with_slots else None
    got, aux = moe.moe_layer(cfg, mdl.Runtime(), torch.from_numpy(x),
                             torch.from_numpy(wr), buf,
                             setup["pa"].layer(1), premat=premat)
    _close(got, want, 1e-5)
    _close(aux.counts, waux.counts, 0)
    assert float(aux.dropped_frac) == 0.0
    idx, vals, *_ = moe.gate(cfg, torch.from_numpy(wr), torch.from_numpy(x),
                             torch.ones(19, dtype=torch.bool))
    ref, _ = moe.moe_layer_ref(cfg, torch.from_numpy(x), idx, vals, buf,
                               setup["pa"].layer(1))
    _close(ref, want, 1e-5)


def _jax_rt():
    return jmdl.Runtime(use_pallas=True)


def test_forward_collect_cache_and_paged_decode_match_jax(setup):
    """Prefill logits and K/V cache, then three paged decode steps (with
    the engine's slot cache), against the JAX package at 1e-4."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    wl, _, wcache = jmdl.forward(jcfg, _jax_rt(), setup["jparams"],
                                 jnp.asarray(toks), pa=setup["jpa"],
                                 collect_cache=True)
    gl, _, gcache = mdl.forward(cfg, mdl.Runtime(), setup["params"],
                                torch.from_numpy(toks), pa=setup["pa"],
                                collect_cache=True)
    _close(gl, wl, 1e-4)
    for name in wcache:
        for kv in ("k", "v"):
            _close(gcache[name][kv], wcache[name][kv], 1e-4)

    ps, max_kv, num_rows = 4, 16, 9 * 4
    ri = np.stack([PageTable(ps, max_kv, [2, 4]).row_idx(),
                   PageTable(ps, max_kv, [1, 3, 6]).row_idx()])
    pos = np.asarray([5, 9], np.int32)
    jc = jmdl.init_paged_cache(jcfg, 2, num_rows)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jc)
    tc = {n: {kv: torch.from_numpy(np.array(a, copy=True))
              for kv, a in c.items()} for n, c in jc.items()}
    premat = moe.materialize_chunks(cfg, setup["params"]["moe_buffer"],
                                    setup["pa"])
    for step in range(3):
        t = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        wl, jc = jmdl.decode_step(jcfg, _jax_rt(), setup["jparams"], jc,
                                  jnp.asarray(t), jnp.asarray(pos),
                                  setup["jpa"], row_idx=jnp.asarray(ri),
                                  page_size=ps)
        gl, tc = mdl.decode_step(cfg, mdl.Runtime(), setup["params"], tc,
                                 torch.from_numpy(t), torch.from_numpy(pos),
                                 setup["pa"], premat,
                                 row_idx=torch.from_numpy(ri), page_size=ps)
        _close(gl, wl, 1e-4)
        for n in jc:
            for kv in ("k", "v"):
                _close(tc[n][kv], jc[n][kv], 1e-4)
        pos = pos + 1
