"""The paged decode's gather path, the JAX package's pure-XLA fallback of
``decode_attention_paged``: with ``page_size=None``, or with
``cfg.paged_attn_kernel=False``, each attention layer gathers
``k[row_idx]`` and ``v[row_idx]`` and runs the dense path's ``_sdpa``.

Two laws, as ``tests/test_serve_batching.py`` states them for the JAX
package: in f32 the gather path is BIT-identical to a dense-cache trace of
the same sequence (masked rows softmax to exact zeros and the reduction
has the dense path's width), and each attention layer's gather path
matches the JAX package's on the same weights and pool within ``TOL`` of
its largest output, for global attention, ``local`` layers with a window,
M-RoPE and Gemma-2's softcap.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmdl  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.common.params import params_from_jax  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serve.kv_pool import PageTable  # noqa: E402

# one layer's gather path, port against JAX, relative to the largest output:
# f32 einsums summed in other orders.  Measured: at most 2.0e-7 without a
# softcap, 1.04e-6 in Gemma-2's global layer (softcap 50, outputs up to 53),
# so the limit sits just above that, not at the reference's 1e-6
TOL = 1.5e-6
PAGE, MAX_KV = 4, 16
TOKENS = [3, 1, 4, 1, 5, 9, 2, 6]

VARIANTS = {
    "attn": ("gpt-moe-s", {}),
    "local": ("gpt-moe-s", {"layer_pattern": ("attn", "local"),
                            "sliding_window": 5}),
    "mrope": ("gpt-moe-s", {"mrope": True}),
    # local / global layers, attention and final logit softcaps
    "gemma2": ("gemma2-9b", {"sliding_window": 5}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(variant):
    arch, kw = VARIANTS[variant]
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32", **kw)
    cfg = configs.get_smoke(arch).replace(dtype="float32", **kw)
    return jcfg, cfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gather_path_is_bit_identical_to_dense_decode(variant):
    """One sequence decoded through the dense cache and through the paged
    pool: every step's logits are the same bits, whether the gather path
    runs for want of ``page_size`` or because the config turns the kernel
    off."""
    _, cfg = _configs(variant)
    params = mdl.init_params(cfg, 0, "cpu")
    pa = None
    if cfg.moe.enabled:
        pa = moe.plan_to_arrays(placement.ep_materialization(
            placement.homogeneous_sharding(moe.num_moe_layers(cfg),
                                           cfg.moe.num_experts, 1)), "cpu")
    rt = mdl.Runtime()
    row_idx = torch.as_tensor(
        PageTable(PAGE, MAX_KV, [1, 2, 3, 4]).row_idx()[None])
    off = cfg.replace(paged_attn_kernel=False)
    dense = mdl.init_cache(cfg, 1, MAX_KV, "cpu")
    paged = {ps: mdl.init_paged_cache(cfg, 1, 5 * PAGE, "cpu")
             for ps in (None, PAGE)}
    with torch.no_grad():
        for i, t in enumerate(TOKENS):
            tok = torch.tensor([[t]], dtype=torch.int32)
            want, _ = mdl.decode_step(cfg, rt, params, dense, tok, i, pa)
            pos = torch.tensor([i], dtype=torch.int32)
            for ps, c in ((None, cfg), (PAGE, off)):
                got, _ = mdl.decode_step(c, rt, params, paged[ps], tok, pos,
                                         pa, row_idx=row_idx, page_size=ps)
                assert torch.equal(got, want), (variant, i, ps)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gather_path_matches_jax(variant):
    """Each attention layer kind of the variant, the same weights, query
    tokens and pool in both packages: three sequences at their own
    positions, one reading the trash page past its pages; the outputs and
    the written pool rows (but the trash row 0) agree."""
    jcfg, cfg = _configs(variant)
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    tables = np.stack([PageTable(PAGE, MAX_KV, [3, 1, 5, 4]).row_idx(),
                       PageTable(PAGE, MAX_KV, [2, 6]).row_idx(),
                       PageTable(PAGE, MAX_KV, [7]).row_idx()])
    pos = np.asarray([13, 6, 2], np.int32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    shape = (8 * PAGE, cfg.num_kv_heads, cfg.head_dim)
    pool = {kv: rng.standard_normal(shape).astype(np.float32)
            for kv in ("k", "v")}
    for j, kind in enumerate(cfg.layer_pattern):
        jp = jax.tree.map(lambda a: a[0],
                          jparams["blocks"][f"l{j}"]["attn"])
        tp = {k: v[0] for k, v in params["blocks"][f"l{j}"]["attn"].items()}
        want, wc = jattn.decode_attention_paged(
            jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in pool.items()},
            jnp.asarray(pos), jnp.asarray(tables), kind=kind,
            page_size=None)
        tc = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        got, gc = attn.decode_attention_paged(
            tp, cfg, torch.from_numpy(x), tc, torch.from_numpy(pos),
            torch.from_numpy(tables), kind=kind, page_size=None)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, (variant, kind, err)
        for kv in ("k", "v"):
            w = np.asarray(wc[kv])[1:]
            assert np.abs(gc[kv][1:].numpy() - w).max() <= TOL * np.abs(
                w).max(), (variant, kind, kv)
