"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's ops take their plain PyTorch versions
(``repro_torch/kernels/ref.py``); the JAX kernels run in interpret mode, as
tests/test_kernels.py runs them.  The same numpy inputs, made from a seed,
go to both.  Tolerances are those of tests/test_kernels.py: f32 2e-5 /
2e-4 (paged 1e-6), bf16 2e-2.  tests/test_torch_kernels_gpu.py holds the
CUDA kernels against these plain versions on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import grouped_mlp as jgm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve.kv_pool import PageTable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-4)


def _paged_tol(dtype):
    return dict(atol=1e-6, rtol=1e-6) if dtype == "float32" \
        else dict(atol=2e-2, rtol=2e-2)


def _both(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return jnp.asarray(a), torch.from_numpy(a.copy())
    return jnp.asarray(a, jd), torch.from_numpy(a.copy()).to(td)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# B1: grouped-MLP forward
# ---------------------------------------------------------------------------
def _gmlp_inputs(seed, K, T, D, F, act):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, T, D)) * 0.3
    wi = rng.standard_normal((K, D, F)) * 0.05
    wg = rng.standard_normal((K, D, F)) * 0.05 if act.endswith("_glu") \
        else None
    wo = rng.standard_normal((K, F, D)) * 0.05
    return x, wi, wg, wo, rng


@pytest.mark.parametrize("K,T,D,F", [(1, 128, 128, 128), (4, 256, 128, 256),
                                     (3, 96, 64, 200), (8, 4, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_matches_jax(K, T, D, F, dtype, act):
    x, wi, wg, wo, rng = _gmlp_inputs(K * T + D, K, T, D, F, act)
    gs = rng.integers(0, T + 1, (K,)).astype(np.int32)
    j = [_both(a, dtype) if a is not None else (None, None)
         for a in (x, wi, wg, wo)]
    gj, gt = _both(gs)
    want = jops.grouped_mlp(*[a[0] for a in j], gj, act=act)
    got = ops.grouped_mlp(*[a[1] for a in j], gt, act=act)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("case", ["zero_groups", "all_full", "row_valid"])
def test_grouped_mlp_adversarial_validity(case):
    """Every group empty, every group full, and scattered row validity
    (segment prefixes of three 128-row stripes, one stripe all invalid)."""
    K, T, D, F = 2, 384, 64, 128
    x, wi, wg, wo, _ = _gmlp_inputs(11, K, T, D, F, "gelu")
    gs = rv = None
    if case == "row_valid":
        cnt = np.asarray([[128, 0, 60], [0, 5, 128]])
        rv = np.zeros((K, T), bool)
        for k in range(K):
            for r in range(3):
                rv[k, r * 128:r * 128 + cnt[k, r]] = True
    else:
        gs = np.full((K,), 0 if case == "zero_groups" else T, np.int32)
    xj, xt = _both(x)
    wij, wit = _both(wi)
    woj, wot = _both(wo)
    kw_j = dict(group_sizes=None if gs is None else jnp.asarray(gs),
                row_valid=None if rv is None else jnp.asarray(rv))
    kw_t = dict(group_sizes=None if gs is None else torch.from_numpy(gs),
                row_valid=None if rv is None else torch.from_numpy(rv))
    want = jops.grouped_mlp(xj, wij, None, woj, act="gelu", **kw_j)
    got = ops.grouped_mlp(xt, wit, None, wot, act="gelu", **kw_t)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))
    if case == "zero_groups":
        assert (got == 0).all()
    if case == "row_valid":
        assert (got.numpy()[~rv] == 0).all()


def _padded_list_masks():
    """(K, T) masks for the inference form's tile list: every slot empty,
    every slot full, T not a multiple of 64 with an empty, a ragged and a
    full slot, the scattered stripes above, a slot holding only the last
    row of a ragged tile, the decode tick's (8 of 64 slots hold one row)
    and a 512-bucket prefill's (~16 rows a slot)."""
    rng = np.random.default_rng(5)
    out = {"zero_groups": np.zeros((3, 256), bool),
           "all_full": np.ones((3, 256), bool),
           "odd_T": np.arange(96)[None, :] < np.asarray([0, 37, 96])[:, None]}
    stripes = np.zeros((2, 384), bool)
    for k, cnt in enumerate([[128, 0, 60], [0, 5, 128]]):
        for r, c in enumerate(cnt):
            stripes[k, r * 128:r * 128 + c] = True
    out["scattered"] = stripes
    last = rng.random((4, 200)) < 0.1
    last[0] = False
    last[1] = np.arange(200) == 199
    out["last_row"] = last
    dec = np.zeros((64, 4), bool)
    dec[rng.permutation(64)[:8], 0] = True
    out["decode"] = dec
    cnt = np.bincount(rng.integers(0, 64, 1024), minlength=64)
    out["prefill"] = np.arange(512)[None, :] < cnt[:, None]
    return out


PADDED_LIST_MASKS = _padded_list_masks()


@pytest.mark.parametrize("case", list(PADDED_LIST_MASKS))
def test_tile_list_padded_is_pallas_skip_table(case):
    """The bf16 inference form's grid (``ref.tile_list_padded``, the plain
    version of the list its C call builds on the device): K·ceil(T/64)
    int32 entries, first the ids k·nt + t of the 64-row tiles whose count
    in the Pallas skip table (``_tile_counts``) is not zero, increasing,
    then -1."""
    mask = PADDED_LIST_MASKS[case]
    K, T = mask.shape
    counts = np.asarray(jgm._tile_counts(
        jgm._pad_to(jnp.asarray(mask, jnp.int32), 1, 64), 64))
    want = np.flatnonzero(counts)
    got = ref.tile_list_padded(torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (K * (-(-T // 64)),)
    np.testing.assert_array_equal(got[:want.size].numpy(), want)
    assert (got[want.size:] == -1).all()


# ---------------------------------------------------------------------------
# B4: flash-attention forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,NQ,NKV,H", [(1, 128, 4, 4, 64),
                                          (2, 256, 4, 2, 64),
                                          (1, 8, 2, 2, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_attention_matches_jax(B, S, NQ, NKV, H, dtype, causal, window):
    rng = np.random.default_rng(S + NQ)
    q, k, v = (_both(rng.standard_normal((B, S, n, H)) * s, dtype)
               for n, s in ((NQ, 0.4), (NKV, 0.4), (NKV, 0.6)))
    want = jops.flash_attention(q[0], k[0], v[0], causal=causal,
                                window=window)
    got = ops.flash_attention(q[1], k[1], v[1], causal=causal, window=window)
    assert got.dtype == q[1].dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("S", [8, 24, 32, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_flash_attention_tiled_ref_matches_jax(S, dtype, causal, window):
    """The bf16 kernel's step-wise arithmetic (64×64 tiles, padded rows and
    columns, q and p rounded where the TPU kernel rounds them) against the
    Pallas kernel; window 40 crosses the 64-row tile edges.  H is 32 at
    S = 8 and 128, else 64."""
    H = 32 if S in (8, 128) else 64
    rng = np.random.default_rng(S + window)
    q, k, v = (_both(rng.standard_normal((2, S, 3, H)) * s, dtype)
               for s in (0.4, 0.4, 0.6))
    want = jops.flash_attention(q[0], k[0], v[0], causal=causal,
                                window=window)
    got = ref.flash_attention_tiled_ref(q[1], k[1], v[1], causal=causal,
                                        window=window)
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# B5: paged decode attention
# ---------------------------------------------------------------------------
PS, MAX_KV = 4, 16


def _paged_case(seed, positions, nkv, group, h=32, num_pages=24,
                dtype="float32"):
    """Adversarial page layouts: shuffled, non-contiguous pages."""
    rng = np.random.default_rng(seed)
    b, nq = len(positions), nkv * group
    q = rng.standard_normal((b, nq, h)) * 0.4
    k = rng.standard_normal((num_pages * PS, nkv, h)) * 0.4
    v = rng.standard_normal((num_pages * PS, nkv, h)) * 0.6
    avail = list(range(1, num_pages))
    rng.shuffle(avail)
    rows = [PageTable(PS, MAX_KV, [avail.pop() for _ in range(p // PS + 1)]
                      ).row_idx() for p in positions]
    return (_both(q, dtype), _both(k, dtype), _both(v, dtype),
            _both(np.stack(rows)), _both(np.asarray(positions, np.int32)))


def _paged_both(case, **kw):
    q, k, v, ri, pos = case
    want = jops.paged_decode_attention(q[0], k[0], v[0], ri[0], pos[0],
                                       page_size=PS, **kw)
    got = ops.paged_decode_attention(q[1], k[1], v[1], ri[1], pos[1],
                                     page_size=PS, **kw)
    return _f32(got), _f32(want)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_gqa_ragged_matches_jax(group, dtype):
    got, want = _paged_both(_paged_case(group * 31, [2, 7, 11, 0, 15],
                                        nkv=2, group=group, dtype=dtype))
    np.testing.assert_allclose(got, want, **_paged_tol(dtype))


def test_paged_decode_position_edges_match_jax():
    got, want = _paged_both(_paged_case(3, [0, PS - 1, PS, MAX_KV - 1],
                                        nkv=4, group=1))
    np.testing.assert_allclose(got, want, **_paged_tol("float32"))


def test_paged_decode_trash_page_never_contributes():
    """Poisoning the trash page 0 changes no live sequence's output."""
    q, k, v, ri, pos = _paged_case(9, [5, 0, 13], nkv=2, group=2)
    clean = ops.paged_decode_attention(q[1], k[1], v[1], ri[1], pos[1],
                                       page_size=PS)
    kp, vp = k[1].clone(), v[1].clone()
    kp[:PS] = 1e4
    vp[:PS] = 1e4
    poison = ops.paged_decode_attention(q[1], kp, vp, ri[1], pos[1],
                                        page_size=PS)
    np.testing.assert_array_equal(clean.numpy(), poison.numpy())


def test_paged_decode_parked_slot_matches_jax():
    """An idle slot (no pages, position 0) reduces over trash row 0 alone,
    in both packages."""
    rng = np.random.default_rng(17)
    q = _both(rng.standard_normal((2, 4, 32)) * 0.4)
    k = _both(rng.standard_normal((5 * PS, 2, 32)))
    v = _both(rng.standard_normal((5 * PS, 2, 32)))
    ri = _both(np.stack([PageTable(PS, MAX_KV, [2, 1]).row_idx(),
                         PageTable(PS, MAX_KV, []).row_idx()]))
    pos = _both(np.asarray([6, 0], np.int32))
    got, want = _paged_both((q, k, v, ri, pos))
    np.testing.assert_allclose(got, want, **_paged_tol("float32"))
    np.testing.assert_allclose(got[1], _f32(v[1])[0].reshape(1, 2, 32)
                               .repeat(2, 1).reshape(4, 32), atol=1e-6)


@pytest.mark.parametrize("window", [3, 4, 7])
def test_paged_decode_window_matches_jax(window):
    got, want = _paged_both(_paged_case(window, [2, 7, 11, 15], nkv=2,
                                        group=2), window=window)
    np.testing.assert_allclose(got, want, **_paged_tol("float32"))


def test_paged_decode_softcap_matches_jax():
    got, want = _paged_both(_paged_case(23, [3, 9, 14], nkv=2, group=2),
                            softcap=50.0)
    np.testing.assert_allclose(got, want, **_paged_tol("float32"))


def _split_both(case, n_warps, **kw):
    q, k, v, ri, pos = case
    want = jops.paged_decode_attention(q[0], k[0], v[0], ri[0], pos[0],
                                       page_size=PS, **kw)
    got = ref.paged_decode_attention_split_ref(
        q[1], k[1], v[1], ri[1], pos[1], page_size=PS, n_warps=n_warps, **kw)
    assert got.dtype == q[1].dtype
    return _f32(got), _f32(want)


@pytest.mark.parametrize("n_warps", [1, 4, 8])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_ref_matches_jax(n_warps, group, dtype):
    """The CUDA kernel's step-wise arithmetic (pages dealt round-robin to
    warps, per-warp online softmax, fixed-order merge) against the Pallas
    kernel.  Positions 0..15 hold 1 to 4 pages, so at 4 and 8 warps some
    warps get no page."""
    got, want = _split_both(_paged_case(group * 7 + n_warps,
                                        [2, 7, 11, 0, 15], nkv=2,
                                        group=group, dtype=dtype), n_warps)
    np.testing.assert_allclose(got, want, **_paged_tol(dtype))


@pytest.mark.parametrize("n_warps", [1, 4, 8])
@pytest.mark.parametrize("window,softcap", [(7, 0.0), (0, 50.0), (5, 30.0)])
def test_paged_split_ref_window_softcap_matches_jax(n_warps, window,
                                                    softcap):
    got, want = _split_both(_paged_case(window + n_warps, [2, 7, 11, 15],
                                        nkv=2, group=2), n_warps,
                            window=window, softcap=softcap)
    np.testing.assert_allclose(got, want, **_paged_tol("float32"))


@pytest.mark.parametrize("n_warps", [1, 8])
def test_paged_split_ref_parked_slot_matches_jax(n_warps):
    """An idle slot (no pages, position 0) reduces over trash row 0 alone;
    at 8 warps seven of its warps are empty and change nothing."""
    rng = np.random.default_rng(19)
    q = _both(rng.standard_normal((2, 4, 32)) * 0.4)
    k = _both(rng.standard_normal((5 * PS, 2, 32)))
    v = _both(rng.standard_normal((5 * PS, 2, 32)))
    ri = _both(np.stack([PageTable(PS, MAX_KV, [2, 1]).row_idx(),
                         PageTable(PS, MAX_KV, []).row_idx()]))
    pos = _both(np.asarray([6, 0], np.int32))
    got, want = _split_both((q, k, v, ri, pos), n_warps)
    np.testing.assert_allclose(got, want, **_paged_tol("float32"))
    np.testing.assert_array_equal(
        got[1], _f32(v[1])[0].reshape(1, 2, 32).repeat(2, 1).reshape(4, 32))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def test_ops_route_cpu_tensors_to_plain_versions():
    """CPU tensors take the plain versions: no kernel launch is counted and
    the results are the plain versions' bit for bit."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    wi = torch.from_numpy(rng.standard_normal((2, 32, 48)).astype(np.float32))
    wo = torch.from_numpy(rng.standard_normal((2, 48, 32)).astype(np.float32))
    gs = torch.tensor([3, 16], dtype=torch.int32)
    torch.testing.assert_close(
        ops.grouped_mlp(x, wi, None, wo, gs, act="gelu"),
        ref.grouped_mlp_ref(x, wi, None, wo, act="gelu", group_sizes=gs),
        rtol=0, atol=0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    torch.testing.assert_close(ops.flash_attention(q, q, q),
                               ref.flash_attention_ref(q, q, q),
                               rtol=0, atol=0)
    (qp, kp, vp, ri, pos) = [a[1] for a in _paged_case(1, [3, 9], 2, 2)]
    torch.testing.assert_close(
        ops.paged_decode_attention(qp, kp, vp, ri, pos, page_size=PS),
        ref.paged_decode_attention_ref(qp, kp, vp, ri, pos), rtol=0, atol=0)
    assert ops.launch_counts() == {"grouped_mlp_fwd": 0,
                                   "grouped_mlp_fwd_train": 0,
                                   "grouped_mlp_dgrad": 0,
                                   "grouped_mlp_wgrad": 0,
                                   "flash_attention_fwd": 0,
                                   "paged_decode_attention": 0}
