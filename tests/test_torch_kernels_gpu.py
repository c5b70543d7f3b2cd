"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py

Tolerances: f32 2e-5 / 2e-4 (paged 1e-5), bf16 2e-2 — the kernels sum in
another order than the plain versions, and bf16 rounds inputs and outputs.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve.kv_pool import PageTable  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
PS, MAX_KV = 4, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, scale, dtype, dev):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev, dtype)


def _both(fn):
    """(kernel result, plain result) of one op call, with launch counts."""
    before = ops.launch_counts()
    got = fn()
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    with ops.reference_mode():
        want = fn()
    assert sum(launched.values()) == 1, launched
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("T", [4, 300])
def test_grouped_mlp_kernel_matches_plain(cuda, dtype, act, T):
    K, D, F = 3, 192, 200
    rng = np.random.default_rng(T)
    x = _t(rng, (K, T, D), 0.3, dtype, cuda)
    wi = _t(rng, (K, D, F), 0.05, dtype, cuda)
    wg = _t(rng, (K, D, F), 0.05, dtype, cuda) if act.endswith("_glu") \
        else None
    wo = _t(rng, (K, F, D), 0.05, dtype, cuda)
    gs = torch.tensor([0, min(37, T - 1), T], dtype=torch.int32, device=cuda)
    got, want = _both(lambda: ops.grouped_mlp(x, wi, wg, wo, gs, act=act))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert (got[0] == 0).all() and (got[1, int(gs[1]):] == 0).all()


@pytest.mark.gpu
def test_grouped_mlp_kernel_row_valid(cuda):
    K, T, D, F = 2, 384, 64, 128
    rng = np.random.default_rng(11)
    x = _t(rng, (K, T, D), 0.3, torch.float32, cuda)
    wi = _t(rng, (K, D, F), 0.05, torch.float32, cuda)
    wo = _t(rng, (K, F, D), 0.05, torch.float32, cuda)
    rv = torch.zeros((K, T), dtype=torch.bool, device=cuda)
    rv[0, :128] = rv[0, 256:316] = rv[1, 128:133] = rv[1, 256:] = True
    got, want = _both(lambda: ops.grouped_mlp(x, wi, None, wo, None, rv,
                                              act="gelu"))
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert (got[~rv] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,causal,window", [(256, True, 0), (256, True, 64),
                                             (8, True, 0), (128, False, 0),
                                             (24, True, 0), (32, True, 0),
                                             (512, True, 0), (512, True, 96),
                                             (128, True, 96),
                                             (512, False, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, S, causal, window):
    """Short prompts and the served buckets; window 96 crosses the kernel's
    64-row query and key tiles."""
    rng = np.random.default_rng(S)
    q, k, v = (_t(rng, (2, S, 3, 64), 0.5, dtype, cuda) for _ in range(3))
    got, want = _both(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                  window=window))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# The redesigned kernels against their step-wise plain versions
# (kernels/ref.py), which round where the kernels round.  bf16 flash: two
# f32 sums in different orders can still land an output, or rarely one
# probability, on neighbouring bf16 values: at most one output ulp
# (2^-7 of |x|) plus one probability ulp (2^-8 · |v| / l, ≤ 4e-3 for
# these inputs, |v| < 3 and l ≥ 1).  Paged: every sum is f32 and only the
# output is rounded: 1e-6 in f32, one output ulp in bf16.
TILED_TOL = dict(atol=4e-3, rtol=2 ** -7)
SPLIT_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-6),
             torch.bfloat16: dict(atol=1e-6, rtol=2 ** -7)}
PAGED_WARPS = 8       # PA_WARPS of csrc/paged_attention.cu


def _offset_copy(t):
    """A contiguous copy of ``t`` that starts one element into its storage,
    so its rows are not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,window,shift", [
    (24, 32, 0, None), (128, 64, 0, None), (512, 64, 0, None),
    (512, 64, 96, None), (256, 32, 40, None),
    (256, 40, 0, None), (24, 40, 0, None),     # 16-byte copies, H padded
    (256, 36, 96, None), (24, 36, 0, None),    # element-wise, H padded
    (128, 64, 0, 0), (256, 64, 96, 1), (128, 40, 0, 2),    # unaligned q/k/v
    (512, 96, 0, None), (32, 96, 0, None),     # gpt-moe-l's heads, padded
    (512, 128, 0, None), (256, 128, 96, None), (128, 128, 0, None)])
def test_flash_attention_kernel_matches_tiled_ref(cuda, S, H, window, shift):
    """bf16 against the plain and the step-wise version, two calls bitwise
    equal; also H below the tiling's width (40 keeps 16-byte copies and
    zero-fills the padding columns, 36 loads element by element) and one
    of q, k, v at an unaligned address (element-wise loads)."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(S * H + window)
    qkv = [_t(rng, (2, S, 3, H), 0.5, torch.bfloat16, cuda)
           for _ in range(3)]
    if shift is not None:
        qkv[shift] = _offset_copy(qkv[shift])
    got, want = _both(lambda: ops.flash_attention(*qkv, causal=True,
                                                  window=window))
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    tiled = ref.flash_attention_tiled_ref(*qkv, causal=True, window=window)
    torch.testing.assert_close(got.float(), tiled.float(), **TILED_TOL)
    again = ops.flash_attention(*qkv, causal=True, window=window)
    assert torch.equal(got, again)          # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [96, 128])
@pytest.mark.parametrize("S,causal", [(512, True), (256, True), (32, True),
                                      (128, False)])
def test_flash_attention_kernel_model_head_dims(cuda, dtype, H, S, causal):
    """The head widths of gpt-moe-l (96, padded to the 128 tiling) and
    olmoe (128) at the served buckets, both dtypes."""
    rng = np.random.default_rng(S + H)
    q, k, v = (_t(rng, (1, S, 4, H), 0.5, dtype, cuda) for _ in range(3))
    got, want = _both(lambda: ops.flash_attention(q, k, v, causal=causal))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _paged_pool(seed, positions, nkv, group, dev, dtype, ps=8, max_kv=512,
                h=64):
    """Pages of a served pool: shuffled, non-contiguous, page 0 trash."""
    rng = np.random.default_rng(seed)
    n_blk = max_kv // ps
    num_pages = len(positions) * n_blk + 1
    q = _t(rng, (len(positions), nkv * group, h), 0.5, dtype, dev)
    k = _t(rng, (num_pages * ps, nkv, h), 0.5, dtype, dev)
    v = _t(rng, (num_pages * ps, nkv, h), 1.0, dtype, dev)
    avail = list(range(1, num_pages))
    rng.shuffle(avail)
    rows = [PageTable(ps, max_kv, [avail.pop() for _ in range(p // ps + 1)]
                      ).row_idx() for p in positions]
    ri = torch.from_numpy(np.stack(rows)).to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, k, v, ri, pos


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,window,softcap,hd,shift", [
    (1, 0, 0.0, 64, None), (4, 0, 0.0, 64, None), (1, 60, 30.0, 64, None),
    (2, 0, 0.0, 36, None),                      # hd not 16-byte wide
    (2, 0, 0.0, 64, 0), (2, 0, 0.0, 64, 1), (2, 0, 0.0, 32, 2)])  # unaligned
def test_paged_decode_kernel_warp_split_boundaries(cuda, dtype, group,
                                                   window, softcap, hd,
                                                   shift):
    """Positions that give 1 page, as many pages as warps, one more, and
    the full 512-token sequence; the kernel against the plain version and
    against its step-wise version, and two calls bitwise equal.  Also
    hd = 36 (bf16 loads element by element, f32 keeps 16-byte loads, 9
    lanes of 16 to a row) and one of q, the K pool or the V pool at an
    unaligned address (element-wise loads)."""
    from repro_torch.kernels import ref
    ps, w = 8, PAGED_WARPS
    positions = [0, ps - 1, w * ps - 1, w * ps, w * ps + 3, 511]
    case = list(_paged_pool(group + window, positions, 3, group, cuda, dtype,
                            h=hd))
    if shift is not None:
        case[shift] = _offset_copy(case[shift])
    kw = dict(page_size=ps, window=window, softcap=softcap)
    got, want = _both(lambda: ops.paged_decode_attention(*case, **kw))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    split = ref.paged_decode_attention_split_ref(*case, n_warps=w, **kw)
    torch.testing.assert_close(got.float(), split.float(), **SPLIT_TOL[dtype])
    again = ops.paged_decode_attention(*case, **kw)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nkv,hd", [(24, 8, 64), (16, 16, 96),
                                       (16, 16, 128), (6, 2, 128)])
def test_paged_decode_kernel_model_heads(cuda, dtype, nq, nkv, hd):
    """The decode heads of granite (24 query heads over 8 KV heads, a group
    of 3), gpt-moe-l (hd 96) and olmoe (hd 128), and a group of 3 at hd
    128, at the warp split's boundaries and the longest sequence."""
    from repro_torch.kernels import ref
    ps, w = 8, PAGED_WARPS
    positions = [0, w * ps - 1, w * ps + 3, 300, 511]
    case = _paged_pool(nq + hd, positions, nkv, nq // nkv, cuda, dtype, h=hd)
    got, want = _both(lambda: ops.paged_decode_attention(*case,
                                                         page_size=ps))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    split = ref.paged_decode_attention_split_ref(*case, n_warps=w,
                                                 page_size=ps)
    torch.testing.assert_close(got.float(), split.float(), **SPLIT_TOL[dtype])


def _paged(seed, positions, nkv, group, dev, h=32, num_pages=24):
    rng = np.random.default_rng(seed)
    q = _t(rng, (len(positions), nkv * group, h), 0.4, torch.float32, dev)
    k = _t(rng, (num_pages * PS, nkv, h), 0.4, torch.float32, dev)
    v = _t(rng, (num_pages * PS, nkv, h), 0.6, torch.float32, dev)
    avail = list(range(1, num_pages))
    rng.shuffle(avail)
    rows = [PageTable(PS, MAX_KV, [avail.pop() for _ in range(p // PS + 1)]
                      ).row_idx() for p in positions]
    ri = torch.from_numpy(np.stack(rows)).to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, k, v, ri, pos


@pytest.mark.gpu
@pytest.mark.parametrize("group,window,softcap", [(1, 0, 0.0), (4, 0, 0.0),
                                                  (2, 7, 50.0), (2, 4, 0.0)])
def test_paged_decode_kernel_matches_plain(cuda, group, window, softcap):
    case = _paged(group, [2, 7, 11, 0, 15, 3], 2, group, cuda)
    got, want = _both(lambda: ops.paged_decode_attention(
        *case, page_size=PS, window=window, softcap=softcap))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_paged_decode_kernel_trash_page_and_parked_slot(cuda):
    """Poisoning the trash page changes no live sequence; an idle slot (no
    pages, position 0) matches the plain version."""
    q, k, v, ri, pos = _paged(9, [5, 0, 13], 2, 2, cuda)
    ri[1] = 0
    clean = ops.paged_decode_attention(q, k, v, ri, pos, page_size=PS)
    kp, vp = k.clone(), v.clone()
    kp[:PS] = 1e4
    vp[:PS] = 1e4
    poison = ops.paged_decode_attention(q, kp, vp, ri, pos, page_size=PS)
    torch.testing.assert_close(clean[[0, 2]], poison[[0, 2]], rtol=0,
                               atol=0)
    with ops.reference_mode():
        want = ops.paged_decode_attention(q, k, v, ri, pos, page_size=PS)
    torch.testing.assert_close(clean, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# grouped-MLP training: forward with residuals, dgrad, wgrad, autograd
# ---------------------------------------------------------------------------
def _train_case(cuda, dtype, act, seed, K=3, T=300, D=192, F=200):
    """Inputs of the three training stages; slot 0 empty, slot 1 ragged
    with a scattered hole, slot 2 full."""
    rng = np.random.default_rng(seed)
    x = _t(rng, (K, T, D), 0.3, dtype, cuda)
    wi = _t(rng, (K, D, F), 0.05, dtype, cuda)
    wg = _t(rng, (K, D, F), 0.05, dtype, cuda) if act.endswith("_glu") \
        else None
    wo = _t(rng, (K, F, D), 0.05, dtype, cuda)
    dy = _t(rng, (K, T, D), 0.1, dtype, cuda)
    mask = torch.zeros((K, T), dtype=torch.int32, device=cuda)
    mask[1, :137] = 1
    mask[1, 40:90] = 0
    mask[2] = 1
    return x, wi, wg, wo, dy, mask


def _launched(fn):
    before = ops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in ops.launch_counts().items()
                 if v != before[k]}


def _close_all(got, want, dtype, rows=None):
    """``rows = (keep, idx)``: for the outputs at the indices ``idx``,
    compare only the rows where the (K, T) bool ``keep`` is set."""
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype == dtype
        if rows is not None and i in rows[1]:
            g, w = g[rows[0]], w[rows[0]]
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_train_kernels_match_plain(cuda, dtype, act):
    """B1 training form, B2 dgrad and B3 wgrad, each on the same inputs as
    its plain version; invalid rows are exactly zero in y, dx, dh1 and h.
    The residuals h1/h2 are compared at valid rows: the kernel leaves them
    unwritten in sub-tiles without a valid row, as the Pallas kernel leaves
    its skipped tiles, and dgrad reads them at valid rows only."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    x, wi, wg, wo, dy, mask = _train_case(cuda, dtype, act, 21)
    fwd, n = _launched(lambda: gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask,
                                                        act=act))
    assert n == {"grouped_mlp_fwd_train": 1}
    _close_all(fwd, ref.grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask,
                                                  act=act), dtype,
               rows=(mask.bool(), (1, 2)))
    _, h1, h2 = fwd
    dg, n = _launched(lambda: gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg,
                                                   wo, act=act))
    assert n == {"grouped_mlp_dgrad": 1}
    _close_all(dg, ref.grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi, wg, wo,
                                             act=act), dtype)
    _, dh1, dh2, h = dg
    wgr, n = _launched(lambda: gm.grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h))
    assert n == {"grouped_mlp_wgrad": 1}
    _close_all(wgr, ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, dh2, h),
               dtype)
    inv = mask == 0
    for a in (fwd[0], dg[0], dg[1], dg[3]):
        assert (a[inv] == 0).all()
    assert (wgr[0][0] == 0).all() and (wgr[2][0] == 0).all()   # empty slot
    # no atomics: the same call gives the same bits
    again = gm.grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h)
    assert all(a is None or torch.equal(a, b) for a, b in zip(wgr, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("D", [1536, 2048])
def test_grouped_mlp_kernels_wide_d(cuda, dtype, act, D):
    """d_model above one f32 block's 1,024 output columns (gpt-moe-l and
    granite 1,536: a ragged second column chunk; olmoe 2,048: two whole
    ones): the inference form, the training form, dgrad and wgrad against
    their plain versions on ``_train_case``'s slots (empty, ragged with a
    hole, full) at a ragged T, invalid rows exactly zero."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    x, wi, wg, wo, dy, mask = _train_case(cuda, dtype, act, D, D=D)
    valid = mask.bool()
    got, want = _both(lambda: ops.grouped_mlp(x, wi, wg, wo, None, valid,
                                              act=act))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert (got[~valid] == 0).all()
    fwd = gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask, act=act)
    _close_all(fwd, ref.grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask,
                                                  act=act), dtype,
               rows=(valid, (1, 2)))
    _, h1, h2 = fwd
    dg = gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo, act=act)
    _close_all(dg, ref.grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi, wg, wo,
                                             act=act), dtype)
    _, dh1, dh2, h = dg
    wgr = gm.grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h)
    _close_all(wgr, ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, dh2, h),
               dtype)
    for a in (fwd[0], dg[0], dg[1], dg[3]):
        assert (a[~valid] == 0).all()


# bf16 dx of the tensor-core dgrad against its step-wise plain version
# (``ref.grouped_mlp_dgrad_split_ref``, dx from hi + lo): both sum the same
# products in f32 in other orders, so they may land on neighbouring bf16
# values: one ulp, 2^-7 of |dx|
SPLIT_DX_TOL = dict(atol=1e-5, rtol=2 ** -7)


def _tc_weights(rng, K, D, F, act, dev, views):
    """wi, wg (None without a gate), wo in bf16; with ``views``, as
    ``core.moe.unpack_chunks`` cuts them from a (K, chunk_len) slot buffer
    (the main path's layout: a slot's matrices at offsets of one buffer
    row)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core import moe
    glu = act.endswith("_glu")
    if views:
        cfg = get("gpt-moe-s")
        cfg = cfg.replace(d_model=D, act=act,
                          moe=dataclasses.replace(cfg.moe, d_ff=F))
        buf = _t(rng, (K, moe.chunk_len(cfg)), 0.05, torch.bfloat16, dev)
        wi, wg, wo = moe.unpack_chunks(cfg, buf)
        assert wi.stride(0) == buf.shape[1] and not wo.is_contiguous()
        return wi, wg, wo
    wi = _t(rng, (K, D, F), 0.05, torch.bfloat16, dev)
    wg = _t(rng, (K, D, F), 0.05, torch.bfloat16, dev) if glu else None
    return wi, wg, _t(rng, (K, F, D), 0.05, torch.bfloat16, dev)


def _tc_check(x, wi, wg, wo, dy, mask, act):
    """The bf16 training forward and dgrad against their plain versions
    (dgrad's dx also against the step-wise split version, tightly); zero
    rows where invalid; two identical calls give the same bits."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    valid = mask.bool()
    fwd, n = _launched(lambda: gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask,
                                                        act=act))
    assert n == {"grouped_mlp_fwd_train": 1}
    _close_all(fwd, ref.grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask,
                                                  act=act), torch.bfloat16,
               rows=(valid, (1, 2)))
    again = gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask, act=act)
    assert torch.equal(fwd[0], again[0])
    assert all(a is None or torch.equal(a[valid], b[valid])
               for a, b in zip(fwd[1:], again[1:]))
    _, h1, h2 = fwd
    dg, n = _launched(lambda: gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg,
                                                   wo, act=act))
    assert n == {"grouped_mlp_dgrad": 1}
    _close_all(dg, ref.grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi, wg, wo,
                                             act=act), torch.bfloat16)
    split = ref.grouped_mlp_dgrad_split_ref(dy, mask, h1, h2, wi, wg, wo,
                                            act=act)
    torch.testing.assert_close(dg[0].float(), split[0].float(),
                               **SPLIT_DX_TOL)
    again = gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo, act=act)
    assert all(a is None or torch.equal(a, b) for a, b in zip(dg, again))
    inv = ~valid
    for a in (fwd[0], *dg):
        assert a is None or (a[inv] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_train_tc_tile_edges(cuda, act):
    """Full width (D 768, F 1,536), group sizes around the 64-row tile of
    the tensor-core kernels (0, 1, 63, 64, 65, 127, 128, 129) with a ragged
    last tile (T = 300), weights as views into a (K, chunk_len) buffer."""
    rng = np.random.default_rng(31)
    K, T, D, F = 8, 300, 768, 1536
    x = _t(rng, (K, T, D), 0.3, torch.bfloat16, cuda)
    dy = _t(rng, (K, T, D), 0.1, torch.bfloat16, cuda)
    wi, wg, wo = _tc_weights(rng, K, D, F, act, cuda, views=True)
    gs = torch.tensor([0, 1, 63, 64, 65, 127, 128, 129], device=cuda)
    mask = (torch.arange(T, device=cuda)[None] < gs[:, None]).to(torch.int32)
    _tc_check(x, wi, wg, wo, dy, mask, act)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_train_tc_scattered_rows(cuda, act):
    """Full width, a scattered ``row_valid``: 30% of rows, one slot empty,
    one 64-row tile empty in another, one tile full."""
    rng = np.random.default_rng(32)
    K, T, D, F = 4, 256, 768, 1536
    x = _t(rng, (K, T, D), 0.3, torch.bfloat16, cuda)
    dy = _t(rng, (K, T, D), 0.1, torch.bfloat16, cuda)
    wi, wg, wo = _tc_weights(rng, K, D, F, act, cuda, views=False)
    mask = torch.from_numpy(rng.random((K, T)) < 0.3).to(cuda, torch.int32)
    mask[0] = 0
    mask[1, 64:128] = 0
    mask[2, 128:192] = 1
    _tc_check(x, wi, wg, wo, dy, mask, act)


@pytest.mark.gpu
@pytest.mark.parametrize("D,F,shift", [(100, 200, 0), (96, 198, 0),
                                       (96, 200, 1)])
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_train_tc_elementwise_branch(cuda, act, D, F, shift):
    """The kernels' element-wise branch: D or F not a multiple of 8, or x,
    dy and the weights at a storage offset that breaks 16-byte alignment
    (``shift``); such inputs run the kernel, not the plain version."""
    rng = np.random.default_rng(33 + D + F + shift)
    K, T = 3, 200

    def shifted(a):                    # a contiguous copy, ``shift`` in
        if not shift:
            return a
        flat = torch.zeros(a.numel() + shift, dtype=a.dtype, device=cuda)
        flat[shift:] = a.flatten()
        return flat[shift:].view(a.shape)
    x = shifted(_t(rng, (K, T, D), 0.3, torch.bfloat16, cuda))
    dy = shifted(_t(rng, (K, T, D), 0.1, torch.bfloat16, cuda))
    wi, wg, wo = (None if w is None else shifted(w) for w in
                  _tc_weights(rng, K, D, F, act, cuda, views=False))
    mask = torch.zeros((K, T), dtype=torch.int32, device=cuda)
    mask[0, :70] = 1
    mask[2, 3:150:2] = 1
    _tc_check(x, wi, wg, wo, dy, mask, act)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_function_matches_autograd_of_plain(cuda, act):
    """``ops.grouped_mlp`` with grad on CUDA runs GroupedMLPFunction over
    the three kernels; its gradients match autograd through the plain
    ``grouped_mlp_ref`` in f32, and invalid rows get exactly zero dx."""
    from repro_torch.kernels import ref
    x, wi, wg, wo, dy, mask = _train_case(cuda, torch.float32, act, 22)
    leaves = [a for a in (x, wi, wg, wo) if a is not None]

    def grads(fn):
        ts = [a.clone().requires_grad_(True) for a in leaves]
        wgt = ts[2] if wg is not None else None
        y = fn(ts[0], ts[1], wgt, ts[-1])
        (y * dy).sum().backward()
        return y.detach(), [t.grad for t in ts]

    (y, g), n = _launched(lambda: grads(
        lambda a, b, c, d: ops.grouped_mlp(a, b, c, d, None, mask.bool(),
                                           act=act)))
    assert n == {"grouped_mlp_fwd_train": 1, "grouped_mlp_dgrad": 1,
                 "grouped_mlp_wgrad": 1}
    yr, gr = grads(lambda a, b, c, d: ref.grouped_mlp_ref(
        a, b, c, d, act=act, row_valid=mask.bool()))
    torch.testing.assert_close(y, yr, atol=2e-5, rtol=2e-4)
    for got, want in zip(g, gr):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert (g[0][mask == 0] == 0).all()


# ---------------------------------------------------------------------------
# bf16 on the tensor cores: B3 wgrad and B1's inference form
# ---------------------------------------------------------------------------
def _wgrad_case(rng, K, T, D, F, act, dev):
    """B3's arguments (x, dy, mask, dh1, dh2, h) in bf16, dh2 None without
    a gate; the mask: slot 0
    empty, slot 1 a ragged prefix with a scattered hole, slot 2 full, slot 3
    one middle tile and the last row.  Invalid rows hold NaN in every
    operand, so an unmasked row would show."""
    x, dy = (_t(rng, (K, T, D), sc, torch.bfloat16, dev) for sc in (.3, .1))
    dh1, dh2, h = (_t(rng, (K, T, F), sc, torch.bfloat16, dev)
                   for sc in (.1, .1, .5))
    if not act.endswith("_glu"):
        dh2 = None
    mask = torch.zeros((K, T), dtype=torch.int32, device=dev)
    mask[1, :min(T, 137)] = 1
    mask[1, 40:90] = 0
    mask[2] = 1
    mask[3, 64:128] = 1
    mask[3, T - 1] = 1
    for a in (x, dy, dh1, dh2, h):
        if a is not None:
            a[mask == 0] = float("nan")
    return x, dy, mask, dh1, dh2, h


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("T,D,F,shift", [
    (96, 768, 1536, None), (300, 768, 1536, None),   # full width, ragged T
    (300, 100, 200, None), (96, 96, 198, None),      # element-wise branch
    (300, 96, 200, 0), (300, 96, 200, 5)])           # x or h off 16 bytes
def test_grouped_mlp_wgrad_tc_matches_plain(cuda, act, T, D, F, shift):
    """B3 in bf16 on the tensor cores against ``ref.grouped_mlp_wgrad_ref``
    (gated: dwi, dwg, dwo; ungated: dwi, dwo), with the tile list built by
    the wrapper and given by the caller; the empty slot's gradients are
    zero; two calls give the same bits."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    rng = np.random.default_rng(T + D + F + (shift or 0))
    case = list(_wgrad_case(rng, 4, T, D, F, act, cuda))
    if shift is not None:
        case[shift] = _offset_copy(case[shift])
    got, n = _launched(lambda: gm.grouped_mlp_wgrad(*case))
    assert n == {"grouped_mlp_wgrad": 1}
    _close_all(got, ref.grouped_mlp_wgrad_ref(*case), torch.bfloat16)
    assert all(a is None or (a[0] == 0).all() for a in got)
    tiles = gm.tile_list(case[2])
    again = gm.grouped_mlp_wgrad(*case, tiles=tiles)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_wgrad_tc_empty_and_scattered(cuda, act):
    """Every slot empty: zero gradients (an empty tile list).  Full width
    with a scattered ``row_valid`` (30% of rows, one 64-row tile empty, one
    full): the plain version's values."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    rng = np.random.default_rng(41)
    x, dy, _, dh1, dh2, h = _wgrad_case(rng, 4, 256, 768, 1536, act, cuda)
    x, dy, dh1, h = (torch.nan_to_num(a) for a in (x, dy, dh1, h))
    dh2 = None if dh2 is None else torch.nan_to_num(dh2)
    empty = torch.zeros((4, 256), dtype=torch.int32, device=cuda)
    got = gm.grouped_mlp_wgrad(x, dy, empty, dh1, dh2, h)
    assert all(a is None or (a == 0).all() for a in got)
    mask = torch.from_numpy(rng.random((4, 256)) < 0.3).to(cuda, torch.int32)
    mask[1, 64:128] = 0
    mask[2, 128:192] = 1
    got = gm.grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h,
                               tiles=gm.tile_list(mask))
    _close_all(got, ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, dh2, h),
               torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("T,D,F,views", [(4, 768, 1536, True),
                                         (300, 768, 1536, True),
                                         (300, 100, 200, False),
                                         (4, 96, 198, False)])
@pytest.mark.parametrize("validity", ["group_sizes", "row_valid"])
def test_grouped_mlp_tc_inference_no_sync(cuda, act, T, D, F, views,
                                          validity):
    """B1's inference form in bf16 on the tensor cores against
    ``grouped_mlp_ref``: the decode (T = 4) and a ragged prefill (T = 300)
    at full width with the weights as views into a slot buffer, and the
    element-wise branch; ``group_sizes`` with zero groups, or a scattered
    ``row_valid``.  The calls run under ``set_sync_debug_mode("error")``:
    the wrapper reads nothing back to the host.  Invalid rows are zero and
    two calls give the same bits."""
    rng = np.random.default_rng(T * D + F)
    K = 8
    x = _t(rng, (K, T, D), 0.3, torch.bfloat16, cuda)
    wi, wg, wo = _tc_weights(rng, K, D, F, act, cuda, views=views)
    if validity == "group_sizes":
        gs = torch.tensor([0, 1, 0, min(63, T), T, 2, 0, min(65, T)],
                          dtype=torch.int32, device=cuda)
        kw = dict(group_sizes=gs)
        valid = torch.arange(T, device=cuda)[None] < gs[:, None]
    else:
        valid = torch.from_numpy(rng.random((K, T)) < 0.3).to(cuda)
        valid[0] = False
        kw = dict(row_valid=valid)
    torch.cuda.synchronize()
    before = ops.launch_counts()["grouped_mlp_fwd"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.grouped_mlp(x, wi, wg, wo, act=act, **kw)
        again = ops.grouped_mlp(x, wi, wg, wo, act=act, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["grouped_mlp_fwd"] == before + 2
    with ops.reference_mode():
        want = ops.grouped_mlp(x, wi, wg, wo, act=act, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    assert (got[~valid] == 0).all()
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_grouped_mlp_function_bf16_shares_tile_list(cuda):
    """bf16 ``GroupedMLPFunction`` on the card: one launch of each stage,
    the forward's tile list handed to dgrad and wgrad, and gradients
    within 2e-2 of each tensor's largest entry of the same function's
    step-wise plain stages on the same tensors."""
    from repro_torch.kernels import grouped_mlp as gm
    rng = np.random.default_rng(42)
    K, T, D, F = 4, 200, 768, 1536
    x = _t(rng, (K, T, D), 0.3, torch.bfloat16, cuda)
    dy = _t(rng, (K, T, D), 0.1, torch.bfloat16, cuda)
    wi, wg, wo = _tc_weights(rng, K, D, F, "gelu", cuda, views=False)
    mask = torch.from_numpy(rng.random((K, T)) < 0.4).to(cuda, torch.int32)
    mask[0] = 0

    def grads(kernel):
        ts = [a.clone().requires_grad_(True) for a in (x, wi, wo)]
        y = gm.GroupedMLPFunction.apply(ts[0], ts[1], None, ts[2], mask,
                                        "gelu", kernel)
        (y.float() * dy.float()).sum().backward()
        return [t.grad for t in ts]
    got, n = _launched(lambda: grads(True))
    assert n == {"grouped_mlp_fwd_train": 1, "grouped_mlp_dgrad": 1,
                 "grouped_mlp_wgrad": 1}
    for a, b in zip(got, grads(False)):
        assert a.dtype == torch.bfloat16
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_grad(cuda):
    """The flash kernel has no backward: a grad-requiring CUDA call raises
    instead of cutting the graph; without grad it runs."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng, (1, 16, 2, 64), 0.5, torch.float32, cuda)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape


# ---------------------------------------------------------------------------
# the decoder-only families' shapes: Gemma-2's decode at hd 256, Jamba's
# exact-length prefill and its experts at D 4,096
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap,shift", [
    (0, 50.0, None), (4096, 50.0, None), (60, 50.0, None), (0, 0.0, None),
    (60, 50.0, 0), (0, 50.0, 1)])                # unaligned q, K pool
def test_paged_decode_kernel_hd256(cuda, dtype, window, softcap, shift):
    """Gemma-2's decode: 16 query heads over 8 KV heads of 256, softcap 50,
    window 4,096 on its local layers (here also 60, which cuts into the
    pages), at the warp split's boundaries and the longest sequence;
    against the plain and the step-wise version, two calls bitwise equal.
    An unaligned q or K pool takes the element-wise loads."""
    from repro_torch.kernels import ref
    ps, w = 8, PAGED_WARPS
    positions = [0, w * ps - 1, w * ps + 3, 300, 511]
    case = list(_paged_pool(256 + window, positions, 8, 2, cuda, dtype,
                            h=256))
    if shift is not None:
        case[shift] = _offset_copy(case[shift])
    kw = dict(page_size=ps, window=window, softcap=softcap)
    got, want = _both(lambda: ops.paged_decode_attention(*case, **kw))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    split = ref.paged_decode_attention_split_ref(*case, n_warps=w, **kw)
    torch.testing.assert_close(got.float(), split.float(), **SPLIT_TOL[dtype])
    assert torch.equal(got, ops.paged_decode_attention(*case, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 17, 90, 200, 300])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_kernel_any_length(cuda, dtype, S, window):
    """Jamba's exact-length prefill: 32 query heads of 128 over 8 KV heads
    (expanded by the dispatcher), causal, at prompt lengths that are no
    power of two and no multiple of 128 (the tail tile's rows zero-filled
    and its keys masked), also windowed; against the plain version, and in
    bf16 also against the step-wise one; two calls bitwise equal."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(S + window)
    q = _t(rng, (1, S, 32, 128), 0.5, dtype, cuda)
    k, v = (_t(rng, (1, S, 8, 128), 0.5, dtype, cuda) for _ in range(2))
    got, want = _both(lambda: ops.flash_attention(q, k, v, causal=True,
                                                  window=window))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        kx, vx = (torch.repeat_interleave(a, 4, dim=2) for a in (k, v))
        torch.testing.assert_close(
            got.float(), ref.flash_attention_tiled_ref(
                q, kx, vx, causal=True, window=window).float(), **TILED_TOL)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_grouped_mlp_kernels_jamba_experts(cuda, dtype, act):
    """Jamba's experts, D 4,096 and F 14,336 (above the f32 kernels'
    3,072 columns of rows in shared memory, which then go through it in two
    halves): the inference form, the training form, dgrad and wgrad
    against their plain versions on ``_train_case``'s slots (empty, ragged
    with a hole, full), invalid rows exactly zero; weights at the scale of
    the model's fan-in init."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    D, F = 4096, 14336
    x, _, _, _, dy, mask = _train_case(cuda, dtype, act, 7, K=3, T=160,
                                       D=D, F=8)
    rng = np.random.default_rng(8)
    wi = _t(rng, (3, D, F), 0.02, dtype, cuda)
    wg = _t(rng, (3, D, F), 0.02, dtype, cuda) if act.endswith("_glu") \
        else None
    wo = _t(rng, (3, F, D), 0.01, dtype, cuda)
    valid = mask.bool()
    got, want = _both(lambda: ops.grouped_mlp(x, wi, wg, wo, None, valid,
                                              act=act))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert (got[~valid] == 0).all()
    fwd, n = _launched(lambda: gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask,
                                                        act=act))
    assert n == {"grouped_mlp_fwd_train": 1}
    _close_all(fwd, ref.grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask,
                                                  act=act), dtype,
               rows=(valid, (1, 2)))
    _, h1, h2 = fwd
    dg, n = _launched(lambda: gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg,
                                                   wo, act=act))
    assert n == {"grouped_mlp_dgrad": 1}
    _close_all(dg, ref.grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi, wg, wo,
                                             act=act), dtype)
    _, dh1, dh2, h = dg
    wgr, n = _launched(lambda: gm.grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h))
    assert n == {"grouped_mlp_wgrad": 1}
    _close_all(wgr, ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, dh2, h),
               dtype)
    for a in (fwd[0], dg[0], dg[1], dg[3]):
        assert (a[~valid] == 0).all()
