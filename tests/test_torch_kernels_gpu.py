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
                                             (8, True, 0), (128, False, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, S, causal, window):
    rng = np.random.default_rng(S)
    q, k, v = (_t(rng, (2, S, 3, 64), 0.5, dtype, cuda) for _ in range(3))
    got, want = _both(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                  window=window))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


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
