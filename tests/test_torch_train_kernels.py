"""The port's grouped-MLP training stages and their autograd wiring against
the JAX package's Pallas kernels.

On the CPU the port runs the step-wise plain versions
(``repro_torch/kernels/ref.py``): the training forward, dgrad and wgrad.
The JAX kernels run in interpret mode, as tests/test_kernels.py runs them,
on the same numpy inputs made from a seed.  Tolerances are those of
tests/test_kernels.py: forward 1e-5 / 1e-4 and gradients 1e-4 / 1e-4 in
f32 (sums taken in another order), bf16 2e-2 per element for one stage
(both sides round at the same points, so they differ by a rounding step at
most) and 4e-2 of the tensor's largest entry for a whole gradient.
tests/test_torch_kernels_gpu.py holds the CUDA kernels against these plain
versions on the card.
"""
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import grouped_mlp as jgm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _inputs(seed, K, T, D, F, act, dtype="float32"):
    """x, wi, wg (None without a gate), wo, dy as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, T, D)) * 0.3
    wi = rng.standard_normal((K, D, F)) * 0.05
    wg = rng.standard_normal((K, D, F)) * 0.05 if act.endswith("_glu") \
        else None
    wo = rng.standard_normal((K, F, D)) * 0.05
    dy = rng.standard_normal((K, T, D)) * 0.1
    out = [None if a is None else a.astype(np.float32)
           for a in (x, wi, wg, wo, dy)]
    if dtype == "bfloat16":     # round once, so both sides see one value
        out = [None if a is None else np.asarray(
            jnp.asarray(a, jnp.bfloat16), np.float32) for a in out]
    return out


def _j(a, dtype):
    return None if a is None else jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return None if a is None else torch.from_numpy(a.copy()).to(
        getattr(torch, dtype))


def _jax_stages(x, wi, wg, wo, mask, dy, act):
    """The three Pallas kernels, wired as ``_bwd_pallas`` wires them, with
    every stage's outputs sliced back to the caller's shapes."""
    k_, t_, d = x.shape
    f_ = wi.shape[-1]
    out = jgm._forward(x, wi, wg, wo, mask, act=act, interpret=True,
                       save_residuals=True)
    y, h1 = out[0], out[1]
    h2 = out[2] if wg is not None else None
    bt, bf = min(jgm.BT, t_), min(jgm.BF, f_)
    maskp = jgm._pad_to(mask, 1, bt)
    tile_n = jgm._tile_counts(maskp, bt)
    dyp = jgm._pad_to(dy, 1, bt)
    wgp = None if wg is None else jgm._pad_to(wg, 2, bf)
    dg = jgm._dgrad(dyp, maskp, h1, h2, jgm._pad_to(wi, 2, bf), wgp,
                    jgm._pad_to(wo, 1, bf), tile_n, act=act, interpret=True,
                    bt=bt, bf=bf)
    dx, dh1, h = dg[0], dg[1], dg[-1]
    dh2 = dg[2] if wg is not None else None
    bd = min(jgm.BD, d)
    dwi, dwg, dwo = jgm._wgrad(
        jgm._pad_to(jgm._pad_to(x, 1, bt), 2, bd), jgm._pad_to(dyp, 2, bd),
        maskp, dh1, dh2, h, tile_n, wi.dtype, interpret=True, bt=bt, bf=bf)
    cut = lambda a, n2: None if a is None else a[:, :t_, :n2]  # noqa: E731
    return dict(y=y, h1=cut(h1, f_), h2=cut(h2, f_), dx=dx[:, :t_],
                dh1=cut(dh1, f_), dh2=cut(dh2, f_), h=cut(h, f_),
                dwi=dwi[:, :d, :f_],
                dwg=None if dwg is None else dwg[:, :d, :f_],
                dwo=dwo[:, :f_, :d], tile_n=np.asarray(tile_n), bt=bt)


def _port_stages(x, wi, wg, wo, mask, dy, act, j):
    """The port's three plain stages; dgrad and wgrad take the JAX chain's
    residuals, so each stage is held on the same inputs."""
    y, h1, h2 = ref.grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask, act=act)
    dt = x.dtype
    res = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(dt)
    dx, dh1, dh2, h = ref.grouped_mlp_dgrad_ref(dy, mask, res(j["h1"]),
                                                res(j["h2"]), wi, wg, wo,
                                                act=act)
    dwi, dwg, dwo = ref.grouped_mlp_wgrad_ref(
        x, dy, mask, res(j["dh1"]), res(j["dh2"]), res(j["h"]))
    return dict(y=y, h1=h1, h2=h2, dx=dx, dh1=dh1, dh2=dh2, h=h, dwi=dwi,
                dwg=dwg, dwo=dwo)


def _mask(case, K, T):
    if case == "zero_groups":
        return np.zeros((K, T), bool)
    if case == "all_full":
        return np.ones((K, T), bool)
    if case == "scattered":
        # segment-prefix validity as the dispatch lays it out (3 stripes
        # of 128), one stripe empty and one 128-row tile empty
        cnt = np.asarray([[128, 0, 60], [0, 5, 128]])
        rv = np.zeros((K, T), bool)
        for k in range(K):
            for r in range(3):
                rv[k, r * 128:r * 128 + cnt[k, r]] = True
        return rv
    gs = {"ragged": [0, 100, T], "odd_shapes": [0, 37, T],
          "bf16": [100, T]}[case]
    return np.arange(T)[None, :] < np.asarray(gs)[:, None]


CASES = {  # case: (K, T, D, F, dtype)
    "zero_groups": (3, 256, 64, 128, "float32"),
    "all_full": (3, 256, 64, 128, "float32"),
    "odd_shapes": (3, 96, 64, 200, "float32"),
    "scattered": (2, 384, 64, 128, "float32"),
    "bf16": (2, 256, 128, 128, "bfloat16"),
}


@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_stages_match_pallas(case, act):
    """Training forward (with residuals), dgrad and wgrad, stage by stage,
    against ``_forward(save_residuals=True)``, ``_dgrad`` and ``_wgrad``."""
    K, T, D, F, dtype = CASES[case]
    arrs = _inputs(zlib.crc32(f"{case}/{act}".encode()), K, T, D, F, act,
                   dtype)
    mask = _mask(case, K, T)
    x, wi, wg, wo, dy = arrs
    j = _jax_stages(*(_j(a, dtype) for a in (x, wi, wg, wo)),
                    jnp.asarray(mask, jnp.int32), _j(dy, dtype), act)
    p = _port_stages(*(_t(a, dtype) for a in (x, wi, wg, wo)),
                     torch.from_numpy(mask), _t(dy, dtype), act, j)
    tol = BF16 if dtype == "bfloat16" else F32
    gtol = BF16 if dtype == "bfloat16" else GRAD
    np.testing.assert_allclose(_np(p["y"]), _np(j["y"]), **tol)
    # residuals: the Pallas forward leaves skipped token tiles unwritten;
    # the port writes zeros on every invalid row
    tile_ok = np.repeat(j["tile_n"].reshape(K, -1) > 0, j["bt"], 1)[:, :T]
    for name in ("h1", "h2"):
        if p[name] is None:
            assert j[name] is None
            continue
        np.testing.assert_allclose(_np(p[name])[tile_ok],
                                   _np(j[name])[tile_ok], **tol)
        assert (_np(p[name])[~mask] == 0).all()
    for name in ("dx", "dh1", "dh2", "h", "dwi", "dwg", "dwo"):
        if p[name] is None:
            assert j[name] is None
            continue
        assert p[name].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(p[name]), _np(j[name]), **gtol)
    assert (_np(p["dx"])[~mask] == 0).all()
    if case == "zero_groups":
        for name in ("dwi", "dwo"):
            assert (_np(p[name]) == 0).all()


# ---------------------------------------------------------------------------
# GroupedMLPFunction against jax.grad through the Pallas kernels
# ---------------------------------------------------------------------------
def _grads(x, wi, wg, wo, gs, rv, act, dtype):
    """(y, grads) of sum(y²) from both packages: the port through
    ``ops.grouped_mlp`` (GroupedMLPFunction), JAX through
    ``repro.kernels.ops.grouped_mlp`` (the custom VJP over the Pallas
    kernels)."""
    args = [a for a in (x, wi, wg, wo) if a is not None]
    gate = wg is not None

    def jloss(*a):
        wgj = a[2] if gate else None
        woj = a[3] if gate else a[2]
        y = jops.grouped_mlp(a[0], a[1], wgj, woj,
                             None if gs is None else jnp.asarray(gs),
                             None if rv is None else jnp.asarray(rv),
                             act=act)
        return jnp.sum(y.astype(jnp.float32) ** 2), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(len(args))),
                                     has_aux=True)(
        *(_j(a, dtype) for a in args))
    ts = [_t(a, dtype).requires_grad_(True) for a in args]
    ops.reset_launch_counts()
    y = ops.grouped_mlp(ts[0], ts[1], ts[2] if gate else None, ts[-1],
                        None if gs is None else torch.from_numpy(gs),
                        None if rv is None else torch.from_numpy(rv),
                        act=act)
    assert y.grad_fn is not None
    (y.float() ** 2).sum().backward()
    assert sum(ops.launch_counts().values()) == 0      # CPU: plain stages
    return y, jy, [t.grad for t in ts], jg


GRAD_CASES = dict(CASES, ragged=(3, 256, 128, 128, "float32"))


def _grad_case(case, act):
    K, T, D, F, dtype = GRAD_CASES[case]
    x, wi, wg, wo, _ = _inputs(zlib.crc32(f"g/{case}/{act}".encode()), K, T,
                               D, F, act, dtype)
    mask = _mask(case, K, T)
    if case == "scattered":
        gs, rv = None, mask
    else:
        gs, rv = mask.sum(1).astype(np.int32), None
    return (x, wi, wg, wo, gs, rv, dtype), mask


@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("case", ["ragged", "zero_groups", "all_full",
                                  "odd_shapes", "scattered"])
def test_grouped_mlp_function_grads_match_jax(case, act):
    """Ports tests/test_kernels.py's backward tests: forward and every
    gradient against jax.grad of the Pallas op, invalid rows get exactly
    zero dx."""
    (x, wi, wg, wo, gs, rv, dtype), mask = _grad_case(case, act)
    y, jy, g, jg = _grads(x, wi, wg, wo, gs, rv, act, dtype)
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    for got, want in zip(g, jg):
        np.testing.assert_allclose(_np(got), _np(want), **GRAD)
    dx = _np(g[0])
    assert (dx[~mask] == 0).all()
    if mask.any():
        assert np.abs(dx[mask]).max() > 0
    else:
        assert (dx == 0).all()


def test_grouped_mlp_function_bf16_grads_match_jax():
    """bf16 operands, f32 sums: every gradient is bf16 and within 4e-2 of
    the largest entry of JAX's."""
    (x, wi, wg, wo, gs, rv, dtype), _ = _grad_case("bf16", "silu_glu")
    y, jy, g, jg = _grads(x, wi, wg, wo, gs, rv, "silu_glu", dtype)
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    for got, want in zip(g, jg):
        assert got.dtype == torch.bfloat16
        scale = max(float(np.abs(_np(want)).max()), 1e-6)
        assert np.abs(_np(got) - _np(want)).max() / scale < 4e-2


def test_grouped_mlp_grad_path_only_when_needed():
    """Without grad the op takes the inference form (no grad_fn); with an
    operand that requires grad it takes GroupedMLPFunction."""
    x, wi, _, wo, _ = _inputs(3, 2, 16, 32, 48, "gelu")
    xt, wit, wot = (torch.from_numpy(a) for a in (x, wi, wo))
    gs = torch.tensor([3, 16], dtype=torch.int32)
    assert ops.grouped_mlp(xt, wit, None, wot, gs, act="gelu").grad_fn \
        is None
    wit.requires_grad_(True)
    y = ops.grouped_mlp(xt, wit, None, wot, gs, act="gelu")
    assert "GroupedMLPFunction" in type(y.grad_fn).__name__
    with torch.no_grad():
        assert ops.grouped_mlp(xt, wit, None, wot, gs, act="gelu").grad_fn \
            is None
    torch.testing.assert_close(
        y, ref.grouped_mlp_ref(xt, wit, None, wot, act="gelu",
                               group_sizes=gs), atol=1e-6, rtol=1e-5)


def test_flash_attention_refuses_grad_only_on_cuda_kernel():
    """On the CPU the plain attention is differentiable; the CUDA kernel
    has no backward and a grad-requiring CUDA call raises (checked on the
    card by tests/test_torch_kernels_gpu.py)."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = ops.flash_attention(q, q, q)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
