"""Plain PyTorch versions of every hand-written kernel.

They compute what the JAX package's ``repro.kernels.ref`` oracles compute,
at the same layouts.  The CPU tests run them, the dispatcher in
``kernels/ops.py`` takes them for CPU tensors, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def act_fn(act: str):
    """The experts' activation.  GELU is the tanh form: ``jax.nn.gelu``
    defaults to it, ``torch.nn.functional.gelu`` does not."""
    if act.startswith("silu"):
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")


def row_mask(t: int, group_sizes=None, row_valid=None, device=None):
    """Canonical (K, t) bool validity from either form (row_valid wins)."""
    if row_valid is not None:
        return row_valid.to(torch.bool)
    return (torch.arange(t, device=device or group_sizes.device)[None, :]
            < group_sizes[:, None])


def grouped_mlp_ref(x, wi, wg, wo, act: str = "silu_glu",
                    group_sizes=None, row_valid=None):
    """x: (K, T, D); wi/wg: (K, D, F); wo: (K, F, D) -> (K, T, D).

    Per-slot FFN ``mask ⊙ (act(x@wi) [⊙ x@wg]) @ wo`` with validity as
    ``group_sizes`` (K,) (valid-row prefix) or ``row_valid`` (K, T); the
    mask applies to the input rows and the output rows."""
    mask = None
    if row_valid is not None or group_sizes is not None:
        mask = row_mask(x.shape[1], group_sizes, row_valid,
                        device=x.device)[..., None]
        x = x * mask.to(x.dtype)
    h = torch.einsum("ktd,kdf->ktf", x, wi)
    if wg is not None:
        h = act_fn(act)(h) * torch.einsum("ktd,kdf->ktf", x, wg)
    else:
        h = act_fn(act)(h)
    y = torch.einsum("ktf,kfd->ktd", h, wo)
    if mask is not None:
        y = y * mask.to(y.dtype)
    return y


_GELU_K0 = math.sqrt(2.0 / math.pi)
_GELU_K1 = 0.044715


def act_and_grad(act: str, h):
    """(act(h), act'(h)) in closed form: the derivative ``jax.vjp`` of the
    activation gives (tanh-form GELU, or SiLU)."""
    if act.startswith("silu"):
        s = torch.sigmoid(h)
        return h * s, s * (1.0 + h * (1.0 - s))
    t = torch.tanh(_GELU_K0 * (h + _GELU_K1 * h ** 3))
    return (0.5 * h * (1.0 + t),
            0.5 * (1.0 + t)
            + 0.5 * h * (1.0 - t * t) * _GELU_K0 * (1.0 + 3 * _GELU_K1 * h * h))


def _rows(mask, a):
    """``a`` with the rows where ``mask`` (K, T) is 0 set to zero."""
    return torch.where(mask.bool()[..., None], a, torch.zeros_like(a))


def grouped_mlp_fwd_train_ref(x, wi, wg, wo, mask, act: str = "silu_glu"):
    """The training form of the forward, stage 1 of three: returns
    ``(y, h1, h2)`` with the pre-activations ``h1 = x@wi``, ``h2 = x@wg``
    (None without a gate) rounded to x's dtype, zero on invalid rows.

    mask: (K, T) validity.  Products are f32 sums of the inputs' values;
    h is rounded to x's dtype before the product with wo and y once at the
    end, as the Pallas kernel rounds (``grouped_mlp.py:135-145``)."""
    dt = x.dtype
    xm = _rows(mask, x).float()
    h1 = torch.einsum("ktd,kdf->ktf", xm, wi.float())
    h2 = None if wg is None else torch.einsum("ktd,kdf->ktf", xm, wg.float())
    h = act_fn(act)(h1)
    if h2 is not None:
        h = h * h2
    y = torch.einsum("ktf,kfd->ktd", h.to(dt).float(), wo.float())
    return (_rows(mask, y).to(dt), h1.to(dt),
            None if h2 is None else h2.to(dt))


def grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi, wg, wo,
                          act: str = "silu_glu"):
    """Stage 2: returns ``(dx, dh1, dh2, h)`` (dh2 None without a gate).

    ``dh = (mask ⊙ dy) @ woᵀ`` stays f32; dh1 = act'(h1)·dh[·h2],
    dh2 = dh·act(h1) and h = act(h1)[·h2] are written in dy's dtype, and
    ``dx = mask ⊙ (dh1 @ wiᵀ [+ dh2 @ wgᵀ])`` is taken from the unrounded
    f32 dh1/dh2, as the Pallas dgrad kernel does (``grouped_mlp.py:215``).
    Invalid rows are zero in every output."""
    dt = dy.dtype
    g = _rows(mask, dy).float()
    dh = torch.einsum("ktd,kfd->ktf", g, wo.float())
    a, da = act_and_grad(act, h1.float())
    if h2 is not None:
        h2f = h2.float()
        dh1, dh2, h = da * (dh * h2f), dh * a, a * h2f
        dh2 = _rows(mask, dh2)
    else:
        dh1, dh2, h = da * dh, None, a
    dh1, h = _rows(mask, dh1), _rows(mask, h)
    dx = torch.einsum("ktf,kdf->ktd", dh1, wi.float())
    if dh2 is not None:
        dx = dx + torch.einsum("ktf,kdf->ktd", dh2, wg.float())
    return (_rows(mask, dx).to(dt), dh1.to(dt),
            None if dh2 is None else dh2.to(dt), h.to(dt))


def grouped_mlp_wgrad_ref(x, dy, mask, dh1, dh2, h):
    """Stage 3: returns ``(dwi, dwg, dwo)`` (dwg None without a gate):
    ``dwi = xᵀ@dh1``, ``dwg = xᵀ@dh2``, ``dwo = hᵀ@(mask ⊙ dy)`` over the
    valid rows, f32 sums written in x's dtype, the weight dtype of the
    training path (the caller casts the weights to it), as the Pallas
    wgrad kernel writes the weight dtype (``grouped_mlp.py:324``)."""
    xm = _rows(mask, x).float()
    g = _rows(mask, dy).float()
    dwi = torch.einsum("ktd,ktf->kdf", xm, _rows(mask, dh1).float())
    dwg = None if dh2 is None else torch.einsum(
        "ktd,ktf->kdf", xm, _rows(mask, dh2).float())
    dwo = torch.einsum("ktf,ktd->kfd", _rows(mask, h).float(), g)
    dt = x.dtype
    return dwi.to(dt), None if dwg is None else dwg.to(dt), dwo.to(dt)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q/k/v: (B, S, N, H), equal heads.  Softmax attention in f32 with an
    optional causal and sliding-window mask; output in q's dtype."""
    b, s, n, h = q.shape
    skv = k.shape[1]
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) \
        / math.sqrt(h)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknh->bqnh", p, v.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, row_idx, positions, *,
                               window: int = 0, softcap: float = 0.0):
    """q: (B, nq, hd); k/v_pool: (num_rows, nkv, hd); row_idx: (B, max_kv)
    int32 pool rows; positions: (B,) int32 write positions.

    Gathers every sequence's rows into a (B, max_kv, nkv, hd) view, masks
    ``t <= positions[b]`` (windowed, soft-capped first) and takes the
    softmax in f32.  Masked rows, the trash page's included, get exactly
    zero probability."""
    ri = row_idx.long()
    kb = k_pool[ri].float()                         # (B, max_kv, nkv, hd)
    vb = v_pool[ri].float()
    b, nq, h = q.shape
    nkv = k_pool.shape[1]
    qg = q.reshape(b, nkv, nq // nkv, h).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, kb) / math.sqrt(h)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(row_idx.shape[1], device=q.device)
    pos = positions.long()
    valid = kpos[None, :] <= pos[:, None]
    if window > 0:
        valid &= kpos[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, vb)
    return out.reshape(b, nq, h).to(q.dtype)
