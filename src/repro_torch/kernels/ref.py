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


def tile_hits(mask, tile: int = 64):
    """(K, ceil(T/tile)) bool: which ``tile``-row token tiles of the (K, T)
    validity hold a valid row (the Pallas kernels' skip table, > 0)."""
    k_, t_ = mask.shape
    nt = -(-t_ // tile)
    m = F.pad(mask.bool(), (0, nt * tile - t_))
    return m.view(k_, nt, tile).any(-1)


def tile_list_padded(mask, tile: int = 64):
    """The plain version of the tile list the bf16 inference form builds
    on the device (``gm_tile_list_kernel``): the ids ``k * ceil(T/tile) +
    t`` of the tiles that hold a valid row, increasing, then -1 up to
    ``K * ceil(T/tile)`` int32 entries, a length the host knows."""
    hits = tile_hits(mask, tile).flatten()
    listed = hits.nonzero().flatten().to(torch.int32)
    return F.pad(listed, (0, hits.numel() - listed.numel()), value=-1)


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


def _dgrad_elementwise(dy, mask, h1, h2, wo, act):
    """f32 (dh1, dh2, h) of dgrad, zero on invalid rows (dh2 None without a
    gate): ``dh = (mask ⊙ dy) @ woᵀ``, dh1 = act'(h1)·dh[·h2],
    dh2 = dh·act(h1), h = act(h1)[·h2]."""
    g = _rows(mask, dy).float()
    dh = torch.einsum("ktd,kfd->ktf", g, wo.float())
    a, da = act_and_grad(act, h1.float())
    if h2 is not None:
        h2f = h2.float()
        dh1, dh2, h = da * (dh * h2f), dh * a, a * h2f
        dh2 = _rows(mask, dh2)
    else:
        dh1, dh2, h = da * dh, None, a
    return _rows(mask, dh1), dh2, _rows(mask, h)


def _dgrad_outputs(dt, mask, wi, wg, dh1, dh2, h, a1, a2):
    """``(dx, dh1, dh2, h)`` in ``dt``, with ``dx = mask ⊙ (a1 @ wiᵀ
    [+ a2 @ wgᵀ])`` summed in f32."""
    dx = torch.einsum("ktf,kdf->ktd", a1, wi.float())
    if a2 is not None:
        dx = dx + torch.einsum("ktf,kdf->ktd", a2, wg.float())
    return (_rows(mask, dx).to(dt), dh1.to(dt),
            None if dh2 is None else dh2.to(dt), h.to(dt))


def grouped_mlp_dgrad_ref(dy, mask, h1, h2, wi, wg, wo,
                          act: str = "silu_glu"):
    """Stage 2: returns ``(dx, dh1, dh2, h)`` (dh2 None without a gate).

    ``dh = (mask ⊙ dy) @ woᵀ`` stays f32; dh1 = act'(h1)·dh[·h2],
    dh2 = dh·act(h1) and h = act(h1)[·h2] are written in dy's dtype, and
    ``dx = mask ⊙ (dh1 @ wiᵀ [+ dh2 @ wgᵀ])`` is taken from the unrounded
    f32 dh1/dh2, as the Pallas dgrad kernel does (``grouped_mlp.py:215``).
    Invalid rows are zero in every output."""
    dh1, dh2, h = _dgrad_elementwise(dy, mask, h1, h2, wo, act)
    return _dgrad_outputs(dy.dtype, mask, wi, wg, dh1, dh2, h, dh1, dh2)


def _bf16_split(d):
    """f32 ``d`` as the f32 sum of two bfloat16 terms, hi = bf16(d) and
    lo = bf16(d - hi): exact in f32, and within ~2^-16 of |d|."""
    hi = d.to(torch.bfloat16).float()
    return hi + (d - hi).to(torch.bfloat16).float()


def grouped_mlp_dgrad_split_ref(dy, mask, h1, h2, wi, wg, wo,
                                act: str = "silu_glu"):
    """The step-wise plain version of the bfloat16 tensor-core dgrad: as
    ``grouped_mlp_dgrad_ref``, but dx is taken from the f32 dh1 (and dh2)
    split into two bfloat16 terms, ``hi = bf16(dh1)`` (the dh1 output) and
    ``lo = bf16(dh1 - hi)``, which the kernel feeds to two bf16 products
    with one f32 sum: ``dx = mask ⊙ ((hi + lo) @ wiᵀ [+ ...])``.  A bf16
    product cannot take the f32 dh1 itself; hi + lo is that value to
    ~2^-16 of it.  Nothing on the main path calls it."""
    dh1, dh2, h = _dgrad_elementwise(dy, mask, h1, h2, wo, act)
    return _dgrad_outputs(dy.dtype, mask, wi, wg, dh1, dh2, h,
                          _bf16_split(dh1),
                          None if dh2 is None else _bf16_split(dh2))


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


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, bq: int = 64, bk: int = 64,
                              kv_groups: int = 2):
    """``flash_attention_ref`` computed step by step as the bf16 CUDA
    kernel computes it: ``bq``-row query tiles against ``bk``-row KV tiles,
    skipped and masked as the kernel skips and masks them, with the TPU
    kernel's rounding points.  q is scaled in its own dtype by the scale
    rounded to that dtype (as JAX rounds a weak-typed scalar), scores sum
    in f32, p is rounded to v's dtype before the product with v, l adds
    the unrounded p, and m, l and acc are f32.  Query rows past S are
    padded with zeros and key rows past S masked.  A query tile's KV tiles
    are dealt to ``kv_groups`` groups (group g takes tiles g, g + groups,
    ... of the tile's range), each with its own online softmax, and the
    groups' states merge in group order.  Nothing on the main path calls
    it; the tests hold it to the JAX package's kernel."""
    b, s, n, h = q.shape
    dt = q.dtype
    scale = float(torch.tensor(1.0 / math.sqrt(h), dtype=dt))
    qs = (q.float() * scale).to(dt).float()
    nqt, nkt = -(-s // bq), -(-s // bk)
    pad_q, pad_k = nqt * bq - s, nkt * bk - s

    def padded(a, extra):          # (B, S, N, H) -> (B, N, S + extra, H)
        return F.pad(a.float(), (0, 0, 0, 0, 0, extra)).permute(0, 2, 1, 3)
    qs, kf, vf = padded(qs, pad_q), padded(k, pad_k), padded(v, pad_k)
    out = torch.zeros_like(qs)
    for qt in range(nqt):
        q0 = qt * bq
        qpos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        hi = nkt - 1
        if causal:
            hi = min(hi, (q0 + bq - 1) // bk)
        lo = 0
        if window > 0 and q0 - window + 1 > 0:
            lo = (q0 - window + 1) // bk
        states = []
        for grp in range(kv_groups):
            m = torch.full((b, n, bq, 1), NEG_INF, device=q.device)
            l = torch.zeros((b, n, bq, 1), device=q.device)
            acc = torch.zeros((b, n, bq, h), device=q.device)
            for kt in range(lo + grp, hi + 1, kv_groups):
                k0 = kt * bk
                kpos = torch.arange(k0, k0 + bk, device=q.device)[None, :]
                sc = qs[:, :, q0:q0 + bq] @ \
                    kf[:, :, k0:k0 + bk].transpose(-1, -2)
                ok = kpos < s
                if causal:
                    ok = ok & (kpos <= qpos)
                if window > 0:
                    ok = ok & (kpos > qpos - window)
                sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(sc - m_new),
                                torch.zeros_like(sc))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + \
                    p.to(v.dtype).float() @ vf[:, :, k0:k0 + bk]
                m = m_new
            states.append((m, l, acc))
        m, l, acc = states[0]
        for mg, lg, ag in states[1:]:
            m_new = torch.maximum(m, mg)
            a, a_g = torch.exp(m - m_new), torch.exp(mg - m_new)
            l = l * a + lg * a_g
            acc = acc * a + ag * a_g
            m = m_new
        out[:, :, q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)[:, :s].to(dt)


def paged_decode_attention_split_ref(q, k_pool, v_pool, row_idx, positions,
                                     *, page_size: int, n_warps: int,
                                     window: int = 0, softcap: float = 0.0):
    """``paged_decode_attention_ref`` computed step by step as the CUDA
    kernel computes it: a sequence's live pages (from the first inside the
    window to ``positions[b] // page_size``) are dealt round-robin to
    ``n_warps`` warps; each warp runs its own online softmax over its
    pages, one page at a time, in f32 on upcast inputs (m, l, acc per
    query head); then the warps' states fold in warp order 0, 1, ...,
    with ``m = max`` and l and acc rescaled.  A warp with no page keeps
    the empty state (m = -1e30, l = 0, acc = 0), which changes nothing.
    Nothing on the main path calls it."""
    b, nq, h = q.shape
    nkv = k_pool.shape[1]
    g = nq // nkv
    scale = 1.0 / h ** 0.5
    out = torch.zeros((b, nkv, g, h), device=q.device)
    qg = q.reshape(b, nkv, g, h).float()
    for bi in range(b):
        pos = int(positions[bi])
        hi = min(pos // page_size, row_idx.shape[1] // page_size - 1)
        lo = 0
        if window > 0 and pos - window + 1 > 0:
            lo = (pos - window + 1) // page_size
        states = []
        for w in range(n_warps):
            m = torch.full((nkv, g, 1), NEG_INF, device=q.device)
            l = torch.zeros((nkv, g, 1), device=q.device)
            acc = torch.zeros((nkv, g, h), device=q.device)
            for i in range(lo + w, hi + 1, n_warps):
                t = torch.arange(i * page_size, (i + 1) * page_size,
                                 device=q.device)
                rows = row_idx[bi, t].long()
                kr = k_pool[rows].float().permute(1, 0, 2)   # (nkv, ps, hd)
                vr = v_pool[rows].float().permute(1, 0, 2)
                s = (qg[bi] @ kr.transpose(-1, -2)) * scale  # (nkv, g, ps)
                if softcap > 0.0:
                    s = torch.tanh(s / softcap) * softcap
                ok = t <= pos
                if window > 0:
                    ok = ok & (t > pos - window)
                s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ vr
                m = m_new
            states.append((m, l, acc))
        m, l, acc = states[0]
        for mw, lw, aw in states[1:]:
            m_new = torch.maximum(m, mw)
            a, a_w = torch.exp(m - m_new), torch.exp(mw - m_new)
            l = l * a + lw * a_w
            acc = acc * a + aw * a_w
            m = m_new
        out[bi] = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, nq, h).to(q.dtype)


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
