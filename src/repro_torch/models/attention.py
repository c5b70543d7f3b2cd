"""GQA attention with RoPE / M-RoPE, softcap, sliding window, and the dense
and the block-paged KV caches.

The plain path is einsum-based; the flash-attention kernel takes over the
prefill when ``use_pallas`` is set (the JAX package's name for "use the
hand-written kernels"), and the paged decode-attention kernel does the
paged decode reduction unless ``cfg.paged_attn_kernel`` is off.  The
dense decode path is plain PyTorch, as it is plain XLA in the JAX
package.  Layouts are the JAX package's: (B, S, N, H)
activations, a (B, max_len, nkv, hd) dense cache, a flat
(num_rows, nkv, hd) paged pool.

Under a dense layout (``lay``, ``models.parallel``; ``dims`` the
projections' layouts) the heads run tensor-parallel where they split
over the ``model`` axis: a rank projects its own query heads and only the
KV heads those read (the reference groups query heads under their KV
head contiguously, so qwen1.5's 4 query heads a rank of 16 read 1 of 8
KV heads, sliced from the replicated ``wk``/``wv``), caches those, and
the output projection's partial sums are summed over ``model``.  Where
the heads do not split (SmolLM's 15 over 16, or ``zero``) attention runs
whole on every rank.  A decode cache sequence-sharded over ``data``
(``lay.seq_axes``) is reduced by log-sum-exp over its shards.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import Param
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, default_mrope_sections

NEG_INF = -1e30


def attn_params(cfg: ModelConfig, cross: bool = False):
    """Q/K/V/O projections; the QKV bias where the config has one, but
    never on cross attention (as in the JAX package)."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": Param((d, nq, hd), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": Param((d, nkv, hd), ("embed", "kv_heads", "head_dim"),
                    init="scaled"),
        "wv": Param((d, nkv, hd), ("embed", "kv_heads", "head_dim"),
                    init="scaled"),
        "wo": Param((nq, hd, d), ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = Param((nq, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = Param((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = Param((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


def _local(p, cfg: ModelConfig, dt, lay, dims):
    """(projections in the compute dtype as this rank uses them, its
    tensor-parallel heads ``lay.heads`` or None).  Without a layout the
    parameters as they are."""
    if lay is None:
        return p, None
    hd = lay.heads(cfg, dims["wq"])
    keep = dims["wq"][1] if hd is not None else ()
    out = {}
    for k, t in p.items():
        t = t.to(dt)
        kv_dim = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}.get(k)
        if hd is not None and kv_dim is not None \
                and not dims[k][kv_dim]:
            # replicated KV heads: only those this rank's queries read
            t = t.narrow(kv_dim, hd[2], hd[3] - hd[2])
        out[k] = lay.gather(t, dims[k], keep=keep)
    return out, hd


def _expand_kv(k, hd, cfg: ModelConfig):
    """A rank's KV heads for its query heads: as they are where its query
    heads are whole groups or lie in one, else one KV head per query head
    (each query head paired with its own KV head)."""
    if hd is None:
        return k
    q0, q1, k0, k1 = hd
    g = cfg.num_heads // cfg.num_kv_heads
    if k1 - k0 == 1 or (q0 % g == 0 and (q1 - q0) % g == 0):
        return k
    idx = torch.arange(q0, q1, device=k.device) // g - k0
    return k.index_select(2, idx)


def _out(p, out, x, lay, dims, hd):
    """The output projection; tensor-parallel heads sum their partial
    results over the heads' axes."""
    y = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    return y if hd is None else lay.all_reduce(y, dims["wq"][1])


def _project_qkv(p, x, xa=None):
    """xa: the cross-attention source (encoder states), whose projections
    give K and V; else self-attention."""
    dt = x.dtype
    src = x if xa is None else xa
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", src, p["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", src, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _sdpa(q, k, v, mask, softcap: float, head_dim: int):
    """q: (B,Sq,Nq,hd)  k,v: (B,Skv,Nkv,hd)  mask: (B,1,Sq,Skv) bool or None."""
    nq, nkv = q.shape[2], k.shape[2]
    group = nq // nkv
    b, sq = q.shape[0], q.shape[1]
    qg = q.reshape(b, sq, nkv, group, head_dim)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(head_dim)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, sq, nq, head_dim).to(q.dtype)


def make_mask(sq: int, skv: int, *, causal: bool, window: int = 0,
              q_offset=0, device=None):
    """(1, 1, Sq, Skv) boolean mask. q_offset: absolute position of q[0]."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(skv, device=device)
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m[None, None]


def _rope(cfg: ModelConfig, x, positions):
    """RoPE of q or k at ``positions`` ((B, S), or (B, S, 3) with M-RoPE,
    whose sections are the JAX package's ``default_mrope_sections``)."""
    mr = default_mrope_sections(cfg.head_dim) if cfg.mrope else None
    return apply_rope(x, positions, cfg.rope_theta, mr)


def _decode_positions(cfg: ModelConfig, posb):
    """(B, 1) decode positions; M-RoPE broadcasts them to its three
    streams, as text positions."""
    return posb[..., None].expand(*posb.shape, 3) if cfg.mrope else posb


def attention(p, cfg: ModelConfig, x, positions, *, kind: str = "attn",
              causal: bool = True, xa=None, use_pallas: bool = False,
              return_kv: bool = False, lay=None, dims=None):
    """Full-sequence attention (training and prefill).  Returns (B,S,D),
    and the rotated (k, v) when ``return_kv`` (the prefill cache fill;
    under a layout the rank's KV heads).  positions: (B, S), or (B, S, 3)
    with M-RoPE.  ``xa`` (B, S_enc, D): cross attention over the encoder
    states, with no RoPE (pass ``causal=False``: no mask)."""
    p, hd = _local(p, cfg, x.dtype, lay, dims)
    q, k, v = _project_qkv(p, x, xa=xa)
    if xa is None:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    window = cfg.sliding_window if kind == "local" else 0
    mask = None
    if causal or window:
        mask = make_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                         device=x.device)
    ke, ve = _expand_kv(k, hd, cfg), _expand_kv(v, hd, cfg)
    # the JAX package's routing rule: the kernel takes masked self-attention
    # without a logit softcap; bidirectional and cross attention (no mask)
    # stay plain, as they are XLA there
    if (use_pallas and mask is not None and xa is None
            and cfg.attn_logit_softcap == 0.0):
        out = kops.flash_attention(q, ke, ve, causal=causal, window=window)
    else:
        out = _sdpa(q, ke, ve, mask, cfg.attn_logit_softcap, cfg.head_dim)
    out = _out(p, out, x, lay, dims, hd)
    if return_kv:
        return out, {"k": k, "v": v}
    return out


def cross_kv(p, cfg: ModelConfig, enc_out, lay=None, dims=None):
    """One decoder layer's cross-attention K and V of the encoder states
    (B, S_enc, D): (B, S_enc, nkv, hd) in their dtype, no RoPE, no bias;
    under a layout the rank's KV heads."""
    p, _ = _local({w: p[w] for w in ("wk", "wv")}, cfg, enc_out.dtype, lay,
                  dims)
    dt = enc_out.dtype
    return tuple(torch.einsum("bsd,dnh->bsnh", enc_out, p[w].to(dt))
                 for w in ("wk", "wv"))


def cross_decode(p, cfg: ModelConfig, x, xk, xv, lay=None, dims=None):
    """One decode token's cross attention against a layer's precomputed
    encoder K/V (B, S_enc, nkv, hd; under a layout the rank's KV heads):
    no RoPE, no mask."""
    p, hd = _local(p, cfg, x.dtype, lay, dims)
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype))
    out = _sdpa(q, _expand_kv(xk, hd, cfg), _expand_kv(xv, hd, cfg), None,
                cfg.attn_logit_softcap, cfg.head_dim)
    return _out(p, out, x, lay, dims, hd)


# ------------------------------------------------------------------ decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, nkv: int = 0):
    """Dense KV cache for ONE sublayer: ``max_len`` token rows per
    sequence of ``nkv`` KV heads (0: the config's)."""
    shape = (batch, max_len, nkv or cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, cfg: ModelConfig, x, cache, pos: int, *,
                     kind="attn", lay=None, dims=None):
    """One-token decode for B sequences at the same position against the
    dense cache.

    x: (B, 1, D); pos: the position being written, a Python int (the
    write and the mask need no value from the device).  The new K/V row
    is written IN PLACE at ``pos``; attention spans cache[0..pos],
    windowed for ``kind="local"``.  Under a layout whose cache is
    sequence-sharded (``lay.seq_axes``) the rank holds positions
    ``[i·S_loc, (i+1)·S_loc)`` of its shard ``i``: the shard holding
    ``pos`` writes it, and the shards' partial softmaxes combine over
    ``seq_axes`` (``_split_kv``).  Returns (out, cache)."""
    b = x.shape[0]
    p, hd = _local(p, cfg, x.dtype, lay, dims)
    q, k_new, v_new = _project_qkv(p, x)
    posb = _decode_positions(cfg, torch.full((b, 1), pos, dtype=torch.long,
                                             device=x.device))
    q = _rope(cfg, q, posb)
    k_new = _rope(cfg, k_new, posb)
    skv = cache["k"].shape[1]
    seq = lay.seq_axes if lay is not None else ()
    off = lay.index(seq) * skv if seq else 0
    if not seq or off <= pos < off + skv:
        cache["k"][:, pos - off] = k_new[:, 0]      # in place
        cache["v"][:, pos - off] = v_new[:, 0]
    window = cfg.sliding_window if kind == "local" else 0
    mask = make_mask(1, skv, causal=True, window=window, q_offset=pos - off,
                     device=x.device)
    k, v = _expand_kv(cache["k"], hd, cfg), _expand_kv(cache["v"], hd, cfg)
    if seq:
        out = _split_kv(q, k, v, mask, cfg, lay, seq)
    else:
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap, cfg.head_dim)
    return _out(p, out, x, lay, dims, hd), cache


def _split_kv(q, k, v, mask, cfg: ModelConfig, lay, axes):
    """``_sdpa`` over a sequence split over ``axes``: each rank's logits
    over its shard, the max over every shard, then the exponentials' sums
    and their products with V summed over the shards (log-sum-exp: the
    unsplit softmax).  A shard with no valid position adds zeros."""
    hdim = cfg.head_dim
    nq, nkv = q.shape[2], k.shape[2]
    b, sq = q.shape[0], q.shape[1]
    qg = q.reshape(b, sq, nkv, nq // nkv, hdim)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(hdim)
    if cfg.attn_logit_softcap > 0.0:
        sc = cfg.attn_logit_softcap
        logits = torch.tanh(logits / sc) * sc
    logits = torch.where(mask[:, :, None], logits,
                         torch.full_like(logits, NEG_INF))
    top = lay.all_reduce_max(logits.amax(-1, keepdim=True), axes)
    e = torch.exp(logits - top)
    den = lay.all_reduce(e.sum(-1), axes)                   # (b,k,g,q)
    num = lay.all_reduce(torch.einsum("bkgqs,bskh->bqkgh", e, v.float()),
                         axes)
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, nq, hdim).to(q.dtype)


def init_paged_kv_cache(cfg: ModelConfig, num_rows: int, dtype, device):
    """Block-paged KV cache for ONE sublayer: a flat pool of
    ``num_rows = num_pages * page_size`` token rows shared by every
    sequence; which rows belong to which sequence is host-side metadata
    (``repro_torch.serve.kv_pool``)."""
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((num_rows, nkv, hd), dtype=dtype, device=device),
            "v": torch.zeros((num_rows, nkv, hd), dtype=dtype, device=device)}


def decode_attention_paged(p, cfg: ModelConfig, x, cache, positions,
                           row_idx, *, kind="attn", page_size=None):
    """One-token decode for B sequences at independent positions against a
    block-paged KV pool.

    x: (B, 1, D); positions: (B,) int32 write positions; row_idx:
    (B, max_kv) int32 per-token pool rows (rows past a sequence's pages
    point at the trash page 0).  The new K/V rows are written IN PLACE into
    ``cache`` (the pool tensors are updated, not copied).  Idle slots
    parked on the trash page all write row 0; which of them wins is
    undefined on CUDA and harmless, since no live sequence reads row 0.
    With ``page_size`` set and ``cfg.paged_attn_kernel`` (the default) the
    reduction runs in the paged decode kernel (its plain version for CPU
    tensors, see ``kernels/ops.py``).  Without ``page_size``, or with the
    config flag off, the gather path of the JAX package runs: ``k[row_idx]``,
    ``v[row_idx]`` and the dense path's ``_sdpa`` over the ``t <=
    positions[b]`` mask (windowed for ``kind="local"``), bit-exact with a
    dense-cache trace of the same sequence.  Returns (out, cache)."""
    q, k_new, v_new = _project_qkv(p, x)
    posb = _decode_positions(cfg, positions[:, None])   # (B, 1[, 3])
    q = _rope(cfg, q, posb)
    k_new = _rope(cfg, k_new, posb)
    write_rows = torch.gather(row_idx.long(), 1,
                              positions.long()[:, None])[:, 0]
    cache["k"][write_rows] = k_new[:, 0]            # in place
    cache["v"][write_rows] = v_new[:, 0]
    window = cfg.sliding_window if kind == "local" else 0
    if page_size is not None and cfg.paged_attn_kernel:
        out = kops.paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], row_idx, positions,
            page_size=page_size, window=window,
            softcap=cfg.attn_logit_softcap)[:, None]
    else:
        rows = row_idx.long()
        kb, vb = cache["k"][rows], cache["v"][rows]  # (B, max_kv, nkv, hd)
        kpos = torch.arange(rows.shape[1], device=x.device)
        at = positions.long()[:, None]
        valid = kpos[None, :] <= at
        if window > 0:
            valid &= kpos[None, :] > at - window
        out = _sdpa(q, kb, vb, valid[:, None, None, :],
                    cfg.attn_logit_softcap, cfg.head_dim)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    return out, cache
