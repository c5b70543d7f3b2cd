"""GQA attention with RoPE / M-RoPE, softcap, sliding window, and the dense
and the block-paged KV caches.

The plain path is einsum-based; the flash-attention kernel takes over the
prefill when ``use_pallas`` is set (the JAX package's name for "use the
hand-written kernels"), and the paged decode-attention kernel does the
paged decode reduction.  The dense decode path is plain PyTorch, as it is
plain XLA in the JAX package.  Layouts are the JAX package's: (B, S, N, H)
activations, a (B, max_len, nkv, hd) dense cache, a flat
(num_rows, nkv, hd) paged pool.
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
              return_kv: bool = False):
    """Full-sequence attention (training and prefill).  Returns (B,S,D),
    and the rotated (k, v) when ``return_kv`` (the prefill cache fill).
    positions: (B, S), or (B, S, 3) with M-RoPE.  ``xa`` (B, S_enc, D):
    cross attention over the encoder states, with no RoPE (pass
    ``causal=False``: no mask)."""
    q, k, v = _project_qkv(p, x, xa=xa)
    if xa is None:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    window = cfg.sliding_window if kind == "local" else 0
    mask = None
    if causal or window:
        mask = make_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                         device=x.device)
    # the JAX package's routing rule: the kernel takes masked self-attention
    # without a logit softcap; bidirectional and cross attention (no mask)
    # stay plain, as they are XLA there
    if (use_pallas and mask is not None and xa is None
            and cfg.attn_logit_softcap == 0.0):
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap, cfg.head_dim)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return out, {"k": k, "v": v}
    return out


# ------------------------------------------------------------------ decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device):
    """Dense KV cache for ONE sublayer: ``max_len`` token rows per
    sequence."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, cfg: ModelConfig, x, cache, pos: int, *,
                     kind="attn"):
    """One-token decode for B sequences at the same position against the
    dense cache.

    x: (B, 1, D); pos: the position being written, a Python int (the
    write and the mask need no value from the device).  The new K/V row
    is written IN PLACE at ``pos``; attention spans cache[0..pos],
    windowed for ``kind="local"``.  Returns (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x)
    posb = _decode_positions(cfg, torch.full((b, 1), pos, dtype=torch.long,
                                             device=x.device))
    q = _rope(cfg, q, posb)
    k_new = _rope(cfg, k_new, posb)
    cache["k"][:, pos] = k_new[:, 0]                # in place
    cache["v"][:, pos] = v_new[:, 0]
    window = cfg.sliding_window if kind == "local" else 0
    skv = cache["k"].shape[1]
    mask = make_mask(1, skv, causal=True, window=window, q_offset=pos,
                     device=x.device)
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg.attn_logit_softcap,
                cfg.head_dim)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    return out, cache


def init_paged_kv_cache(cfg: ModelConfig, num_rows: int, dtype, device):
    """Block-paged KV cache for ONE sublayer: a flat pool of
    ``num_rows = num_pages * page_size`` token rows shared by every
    sequence; which rows belong to which sequence is host-side metadata
    (``repro_torch.serve.kv_pool``)."""
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((num_rows, nkv, hd), dtype=dtype, device=device),
            "v": torch.zeros((num_rows, nkv, hd), dtype=dtype, device=device)}


def decode_attention_paged(p, cfg: ModelConfig, x, cache, positions,
                           row_idx, *, kind="attn", page_size: int):
    """One-token decode for B sequences at independent positions against a
    block-paged KV pool.

    x: (B, 1, D); positions: (B,) int32 write positions; row_idx:
    (B, max_kv) int32 per-token pool rows (rows past a sequence's pages
    point at the trash page 0).  The new K/V rows are written IN PLACE into
    ``cache`` (the pool tensors are updated, not copied).  Idle slots
    parked on the trash page all write row 0; which of them wins is
    undefined on CUDA and harmless, since no live sequence reads row 0.
    The reduction runs in the paged decode kernel (its plain version for
    CPU tensors, see ``kernels/ops.py``); the JAX package's separate gather
    path behind ``cfg.paged_attn_kernel=False`` computes the same function
    and is not ported.  Returns (out, cache)."""
    q, k_new, v_new = _project_qkv(p, x)
    posb = _decode_positions(cfg, positions[:, None])   # (B, 1[, 3])
    q = _rope(cfg, q, posb)
    k_new = _rope(cfg, k_new, posb)
    write_rows = torch.gather(row_idx.long(), 1,
                              positions.long()[:, None])[:, 0]
    cache["k"][write_rows] = k_new[:, 0]            # in place
    cache["v"][write_rows] = v_new[:, 0]
    window = cfg.sliding_window if kind == "local" else 0
    out = kops.paged_decode_attention(
        q[:, 0], cache["k"], cache["v"], row_idx, positions,
        page_size=page_size, window=window,
        softcap=cfg.attn_logit_softcap)[:, None]
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    return out, cache
