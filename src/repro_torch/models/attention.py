"""GQA attention with RoPE, softcap, sliding window and the block-paged KV
cache.

The plain path is einsum-based; the flash-attention kernel takes over the
prefill when ``use_pallas`` is set (the JAX package's name for "use the
hand-written kernels"), and the paged decode-attention kernel does the
decode reduction.  Layouts are the JAX package's:
(B, S, N, H) activations, a flat (num_rows, nkv, hd) paged pool.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import Param
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def attn_params(cfg: ModelConfig):
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
    if cfg.qkv_bias:
        p["bq"] = Param((nq, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = Param((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = Param((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


def _project_qkv(p, x):
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(dt))
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


def _check_rope(cfg: ModelConfig):
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not yet ported to repro_torch")


def attention(p, cfg: ModelConfig, x, positions, *, kind: str = "attn",
              causal: bool = True, use_pallas: bool = False,
              return_kv: bool = False):
    """Full-sequence self-attention (prefill).  Returns (B,S,D), and the
    rotated (k, v) when ``return_kv`` (the prefill cache fill)."""
    _check_rope(cfg)
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if kind == "local" else 0
    mask = None
    if causal or window:
        mask = make_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                         device=x.device)
    # the JAX package's routing rule: the kernel takes masked self-attention
    # without a logit softcap
    if use_pallas and mask is not None and cfg.attn_logit_softcap == 0.0:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap, cfg.head_dim)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return out, {"k": k, "v": v}
    return out


# ------------------------------------------------------------------ decode
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
    _check_rope(cfg)
    q, k_new, v_new = _project_qkv(p, x)
    posb = positions[:, None]                       # (B, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
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
