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
