"""Common neural-net building blocks on tensors (parameters are plain
nested dicts, as in the JAX package)."""
from __future__ import annotations

import torch

from repro_torch.common.params import Param
from repro_torch.kernels.ref import act_fn


# ---------------------------------------------------------------- norms
def norm_params(d: int):
    return {"scale": Param((d,), ("unsharded",), init="ones")}


def apply_norm(p, x, kind: str = "rms", eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    if kind == "rms":
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    else:  # ln without bias: the variance of the centred x
        x = x - x.mean(-1, keepdim=True)
        x = x * torch.rsqrt(x.var(-1, unbiased=False, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


# ---------------------------------------------------------------- embeddings
def embed_params(vocab: int, d: int, tie: bool):
    p = {"embedding": Param((vocab, d), ("vocab", None), init="normal")}
    if not tie:
        p["unembed"] = Param((d, vocab), (None, "vocab"), init="scaled")
    return p


def embed(p, tokens, dtype=None):
    """The table is cast to the compute dtype BEFORE the lookup, where the
    JAX package casts it (the lookup then moves compute-dtype rows)."""
    table = p["embedding"]
    if dtype is not None:
        table = table.to(dtype)
    return table[tokens.long()]


def unembed(p, x, softcap: float = 0.0):
    """Product in the compute dtype, then f32, then the optional softcap."""
    if "unembed" in p:
        logits = x @ p["unembed"].to(x.dtype)
    else:
        logits = x @ p["embedding"].to(x.dtype).t()
    logits = logits.float()
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------- dense FFN
def is_glu(act: str) -> bool:
    return act.endswith("_glu")


def mlp_params(d: int, d_ff: int, act: str):
    p = {"wi": Param((d, d_ff), ("embed", "ff"), init="scaled"),
         "wo": Param((d_ff, d), ("ff", "embed"), init="scaled")}
    if is_glu(act):
        p["wg"] = Param((d, d_ff), ("embed", "ff"), init="scaled")
    return p


def apply_mlp(p, x, act: str):
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if is_glu(act):
        h = act_fn(act)(h) * (x @ p["wg"].to(dt))
    else:
        h = act_fn("gelu")(h)
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: (..., S).  Split-half rotation: the
    first and second halves of hd form the rotated pairs."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
