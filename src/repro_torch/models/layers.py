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


def embed(p, tokens, dtype=None, lay=None, dims=None):
    """The table is cast to the compute dtype BEFORE the lookup, where the
    JAX package casts it (the lookup then moves compute-dtype rows).

    Under a layout ``lay`` (``models.parallel``; ``dims`` the embedding
    subtree's layouts) a table whose vocabulary is split over axes the
    rows are replicated over is looked up vocab-parallel: a token outside
    the rank's shard gives zero, and the sum over those axes gives the
    row.  Any other split is gathered first."""
    table = p["embedding"]
    if dtype is not None:
        table = table.to(dtype)
    if lay is None:
        return table[tokens.long()]
    layout = dims["embedding"]
    va = layout[0]
    if not lay.tp(va):
        return lay.gather(table, layout)[tokens.long()]
    table = lay.gather(table, layout, keep=va)
    n = table.shape[0]
    local = tokens.long() - lay.index(va) * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
    return lay.all_reduce(rows, va)


def vocab_axes(lay, dims):
    """The axes the logits' vocabulary stays split over under ``lay``
    (``()``: whole logits on the rank)."""
    if lay is None:
        return ()
    w = dims["unembed"] if "unembed" in dims else dims["embedding"]
    va = w[1] if "unembed" in dims else w[0]
    return va if lay.tp(va) else ()


def unembed_weights(p, dtype, lay=None, dims=None):
    """The output projection's parameters as ``unembed`` multiplies by
    them: in ``dtype``, and under a layout gathered but for the
    vocabulary's tensor-parallel split (``vocab_axes``).  With ``lay``
    None ``unembed`` takes the result as it is."""
    key = "unembed" if "unembed" in p else "embedding"
    w = p[key].to(dtype)
    if lay is not None:
        w = lay.gather(w, dims[key], keep=vocab_axes(lay, dims))
    return {key: w}


def unembed(p, x, softcap: float = 0.0, lay=None, dims=None):
    """Product in the compute dtype, then f32, then the optional softcap.
    Under a layout: the rank's vocabulary shard of the logits where the
    vocabulary runs tensor-parallel (``vocab_axes``), whole logits
    otherwise."""
    w = unembed_weights(p, x.dtype, lay, dims)
    if "unembed" in w:
        logits = x @ w["unembed"]
    else:
        logits = x @ w["embedding"].t()
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


def apply_mlp(p, x, act: str, lay=None, dims=None):
    """The dense FFN.  Under a layout ``lay`` (``dims``: the FFN's
    layouts) the d_model splits are gathered and a hidden dim split over
    axes the rows are replicated over runs tensor-parallel: ``wi``/``wg``
    column-parallel, ``wo`` row-parallel, one sum over those axes."""
    dt = x.dtype
    w = {k: t.to(dt) for k, t in p.items()}
    fa = ()
    if lay is not None:
        fa = dims["wi"][1] if lay.tp(dims["wi"][1]) else ()
        w = {k: lay.gather(t, dims[k], keep=fa) for k, t in w.items()}
    h = x @ w["wi"]
    if is_glu(act):
        h = act_fn(act)(h) * (x @ w["wg"])
    else:
        h = act_fn("gelu")(h)
    out = h @ w["wo"]
    return lay.all_reduce(out, fa) if fa else out


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0,
               mrope_sections=None):
    """x: (..., S, H, hd); positions: (..., S), or (..., S, 3) for M-RoPE.
    Split-half rotation: the first and second halves of hd form the
    rotated pairs.

    M-RoPE (Qwen2-VL, arXiv:2409.12191): the hd/2 rotary frequencies are
    split into temporal, height and width sections (``mrope_sections``),
    each rotated by its own position stream.  For text tokens the three
    streams coincide and M-RoPE reduces to RoPE."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    if mrope_sections is None:
        ang = positions[..., None].float() * inv          # (..., S, hd/2)
    else:
        assert positions.shape[-1] == 3, "M-RoPE needs (..., S, 3) positions"
        secs, start = [], 0
        for i, sec in enumerate(mrope_sections):
            secs.append(positions[..., i, None].float()
                        * inv[start:start + sec])
            start += sec
        ang = torch.cat(secs, dim=-1)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def default_mrope_sections(head_dim: int):
    """Qwen2-VL uses [16, 24, 24] for hd=128; scale proportionally."""
    half = head_dim // 2
    t = half // 4
    rest = half - t
    h = rest // 2
    return (t, h, rest - h)
