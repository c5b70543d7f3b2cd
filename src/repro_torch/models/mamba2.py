"""Mamba-2 (SSD, state-space duality: arXiv:2405.21060) block, the
counterpart of the JAX package's ``repro/models/mamba2.py``.

Chunked SSD forward for training and prefill (sub-quadratic: O(L·Q) with
chunk Q), and the one-step recurrence for decode (O(1) per token).  The
JAX package runs no Pallas kernel here: its SSD einsums, its scan over
chunks and the depthwise causal conv are plain XLA, so they are plain
PyTorch here, the scan a Python loop over chunks.  Layouts and parameter
names are the JAX package's.

Under a dense layout (``lay``, ``models.parallel``; ``dims`` the block's
layouts) a rank holds ``in_proj``, ``conv_w``, ``conv_b``, ``gate_norm``
and ``out_proj`` in the reference's shard shapes and all-gathers them
before use: ``in_proj``'s output concatenates z, x, B, C and dt, so a
flat split of it over ``model`` cuts across those segments, and the
block's compute is replicated over ``model``.  The recurrent cache keeps
the reference's layout (``mamba_cache_axes``: the conv channels and the
SSM heads over ``model``): a prefill keeps its shard of the final state,
and a decode step advances its own channels and heads (the conv is
depthwise, the SSM per head) and all-gathers their outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import Param


def mamba_params(cfg: ModelConfig):
    d, s = cfg.d_model, cfg.ssm
    d_in = s.expand * d
    nh = s.num_heads(d)
    conv_ch = d_in + 2 * s.state_dim
    return {
        "in_proj": Param((d, 2 * d_in + 2 * s.state_dim + nh),
                         ("embed", "ssm_inner"), init="scaled"),
        "conv_w": Param((s.conv_width, conv_ch), (None, "ssm_inner"),
                        init="scaled"),
        "conv_b": Param((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": Param((nh,), ("unsharded",), init="arange"),
        "D": Param((nh,), ("unsharded",), init="ones"),
        "dt_bias": Param((nh,), ("unsharded",), init="zeros"),
        "gate_norm": Param((d_in,), ("ssm_inner",), init="ones"),
        "out_proj": Param((d_in, d), ("ssm_inner", "embed"), init="scaled"),
    }


def _causal_conv(x, w, b):
    """x: (B, L, C) depthwise causal conv of width K = w.shape[0]; w:
    (K, C), b: (C,).  Returns (B, L, C), the taps summed in tap order."""
    k, n = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + n, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in = cfg.ssm.expand * cfg.d_model
    n = cfg.ssm.state_dim
    nh = cfg.ssm.num_heads(cfg.d_model)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    assert dt.shape[-1] == nh
    return z, xbc, dt


def _gated_norm(y, z, scale, eps=1e-6):
    y = y * F.silu(z.float())
    y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + eps)
    return y * scale.float()


def _pad_seq(a, pad: int):
    """Zero-pad dim 1 of ``a`` at its end by ``pad``."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """SSD scan.  x: (B, L, H, P) f32, dt: (B, L, H) f32 (post-softplus),
    A: (H,) f32 (negative), Bm/Cm: (B, L, N) f32.
    Returns (y: (B, L, H, P), final_state: (B, H, N, P))."""
    bsz, n_len, nh, pd = x.shape
    n = Bm.shape[-1]
    q = min(chunk, n_len)
    pad = (-n_len) % q
    if pad:
        x, dt, Bm, Cm = (_pad_seq(a, pad) for a in (x, dt, Bm, Cm))
    nc = (n_len + pad) // q
    xc = x.reshape(bsz, nc, q, nh, pd)
    dtc = dt.reshape(bsz, nc, q, nh)
    bc = Bm.reshape(bsz, nc, q, n)
    cc = Cm.reshape(bsz, nc, q, n)

    logdec = dtc * A[None, None, None, :]              # (B,nc,Q,H) <= 0
    cum = torch.cumsum(logdec, dim=2)                  # L_t
    # --- intra-chunk (quadratic within the chunk) ---------------------
    cb = torch.einsum("bcqn,bcsn->bcqs", cc, bc)       # (B,nc,Q,Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    # mask the EXPONENT, not only the product (C4): above the diagonal
    # cum_q - cum_s > 0 and exp overflows to inf; a where() on the product
    # alone hides it in the forward, but exp's backward then multiplies the
    # masked-out zero gradient by inf and every gradient upstream is NaN
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    dec = torch.exp(torch.where(tri, diff, torch.zeros((), device=x.device)))
    m = torch.where(tri, cb[..., None] * dec * dtc[:, :, None, :, :],
                    torch.zeros((), device=x.device))
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", m, xc)
    # --- chunk summary states -----------------------------------------
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)       # decay to chunk end
    s_chunk = torch.einsum("bcsh,bcsn,bcshp->bchnp", dtc * dec_end, bc, xc)
    tot = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    # --- inter-chunk scan ---------------------------------------------
    state = (torch.zeros((bsz, nh, n, pd), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * tot[:, c, :, None, None] + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)             # (B,nc,H,N,P)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, nc * q, nh, pd)
    return y[:, :n_len], state


def _whole(p, lay, dims):
    """The block's parameters, gathered whole under a layout."""
    if lay is None:
        return p
    return {k: lay.gather(t, dims[k]) for k, t in p.items()}


def _cache_splits(cfg: ModelConfig, lay):
    """(conv channels' axes, SSM heads' axes) of the recurrent cache under
    ``lay`` (the ``ssm_inner`` dims of ``mamba_cache_axes``)."""
    s = cfg.ssm
    conv_ch = s.expand * cfg.d_model + 2 * s.state_dim
    return (lay.layout_of((conv_ch,), ("ssm_inner",))[0],
            lay.layout_of((s.num_heads(cfg.d_model),), ("ssm_inner",))[0])


def _block_of(lay, t, axes, dim: int):
    """This rank's block of ``t`` along ``dim`` split over ``axes`` (all of
    it without a layout)."""
    if lay is None or lay.size(axes) == 1:
        return t
    return t.chunk(lay.size(axes), dim)[lay.index(axes)]


def mamba_forward(p, cfg: ModelConfig, x, return_state: bool = False,
                  lay=None, dims=None):
    """x: (B, L, D) -> (B, L, D); with ``return_state`` also the decode
    cache after the sequence (the conv tail and the final SSM state: the
    prefill's state handoff; under a layout the rank's shard of it)."""
    p = _whole(p, lay, dims)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.num_heads(cfg.d_model)
    dt_ = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = xbc.float()
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"].float(),
                              p["conv_b"].float()))
    xs = xbc[..., :d_in]
    bm = xbc[..., d_in:d_in + s.state_dim]
    cm = xbc[..., d_in + s.state_dim:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(*xs.shape[:2], nh, s.head_dim)
    y, state = ssd_chunked(xh, dt, a, bm, cm, s.chunk)
    y = y + p["D"].float()[None, None, :, None] * xh
    y = y.reshape(*xs.shape[:2], d_in)
    y = _gated_norm(y, z, p["gate_norm"])
    out = y.to(dt_) @ p["out_proj"].to(dt_)
    if return_state:
        kw = s.conv_width - 1
        tail = xbc_raw[:, -kw:, :]
        if tail.shape[1] < kw:
            tail = F.pad(tail, (0, 0, kw - tail.shape[1], 0))
        if lay is not None:
            ca, sa = _cache_splits(cfg, lay)
            tail, state = (_block_of(lay, tail, ca, 2),
                           _block_of(lay, state, sa, 1))
        return out, {"conv": tail, "ssm": state}
    return out


# ---------------------------------------------------------------- decode
def init_mamba_cache(cfg: ModelConfig, batch: int, device, lay=None):
    """One sublayer's decode state for ``batch`` sequences: the conv's
    last K - 1 inputs and the SSM state, f32 (whatever the compute
    dtype), as in the JAX package; under a layout the rank's channels and
    heads."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.num_heads(cfg.d_model)
    conv_ch = d_in + 2 * s.state_dim
    if lay is not None:
        ca, sa = _cache_splits(cfg, lay)
        conv_ch //= lay.size(ca)
        nh //= lay.size(sa)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, nh, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode_step(p, cfg: ModelConfig, x, cache, lay=None, dims=None):
    """x: (B, 1, D).  The O(1) recurrent update; returns (out, new cache)
    with new tensors (the caller writes them into its cache).  Under a
    layout the cache holds the rank's conv channels and SSM heads: it
    advances those and all-gathers the conv's and the SSM's outputs."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.num_heads(cfg.d_model)
    dt_ = x.dtype
    p = _whole(p, lay, dims)
    ca = sa = ()
    if lay is not None:
        ca, sa = _cache_splits(cfg, lay)
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = xbc[:, 0].float()                                   # (B, C)
    hist = torch.cat([cache["conv"], _block_of(lay, xbc, ca, 1)[:, None]],
                     dim=1)                                   # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", hist,
                            _block_of(lay, p["conv_w"].float(), ca, 1)) \
        + _block_of(lay, p["conv_b"].float(), ca, 0)
    if ca:
        conv_out = lay.gather_nograd(conv_out, ca, 1)
    conv_out = F.silu(conv_out)
    xs = conv_out[:, :d_in]
    bm = conv_out[:, d_in:d_in + s.state_dim]
    cm = conv_out[:, d_in + s.state_dim:]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # (B, H)
    a = torch.exp(dt1 * -torch.exp(p["A_log"].float())[None, :])
    xh = xs.reshape(-1, nh, s.head_dim)                      # (B, H, P)
    upd = torch.einsum("bh,bn,bhp->bhnp", _block_of(lay, dt1, sa, 1), bm,
                       _block_of(lay, xh, sa, 1))
    new_ssm = cache["ssm"] * _block_of(lay, a, sa, 1)[:, :, None, None] \
        + upd                                                 # (B,H,N,P)
    y = torch.einsum("bn,bhnp->bhp", cm, new_ssm)
    if sa:
        y = lay.gather_nograd(y, sa, 1)
    y = y + p["D"].float()[None, :, None] * xh
    y = _gated_norm(y.reshape(-1, 1, d_in), z, p["gate_norm"])
    out = y.to(dt_) @ p["out_proj"].to(dt_)
    return out, {"conv": hist[:, 1:], "ssm": new_ssm}
