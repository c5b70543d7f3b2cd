"""Model assembly: config -> params / forward (training and prefill) /
dense and paged decode.

A model is a stack of ``num_superblocks`` identical superblocks (one tile
of ``cfg.layer_pattern``: attention layers, ``attn`` or ``local``, and
Mamba-2 layers, ``mamba``).  An encoder-decoder (Whisper) adds an encoder,
a stack of ``cfg.encoder_layers`` bidirectional attention superblocks over
the stub frontend's frame embeddings, and a cross-attention sublayer in
each decoder superblock.  Parameters are stacked along a leading
superblock axis exactly as in the JAX package (``blocks/l{j}/...``), and
the JAX package's ``scan`` over superblocks becomes a Python loop here.
MoE FFNs read from the one cross-layer chunk buffer through
``repro_torch.core.moe``.  On a process grid the stack follows the
reference's ``moe.rematerialize`` modes and its one-layer-ahead
SparseAllGather (``_grid_blocks``, the port of ``_pipelined_blocks``).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import sys
import threading
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import init_tree, stack_params, torch_dtype
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import MoERuntime, PlanArrays
from repro_torch.models import attention as attn
from repro_torch.models import layers as ly
from repro_torch.models import mamba2 as mb


def checkpoint(fn, *args, **kw):
    """``torch.utils.checkpoint.checkpoint``, with ``torch._dynamo``
    imported first on a thread of its own.  The checkpoint imports it at
    its first call, and that import leaves a frame of ``torch.fx.wrap``
    in a reference cycle that holds every frame on the importing stack:
    the first checkpointed step of a process would keep its training
    state (the frames' locals) alive until the cyclic garbage collector
    runs.  A thread's stack holds nothing of the caller."""
    if "torch._dynamo" not in sys.modules:
        t = threading.Thread(target=importlib.import_module,
                             args=("torch._dynamo",), name="import-dynamo")
        t.start()
        t.join()
    return _checkpoint(fn, *args, **kw)


@dataclasses.dataclass
class Runtime:
    """Execution context threaded through the model, as in the JAX package
    without a mesh.  ``use_pallas`` keeps the JAX package's name for "run
    the hand-written kernel" in attention: the flash-attention forward at
    prefill.  ``moe.use_pallas`` does the same for the grouped expert FFN.
    Kernels run for CUDA tensors; CPU tensors take their plain versions.
    The port defaults both on (serving); training turns attention's off,
    since the flash kernel has no backward and the JAX package trains with
    XLA attention."""
    use_pallas: bool = True
    moe: MoERuntime = dataclasses.field(default_factory=MoERuntime)

    @property
    def grid(self):
        """The process grid (``launch.mesh.ProcessGrid``) or None.  On a
        grid each rank runs the whole model on its own rows of the batch,
        and only the MoE layer communicates."""
        return self.moe.grid


def _moe_positions(cfg: ModelConfig) -> Tuple[int, ...]:
    """Positions within a superblock that carry an MoE FFN (must be
    consistent across superblocks)."""
    pl = len(cfg.layer_pattern)
    pos = tuple(j for j in range(pl) if cfg.is_moe_layer(j))
    for sb in range(cfg.num_superblocks):
        got = tuple(j for j in range(pl) if cfg.is_moe_layer(sb * pl + j))
        assert got == pos, (
            f"{cfg.name}: MoE period {cfg.moe.period} incompatible with "
            f"layer_pattern length {pl}")
    return pos


def _check_ported(cfg: ModelConfig):
    kinds = set(cfg.layer_pattern)
    if not kinds <= {"attn", "local", "mamba"}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} are not ported to "
            f"repro_torch")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------
def _sublayer_decl(cfg: ModelConfig, kind: str, is_moe: bool,
                   cross: bool = False):
    """An attention sublayer has an FFN (dense or MoE); a mamba one only
    when it is an MoE layer (the hybrid's), with its norm.  ``cross``: an
    encoder-decoder's decoder sublayer, with its cross-attention norm
    ``lnx`` and projections ``xattn``."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": ly.norm_params(d)}
    if kind == "mamba":
        p["mamba"] = mb.mamba_params(cfg)
    else:
        p["attn"] = attn.attn_params(cfg)
    if cross:
        p["lnx"] = ly.norm_params(d)
        p["xattn"] = attn.attn_params(cfg, cross=True)
    if kind != "mamba" or is_moe:
        p["ln2"] = ly.norm_params(d)
    if kind != "mamba" and not is_moe:
        p["mlp"] = ly.mlp_params(d, cfg.d_ff, cfg.act)
    return p


def param_decls(cfg: ModelConfig, ep: int = 1):
    """Full parameter declaration tree (Param descriptors), the JAX
    package's tree: an encoder-decoder adds ``encoder/{blocks,
    final_norm}`` (one attention sublayer per encoder superblock)."""
    _check_ported(cfg)
    moe_pos = _moe_positions(cfg) if cfg.moe.enabled else ()
    sb = {f"l{j}": _sublayer_decl(cfg, kind, j in moe_pos,
                                  cross=cfg.is_encoder_decoder)
          for j, kind in enumerate(cfg.layer_pattern)}
    decls: Dict[str, Any] = {
        "embed": ly.embed_params(cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings),
        "blocks": stack_params(sb, cfg.num_superblocks),
        "final_norm": ly.norm_params(cfg.d_model),
    }
    if cfg.moe.enabled:
        decls["router"] = moe_core.router_param(cfg)
        decls["moe_buffer"] = moe_core.moe_buffer_param(cfg, ep)
    if cfg.is_encoder_decoder:
        enc_sb = {"l0": _sublayer_decl(cfg, "attn", False)}
        decls["encoder"] = {
            "blocks": stack_params(enc_sb, cfg.encoder_layers),
            "final_norm": ly.norm_params(cfg.d_model),
        }
    return decls


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                ep: int = 1, grid=None):
    """Parameters from a seeded ``torch.Generator`` on ``device``.  With a
    process ``grid`` every rank makes the same tree and keeps its shard of
    the chunk buffer (``shard_params``)."""
    params = init_tree(param_decls(cfg, ep), seed, cfg.param_dtype, device)
    return params if grid is None else shard_params(params, grid)


def shard_params(params, grid):
    """The tree a rank of ``grid`` holds: every parameter replicated but
    the chunk buffer, of which it keeps its (rows / model, chunk_len /
    data) shard."""
    if "moe_buffer" not in params:
        return params
    return dict(params, moe_buffer=moe_core.shard_buffer(
        params["moe_buffer"], grid))


def _block(params, sb: int):
    """Superblock ``sb``'s slice of the stacked block parameters (views)."""
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[sb]
    return take(params["blocks"])


# ---------------------------------------------------------------------------
# MoE FFN wrapper
# ---------------------------------------------------------------------------
def _moe_ffn(cfg: ModelConfig, rt: Runtime, x, wr, buf, pa: PlanArrays,
             premat=None, layer: int = -1, pipe=None, pa_prev=None,
             warm_start: bool = False):
    """x: (B, S, D) -> (y, MoEAux): flatten the tokens and run the MoE
    layer over all of them (no padding to a device count: on a grid each
    rank holds whole rows of the batch, which are its token slice).

    On a grid in ``rematerialize="gather"`` mode, given slots go through
    ``moe_layer_regather``, or with a backward ``pipe`` (``BwdPipe``)
    through ``moe_layer_regather_pipelined``: ``pa_prev`` is the previous
    MoE layer's tables (None for the first) and ``warm_start`` marks the
    network's last MoE layer."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if (premat is not None and rt.grid is not None
            and cfg.moe.rematerialize == "gather"):
        if pipe is not None:
            y, aux = moe_core.moe_layer_regather_pipelined(
                cfg, rt.moe, xt, wr, buf, pa, pa_prev, None, premat, pipe,
                layer, warm_start)
        else:
            y, aux = moe_core.moe_layer_regather(cfg, rt.moe, xt, wr, buf,
                                                 pa, None, premat, layer)
    else:
        y, aux = moe_core.moe_layer(cfg, rt.moe, xt, wr, buf, pa,
                                    premat=premat, layer=layer)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Full-sequence forward (training and prefill)
# ---------------------------------------------------------------------------
def _mixer(cfg: ModelConfig, rt: Runtime, kind: str, positions,
           causal: bool, p, h, collect_cache: bool = False):
    """A sublayer's sequence mixer on its normed input ``h``: attention, or
    the Mamba-2 block for ``kind="mamba"``; with ``collect_cache`` also its
    decode cache (the rotated K/V, or the conv tail and the SSM state)."""
    if kind == "mamba":
        return mb.mamba_forward(p["mamba"], cfg, h,
                                return_state=collect_cache)
    return attn.attention(p["attn"], cfg, h, positions, kind=kind,
                          causal=causal, use_pallas=rt.use_pallas,
                          return_kv=collect_cache)


def _superblock(cfg: ModelConfig, rt: Runtime, params, sb: int, pa, premat,
                positions, causal: bool, collect_cache: bool, x,
                enc_out=None):
    """One superblock: returns (x, [MoEAux per MoE layer], {l{j}: cache}
    when ``collect_cache``: an attention sublayer's {"k", "v"}, a mamba
    one's {"conv", "ssm"}).  ``enc_out`` (B, S_enc, D): the encoder
    states each attention sublayer cross-attends to after its
    self-attention (an encoder-decoder's decoder)."""
    moe_pos = _moe_positions(cfg) if cfg.moe.enabled else ()
    p_sb = _block(params, sb)
    aux_list, cache = [], {}
    mi = sb * len(moe_pos)
    for j, kind in enumerate(cfg.layer_pattern):
        p = p_sb[f"l{j}"]
        y = _mixer(cfg, rt, kind, positions, causal, p,
                   ly.apply_norm(p["ln1"], x, cfg.norm), collect_cache)
        if collect_cache:
            y, cache[f"l{j}"] = y
        x = x + y
        if enc_out is not None and kind != "mamba":
            hx = ly.apply_norm(p["lnx"], x, cfg.norm)
            x = x + attn.attention(p["xattn"], cfg, hx, positions,
                                   causal=False, xa=enc_out)
        if j in moe_pos:
            h = ly.apply_norm(p["ln2"], x, cfg.norm)
            y, aux = _moe_ffn(cfg, rt, h, params["router"][mi],
                              params["moe_buffer"], pa.layer(mi),
                              premat=None if premat is None else premat[mi],
                              layer=mi)
            x = x + y
            aux_list.append(aux)
            mi += 1
        elif kind != "mamba":
            x = _dense_ffn(cfg, p, x)
    return x, aux_list, cache


def _use_pipeline(cfg: ModelConfig, rt: Runtime) -> bool:
    """The one-layer-ahead SparseAllGather prefetch: on a process grid,
    with ``cfg.moe.pipeline``, off under ``rematerialize="block"``."""
    return (cfg.moe.enabled and cfg.moe.pipeline and rt.grid is not None
            and cfg.moe.rematerialize != "block")


def _use_bwd_pipe(cfg: ModelConfig, rt: Runtime) -> bool:
    """The backward re-gather pipeline: ``gather`` mode on a grid with
    ``cfg.moe.bwd_prefetch``."""
    return (cfg.moe.enabled and cfg.moe.rematerialize == "gather"
            and cfg.moe.bwd_prefetch and rt.grid is not None)


def _mix(cfg: ModelConfig, rt: Runtime, kind: str, positions, causal: bool,
         p, x):
    """A sublayer's mixer segment: x + mixer(norm(x))."""
    return x + _mixer(cfg, rt, kind, positions, causal, p,
                      ly.apply_norm(p["ln1"], x, cfg.norm))


def _dense_ffn(cfg: ModelConfig, p, x):
    return x + ly.apply_mlp(p["mlp"], ly.apply_norm(p["ln2"], x, cfg.norm),
                            cfg.act)


def _grid_blocks(cfg: ModelConfig, rt: Runtime, params, x, positions,
                 pa: PlanArrays, causal: bool, premat=None):
    """The superblock stack on a process grid in ``save`` or ``gather``
    mode (``block`` mode runs the whole-superblock checkpoint of
    ``forward``).  Returns (x, [MoEAux per MoE layer]).

    With ``cfg.moe.pipeline`` the SparseAllGather runs one layer ahead: a
    warm-up gather issues layer 0's before the first block, and each MoE
    position issues layer l+1's after its attention and before layer l's
    consumer, so the collectives overlap the compute in between; none is
    issued after the last layer.  Without the pipeline (``save`` only)
    each layer issues its own there.  ``premat``: step-hoisted (L, 1, K,
    chunk_len) slots (``moe.materialize_stack``), consumed in place of
    every gather.

    With ``cfg.remat`` and grad on, the attention and dense-FFN segments
    are checkpointed one by one.  ``save``: the MoE layer is checkpointed
    too, with its slots as an explicit input, so the slots are kept and
    its recompute gathers nothing.  ``gather``: the prefetch reads a
    detached buffer and the MoE layer is ``moe_layer_regather``
    (``_pipelined`` with ``cfg.moe.bwd_prefetch``), which keeps no slots
    and re-gathers them in the backward."""
    gather = cfg.moe.rematerialize == "gather"
    grad = torch.is_grad_enabled()
    remat = cfg.remat and grad
    ahead = cfg.moe.pipeline
    dt = torch_dtype(cfg.dtype)
    buf = params["moe_buffer"]
    src = buf.detach() if gather else buf
    n_moe = pa.local_rows.shape[0]
    moe_pos = _moe_positions(cfg)
    pipe = moe_core.BwdPipe() if _use_bwd_pipe(cfg, rt) and grad else None

    def issue(l):
        return moe_core.materialize_layer(cfg, rt.moe, src, pa.layer(l), dt,
                                          layer=l)

    def seg(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    def consume(l, p, wr, x, slots):
        h = ly.apply_norm(p["ln2"], x, cfg.norm)
        y, aux = _moe_ffn(cfg, rt, h, wr, buf, pa.layer(l), premat=slots,
                          layer=l, pipe=pipe,
                          pa_prev=pa.layer(l - 1) if l > 0 else None,
                          warm_start=l == n_moe - 1)
        return x + y, aux

    nxt = issue(0) if premat is None and ahead else None
    aux_list = []
    mi = 0
    for sb in range(cfg.num_superblocks):
        p_sb = _block(params, sb)
        for j, kind in enumerate(cfg.layer_pattern):
            p = p_sb[f"l{j}"]
            x = seg(partial(_mix, cfg, rt, kind, positions, causal), p, x)
            if j not in moe_pos:
                if kind != "mamba":
                    x = seg(partial(_dense_ffn, cfg), p, x)
                continue
            if premat is not None:
                slots = premat[mi]
            elif ahead:
                slots, nxt = nxt, (issue(mi + 1) if mi + 1 < n_moe
                                   else None)
            else:
                slots = issue(mi)
            wr = params["router"][mi]
            if remat and not gather:
                x, aux = checkpoint(partial(consume, mi), p, wr, x,
                                    moe_core._slots_of(slots),
                                    use_reentrant=False)
            else:
                x, aux = consume(mi, p, wr, x, slots)
            aux_list.append(aux)
            mi += 1
    return x, aux_list


def forward(cfg: ModelConfig, rt: Runtime, params, tokens=None, *,
            embeds=None, pa: Optional[PlanArrays] = None, positions=None,
            encoder_input=None, causal: bool = True,
            collect_cache: bool = False, return_hidden: bool = False,
            premat=None):
    """tokens: (B, S) int -> (logits (B, S, V) f32, aux) — or
    (logits, aux, cache) with ``collect_cache``: the cache holds every
    attention layer's rotated K/V as ``{"l{j}": {"k", "v"}}`` of shape
    (n_superblocks, B, S, nkv, hd), and every mamba layer's state after
    the sequence as ``{"l{j}": {"conv", "ssm"}}`` (n_superblocks, B, ...),
    the JAX package's stacked layouts.  aux: one MoEAux per MoE layer, in
    layer order.

    ``embeds`` (B, S, D) replaces ``tokens`` for a frontend stub
    (Qwen2-VL's patch and text embeddings): taken as they are, without the
    √d scale of the token embedding.  ``encoder_input`` (B, S_enc, D): an
    encoder-decoder's frame embeddings (Whisper's stub frontend), encoded
    once (``_encode``) and cross-attended by every decoder superblock;
    with ``collect_cache`` the cache also holds every decoder layer's
    cross K/V, ``xk`` and ``xv`` (n_superblocks, B, S_enc, nkv, hd)
    (``precompute_cross_kv``).  ``positions`` defaults to 0..S-1 per
    sequence, broadcast to the three streams (B, S, 3) under M-RoPE.

    ``return_hidden`` returns the final-norm hidden states (B, S, D) in
    place of the logits: the train path computes its loss chunked from
    them and never materializes (B, S, V) logits.  With ``cfg.remat`` and
    grad enabled each superblock runs under ``torch.utils.checkpoint``, at
    the place the JAX package puts its ``jax.checkpoint``: only the
    superblock inputs are kept, and the backward re-runs each block's
    forward (so the forward kernels launch twice per step).

    pa: stacked PlanArrays (L_moe leading dim).  premat: optional
    (L_moe, 1, K, chunk_len) compute slots (``moe.materialize_chunks``, or
    ``moe.materialize_stack`` on a grid, where it needs the pipelined
    path).

    On a process grid the MoE stack follows ``cfg.moe.rematerialize``:
    ``save`` and ``gather`` run ``_grid_blocks`` (the one-layer-ahead
    prefetch, segment checkpoints), ``block`` the whole-superblock
    checkpoint above with each layer's gather inside it."""
    _check_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    if embeds is None:
        # scaled in the compute dtype, as the JAX package scales
        x = ly.embed(params["embed"], tokens, dt) * math.sqrt(cfg.d_model)
    else:
        x = embeds.to(dt)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
        if cfg.mrope:
            positions = positions[..., None].expand(b, s, 3)
    if cfg.moe.enabled:
        assert pa is not None, "MoE arch needs PlanArrays"
    if premat is not None and rt.grid is not None \
            and not _use_pipeline(cfg, rt):
        raise ValueError("forward(premat=...) on a process grid needs the "
                         "pipelined MoE path (moe.pipeline=True, "
                         "rematerialize != 'block')")
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    enc_out = None
    if cfg.is_encoder_decoder:
        if encoder_input is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             f"needs encoder_input")
        enc_out = _encode(cfg, rt, params["encoder"], encoder_input.to(dt))
    aux_list = []
    caches = {f"l{j}": [] for j in range(len(cfg.layer_pattern))}
    if (cfg.moe.enabled and rt.grid is not None and not collect_cache
            and cfg.moe.rematerialize != "block"):
        x, aux_list = _grid_blocks(cfg, rt, params, x, positions, pa, causal,
                                   premat)
    else:
        for sb in range(cfg.num_superblocks):
            blk = partial(_superblock, cfg, rt, params, sb, pa, premat,
                          positions, causal, collect_cache,
                          enc_out=enc_out)
            if remat:
                x, auxs, cache = checkpoint(blk, x, use_reentrant=False)
            else:
                x, auxs, cache = blk(x)
            aux_list.extend(auxs)
            for name, c in cache.items():
                caches[name].append(c)
    x = ly.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux_list
    logits = ly.unembed(params["embed"], x, cfg.final_logit_softcap)
    if collect_cache:
        cache = {name: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                 for name, cs in caches.items()}
        if enc_out is not None:
            cache["xk"], cache["xv"] = precompute_cross_kv(cfg, params,
                                                           enc_out)
        return logits, aux_list, cache
    return logits, aux_list


def _encode(cfg: ModelConfig, rt: Runtime, enc_params, enc_in):
    """The encoder: ``cfg.encoder_layers`` superblocks of bidirectional
    self-attention (RoPE, no mask: the plain path, as the JAX package's
    XLA) and the dense FFN over ``enc_in`` (B, S_enc, D) in the compute
    dtype, then the encoder's final norm.  With ``cfg.remat`` and grad on
    each superblock runs under ``torch.utils.checkpoint``, where the JAX
    package puts its ``jax.checkpoint``."""
    b, s = enc_in.shape[:2]
    positions = torch.arange(s, device=enc_in.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    x = enc_in
    for sb in range(cfg.encoder_layers):
        blk = partial(_superblock, cfg, rt, enc_params, sb, None, None,
                      positions, False, False)
        if remat:
            x, _, _ = checkpoint(blk, x, use_reentrant=False)
        else:
            x, _, _ = blk(x)
    return ly.apply_norm(enc_params["final_norm"], x, cfg.norm)


def precompute_cross_kv(cfg: ModelConfig, params, enc_out):
    """Every decoder layer's cross-attention K and V of the encoder states
    ``enc_out`` (B, S_enc, D): (n_superblocks, B, S_enc, nkv, hd) each, in
    ``enc_out``'s dtype (no RoPE, no bias)."""
    dt = enc_out.dtype
    xattn = params["blocks"]["l0"]["xattn"]
    return tuple(torch.stack([
        torch.einsum("bsd,dnh->bsnh", enc_out, w[sb].to(dt))
        for sb in range(cfg.num_superblocks)]) for w in (xattn["wk"],
                                                           xattn["wv"]))


def _cross_decode(p, cfg: ModelConfig, x, xk, xv):
    """One decode token's cross attention against a layer's precomputed
    encoder K/V (B, S_enc, nkv, hd): no RoPE, no mask."""
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    out = attn._sdpa(q, xk, xv, None, cfg.attn_logit_softcap, cfg.head_dim)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Decode (one token against a dense or a block-paged cache)
# ---------------------------------------------------------------------------
def _stacked(cfg: ModelConfig, one):
    """One sublayer's cache tensors with a leading num_superblocks axis."""
    return {k: t.expand(cfg.num_superblocks, *t.shape).clone()
            for k, t in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Dense decode cache: every attention sublayer holds
    (num_superblocks, batch, max_len, nkv, hd) K and V, every mamba
    sublayer its (num_superblocks, batch, ...) f32 conv and SSM state, as
    in the JAX package; an encoder-decoder also the cross K/V ``xk`` and
    ``xv`` (num_superblocks, batch, encoder_seq_len, nkv, hd), zeros until
    ``precompute_cross_kv`` fills them."""
    _check_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    cache = {f"l{j}": _stacked(cfg, mb.init_mamba_cache(cfg, batch, device)
                               if kind == "mamba" else attn.init_kv_cache(
                                   cfg, batch, max_len, dt, device))
             for j, kind in enumerate(cfg.layer_pattern)}
    if cfg.is_encoder_decoder:
        shp = (cfg.num_superblocks, batch, cfg.encoder_seq_len,
               cfg.num_kv_heads, cfg.head_dim)
        for k in ("xk", "xv"):
            cache[k] = torch.zeros(shp, dtype=dt, device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_rows: int,
                     device="cuda"):
    """Block-paged decode cache: every attention sublayer owns a flat pool
    of ``num_rows`` token rows, while a mamba sublayer, whose state does
    not grow with the sequence, keeps one dense state per scheduler slot
    (``num_slots``); a leading ``num_superblocks`` axis on each, as in the
    JAX package.  A slot's state is overwritten whole by its request's
    prefill, so nothing of an earlier request reaches a later one.
    Encoder-decoder caches are not paged, as in the JAX package."""
    _check_ported(cfg)
    if cfg.is_encoder_decoder:
        raise ValueError("paged decode does not support encoder-decoder "
                         "caches")
    dt = torch_dtype(cfg.dtype)
    n_sb = cfg.num_superblocks
    nkv, hd = cfg.num_kv_heads, cfg.head_dim

    def one(kind):
        if kind == "mamba":
            return _stacked(cfg, mb.init_mamba_cache(cfg, num_slots, device))
        return {kv: torch.zeros((n_sb, num_rows, nkv, hd), dtype=dt,
                                device=device) for kv in ("k", "v")}
    return {f"l{j}": one(kind) for j, kind in enumerate(cfg.layer_pattern)}


def decode_step(cfg: ModelConfig, rt: Runtime, params, cache, tokens, pos,
                pa: Optional[PlanArrays] = None, premat=None, *,
                row_idx=None, page_size=None):
    """One decode token for B sequences.

    tokens: (B, 1) int.  Without ``row_idx`` the cache is the dense one
    (``init_cache``) and ``pos`` is the position every sequence writes, a
    Python int.  With ``row_idx`` (B, max_kv) int32 per-token pool rows
    the cache is the block-paged one (``init_paged_cache``), ``pos`` a (B,)
    int32 tensor of per-sequence write positions, and ``page_size`` the
    pool's page size (the paged decode kernel reads one page per step;
    None, or ``cfg.paged_attn_kernel=False``, gathers the rows instead:
    ``attention.decode_attention_paged``).
    premat: optional (L_moe, 1, K, chunk_len) compute slots
    (``moe.materialize_chunks``).  A mamba sublayer advances its dense
    state of each of the B sequences (in paged mode, of each scheduler
    slot) by one token.  An encoder-decoder's attention sublayer then
    cross-attends to its layer of the cache's ``xk`` / ``xv`` (dense cache
    only).  The cache is updated IN PLACE.  Returns (logits (B, 1, V) f32,
    cache)."""
    if row_idx is not None and cfg.is_encoder_decoder:
        raise ValueError("paged decode does not support encoder-decoder "
                         "models")
    _check_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    x = ly.embed(params["embed"], tokens, dt) * math.sqrt(cfg.d_model)
    moe_pos = _moe_positions(cfg) if cfg.moe.enabled else ()
    if moe_pos:
        assert pa is not None, "MoE arch needs PlanArrays"
    mi = 0
    for sb in range(cfg.num_superblocks):
        p_sb = _block(params, sb)
        for j, kind in enumerate(cfg.layer_pattern):
            p = p_sb[f"l{j}"]
            c_sb = {k: t[sb] for k, t in cache[f"l{j}"].items()}
            h = ly.apply_norm(p["ln1"], x, cfg.norm)
            if kind == "mamba":     # one dense state per sequence or slot
                y, new = mb.mamba_decode_step(p["mamba"], cfg, h, c_sb)
                for k, t in new.items():
                    c_sb[k].copy_(t)                # in place
            elif row_idx is None:
                y, _ = attn.decode_attention(p["attn"], cfg, h, c_sb, pos,
                                             kind=kind)
            else:
                y, _ = attn.decode_attention_paged(
                    p["attn"], cfg, h, c_sb, pos, row_idx, kind=kind,
                    page_size=page_size)
            x = x + y
            if cfg.is_encoder_decoder and kind != "mamba":
                hx = ly.apply_norm(p["lnx"], x, cfg.norm)
                x = x + _cross_decode(p["xattn"], cfg, hx, cache["xk"][sb],
                                      cache["xv"][sb])
            if j in moe_pos:
                h = ly.apply_norm(p["ln2"], x, cfg.norm)
                y, _ = _moe_ffn(cfg, rt, h, params["router"][mi],
                                params["moe_buffer"], pa.layer(mi),
                                premat=None if premat is None
                                else premat[mi])
                x = x + y
                mi += 1
            elif kind != "mamba":
                h = ly.apply_norm(p["ln2"], x, cfg.norm)
                x = x + ly.apply_mlp(p["mlp"], h, cfg.act)
    x = ly.apply_norm(params["final_norm"], x, cfg.norm)
    return ly.unembed(params["embed"], x, cfg.final_logit_softcap), cache
