"""Model assembly: config -> params / forward (training and prefill) /
paged decode.

A model is a stack of ``num_superblocks`` identical superblocks (one tile
of ``cfg.layer_pattern``).  Parameters are stacked along a leading
superblock axis exactly as in the JAX package (``blocks/l{j}/...``), and
the JAX package's ``scan`` over superblocks becomes a Python loop here.
MoE FFNs read from the one cross-layer chunk buffer through
``repro_torch.core.moe``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import init_tree, stack_params, torch_dtype
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import MoERuntime, PlanArrays
from repro_torch.models import attention as attn
from repro_torch.models import layers as ly


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
    if cfg.is_encoder_decoder or not kinds <= {"attn", "local"}:
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only attention models are ported to "
            f"repro_torch so far (layer kinds {sorted(kinds)})")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------
def _sublayer_decl(cfg: ModelConfig, is_moe: bool):
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": ly.norm_params(d),
                         "attn": attn.attn_params(cfg),
                         "ln2": ly.norm_params(d)}
    if not is_moe:
        p["mlp"] = ly.mlp_params(d, cfg.d_ff, cfg.act)
    return p


def param_decls(cfg: ModelConfig, ep: int = 1):
    """Full parameter declaration tree (Param descriptors), the JAX
    package's tree for decoder-only attention models."""
    _check_ported(cfg)
    moe_pos = _moe_positions(cfg) if cfg.moe.enabled else ()
    sb = {f"l{j}": _sublayer_decl(cfg, j in moe_pos)
          for j in range(len(cfg.layer_pattern))}
    decls: Dict[str, Any] = {
        "embed": ly.embed_params(cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings),
        "blocks": stack_params(sb, cfg.num_superblocks),
        "final_norm": ly.norm_params(cfg.d_model),
    }
    if cfg.moe.enabled:
        decls["router"] = moe_core.router_param(cfg)
        decls["moe_buffer"] = moe_core.moe_buffer_param(cfg, ep)
    return decls


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                ep: int = 1):
    """Parameters from a seeded ``torch.Generator`` on ``device``."""
    return init_tree(param_decls(cfg, ep), seed, cfg.param_dtype, device)


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
             premat=None):
    """x: (B, S, D) -> (y, MoEAux): flatten the tokens and run the MoE
    layer over all of them (world size 1: no padding to a device count)."""
    b, s, d = x.shape
    y, aux = moe_core.moe_layer(cfg, rt.moe, x.reshape(b * s, d), wr, buf,
                                pa, premat=premat)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Full-sequence forward (training and prefill)
# ---------------------------------------------------------------------------
def _superblock(cfg: ModelConfig, rt: Runtime, params, sb: int, pa, premat,
                positions, causal: bool, collect_cache: bool, x):
    """One superblock: returns (x, [MoEAux per MoE layer], {l{j}: (k, v)}
    when ``collect_cache``)."""
    moe_pos = _moe_positions(cfg) if cfg.moe.enabled else ()
    p_sb = _block(params, sb)
    aux_list, cache = [], {}
    mi = sb * len(moe_pos)
    for j, kind in enumerate(cfg.layer_pattern):
        p = p_sb[f"l{j}"]
        h = ly.apply_norm(p["ln1"], x, cfg.norm)
        y = attn.attention(p["attn"], cfg, h, positions, kind=kind,
                           causal=causal, use_pallas=rt.use_pallas,
                           return_kv=collect_cache)
        if collect_cache:
            y, cache[f"l{j}"] = y
        x = x + y
        h = ly.apply_norm(p["ln2"], x, cfg.norm)
        if j in moe_pos:
            y, aux = _moe_ffn(cfg, rt, h, params["router"][mi],
                              params["moe_buffer"], pa.layer(mi),
                              premat=None if premat is None else premat[mi])
            aux_list.append(aux)
            mi += 1
        else:
            y = ly.apply_mlp(p["mlp"], h, cfg.act)
        x = x + y
    return x, aux_list, cache


def forward(cfg: ModelConfig, rt: Runtime, params, tokens, *,
            pa: Optional[PlanArrays] = None, positions=None,
            causal: bool = True, collect_cache: bool = False,
            return_hidden: bool = False, premat=None):
    """tokens: (B, S) int -> (logits (B, S, V) f32, aux) — or
    (logits, aux, cache) with ``collect_cache``: the cache holds every
    layer's rotated K/V as ``{"l{j}": {"k", "v"}}`` of shape
    (n_superblocks, B, S, nkv, hd), the JAX package's stacked layout.
    aux: one MoEAux per MoE layer, in layer order.

    ``return_hidden`` returns the final-norm hidden states (B, S, D) in
    place of the logits: the train path computes its loss chunked from
    them and never materializes (B, S, V) logits.  With ``cfg.remat`` and
    grad enabled each superblock runs under ``torch.utils.checkpoint``, at
    the place the JAX package puts its ``jax.checkpoint``: only the
    superblock inputs are kept, and the backward re-runs each block's
    forward (so the forward kernels launch twice per step).

    pa: stacked PlanArrays (L_moe leading dim).  premat: optional
    (L_moe, 1, K, chunk_len) compute slots (``moe.materialize_chunks``)."""
    _check_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    # scaled in the compute dtype, as the JAX package scales
    x = ly.embed(params["embed"], tokens, dt) * math.sqrt(cfg.d_model)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.moe.enabled:
        assert pa is not None, "MoE arch needs PlanArrays"
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    aux_list = []
    caches = {f"l{j}": {"k": [], "v": []}
              for j in range(len(cfg.layer_pattern))}
    for sb in range(cfg.num_superblocks):
        blk = partial(_superblock, cfg, rt, params, sb, pa, premat,
                      positions, causal, collect_cache)
        if remat:
            x, auxs, cache = checkpoint(blk, x, use_reentrant=False)
        else:
            x, auxs, cache = blk(x)
        aux_list.extend(auxs)
        for name, c in cache.items():
            for kv in ("k", "v"):
                caches[name][kv].append(c[kv])
    x = ly.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux_list
    logits = ly.unembed(params["embed"], x, cfg.final_logit_softcap)
    if collect_cache:
        cache = {name: {kv: torch.stack(v) for kv, v in c.items()}
                 for name, c in caches.items()}
        return logits, aux_list, cache
    return logits, aux_list


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------
def init_paged_cache(cfg: ModelConfig, num_slots: int, num_rows: int,
                     device="cuda"):
    """Block-paged decode cache: every attention sublayer owns a flat pool
    of ``num_rows`` token rows, with a leading ``num_superblocks`` axis, as
    in the JAX package (``num_slots`` sizes per-slot state, which only
    recurrent layers have; none is ported yet)."""
    _check_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    n_sb = cfg.num_superblocks
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {f"l{j}": {kv: torch.zeros((n_sb, num_rows, nkv, hd), dtype=dt,
                                      device=device)
                      for kv in ("k", "v")}
            for j in range(len(cfg.layer_pattern))}


def decode_step(cfg: ModelConfig, rt: Runtime, params, cache, tokens, pos,
                pa: Optional[PlanArrays] = None, premat=None, *,
                row_idx=None, page_size=None):
    """One decode token for B independent sequences against the block-paged
    cache (``init_paged_cache``).

    tokens: (B, 1) int; pos: (B,) int32 per-sequence write positions;
    row_idx: (B, max_kv) int32 per-token pool rows; page_size: the pool's
    page size (the paged decode kernel reads one page per step).  The pools
    are updated IN PLACE.  Returns (logits (B, 1, V) f32, cache)."""
    if row_idx is None or page_size is None:
        raise NotImplementedError("the dense-cache decode path is not yet "
                                  "ported to repro_torch; pass row_idx and "
                                  "page_size")
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
            pool = {kv: cache[f"l{j}"][kv][sb] for kv in ("k", "v")}
            h = ly.apply_norm(p["ln1"], x, cfg.norm)
            y, _ = attn.decode_attention_paged(p["attn"], cfg, h, pool, pos,
                                               row_idx, kind=kind,
                                               page_size=page_size)
            x = x + y
            h = ly.apply_norm(p["ln2"], x, cfg.norm)
            if j in moe_pos:
                y, _ = _moe_ffn(cfg, rt, h, params["router"][mi],
                                params["moe_buffer"], pa.layer(mi),
                                premat=None if premat is None
                                else premat[mi])
                mi += 1
            else:
                y = ly.apply_mlp(p["mlp"], h, cfg.act)
            x = x + y
    x = ly.apply_norm(params["final_norm"], x, cfg.norm)
    return ly.unembed(params["embed"], x, cfg.final_logit_softcap), cache
