"""The FSSDP MoE layer at world size 1: gate, sort-based dispatch, grouped
expert FFN on the hand-written kernel, combine.

This is the subset of the JAX package's ``repro/core/moe.py`` that one
device runs.  One flat chunk buffer ``(rows, chunk_len)`` holds every
expert of every MoE layer; a materialization plan maps each layer's
experts to compute slots; ``materialize_chunks`` builds the slots of every
layer in the compute dtype once per (plan, parameter version), and
``moe_layer`` runs the body of the JAX package's ``_moe_body`` with
``me = 0``: the collectives of a one-device mesh are identities, so none
is issued.  ``moe_layer_ref`` — the dense oracle that applies every expert
to every token — is its plain reference.

The layer is differentiable end to end: the dispatch scatter and the
combine gather pass gradients, the grouped FFN carries its own backward
(``kernels.grouped_mlp.GroupedMLPFunction``), and the gradient of the
compute slots flows back into the f32 chunk buffer through the cast.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import Param, torch_dtype
from repro_torch.core.placement import MaterializationPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import act_fn, grouped_mlp_ref


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------
def n_mats(cfg: ModelConfig) -> int:
    return 3 if cfg.act.endswith("_glu") else 2


def chunk_len(cfg: ModelConfig) -> int:
    return n_mats(cfg) * cfg.d_model * cfg.moe.d_ff


def num_moe_layers(cfg: ModelConfig) -> int:
    return sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


def buffer_rows(cfg: ModelConfig, ep: int) -> int:
    """Global rows (padded so every device owns the same count)."""
    per_dev = -(-num_moe_layers(cfg) * cfg.moe.num_experts // ep)
    return per_dev * ep


def moe_buffer_param(cfg: ModelConfig, ep: int) -> Param:
    return Param((buffer_rows(cfg, ep), chunk_len(cfg)),
                 ("expert", "expert_ff"), init="normal")


def router_param(cfg: ModelConfig) -> Param:
    return Param((num_moe_layers(cfg), cfg.d_model, cfg.moe.num_experts),
                 ("layers", None, None), init="scaled")


def unpack_chunks(cfg: ModelConfig, chunks):
    """chunks: (K, chunk_len) -> views (wi, wg|None, wo) of shapes
    (K,d,f), (K,d,f), (K,f,d); each slot's matrices stay contiguous."""
    d, f = cfg.d_model, cfg.moe.d_ff
    wi = chunks[:, :d * f].unflatten(1, (d, f))
    if n_mats(cfg) == 3:
        wg = chunks[:, d * f:2 * d * f].unflatten(1, (d, f))
        wo = chunks[:, 2 * d * f:].unflatten(1, (f, d))
        return wi, wg, wo
    wo = chunks[:, d * f:].unflatten(1, (f, d))
    return wi, None, wo


# ---------------------------------------------------------------------------
# Plan -> tables
# ---------------------------------------------------------------------------
class PlanArrays(NamedTuple):
    """Per-MoE-layer tables (leading dim = L_moe), int32."""
    local_rows: object      # (L, M, k_local)
    local_experts: object   # (L, M, k_local) (-1 pad)
    extra_experts: object   # (L, M, m) (-1 pad)
    ring_send_rows: object  # (L, M, m)
    expert_slot: object     # (L, M, E) (-1 = absent)
    replicas: object        # (L, E, r_max)
    n_replicas: object      # (L, E)
    owner_dev: object       # (L, E)
    owner_row: object       # (L, E)

    def layer(self, i: int) -> "PlanArrays":
        """This layer's slice (leading L dim removed)."""
        return PlanArrays(*[a[i] for a in self])


def plan_tables(plan: MaterializationPlan, r_max: int = 0) -> PlanArrays:
    """Derive every runtime table from the plan, as numpy int32."""
    sh = plan.sharding
    r_max = r_max or max(1, plan.m + 1)
    slot_expert, expert_slot = plan.slot_tables()
    replicas, n_rep = plan.replica_tables(r_max, slot_expert)
    return PlanArrays(
        local_rows=plan.local_rows, local_experts=plan.local_experts,
        extra_experts=plan.extra_experts,
        ring_send_rows=plan.ring_send_rows, expert_slot=expert_slot,
        replicas=replicas, n_replicas=n_rep,
        owner_dev=sh.owner_dev, owner_row=sh.owner_row)


def tables_to_device(tables: PlanArrays, device) -> PlanArrays:
    return PlanArrays(*[torch.as_tensor(np.asarray(a, np.int32),
                                        device=device) for a in tables])


def plan_to_arrays(plan: MaterializationPlan, device, r_max: int = 0):
    return tables_to_device(plan_tables(plan, r_max), device)


@dataclasses.dataclass
class MoERuntime:
    """Context of the MoE layer: the JAX package's ``MoERuntime`` at world
    size 1 (no mesh, the ``ep`` plan).  ``use_pallas`` runs the grouped
    expert FFN through ``kernels.ops`` (the CUDA kernels for CUDA tensors);
    the port defaults it on, where the JAX package defaults it off."""
    use_pallas: bool = True


class MoEAux(NamedTuple):
    counts: torch.Tensor         # (E,) f32 token counts this layer
    aux_loss: torch.Tensor       # scalar load-balance loss
    z_loss: torch.Tensor         # scalar router z-loss
    dropped_frac: torch.Tensor   # scalar fraction of (token,k) dropped
    device_loads: torch.Tensor   # (M,) real tokens processed per device
    pad_frac: torch.Tensor       # scalar fraction of padding rows


# ---------------------------------------------------------------------------
# Gate (GShard top-k)
# ---------------------------------------------------------------------------
def gate(cfg: ModelConfig, wr, x, valid):
    """x: (T, D); valid: (T,) bool.  Returns (idx:(T,k), vals:(T,k) f32,
    counts:(E,), aux_loss, z_loss).

    Top-k is a stable descending sort, so exact ties go to the lower expert
    index as ``jax.lax.top_k`` gives them (``torch.topk`` promises no tie
    order on CUDA)."""
    k = cfg.moe.experts_per_token
    e = cfg.moe.num_experts
    logits = x.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = srt[:, :k], order[:, :k]
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    vals = vals * valid[:, None]
    # per-expert counts by scatter-add; invalid entries land in an overflow
    # bucket that is sliced off
    cell = torch.where(valid[:, None], idx, torch.full_like(idx, e))
    counts = torch.zeros(e + 1, dtype=torch.float32, device=x.device)
    counts.index_add_(0, cell.reshape(-1),
                      torch.ones(cell.numel(), device=x.device))
    counts = counts[:e]
    prob_sum = (probs * valid[:, None]).sum(0)
    n_valid = valid.sum().float().clamp_min(1.0)
    # the load fraction is a constant of the loss, as the JAX package's
    # stop_gradient makes it
    frac = (counts / counts.sum().clamp_min(1.0)).detach()
    aux = e * torch.sum(frac * (prob_sum / n_valid))
    z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2 * valid) / n_valid
    return idx, vals, counts, aux, z


# ---------------------------------------------------------------------------
# Sort-based dispatch primitives
# ---------------------------------------------------------------------------
def segment_ranks(keys):
    """rank[i] = |{j < i : keys[j] == keys[i]}| from one stable argsort."""
    n = keys.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    is_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_start[1:] = sk[1:] != sk[:-1]
    seg_start = torch.cummax(torch.where(is_start, iota,
                                         torch.zeros_like(iota)), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=keys.device)
    rank[order] = iota - seg_start
    return rank.to(torch.int32)


def replica_dispatch(e_safe, valid, expert_slot, replicas, n_replicas, me,
                     K: int, capacity: int, local_first: bool):
    """Sort-based §4.4 dispatch: destinations, cell positions, keep mask and
    per-cell kept counts from ONE stable argsort of the flat assignments
    (see the JAX package's ``replica_dispatch``).

    e_safe: (N,) expert per flat (token, k) entry (>= 0); valid: (N,) bool.
    expert_slot: (M, E); replicas: (E, r_max); n_replicas: (E,).
    Returns (dest, slot, pos, keep, counts) with counts (M, K) int32."""
    M, E = expert_slot.shape
    e_safe = e_safe.long()
    my_slot = expert_slot[me][e_safe]
    rank = segment_ranks(torch.where(valid, e_safe,
                                     torch.full_like(e_safe, E))).long()
    n_rep = n_replicas[e_safe].long().clamp(1, replicas.shape[-1])
    rr = (rank + me) % n_rep
    dest_rr = replicas[e_safe, rr].long()
    if local_first:
        dest = torch.where(my_slot >= 0, torch.full_like(dest_rr, me),
                           dest_rr)
        cycle = torch.where(my_slot >= 0, torch.ones_like(n_rep), n_rep)
    else:
        dest, cycle = dest_rr, n_rep
    slot = expert_slot[dest, e_safe].long()
    pos = rank // cycle
    keep = valid & (pos < capacity) & (slot >= 0)
    cell = torch.where(keep, dest * K + slot,
                       torch.full_like(dest, M * K))   # overflow bucket
    counts = torch.zeros(M * K + 1, dtype=torch.int32, device=dest.device)
    counts.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    return dest, slot, pos, keep, counts[:M * K].reshape(M, K)


# ---------------------------------------------------------------------------
# Expert compute over K slots
# ---------------------------------------------------------------------------
def _expert_ffn(cfg: ModelConfig, chunks, xr, use_pallas: bool,
                group_sizes=None, row_valid=None):
    """chunks: (K, chunk_len); xr: (K, T, D). Returns (K, T, D).  With
    ``use_pallas`` the grouped FFN goes through ``kernels.ops`` (the CUDA
    kernel for CUDA tensors), else through its plain version."""
    wi, wg, wo = unpack_chunks(cfg, chunks)
    dt = xr.dtype
    wi, wo = wi.to(dt), wo.to(dt)
    wg = None if wg is None else wg.to(dt)
    if use_pallas:
        return kops.grouped_mlp(xr, wi, wg, wo, group_sizes, row_valid,
                                act=cfg.act)
    return grouped_mlp_ref(xr, wi, wg, wo, act=cfg.act,
                           group_sizes=group_sizes, row_valid=row_valid)


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------
def _layer_slots(buf, pa_l: PlanArrays, dtype):
    """One layer's (K, chunk_len) compute slots at world size 1: the owned
    rows ``buf[local_rows]``, zeroed where no expert sits, in ``dtype``."""
    rows = pa_l.local_rows[0].long()
    used = (pa_l.local_experts[0] >= 0)[:, None]
    return buf[rows].to(dtype) * used.to(dtype)


def materialize_chunks(cfg: ModelConfig, buf, pa: PlanArrays, dtype=None):
    """Every MoE layer's compute slots: (L, 1, K, chunk_len) in the compute
    dtype (the world-size-1 SparseAllGather: local rows only, no
    collective).  Built layer by layer, so the transient f32 copy is one
    layer's."""
    dt = torch_dtype(dtype or cfg.dtype)
    L = pa.local_rows.shape[0]
    k = pa.local_rows.shape[-1]
    out = torch.empty((L, 1, k, buf.shape[1]), dtype=dt, device=buf.device)
    for l in range(L):
        out[l, 0] = _layer_slots(buf, pa.layer(l), dt)
    return out


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------
def moe_layer(cfg: ModelConfig, rt, x, wr, buf, pa: PlanArrays, valid=None,
              premat=None):
    """The FSSDP MoE layer at world size 1.

    x: (T, D) tokens; wr: (D, E) this layer's router; buf: the flat chunk
    buffer (rows, chunk_len); pa: this layer's PlanArrays slice; premat:
    optional (1, K, chunk_len) compute slots from ``materialize_chunks``
    (else this layer's slots are built from ``buf``).  ``rt``: a
    ``MoERuntime`` (only ``use_pallas`` is read).  Returns
    (y: (T, D), MoEAux).

    Gate, then the sort-based dispatch with ``me = 0`` into a (K, C, D)
    buffer, the grouped FFN with per-slot group sizes (kernel B1), and the
    combine weighted by the gate values — the ``ep`` branch of the JAX
    package's ``_moe_body`` with the all_to_alls of a one-device mesh
    (identities) left out.  The capacity C is the number of tokens in the
    call: a token's top-k experts are distinct, so every expert can take
    each of its tokens, nothing is dropped — prompt-bucket padding tokens
    cannot crowd out real ones — and the layer computes the same function
    as ``moe_layer_ref``, the dense oracle the mesh-less JAX layer serves
    with, at k/E of its expert FLOPs."""
    T, D = x.shape
    if valid is None:
        valid = torch.ones(T, dtype=torch.bool, device=x.device)
    if pa.local_rows.shape[0] != 1:
        raise NotImplementedError("repro_torch runs the MoE layer at world "
                                  "size 1 only")
    chunks = premat[0] if premat is not None else _layer_slots(buf, pa,
                                                               x.dtype)
    K = chunks.shape[0]
    idx, vals, counts, aux, z = gate(cfg, wr, x, valid)
    k = idx.shape[1]
    e_flat = idx.reshape(-1)
    w_flat = vals.reshape(-1)
    valid_w = w_flat > 0
    e_safe = e_flat.clamp_min(0)
    capacity = T
    dest, slot, pos, keep, send_cnt = replica_dispatch(
        e_safe, valid_w, pa.expert_slot, pa.replicas, pa.n_replicas, 0, K,
        capacity, local_first=True)
    dropped = 1.0 - keep.sum() / valid_w.sum().clamp_min(1)
    tok = torch.arange(T * k, device=x.device) // k
    # out-of-capacity entries are dropped by masking them out first: an
    # index_put_ has no drop mode
    buf_x = torch.zeros((K, capacity, D), dtype=x.dtype, device=x.device)
    buf_x[slot[keep], pos[keep]] = x[tok[keep]]
    # kept entries fill a position prefix of each slot: the kept counts are
    # the group sizes
    gs = send_cnt[0]
    yr = _expert_ffn(cfg, chunks, buf_x, rt.use_pallas, group_sizes=gs)
    got = yr[slot.clamp(0, K - 1), pos.clamp(0, capacity - 1)] \
        * keep[:, None].to(x.dtype)
    y = (got.reshape(T, k, D) * vals.reshape(T, k, 1).to(x.dtype)).sum(1)
    dev_loads = send_cnt.sum(1).float()
    pad_frac = 1.0 - dev_loads.sum() / float(K * capacity)
    return y, MoEAux(counts, aux, z, dropped, dev_loads, pad_frac)


# ---------------------------------------------------------------------------
# Single-device reference (oracle)
# ---------------------------------------------------------------------------
def moe_layer_ref(cfg: ModelConfig, x, idx, vals, buf, pa: PlanArrays):
    """Dense-compute oracle: every expert applied to every token, combined
    with the top-k weights; ``buf`` is the (rows, chunk_len) buffer and
    expert e's chunk sits at row ``owner_row[e]`` (world size 1)."""
    e_count = cfg.moe.num_experts
    chunks = buf[pa.owner_row.long()]                  # (E, chunk_len)
    wi, wg, wo = unpack_chunks(cfg, chunks)
    dt = x.dtype
    h = torch.einsum("td,edf->etf", x, wi.to(dt))
    if wg is not None:
        h = act_fn(cfg.act)(h) * torch.einsum("td,edf->etf", x, wg.to(dt))
    else:
        h = act_fn("gelu")(h)
    y_all = torch.einsum("etf,efd->etd", h, wo.to(dt))  # (E, T, D)
    comb = torch.zeros((x.shape[0], e_count), dtype=torch.float32,
                       device=x.device)
    comb.scatter_add_(1, idx.long(), vals.float())
    y = torch.einsum("te,etd->td", comb.to(dt), y_all)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)
