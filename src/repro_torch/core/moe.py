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

Across the ranks of a process grid (``_moe_layer_grid``) the slots come
from the SparseAllGather, whose backward is the hand-written
SparseReduceScatter.  ``materialize_layer`` issues one layer's gather
without waiting for it (on CUDA from the grid's own stream) so the model
can run it one layer ahead of its consumer; ``materialize_stack`` issues
every layer's at once (step-level hoisting); ``moe_layer_regather`` and
``moe_layer_regather_pipelined`` are the layer of the ``gather`` remat
mode, which keeps no slots and re-gathers them in the backward.  An event
log (``enable_event_log``) records the order of gathers, grouped FFNs and
SparseReduceScatters for the tests of those schedules.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

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


def shard_buffer(buf, grid):
    """This rank's shard of the global (rows, chunk_len) buffer: rows over
    the EP (model) index, columns over the FSDP (data) index, as the JAX
    package lays the buffer out (``P("model", "data")``).  A copy."""
    rows = buf.shape[0] // grid.model
    cols = buf.shape[1] // grid.data
    if rows * grid.model != buf.shape[0] or cols * grid.data != buf.shape[1]:
        raise ValueError(f"buffer {tuple(buf.shape)} does not split over a "
                         f"{grid.data} x {grid.model} grid")
    return buf[grid.e * rows:(grid.e + 1) * rows,
               grid.d * cols:(grid.d + 1) * cols].clone()


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
    """Context of the MoE layer, the JAX package's ``MoERuntime``.

    Without a ``grid`` the layer runs at world size 1 (no collective, the
    ``ep`` plan).  With a ``launch.mesh.ProcessGrid`` it runs the FSSDP
    layer across the grid's ranks: ``impl`` (``ring`` | ``a2a`` |
    ``dense`` | ``none`` for the ``ep`` plan) picks the SparseAllGather,
    ``capacity`` the tokens per (source, slot) cell (0 = ``auto_capacity``)
    and ``local_first`` the §4.4 dispatch rule.  The JAX runtime's ``m``
    and ``r_max`` must equal the plan's; here the layer reads them from
    the plan's tables.  ``use_pallas`` runs the grouped expert FFN through
    ``kernels.ops`` (the CUDA kernels for CUDA tensors); the port defaults
    it on, where the JAX package defaults it off."""
    use_pallas: bool = True
    grid: Any = None
    impl: str = "ring"
    capacity: int = 0
    local_first: bool = True


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
def gate(cfg: ModelConfig, wr, x, valid, group=None):
    """x: (T, D); valid: (T,) bool.  Returns (idx:(T,k), vals:(T,k) f32,
    counts:(E,), aux_loss, z_loss).

    Top-k is a stable descending sort, so exact ties go to the lower expert
    index as ``jax.lax.top_k`` gives them (``torch.topk`` promises no tie
    order on CUDA).  With a process ``group`` (the distributed layer) the
    statistics are summed over its ranks in one all-reduce, as the JAX
    layer's ``psum``: every rank then holds the global counts, aux and z
    losses."""
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
    n_valid = valid.sum().float()
    z_sum = torch.sum(torch.logsumexp(logits, dim=-1) ** 2 * valid)
    if group is not None:
        stats = _SumOverRanks.apply(torch.cat(
            [counts, prob_sum, n_valid[None], z_sum[None]]), group)
        counts, prob_sum = stats[:e].detach(), stats[e:2 * e]
        n_valid, z_sum = stats[2 * e].detach(), stats[2 * e + 1]
    n_valid = n_valid.clamp_min(1.0)
    # the load fraction is a constant of the loss, as the JAX package's
    # stop_gradient makes it
    frac = (counts / counts.sum().clamp_min(1.0)).detach()
    aux = e * torch.sum(frac * (prob_sum / n_valid))
    z = z_sum / n_valid
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
                group_sizes=None, row_valid=None, layer: int = -1,
                train: bool = False):
    """chunks: (K, chunk_len); xr: (K, T, D). Returns (K, T, D).  With
    ``use_pallas`` the grouped FFN goes through ``kernels.ops`` (the CUDA
    kernel for CUDA tensors; ``train``: its training form even without
    grad), else through its plain version.  With the event log on, the
    call logs ``ffn``, and its backward logs ``ffn_bwd`` just before its
    dgrad and wgrad and ``ffn_bwd_end`` after them."""
    wi, wg, wo = unpack_chunks(cfg, chunks)
    dt = xr.dtype
    wi, wo = wi.to(dt), wo.to(dt)
    wg = None if wg is None else wg.to(dt)
    logged = _EVENTS is not None
    if logged:
        _event("ffn", layer)
        if xr.requires_grad:
            xr = _Mark.apply(xr, "ffn_bwd_end", layer)
    if use_pallas:
        y = kops.grouped_mlp(xr, wi, wg, wo, group_sizes, row_valid,
                             act=cfg.act, train=train)
    else:
        y = grouped_mlp_ref(xr, wi, wg, wo, act=cfg.act,
                            group_sizes=group_sizes, row_valid=row_valid)
    if logged and y.requires_grad:
        y = _Mark.apply(y, "ffn_bwd", layer)
    return y


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
    collective), the values of ``_layer_slots``.  Built one slot at a time,
    so the transient f32 copy is one buffer row (a layer's rows in f32 are
    11 GB at Jamba's widths, which would not fit beside its weights).
    Tables of more than one rank are refused: on a process grid each rank
    holds its own shard, and its slots come from ``materialize_stack``."""
    if pa.local_rows.shape[1] != 1:
        raise ValueError(f"materialize_chunks builds the slots of world size "
                         f"1; these tables are {pa.local_rows.shape[1]} "
                         f"ranks': use materialize_stack on the grid")
    dt = torch_dtype(dtype or cfg.dtype)
    L = pa.local_rows.shape[0]
    k = pa.local_rows.shape[-1]
    out = torch.empty((L, 1, k, buf.shape[1]), dtype=dt, device=buf.device)
    for l in range(L):
        rows = pa.local_rows[l, 0].long()
        for i in range(k):
            out[l, 0, i].copy_(buf.index_select(0, rows[i:i + 1])[0])
        out[l, 0].mul_((pa.local_experts[l, 0] >= 0)[:, None].to(dt))
    return out


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------
def moe_layer(cfg: ModelConfig, rt, x, wr, buf, pa: PlanArrays, valid=None,
              premat=None, layer: int = -1):
    """The FSSDP MoE layer at world size 1.

    x: (T, D) tokens; wr: (D, E) this layer's router; buf: the flat chunk
    buffer (rows, chunk_len); pa: this layer's PlanArrays slice; premat:
    optional (1, K, chunk_len) compute slots from ``materialize_chunks``
    (else this layer's slots are built from ``buf``).  ``rt``: a
    ``MoERuntime`` (only ``use_pallas`` is read).  ``layer``: the MoE
    layer's index, which only the event log reads.  Returns
    (y: (T, D), MoEAux).  On a process grid (``rt.grid``) the layer is
    ``_moe_layer_grid``, and ``premat`` may also be a ``Slots`` handle of
    ``materialize_layer`` still in flight.

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
    if getattr(rt, "grid", None) is not None:
        return _moe_layer_grid(cfg, rt, x, wr, buf, pa, valid, premat, layer)
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
    yr = _expert_ffn(cfg, chunks, buf_x, rt.use_pallas, group_sizes=gs,
                     layer=layer)
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


# ---------------------------------------------------------------------------
# The FSSDP layer across ranks
# ---------------------------------------------------------------------------
# Every collective the layer issues, by kind: [calls, bytes this rank sent to
# other ranks].  The forward's kinds are the SparseAllGather's ``spag_ring``
# (one single hop), ``spag_a2a``, ``spag_dense`` and ``spag_fsdp``, the
# token all-to-alls ``tokens_out`` and ``tokens_back``, the kept-count
# all-to-all ``counts`` and the statistics all-reduces ``gate_stats`` and
# ``dev_loads``; the SparseReduceScatter's are ``sprs_*``, the token
# all-to-alls' backward ``*_bwd``.
_COLLECTIVES: dict = {}


def collective_counts() -> dict:
    """{kind: {"calls": n, "bytes": b}} since the last reset."""
    return {k: {"calls": v[0], "bytes": v[1]}
            for k, v in _COLLECTIVES.items()}


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


# The event log: (kind, MoE layer, "fwd" | "bwd") in issue order, off
# unless ``enable_event_log`` turned it on.  Kinds: ``spag`` (one layer's
# SparseAllGather issued), ``sprs`` (one layer's SparseReduceScatter),
# ``ffn`` (a grouped-FFN forward: the layer's, or its recompute in the
# backward), ``ffn_bwd`` and ``ffn_bwd_end`` (just before and just after
# the grouped FFN's dgrad and wgrad).  A record is "bwd" when autograd's
# backward pass is running, recomputes included.
_EVENTS: Optional[list] = None


def enable_event_log(on: bool = True) -> None:
    """Start (with an empty log) or stop the event log."""
    global _EVENTS
    _EVENTS = [] if on else None


def event_log() -> list:
    return list(_EVENTS or [])


def reset_event_log() -> None:
    if _EVENTS is not None:
        _EVENTS.clear()


def _event(kind: str, layer: int) -> None:
    if _EVENTS is not None:
        bwd = torch._C._current_graph_task_id() >= 0
        _EVENTS.append((kind, layer, "bwd" if bwd else "fwd"))


class _Mark(torch.autograd.Function):
    """The identity; its backward logs ``(kind, layer)`` to the event
    log."""

    @staticmethod
    def forward(ctx, x, kind, layer):
        ctx.tag = (kind, layer)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _event(*ctx.tag)
        return g, None, None


def _record(kind: str, nbytes: float) -> None:
    c = _COLLECTIVES.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _hop(t, send_to: int, recv_from: int, grid, kind: str):
    """One single-hop exchange of the ring: send ``t`` to global rank
    ``send_to`` and receive a tensor like it from ``recv_from``.  A ring
    offset that lands on this rank (``j + 1`` a multiple of the ring size)
    moves nothing: the hop is the identity, as a ``ppermute`` onto itself."""
    if send_to == grid.rank:
        _record(kind, 0)
        return t.clone()
    t = t.contiguous()
    out = torch.empty_like(t)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, send_to, grid.ep_group),
            dist.P2POp(dist.irecv, out, recv_from, grid.ep_group)]):
        w.wait()
    _record(kind, _nbytes(t))
    return out


def _a2a(x, group, kind: str):
    """Equal-split all-to-all over dim 0 of ``x`` (one block per rank)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    g = dist.get_world_size(group)
    _record(kind, _nbytes(x) * (g - 1) // g)
    return out


def _all_gather(x, group, kind: str):
    """Concatenation of every rank's 2-D ``x`` along dim 0, in rank
    order."""
    g = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((g * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    _record(kind, _nbytes(x) * (g - 1))
    return out


def _reduce_scatter(x, group, kind: str, dim: int):
    """The transpose of an all-gather along ``dim``: sum over ranks, this
    rank's block of ``dim``."""
    g = dist.get_world_size(group)
    if dim == 1:
        x = x.contiguous().view(x.shape[0], g, x.shape[1] // g).movedim(1, 0)
        x = x.reshape(-1, x.shape[-1])
    x = x.contiguous()
    out = torch.empty((x.shape[0] // g,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    _record(kind, _nbytes(x) * (g - 1) // g)
    return out


def _all_reduce(x, group, kind: str):
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    g = dist.get_world_size(group)
    _record(kind, 2 * _nbytes(x) * (g - 1) // g)
    return x


class _SumOverRanks(torch.autograd.Function):
    """Sum over the ranks of ``group`` (an all-reduce); the backward is the
    identity.  Each rank adds the summed statistic to its share of the
    loss once, and the gradients of replicated parameters are summed over
    the ranks afterwards, so the identity gives the gradient of the global
    loss.  It is what JAX's transpose of the gate's ``psum`` gives on the
    mesh: the router's gradient through the aux and z losses equals the
    mesh-less one."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "gate_stats")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """The token all-to-all; its backward is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return _a2a(x, group, kind)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.kind + "_bwd"), None, None


def _mask_col(mask, dtype):
    return mask[:, None].to(dtype)


def _spag_ep(buf, pa, grid, impl: str, dt, rows_per=None):
    """The EP half of one layer's SparseAllGather on this rank: the f32
    shard ``buf`` (rows_local, chunk_loc) -> this rank's column shard
    (K, chunk_loc) of the compute slots in ``dt``.  The rows are taken,
    then cast, so only they are converted, and every collective moves the
    compute dtype.  The owned slots are a take of the local rows,
    ``rows_per`` rows at a time (default: all at once), which bounds the
    transient f32 copy; the m extra slots come over the EP group (ring,
    a2a or dense).  The FSDP half (``_spag_issue``) all-gathers the column
    shards."""
    M, me, ranks = grid.model, grid.e, grid.ep_ranks
    m = pa.extra_experts.shape[-1]
    rows, own = pa.local_rows[me].long(), pa.local_experts[me] >= 0
    n = rows_per or max(rows.shape[0], 1)
    slots = [buf[rows[i:i + n]].to(dt) * _mask_col(own[i:i + n], dt)
             for i in range(0, rows.shape[0], n)]
    my_e = pa.extra_experts[me].long()
    if impl == "ring" and m:
        send = buf[pa.ring_send_rows[me].long()].to(dt)        # (m, chunk)
        got = torch.stack([_hop(send[j], ranks[(me - j - 1) % M],
                                ranks[(me + j + 1) % M], grid, "spag_ring")
                           for j in range(m)])
        slots.append(got * _mask_col(my_e >= 0, dt))
    elif impl == "a2a" and m:
        wanted = pa.extra_experts.long()                       # (M, m)
        wc = wanted.clamp_min(0)
        is_mine = (pa.owner_dev[wc] == me) & (wanted >= 0)
        rows = pa.owner_row[wc].long()
        send = buf[rows.reshape(-1)].to(dt).view(M, m, buf.shape[1]) \
            * is_mine[..., None].to(dt)
        recv = _a2a(send, grid.ep_group, "spag_a2a")           # (M, m, chunk)
        src = pa.owner_dev[my_e.clamp_min(0)].long()
        got = recv[src, torch.arange(m, device=buf.device)]
        slots.append(got * _mask_col(my_e >= 0, dt))
    elif impl == "dense":
        # the FSDP baseline moves every row: the whole shard, cast
        allbuf = _all_gather(buf.to(dt), grid.ep_group, "spag_dense")
        ec = my_e.clamp_min(0)
        grow = pa.owner_dev[ec].long() * buf.shape[0] \
            + pa.owner_row[ec].long()
        slots.append(allbuf[grow] * _mask_col(my_e >= 0, dt))
    return torch.cat(slots)                                    # (K, chunk_loc)


@contextlib.contextmanager
def _comm_stream(grid, device):
    """On CUDA, run the block on the grid's comm stream, after the work
    queued so far on the current stream (the buffer it reads is up to
    date).  Elsewhere, a no-op."""
    if device.type != "cuda":
        yield
        return
    if grid.comm_stream is None:
        grid.comm_stream = torch.cuda.Stream(device)
    grid.comm_stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(grid.comm_stream):
        yield


class _Pending:
    """Collectives in flight and the tensors they touch.  ``wait`` makes
    the caller's CUDA stream (or, on the CPU, the caller) wait for the
    works, and marks the tensors as used by that stream, so the comm
    stream's allocator takes their memory back only after it."""

    def __init__(self, works, keep):
        self.works, self.keep = list(works), list(keep)

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        if self.keep and self.keep[0].is_cuda:
            cur = torch.cuda.current_stream(self.keep[0].device)
            for t in self.keep:
                t.record_stream(cur)
        self.works, self.keep = [], []


def _spag_issue(buf, pa, grid, impl: str, dt, out=None, rows_per=None):
    """Issue one layer's SparseAllGather on this rank and return
    ``(gathered, pending)``: the (g·K, chunk_loc) tensor that the FSDP
    all-gather writes, the column shards of the g ranks of the FSDP group
    one after the other, and the ``_Pending`` to wait before reading it
    (``Slots`` turns it into the (K, chunk_len) compute slots).

    Everything is issued from the grid's comm stream on CUDA: the EP half
    waits its collectives there (the host and the compute stream do not
    wait), and the FSDP half's ``all_gather_into_tensor`` is issued with
    ``async_op=True``.  ``out``: a (K, chunk_len) tensor to gather into
    when the FSDP group is one rank (then the two layouts are one).  On
    the CPU (gloo) the EP half's collectives are waited by the host
    before the FSDP half, which stays in flight until ``wait``.
    ``rows_per``: ``_spag_ep``'s."""
    with _comm_stream(grid, buf.device):
        chunks = _spag_ep(buf, pa, grid, impl, dt, rows_per)
        k_, c = chunks.shape
        g = dist.get_world_size(grid.fsdp_group)
        flat = out.view(k_, c) if out is not None and g == 1 \
            else chunks.new_empty((g * k_, c))
        work = dist.all_gather_into_tensor(flat, chunks,
                                           group=grid.fsdp_group,
                                           async_op=True)
        _record("spag_fsdp", _nbytes(chunks) * (g - 1))
    return flat, _Pending([work], [chunks, flat])


def _sprs(ct, pa, grid, impl: str, rows_local: int, layer: int = -1,
          into=None):
    """SparseReduceScatter, the transpose of the SparseAllGather
    (``_spag_issue``), written out: the
    (K, chunk_len) slot cotangent, or (g, K, chunk_loc) in the FSDP
    all-gather's layout, -> the f32 gradient of this rank's
    (rows_local, chunk_loc) buffer shard.  The FSDP group reduce-scatters
    the columns (in f32), the EP group sends each extra slot's cotangent
    back to the rank it came from, and the cotangents land on the owner's
    rows.  Every sum runs in a fixed order, with no atomics: the
    collectives', then one accumulation per ring round or per destination,
    each a sorted ``index_put_(accumulate=True)`` (a slot with no expert
    adds its zero cotangent to some row) or an ``index_add_`` onto one
    row.  The gradient is a tensor of its own, not a view, so autograd
    sums the layers' gradients in place.  ``into``: a gradient to add this
    layer's to instead (its rows are other layers', and a slot with no
    expert adds zeros, so the sum is the same bits)."""
    _event("sprs", layer)
    M, me, ranks = grid.model, grid.e, grid.ep_ranks
    kl = pa.local_rows.shape[-1]
    m = pa.extra_experts.shape[-1]
    if ct.dim() == 3:           # (g, K, chunk_loc): the gather's own layout
        ct = _reduce_scatter(ct.float().reshape(-1, ct.shape[-1]),
                             grid.fsdp_group, "sprs_fsdp", 0)
    else:
        ct = _reduce_scatter(ct.float(), grid.fsdp_group, "sprs_fsdp", 1)
    c = ct.shape[1]
    g = ct.new_zeros((rows_local, c)) if into is None else into
    own = pa.local_experts[me] >= 0
    g.index_put_((pa.local_rows[me].long(),), ct[:kl] * _mask_col(own, ct.dtype),
                 accumulate=True)
    my_e = pa.extra_experts[me].long()
    ct_x = ct[kl:] * _mask_col(my_e >= 0, ct.dtype)               # (m, chunk)
    if impl == "ring" and m:
        sent = pa.ring_send_rows[me].long()
        for j in range(m):                    # the reverse hop of round j
            back = _hop(ct_x[j], ranks[(me + j + 1) % M],
                        ranks[(me - j - 1) % M], grid, "sprs_ring")
            g.index_add_(0, sent[j:j + 1], back[None])
    elif impl == "a2a" and m:
        wanted = pa.extra_experts.long()
        wc = wanted.clamp_min(0)
        is_mine = (pa.owner_dev[wc] == me) & (wanted >= 0)
        rows = pa.owner_row[wc].long()
        src = pa.owner_dev[my_e.clamp_min(0)].long()
        ct_recv = ct.new_zeros((M, m, c))
        ct_recv[src, torch.arange(m, device=ct.device)] = ct_x
        back = _a2a(ct_recv, grid.ep_group, "sprs_a2a") \
            * is_mine[..., None].to(ct.dtype)
        for t in range(M):                    # one destination at a time
            g.index_put_((rows[t],), back[t], accumulate=True)
    elif impl == "dense":
        ec = my_e.clamp_min(0)
        grow = pa.owner_dev[ec].long() * rows_local + pa.owner_row[ec].long()
        ct_all = ct.new_zeros((M * rows_local, c))
        ct_all.index_put_((grow,), ct_x, accumulate=True)
        g += _reduce_scatter(ct_all, grid.ep_group, "sprs_dense", 0)
    return g


class SparseAllGather(torch.autograd.Function):
    """``apply(buf, pa, grid, impl, dtype, layer, box)``: this rank's f32
    buffer shard (rows_local, chunk_loc) -> one layer's (g·K, chunk_loc)
    gathered column shards in ``dtype``, issued asynchronously
    (``_spag_issue``): the ``_Pending`` to wait before reading them is
    appended to the list ``box``.  The backward is the hand-written
    SparseReduceScatter (``_sprs``), whose gradient lands in f32 on the
    owner's rows."""

    @staticmethod
    def forward(ctx, buf, pa, grid, impl, dtype, layer, box):
        ctx.meta = (pa, grid, impl, buf.shape[0], buf.dtype, layer)
        raw, pending = _spag_issue(buf, pa, grid, impl, dtype)
        box.append(pending)
        return raw

    @staticmethod
    def backward(ctx, ct):
        pa, grid, impl, rows, dtype, layer = ctx.meta
        ct = ct.view(grid.data, -1, ct.shape[-1])
        return (_sprs(ct, pa, grid, impl, rows, layer).to(dtype),) \
            + (None,) * 6


class Slots:
    """One layer's compute slots in flight (``materialize_layer``):
    ``wait()`` returns them, (1, K, chunk_len), once their collectives
    have landed.  The consumer waits there and nowhere before.  The
    gathered (g·K, chunk_loc) column shards become the slots' columns
    there, on the consumer's stream (a view when g is 1)."""

    def __init__(self, raw, pending, g: int):
        self._slots, self._pending, self._g = raw, pending, g

    def wait(self):
        if self._pending is not None:
            self._pending.wait()
            self._pending = None
            g, c = self._g, self._slots.shape[1]
            self._slots = self._slots.view(g, -1, c).movedim(0, 1) \
                .reshape(1, -1, g * c)
        return self._slots


def _slots_of(premat):
    """A layer's (1, K, chunk_len) slots from a tensor or a ``Slots``."""
    return premat.wait() if isinstance(premat, Slots) else premat


def materialize_layer(cfg: ModelConfig, rt: MoERuntime, buf,
                      pa_l: PlanArrays, dtype=None, layer: int = -1):
    """One layer's SparseAllGather on this rank of ``rt.grid``, issued
    and not waited: a ``Slots`` whose ``wait()`` gives the (1, K,
    chunk_len) compute slots in ``dtype`` (default ``cfg.dtype``).  The
    pipelined forward issues layer l+1's before layer l's consumer, and
    the backward re-gather pipeline layer l-1's before layer l's
    recompute.  When ``buf`` requires grad (and grad is on) the slots
    carry the SparseReduceScatter back to it; a detached ``buf`` gives
    slots without a gradient."""
    dt = torch_dtype(dtype or cfg.dtype)
    _event("spag", layer)
    if torch.is_grad_enabled() and buf.requires_grad:
        box = []
        raw = SparseAllGather.apply(buf, pa_l, rt.grid, rt.impl, dt, layer,
                                    box)
        return Slots(raw, box[0], rt.grid.data)
    return Slots(*_spag_issue(buf, pa_l, rt.grid, rt.impl, dt), rt.grid.data)


def sparse_reduce_scatter_stack(ct, pa: PlanArrays, grid, impl: str,
                                rows_local: int):
    """The transpose of ``materialize_stack``: the (L, 1, K, chunk_len)
    slot cotangent -> the f32 gradient of this rank's buffer shard, one
    ``_sprs`` per layer in layer order, all landing in one tensor."""
    g = None
    for l in range(ct.shape[0]):
        g = _sprs(ct[l, 0], pa.layer(l), grid, impl, rows_local, l, into=g)
    return g


def materialize_stack(cfg: ModelConfig, rt: MoERuntime, buf,
                      pa: PlanArrays, dtype=None, rows_per=None):
    """Every MoE layer's SparseAllGather on this rank of ``rt.grid`` in one
    call: (L, 1, K, chunk_len) compute slots in ``dtype``, with no
    gradient.  All L gathers are issued before any is waited.  It is
    linear in ``buf``, and ``sparse_reduce_scatter_stack`` is its
    transpose.  The train step builds the slots once per step with it,
    every microbatch consumes them (``forward(premat=)``), and the summed
    slot cotangent goes through the transpose once; the serving engine on
    a grid builds its slot cache with it, one owned row at a time
    (``rows_per=1``, as ``materialize_chunks`` builds them).  A build
    issues L·m ring hops (``impl="ring"``) and L FSDP all-gathers."""
    dt = torch_dtype(dtype or cfg.dtype)
    grid = rt.grid
    L = pa.local_rows.shape[0]
    K = pa.local_rows.shape[-1] + pa.extra_experts.shape[-1]
    out = buf.new_empty((L, 1, K, buf.shape[1] * grid.data), dtype=dt)
    slots = []
    with torch.no_grad():
        for l in range(L):
            _event("spag", l)
            slots.append(Slots(*_spag_issue(buf, pa.layer(l), grid,
                                            rt.impl, dt, out=out[l, 0],
                                            rows_per=rows_per),
                               grid.data))
        for l, s in enumerate(slots):
            got = s.wait()
            if grid.data > 1:           # else gathered in place
                out[l].copy_(got)
    return out


def _spread(flat, keep, n: int):
    """Gather rows for the combine: a kept entry's own cell; a dropped
    entry reads some cell and is masked out after.  Dropped entries are
    spread over the cells, not stacked on one: the gather's backward, a
    sorted accumulation, walks the entries of one index serially."""
    spread = torch.arange(flat.shape[0], device=flat.device) % n
    return torch.where(keep, flat, spread)


def auto_capacity(cfg: ModelConfig, t_loc: int, ep: int, k_total: int) -> int:
    """Tokens per (source, slot) cell: the config's capacity factor times
    the cell's fair share of the rank's ``t_loc · k`` assignments."""
    want = cfg.moe.capacity_factor * t_loc * cfg.moe.experts_per_token \
        / max(ep * k_total, 1)
    return max(1, int(-(-want // 1)))


def _moe_layer_grid(cfg: ModelConfig, rt: MoERuntime, x, wr, buf,
                    pa: PlanArrays, valid, premat=None, layer: int = -1,
                    train: bool = False):
    """The FSSDP MoE layer on this rank: the JAX package's ``_moe_body``.

    x: (T, D) this rank's tokens; buf: this rank's (rows_local, chunk_loc)
    f32 buffer shard; pa: this layer's tables for the whole grid.  The
    SparseAllGather comes first (it does not depend on the gate), then the
    gate with its statistics summed over the world, the sort-based
    dispatch with ``me`` = this rank's EP index into (M, K, C) cells, the
    token all-to-all, the grouped FFN over the uncompacted (K, M·C, D)
    layout whose valid rows are each source's prefix of its C-row stripe
    (``row_valid``, from a (M, K) all-to-all of the kept counts), the
    reverse all-to-all and the combine.  Over-capacity entries are dropped
    by masking them onto a row that is cut off (an ``index_put_`` has no
    drop mode).  ``dense``: every expert is local, no token moves.

    ``premat``: this layer's (1, K, chunk_len) slots, a tensor or a
    ``Slots`` in flight, consumed in place of the layer's own
    SparseAllGather (none is issued).  Either way the slots are waited
    just before the grouped FFN, so the gather overlaps the gate and the
    dispatch.  ``train``: the grouped FFN's training form even without
    grad (``_Regather``)."""
    grid = rt.grid
    M, me = grid.model, grid.e
    T, D = x.shape
    E = cfg.moe.num_experts
    K = pa.local_rows.shape[-1] + pa.extra_experts.shape[-1]
    cap = rt.capacity or auto_capacity(cfg, T, M, K)
    slots = premat if premat is not None else materialize_layer(
        cfg, rt, buf, pa, x.dtype, layer)
    idx, vals, counts, aux, z = gate(cfg, wr, x, valid,
                                     group=grid.world_group)
    k = idx.shape[1]
    w_flat = vals.reshape(-1)
    valid_w = w_flat > 0
    e_safe = idx.reshape(-1).clamp_min(0).long()
    xtok = x[:, None, :].expand(T, k, D).reshape(T * k, D)
    if rt.impl == "dense":
        # every expert local: cells are slots, the position a per-expert
        # rank over valid entries only (kept rows stay a slot prefix)
        cap_eff = M * cap
        slot = pa.expert_slot[me][e_safe].long()
        pos = segment_ranks(torch.where(valid_w, e_safe,
                                        torch.full_like(e_safe, E))).long()
        keep = valid_w & (pos < cap_eff) & (slot >= 0)
        gs = torch.bincount(torch.where(keep, slot, torch.full_like(slot, K)),
                            minlength=K + 1)[:K].to(torch.int32)
        flat = torch.where(keep, slot.clamp_min(0) * cap_eff + pos,
                           torch.full_like(pos, K * cap_eff))
        xr = x.new_zeros((K * cap_eff + 1, D)).index_put_((flat,), xtok)
        yr = _expert_ffn(cfg, _slots_of(slots)[0],
                         xr[:-1].view(K, cap_eff, D), rt.use_pallas,
                         group_sizes=gs, layer=layer, train=train)
        got = yr.reshape(-1, D)[_spread(flat, keep, K * cap_eff)]
        dev_loads_l = torch.zeros(M, dtype=torch.float32, device=x.device)
        dev_loads_l[me] = gs.sum().float()
        rows_per_dev = K * cap_eff
    else:
        dest, slot, pos, keep, send_cnt = replica_dispatch(
            e_safe, valid_w, pa.expert_slot, pa.replicas, pa.n_replicas, me,
            K, cap, rt.local_first)
        pos = pos.long()
        flat = torch.where(keep, (dest * K + slot.clamp_min(0)) * cap + pos,
                           torch.full_like(pos, M * K * cap))
        send = x.new_zeros((M * K * cap + 1, D)).index_put_((flat,), xtok)
        recv = _AllToAll.apply(send[:-1].view(M, K, cap, D), grid.ep_group,
                               "tokens_out")
        xr = recv.permute(1, 0, 2, 3).reshape(K, M * cap, D)
        if rt.use_pallas:
            # the kept counts ride a (M, K) int all-to-all; each source's
            # kept tokens fill a prefix of its C-row stripe, so validity is
            # metadata and the kernels skip the tiles with no valid row
            recv_cnt = _a2a(send_cnt, grid.ep_group, "counts")    # (M, K)
            r = torch.arange(M * cap, device=x.device)
            row_valid = (r % cap)[None, :] < recv_cnt.T[:, r // cap]
            yr = _expert_ffn(cfg, _slots_of(slots)[0], xr, True,
                             row_valid=row_valid, layer=layer, train=train)
        else:
            yr = _expert_ffn(cfg, _slots_of(slots)[0], xr, False,
                             layer=layer)
        yback = yr.view(K, M, cap, D).permute(1, 0, 2, 3)
        ret = _AllToAll.apply(yback, grid.ep_group, "tokens_back")
        got = ret.reshape(-1, D)[_spread(flat, keep, M * K * cap)]
        dev_loads_l = send_cnt.sum(1).float()
        rows_per_dev = K * M * cap
    dropped = 1.0 - keep.sum() / valid_w.sum().clamp_min(1)
    got = torch.where(keep[:, None], got, torch.zeros_like(got))
    y = (got.reshape(T, k, D) * vals.reshape(T, k, 1).to(x.dtype)).sum(1)
    dev_loads = _all_reduce(dev_loads_l, grid.world_group, "dev_loads")
    pad_frac = 1.0 - dev_loads.sum() / float(rows_per_dev * grid.size)
    return y, MoEAux(counts, aux, z, dropped, dev_loads, pad_frac)


# ---------------------------------------------------------------------------
# Re-materialization: a layer whose backward re-gathers its slots
# ---------------------------------------------------------------------------
class BwdPipe:
    """The backward re-gather pipeline of one forward pass: layer l's
    backward puts the re-gather it issued for layer l-1 here, and layer
    l-1's backward takes it."""

    def __init__(self):
        self._slots = {}

    def put(self, layer: int, slots: Slots) -> None:
        self._slots[layer] = slots

    def take(self, layer: int) -> Slots:
        if layer not in self._slots:
            raise RuntimeError(f"no re-gathered slots for MoE layer {layer}: "
                               f"the next layer's backward issued none")
        return self._slots.pop(layer)


class _Regather(torch.autograd.Function):
    """The grid layer consuming given slots with no gradient through them.
    It saves x, wr, the buffer (by reference) and ``valid`` (the plan
    tables ride on ``ctx``), and neither the slots nor anything of the
    layer's interior.  Its backward gets the slots again (re-gathered
    from the buffer, or taken from the pipe), re-runs the layer, and lands
    the slot cotangent on the buffer through the SparseReduceScatter."""

    @staticmethod
    def forward(ctx, x, wr, buf, cfg, rt, pa, valid, premat, layer, pipe,
                pa_prev, warm_start):
        # the grouped FFN's training form, as in the backward's re-run: the
        # layer's output is the one every other mode computes, to the bit
        y, aux = _moe_layer_grid(cfg, rt, x, wr, buf, pa, valid, premat,
                                 layer, train=True)
        ctx.save_for_backward(x, wr, buf, valid)
        ctx.meta = (cfg, rt, pa, layer, pipe, pa_prev, warm_start)
        ctx.mark_non_differentiable(aux.counts, aux.dropped_frac,
                                    aux.device_loads, aux.pad_frac)
        return (y,) + tuple(aux)

    @staticmethod
    def backward(ctx, gy, _counts, g_aux, g_z, _dropped, _loads, _pad):
        x, wr, buf, valid = ctx.saved_tensors
        cfg, rt, pa, layer, pipe, pa_prev, warm_start = ctx.meta
        src = buf.detach()
        # 1. this layer's slots: re-gathered during the next layer's
        # backward, or here (no pipe, or the last MoE layer's warm-up)
        if pipe is None or warm_start:
            slots = materialize_layer(cfg, rt, src, pa, x.dtype, layer)
        else:
            slots = pipe.take(layer)
        # 2. the backward prefetch: layer l-1's re-gather, issued before
        # this layer's recompute and its dgrad and wgrad
        if pipe is not None and pa_prev is not None:
            pipe.put(layer - 1, materialize_layer(cfg, rt, src, pa_prev,
                                                  x.dtype, layer - 1))
        # 3. re-run the layer on the slots (no gather in here)
        ch = slots.wait().detach().requires_grad_()
        x_ = x.detach().requires_grad_()
        wr_ = wr.detach().requires_grad_()
        with torch.enable_grad():
            y2, aux2 = _moe_layer_grid(cfg, rt, x_, wr_, src, pa, valid, ch,
                                       layer)
            dx, dwr, dch = torch.autograd.grad(
                (y2, aux2.aux_loss, aux2.z_loss), (x_, wr_, ch),
                (gy, g_aux, g_z))
        # 4. the SparseReduceScatter lands the slot cotangent on the owners
        dbuf = _sprs(dch[0], pa, rt.grid, rt.impl, buf.shape[0],
                     layer).to(buf.dtype)
        return (dx, dwr, dbuf) + (None,) * 9


def _regather(cfg, rt, x, wr, buf, pa_l, valid, premat, layer, pipe,
              pa_prev, warm_start):
    if valid is None:
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    out = _Regather.apply(x, wr, buf, cfg, rt, pa_l, valid, premat, layer,
                          pipe, pa_prev, warm_start)
    return out[0], MoEAux(*out[1:])


def moe_layer_regather(cfg: ModelConfig, rt: MoERuntime, x, wr, buf,
                       pa_l: PlanArrays, valid, premat, layer: int = -1):
    """``moe_layer(premat=)`` with re-materialization (paper §4.3), the
    ``rematerialize="gather"`` layer of the JAX package: the forward
    consumes the given slots (a tensor or a ``Slots``) without a gradient
    through them, and keeps neither them nor the layer's interior; the
    backward replays this layer's SparseAllGather from the buffer, re-runs
    the layer, and turns the slot cotangent into the buffer's gradient
    with the SparseReduceScatter."""
    return _regather(cfg, rt, x, wr, buf, pa_l, valid, premat, layer, None,
                     None, False)


def moe_layer_regather_pipelined(cfg: ModelConfig, rt: MoERuntime, x, wr,
                                 buf, pa_l: PlanArrays, pa_prev, valid,
                                 premat, pipe: BwdPipe, layer: int,
                                 warm_start: bool = False):
    """``moe_layer_regather`` with the backward re-gather pipeline, the
    backward mirror of the forward's one-layer-ahead prefetch.  Layer l's
    backward, in issue order: takes its slots from ``pipe`` (re-gathered
    during layer l+1's backward; the network's last MoE layer, with
    ``warm_start``, gathers its own), issues layer l-1's re-gather
    (``pa_prev``; None for the first MoE layer, which issues none) into
    ``pipe``, re-runs the layer, and lands its buffer gradient through the
    SparseReduceScatter.  The JAX package also emits a re-gather before
    the first layer, which XLA drops as dead; run eagerly it would move
    data, so none is issued: 3·m·L ring hops per step."""
    return _regather(cfg, rt, x, wr, buf, pa_l, valid, premat, layer, pipe,
                     pa_prev, warm_start)
