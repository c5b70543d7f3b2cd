"""Train step: loss, gradients, AdamW update — the port of the JAX
package's ``repro/train/step.py`` at world size 1.

The placement tables (PlanArrays) are ordinary inputs of every step, so
the Hecate scheduler can re-plan between steps.  Gradients come from
``torch.autograd.grad`` over the parameter tree's leaves (they are
returned, not accumulated into ``.grad``), and gradient accumulation over
microbatches sums them in f32 in microbatch order, as the JAX step's scan
does.

On a process grid (``rt.grid``) every rank runs the step on its own rows
of the global batch: the loss is the mean over every rank's tokens, the
gradients of the replicated parameters (embedding, attention, norms,
router) are summed over the world in one all-reduce per dtype, the chunk
buffer's gradient stays on the rank that owns the shard (the
SparseReduceScatter put it there), the clipping norm is the global one,
and AdamW runs on each rank's parameters.

Under a dense layout (``rt.layout``, ``models.parallel``) the logits'
vocabulary may be split over ``model``: the loss is then vocab-parallel,
a log-sum-exp over the shards with the target logit from the rank that
owns it.  A rank's share of the loss is its rows' summed NLL over the
token count summed over the world, in which each row counts once per rank
that holds it.  A leaf's gradient is then summed over every axis the leaf
is replicated over (the collectives' backwards are exact transposes, so
the gathered leaves' shards already hold their sums over the gather), in
one all-reduce per (axes, dtype), and the clipping norm counts each
element of the global gradient once.

Under gradient accumulation on a grid the SparseAllGather is hoisted out
of the microbatch loop: ``moe.materialize_stack`` builds every MoE
layer's slots once at the head of the step and every microbatch's forward
consumes them (``premat=``), L gathers per step whatever the number of
microbatches.  In ``save`` mode each microbatch's slot cotangent is
summed in f32, in microbatch order, and one stacked SparseReduceScatter
lands the sum on the buffer; in ``gather`` mode the hoisted slots carry
no gradient and each microbatch's backward re-gathers.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.faults import GRAD_SCALE_KEY
from repro_torch.common.params import _leaves, _set, torch_dtype
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import PlanArrays
from repro_torch.models import layers as ly
from repro_torch.models import model as mdl
from repro_torch.models.model import checkpoint
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    step: torch.Tensor


def init_state(cfg: ModelConfig, seed: int, ep: int = 1,
               device="cuda", grid=None) -> TrainState:
    params = mdl.init_params(cfg, seed, device, ep, grid)
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=device))


def cross_entropy(logits, labels, ignore: int = -1):
    """logits (B,S,V) f32; labels (B,S) int. Mean over valid tokens."""
    mask = (labels != ignore).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
    nll = (lse - ll[..., 0]) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)


def chunked_xent(cfg: ModelConfig, embed_params, hidden, labels,
                 n_chunks: int = 8, ignore: int = -1, lay=None):
    """Streaming next-token loss: unembed + logsumexp one sequence chunk at
    a time, each under ``torch.utils.checkpoint``, so the (B, S, V) f32
    logits never exist (the backward recomputes one chunk's logits at a
    time).  Chunk sums are added in order, as the JAX package's scan
    adds them."""
    nll, cnt = chunked_nll(cfg, embed_params, hidden, labels, n_chunks,
                           ignore, lay)
    return nll / cnt.clamp_min(1.0)


def _vocab_parallel_nll(logits, lab, lay, va):
    """Per-token NLL of logits whose vocabulary is split over ``va``: the
    max over every shard (a constant of the gradient), the shards' sums of
    exponentials summed, and the target logit from the shard that holds
    it."""
    n = logits.shape[-1]
    top = lay.all_reduce_max(logits.amax(-1), va)
    lse = top + torch.log(lay.all_reduce(
        torch.exp(logits - top[..., None]).sum(-1), va))
    local = lab.clamp_min(0).long() - lay.index(va) * n
    inside = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse - lay.all_reduce(ll * inside, va)


def chunked_nll(cfg: ModelConfig, embed_params, hidden, labels,
                n_chunks: int = 8, ignore: int = -1, lay=None):
    """(summed negative log-likelihood, token count) of ``chunked_xent``;
    vocab-parallel where ``lay`` splits the logits' vocabulary."""
    b, s, d = hidden.shape
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    dims = lay.dims["embed"] if lay is not None else None
    va = ly.vocab_axes(lay, dims)
    if lay is not None:
        # gathered once for every chunk (the chunks' checkpoints keep the
        # one tensor), not once a chunk and again in each recompute
        embed_params = ly.unembed_weights(embed_params, hidden.dtype, lay,
                                          dims)

    def body(h, lab):
        logits = ly.unembed(embed_params, h, cfg.final_logit_softcap)
        mask = (lab != ignore).to(torch.float32)
        if va:
            return (_vocab_parallel_nll(logits, lab, lay, va)
                    * mask).sum(), mask.sum()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab.clamp_min(0).long()[..., None])
        return ((lse - ll[..., 0]) * mask).sum(), mask.sum()

    nll = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        a, m = checkpoint(body, hidden[:, sl], labels[:, sl],
                          use_reentrant=False)
        nll, cnt = nll + a, cnt + m
    return nll, cnt


def _unpack_batch(cfg: ModelConfig, batch):
    """(forward kwargs, labels): a frontend arch that is not
    encoder-decoder (Qwen2-VL) takes ``{"embeds": (B, S, D), "labels": (B,
    S)}``, an encoder-decoder (Whisper) ``{"encoder_input": (B, S_enc, D),
    "tokens": (B, S+1)}``, the others ``{"tokens": (B, S+1)}``; labels are
    the next tokens."""
    if cfg.frontend is not None and not cfg.is_encoder_decoder:
        return {"embeds": batch["embeds"]}, batch["labels"]
    toks = batch["tokens"]
    if cfg.is_encoder_decoder:
        return ({"tokens": toks[:, :-1],
                 "encoder_input": batch["encoder_input"]}, toks[:, 1:])
    return {"tokens": toks[:, :-1]}, toks[:, 1:]


def loss_fn(cfg: ModelConfig, rt: mdl.Runtime, params, batch,
            pa: Optional[PlanArrays], causal: bool = True, premat=None):
    """Next-token loss of ``batch`` (``_unpack_batch``) plus the MoE aux
    and z terms; returns (loss, metrics).  ``premat``: step-hoisted slots
    for ``forward``."""
    kwargs, labels = _unpack_batch(cfg, batch)
    hidden, aux = mdl.forward(cfg, rt, params, pa=pa, causal=causal,
                              return_hidden=True, premat=premat, **kwargs)
    grid = getattr(rt, "grid", None)
    if grid is None:
        loss = chunked_xent(cfg, params["embed"], hidden, labels)
        metrics = {"xent": loss}
    else:
        # this rank's share of the global mean: its summed NLL over the
        # token count of the whole world (a row held by n ranks counts n
        # times in both)
        nll, cnt = chunked_nll(cfg, params["embed"], hidden, labels,
                               lay=rt.layout)
        tot = torch.stack([nll.detach(), cnt])
        dist.all_reduce(tot, group=grid.world_group)
        n = tot[1].clamp_min(1.0)
        loss = nll / n
        metrics = {"xent": tot[0] / n}
    loss_x = loss
    if aux:
        aux_l = cfg.moe.aux_loss_weight * torch.stack(
            [a.aux_loss for a in aux]).sum()
        z_l = cfg.moe.router_z_loss_weight * torch.stack(
            [a.z_loss for a in aux]).sum()
        loss = loss + aux_l + z_l
        metrics.update(
            aux_loss=aux_l, z_loss=z_l,
            expert_counts=torch.stack([a.counts for a in aux]).detach(),
            device_loads=torch.stack([a.device_loads for a in aux]).detach(),
            dropped_frac=torch.stack([a.dropped_frac for a in aux]).mean(),
            # fraction of expert-compute rows that are padding: the work
            # the grouped kernels skip (mean over layers)
            pad_frac=torch.stack([a.pad_frac for a in aux]).mean().detach())
    metrics["loss"] = loss
    if grid is not None:
        # the aux and z terms are global already (the gate sums its
        # statistics over the world): the reported loss is the global one
        metrics["loss"] = metrics["xent"] + (loss - loss_x).detach()
    return loss, metrics


def _require_grad(params) -> None:
    for _, t in _leaves(params):
        if t.is_floating_point() and not t.requires_grad:
            t.requires_grad_(True)


def loss_and_grads(cfg: ModelConfig, rt: mdl.Runtime, params, batch,
                   pa: Optional[PlanArrays], causal: bool = True):
    """(metrics, grads): the loss's gradient with respect to every leaf of
    ``params`` (a tree of the same keys; zeros where a leaf is unused)."""
    metrics, grads, _ = _loss_and_grads(cfg, rt, params, batch, pa, causal)
    return metrics, grads


def _loss_and_grads(cfg, rt, params, batch, pa, causal, premat=None):
    """``loss_and_grads`` with step-hoisted slots: (metrics, grads, the
    slots' gradient, or None where ``premat`` carries none)."""
    _require_grad(params)
    paths, ts = zip(*_leaves(params))
    wrt = ts + ((premat,) if premat is not None and premat.requires_grad
                else ())
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, rt, params, batch, pa, causal, premat)
        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
    g_premat = gs[len(ts)] if len(wrt) > len(ts) else None
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(ts, gs)]
    grid = getattr(rt, "grid", None)
    lay = getattr(rt, "layout", None)
    if lay is not None:
        sum_layout_grads(gs, paths, lay)
    elif grid is not None:
        sum_replicated_grads(gs, [p[0] != "moe_buffer" for p in paths],
                             grid.world_group)
    grads = {}
    for path, g in zip(paths, gs):
        _set(grads, path, g)
    return {k: v.detach() for k, v in metrics.items()}, grads, g_premat


def sum_replicated_grads(gs, replicated, group) -> None:
    """Sum the gradients flagged ``replicated`` over the ranks of
    ``group``, in place: one all-reduce of a flat bucket per dtype, the
    leaves in the tree's sorted key order."""
    by_dtype = {}
    for g, rep in zip(gs, replicated):
        if rep:
            by_dtype.setdefault(g.dtype, []).append(g)
    for leaves in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, group=group)
        at = 0
        for g in leaves:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


def _leaf_layout(lay, path):
    node = lay.dims
    for k in path:
        node = node[k]
    return node


def sum_layout_grads(gs, paths, lay) -> None:
    """Under a layout: sum each leaf's gradient over the axes the leaf is
    replicated over, in place, one all-reduce of a flat bucket per (axes,
    dtype), the leaves in the tree's sorted key order.  The chunk buffer's
    shard has its sum already (the SparseReduceScatter)."""
    by_axes = {}
    for g, path in zip(gs, paths):
        axes = lay.leaf_replicas(_leaf_layout(lay, path))
        if path[0] != "moe_buffer" and lay.size(axes) > 1:
            by_axes.setdefault(axes, []).append(g)
    for axes, leaves in by_axes.items():
        sum_replicated_grads(leaves, [True] * len(leaves), lay.group(axes))


def global_grad_norm(grads, grid, lay=None):
    """The clipping norm of the whole model's gradient on a grid: the
    replicated leaves' squares (the same on every rank) plus the buffer
    shards' squares summed over the world.  Under a layout each leaf's
    squares over the ranks that hold the same shard of it, summed over the
    world: every element of the global gradient once."""
    if lay is not None:
        sq = sum(torch.sum(g.float() ** 2) / lay.size(lay.leaf_replicas(
            _leaf_layout(lay, path))) for path, g in _leaves(grads))
        dist.all_reduce(sq, group=grid.world_group)
        return torch.sqrt(sq)
    sq = sum(torch.sum(g.float() ** 2) for path, g in _leaves(grads)
             if path[0] != "moe_buffer")
    if "moe_buffer" in grads:
        buf_sq = torch.sum(grads["moe_buffer"].float() ** 2)
        dist.all_reduce(buf_sq, group=grid.world_group)
        sq = sq + buf_sq
    return torch.sqrt(sq)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# what the step-hoisted slots may hold on a rank (a fifth of the card's
# 80 GB): Jamba's 16 MoE layers of three 176M-element slots would hold 17
# GB of bf16 slots and a 34 GB f32 cotangent
HOIST_BYTES = 16e9


def hoisted_bytes(cfg: ModelConfig, grid) -> int:
    """Bytes the hoisted SparseAllGather holds on a rank of ``grid``:
    every MoE layer's (K, chunk_len) slots in the compute dtype, and in
    ``save`` mode a microbatch's slot cotangent in it and their f32 sum."""
    K = -(-cfg.moe.num_experts // grid.model) + cfg.moe.slots_per_device
    n = moe_core.num_moe_layers(cfg) * K * moe_core.chunk_len(cfg)
    dt = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return n * (2 * dt + 4 if cfg.moe.rematerialize == "save" else dt)


def build_train_step(cfg: ModelConfig, rt: mdl.Runtime, tc: TrainConfig,
                     causal: bool = True,
                     hoist_premat: Optional[bool] = None):
    """Returns fn(state, batch, pa) -> (state, metrics).

    ``tc.microbatch = n > 1`` splits the batch into n microbatches along
    its first axis and averages their gradients (summed in f32 in
    microbatch order, then scaled by 1/n); metrics are averaged the same
    way and expert counts summed.  A batch carrying ``GRAD_SCALE_KEY``
    (the ``train.nan_grads`` fault site) multiplies it into the gradients.
    With ``tc.step_guard`` a non-finite loss or gradient norm skips the
    update bit-exactly (``adamw.update``).

    ``hoist_premat``: None hoists the SparseAllGathers out of the
    microbatch loop whenever the pipelined MoE path of a grid is on, n > 1
    and what the hoisting holds fits ``HOIST_BYTES`` (``hoisted_bytes``);
    False keeps each microbatch's own gathers (the baseline)."""
    n = max(tc.microbatch, 1)
    grid = getattr(rt, "grid", None)
    hoist = (cfg.moe.enabled and grid is not None and n > 1
             and mdl._use_pipeline(cfg, rt)
             and hoisted_bytes(cfg, grid) <= HOIST_BYTES) \
        if hoist_premat is None else hoist_premat
    if hoist and not mdl._use_pipeline(cfg, rt):
        raise ValueError("hoist_premat needs the pipelined MoE path of a "
                         "process grid (moe.pipeline, rematerialize != "
                         "'block')")
    save = cfg.moe.rematerialize == "save"
    dt = torch_dtype(cfg.dtype)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   pa: Optional[PlanArrays]):
        batch = dict(batch)
        fault_scale = batch.pop(GRAD_SCALE_KEY, None)
        hoisted = hoist and pa is not None and n > 1
        premat = None
        if hoisted:
            # every layer's slots, built once for all the microbatches;
            # in save mode they are a leaf whose gradient is summed below
            premat = moe_core.materialize_stack(
                cfg, rt.moe, state.params["moe_buffer"], pa, dt)
            premat.requires_grad_(save)
        if n == 1:
            metrics, grads = loss_and_grads(cfg, rt, state.params, batch,
                                            pa, causal)
        else:
            grads = msum = g_slots = None
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                m, g, gp = _loss_and_grads(cfg, rt, state.params, mb, pa,
                                           causal, premat)
                # sums in place: the gradients are tensors of their own,
                # and the buffer's and the slots' are GBs each
                g = _tree_map(lambda a: a.to(torch.float32), g)
                if gp is not None:
                    g_slots = gp.float() if g_slots is None \
                        else g_slots.add_(gp)
                if grads is None:
                    grads, msum = g, m
                else:
                    _tree_map(lambda a, b: a.add_(b), grads, g)
                    msum = {k: msum[k] + m[k] for k in msum}
                del g, gp
            inv = 1.0 / n
            _tree_map(lambda a: a.mul_(inv), grads)
            metrics = {k: v * inv for k, v in msum.items()}
            if g_slots is not None:
                # the stacked SparseReduceScatter lands the summed slot
                # cotangent on the owners' rows, once per step
                premat = None
                dbuf = moe_core.sparse_reduce_scatter_stack(
                    g_slots.to(dt), pa, grid, rt.moe.impl,
                    state.params["moe_buffer"].shape[0])
                del g_slots
                grads["moe_buffer"].add_(dbuf.mul_(inv))
            if "expert_counts" in metrics:
                metrics["expert_counts"] = metrics["expert_counts"] * n
        if fault_scale is not None:
            grads = _tree_map(
                lambda g: g * torch.as_tensor(fault_scale, dtype=g.dtype,
                                              device=g.device), grads)
        extra_ok = torch.isfinite(metrics["loss"]) if tc.step_guard \
            else None
        params, opt, opt_metrics = adamw.update(
            grads, state.opt, state.params, tc,
            skip_nonfinite=tc.step_guard, extra_ok=extra_ok,
            gnorm=None if grid is None else global_grad_norm(
                grads, grid, getattr(rt, "layout", None)))
        metrics.update(opt_metrics)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step
