"""Train step: loss, gradients, AdamW update — the port of the JAX
package's ``repro/train/step.py`` at world size 1.

The placement tables (PlanArrays) are ordinary inputs of every step, so
the Hecate scheduler can re-plan between steps.  Gradients come from
``torch.autograd.grad`` over the parameter tree's leaves (they are
returned, not accumulated into ``.grad``), and gradient accumulation over
microbatches sums them in f32 in microbatch order, as the JAX step's scan
does.  The materialization hoisting of the JAX step needs a mesh and is
not ported.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.faults import GRAD_SCALE_KEY
from repro_torch.common.params import _leaves, _set
from repro_torch.core.moe import PlanArrays
from repro_torch.models import layers as ly
from repro_torch.models import model as mdl
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    step: torch.Tensor


def init_state(cfg: ModelConfig, seed: int, ep: int = 1,
               device="cuda") -> TrainState:
    params = mdl.init_params(cfg, seed, device, ep)
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
                 n_chunks: int = 8, ignore: int = -1):
    """Streaming next-token loss: unembed + logsumexp one sequence chunk at
    a time, each under ``torch.utils.checkpoint``, so the (B, S, V) f32
    logits never exist (the backward recomputes one chunk's logits at a
    time).  Chunk sums are added in order, as the JAX package's scan
    adds them."""
    b, s, d = hidden.shape
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks

    def body(h, lab):
        logits = ly.unembed(embed_params, h, cfg.final_logit_softcap)
        mask = (lab != ignore).to(torch.float32)
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
    return nll / cnt.clamp_min(1.0)


def loss_fn(cfg: ModelConfig, rt: mdl.Runtime, params, batch,
            pa: Optional[PlanArrays], causal: bool = True):
    """Next-token loss of ``batch["tokens"]`` (B, S+1) plus the MoE aux and
    z terms; returns (loss, metrics)."""
    toks = batch["tokens"]
    hidden, aux = mdl.forward(cfg, rt, params, toks[:, :-1], pa=pa,
                              causal=causal, return_hidden=True)
    labels = toks[:, 1:]
    loss = chunked_xent(cfg, params["embed"], hidden, labels)
    metrics = {"xent": loss}
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
    return loss, metrics


def _require_grad(params) -> None:
    for _, t in _leaves(params):
        if t.is_floating_point() and not t.requires_grad:
            t.requires_grad_(True)


def loss_and_grads(cfg: ModelConfig, rt: mdl.Runtime, params, batch,
                   pa: Optional[PlanArrays], causal: bool = True):
    """(metrics, grads): the loss's gradient with respect to every leaf of
    ``params`` (a tree of the same keys; zeros where a leaf is unused)."""
    _require_grad(params)
    paths, ts = zip(*_leaves(params))
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, rt, params, batch, pa, causal)
        gs = torch.autograd.grad(loss, ts, allow_unused=True)
    grads = {}
    for path, t, g in zip(paths, ts, gs):
        _set(grads, path, torch.zeros_like(t) if g is None else g)
    return {k: v.detach() for k, v in metrics.items()}, grads


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def build_train_step(cfg: ModelConfig, rt: mdl.Runtime, tc: TrainConfig,
                     causal: bool = True):
    """Returns fn(state, batch, pa) -> (state, metrics).

    ``tc.microbatch = n > 1`` splits the batch into n microbatches along
    its first axis and averages their gradients (summed in f32 in
    microbatch order, then scaled by 1/n); metrics are averaged the same
    way and expert counts summed.  A batch carrying ``GRAD_SCALE_KEY``
    (the ``train.nan_grads`` fault site) multiplies it into the gradients.
    With ``tc.step_guard`` a non-finite loss or gradient norm skips the
    update bit-exactly (``adamw.update``)."""
    n = max(tc.microbatch, 1)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   pa: Optional[PlanArrays]):
        batch = dict(batch)
        fault_scale = batch.pop(GRAD_SCALE_KEY, None)
        if n == 1:
            metrics, grads = loss_and_grads(cfg, rt, state.params, batch,
                                            pa, causal)
        else:
            grads = msum = None
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                m, g = loss_and_grads(cfg, rt, state.params, mb, pa, causal)
                g = _tree_map(lambda a: a.to(torch.float32), g)
                if grads is None:
                    grads, msum = g, m
                else:
                    grads = _tree_map(torch.add, grads, g)
                    msum = {k: msum[k] + m[k] for k in msum}
            inv = 1.0 / n
            grads = _tree_map(lambda a: a * inv, grads)
            metrics = {k: v * inv for k, v in msum.items()}
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
            skip_nonfinite=tc.step_guard, extra_ok=extra_ok)
        metrics.update(opt_metrics)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step
