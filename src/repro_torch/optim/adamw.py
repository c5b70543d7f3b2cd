"""AdamW with f32 master parameters and moments: the port of the JAX
package's ``repro/optim/adamw.py``.

Parameter trees are nested dicts of tensors; leaves are visited in sorted
key order, the order ``jax.tree`` gives a dict, so sums over leaves (the
global norm) are taken in the JAX package's order.  Where JAX returns new
arrays, ``update`` writes the new parameters and moments into the given
tensors in place, a slice at a time: for gpt-moe-s the chunk buffer's
parameters and moments are 7.4 GB each, and whole-tensor temporaries of
the update would not fit beside them.  The values are those of the JAX
update, element for element.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.params import _leaves

_SLICE = 1 << 25      # elements per slice of the in-place update


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def leaves(tree):
    """The tensors of a nested-dict tree in sorted key order."""
    return [t for _, t in _leaves(tree)]


def init(params) -> OptState:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    dev = leaves(params)[0].device
    return OptState(mu=zeros(params), nu=zeros(params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(tc: TrainConfig, step):
    """Linear warm-up, then cosine decay to 10% of the peak."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    total = max(tc.total_steps - tc.warmup_steps, 1)
    frac = torch.clamp((step - tc.warmup_steps) / total, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params, tc: TrainConfig, *,
           skip_nonfinite: bool = False, extra_ok=None, gnorm=None):
    """Returns (params, new_state, metrics); ``params`` and the moments
    are updated in place.

    skip_nonfinite: the step-health guard.  On a non-finite gradient
    global norm (or a false ``extra_ok``) every parameter and moment is
    where-selected back to its old value and ``count`` does not advance:
    the update is skipped bit-exactly, never by multiplying.
    ``metrics["step_ok"]`` (0.0/1.0) reports it.  ``gnorm``: the gradient
    norm to clip and guard with, when ``grads`` is a shard of the model's
    (a rank of a process grid); else ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    ok = None
    if skip_nonfinite:
        ok = torch.isfinite(gnorm)
        if extra_ok is not None:
            ok = torch.logical_and(ok, extra_ok)
    count = state.count + (1 if ok is None else ok.to(torch.int32))
    if tc.grad_clip > 0:
        scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    lr = lr_schedule(tc, count)
    b1, b2 = tc.beta1, tc.beta2
    c1 = 1 - torch.pow(b1, count.to(torch.float32))
    c2 = 1 - torch.pow(b2, count.to(torch.float32))

    for g, m0, v0, p in zip(leaves(grads), leaves(state.mu),
                            leaves(state.nu), leaves(params)):
        g = g.reshape(-1)
        m0, v0, pf = (a.view(-1) for a in (m0, v0, p))   # in place
        for s in range(0, pf.numel(), _SLICE):
            sl = slice(s, s + _SLICE)
            gs = g[sl].to(torch.float32) * scale
            m = b1 * m0[sl] + (1 - b1) * gs
            v = b2 * v0[sl] + (1 - b2) * gs * gs
            step_ = (m / c1) / (torch.sqrt(v / c2) + tc.eps)
            old = pf[sl].to(torch.float32)
            newp = (old - lr * (step_ + tc.weight_decay * old)).to(p.dtype)
            if ok is not None:
                newp = torch.where(ok, newp, pf[sl])
                m = torch.where(ok, m, m0[sl])
                v = torch.where(ok, v, v0[sl])
            pf[sl].copy_(newp)
            m0[sl].copy_(m)
            v0[sl].copy_(v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    if ok is not None:
        metrics["step_ok"] = ok.to(torch.float32)
    return params, OptState(state.mu, state.nu, count), metrics
