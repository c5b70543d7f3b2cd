"""Placement latency model: the port's copy of the JAX package's
``repro/core/costs.py``, the model behind the calibration stage (§4.2).

The three quantities of the paper's §3.1 analysis (the most loaded
device's expert compute, the most loaded device's inbound token bytes,
the SparseAllGather volume), evaluated for the static-slot placements.
The scheduler compares plans under the same loads, so the hardware
constants cancel out of every decision but the overlap budget.  The
default hardware is the card the port runs on (``config.H100``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.common.config import H100, HardwareConfig, ModelConfig
from repro_torch.core.moe import chunk_len
from repro_torch.core.placement import MaterializationPlan


@dataclasses.dataclass(frozen=True)
class CostContext:
    cfg: ModelConfig
    tokens_per_step: float              # global tokens routed per MoE layer
    hw: HardwareConfig = H100
    attn_time_s: float = 0.0            # non-MoE time the gather can hide
                                        # behind (0 = none)

    @property
    def expert_bytes(self) -> float:
        return chunk_len(self.cfg) * 2.0           # bf16 materialization

    @property
    def expert_flops_per_token(self) -> float:
        return 2.0 * chunk_len(self.cfg)


def device_loads_for(plan: MaterializationPlan, loads: np.ndarray,
                     layer: int, tokens: float, top_k: int) -> np.ndarray:
    """Expected tokens per device under even replica splitting (§4.4)."""
    slot_expert, _ = plan.slot_tables()
    M = plan.sharding.num_devices
    E = plan.sharding.num_experts
    f = np.asarray(loads, np.float64)
    if f.ndim == 2:                      # (L, E) -> this layer's row
        f = f[layer]
    f = f / max(f.sum(), 1e-12) * tokens * top_k
    n_rep = np.zeros(E)
    for d in range(M):
        for e in slot_expert[layer, d]:
            if e >= 0:
                n_rep[e] += 1
    out = np.zeros(M)
    for d in range(M):
        for e in slot_expert[layer, d]:
            if e >= 0:
                out[d] += f[e] / max(n_rep[e], 1)
    return out


def placement_latency(ctx: CostContext, plan: MaterializationPlan,
                      loads: np.ndarray, layer: int = 0,
                      extra_on_path: bool = False,
                      device_weights: Optional[np.ndarray] = None) -> float:
    """Modelled latency of one layer (seconds) for ``plan`` under
    ``loads``.

    ``extra_on_path`` charges the SparseAllGather fully to the critical
    path (the calibration case: a plan changed after the gate cannot
    overlap).  ``device_weights``: per-device speed (1.0 = full speed); a
    device at weight w takes 1/w as long per token, so the compute term is
    the largest speed-scaled device load."""
    cfg = ctx.cfg
    dev = device_loads_for(plan, loads, layer, ctx.tokens_per_step,
                           cfg.moe.experts_per_token)
    dev_t = dev
    if device_weights is not None:
        w = np.asarray(device_weights, np.float64).reshape(-1)
        dev_t = dev * (w.max() / w)
    comp = dev_t.max() * ctx.expert_flops_per_token * 3 \
        / ctx.hw.peak_flops_bf16
    # dispatch: the worst inbound link carries about the largest device
    # load (links do not slow down with their device)
    a2a = 4 * dev.max() * cfg.d_model * 2 / ctx.hw.ici_bw
    # materialization volume per device (the ring moves exactly λS)
    m_extra = int((plan.extra_experts[layer] >= 0).sum()) \
        / max(plan.sharding.num_devices, 1)
    spag = 2 * m_extra * ctx.expert_bytes / ctx.hw.ici_bw
    over = spag if extra_on_path else max(0.0, spag - ctx.attn_time_s)
    return comp + a2a + over


def calibration_gain(ctx: CostContext, current: MaterializationPlan,
                     candidate: MaterializationPlan, real_loads: np.ndarray,
                     layer: int = 0,
                     device_weights: Optional[np.ndarray] = None) -> float:
    """Positive when switching to ``candidate``, paying its gather on the
    critical path (§4.2), still wins under the real loads."""
    t_cur = placement_latency(ctx, current, real_loads, layer,
                              device_weights=device_weights)
    t_cand = placement_latency(ctx, candidate, real_loads, layer,
                               extra_on_path=True,
                               device_weights=device_weights)
    return t_cur - t_cand
