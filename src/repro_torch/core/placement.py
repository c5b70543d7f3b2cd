"""Chunk placements and sharding/materialization plans (host-side, numpy).

This package's own copy of ``ShardingPlan``, ``homogeneous_sharding``,
``MaterializationPlan`` and ``ep_materialization``.  A *chunk* is one
expert's flattened parameter vector; the sharding plan says which device
owns each expert and at which row of the flat buffer; the materialization
plan adds the compute slots each device exposes per layer.  All tables are
int32 numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _segment_rank(keys: np.ndarray) -> np.ndarray:
    """rank[i] = |{j < i : keys[j] == keys[i]}| — vectorized (stable
    argsort + running segment start), the numpy mirror of
    ``core.moe.segment_ranks``.  The table functions below use it to
    replace their per-element Python fill loops; plan construction runs
    every training iteration, so these are on the planner's latency
    budget."""
    n = keys.shape[0]
    idx = np.arange(n, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new = np.ones(n, bool)
    new[1:] = sk[1:] != sk[:-1]
    seg_start = np.maximum.accumulate(np.where(new, idx, 0))
    rank = np.empty(n, np.int64)
    rank[order] = idx - seg_start
    return rank


@dataclasses.dataclass
class ShardingPlan:
    """Pre-condition P: expert ownership + flat-buffer rows (all MoE layers)."""

    num_layers: int                     # number of MoE layers L
    num_experts: int                    # experts per layer E
    num_devices: int                    # EP-axis size M
    rows_per_device: int                # flat buffer rows per device
    owner_dev: np.ndarray               # (L, E) int32 — owning device
    owner_row: np.ndarray               # (L, E) int32 — row in owner's buffer
    k_local: int                        # max owned experts per (layer, device)

    def validate(self) -> None:
        L, E, M = self.num_layers, self.num_experts, self.num_devices
        assert self.owner_dev.shape == (L, E) and self.owner_row.shape == (L, E)
        assert (0 <= self.owner_dev).all() and (self.owner_dev < M).all()
        # rows unique per device
        flat = self.owner_dev.astype(np.int64) * self.rows_per_device + self.owner_row
        assert len(np.unique(flat)) == L * E, "buffer rows must be unique"
        assert (self.owner_row < self.rows_per_device).all()
        # k_local respected
        for l in range(L):
            counts = np.bincount(self.owner_dev[l], minlength=M)
            assert counts.max() <= self.k_local, (l, counts.max(), self.k_local)

    def global_rows(self) -> np.ndarray:
        """(L, E) int64: each expert's row in the GLOBAL flat buffer —
        ``owner_dev * rows_per_device + owner_row``.  The canonical row
        addressing shared by live resharding (``trainer.reshard_perm``)
        and the mesh-shape-elastic restore path
        (``common.sharding.elastic_row_remap``)."""
        return (self.owner_dev.astype(np.int64) * self.rows_per_device
                + self.owner_row.astype(np.int64))

    def owned_rows_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per (layer, device): which buffer rows hold its owned experts.

        Returns (rows:(L,M,k_local) int32 buffer-row or 0 for pad,
                 experts:(L,M,k_local) int32 expert-id or -1 for pad)."""
        L, E, M = self.num_layers, self.num_experts, self.num_devices
        rows = np.zeros((L, M, self.k_local), np.int32)
        experts = np.full((L, M, self.k_local), -1, np.int32)
        # slot j of (l, d) = j-th expert (ascending id) owned by d in l:
        # rank within the (l, d) groups of the layer-major flat order
        dev = self.owner_dev.reshape(-1).astype(np.int64)
        l_idx = np.arange(L, dtype=np.int64).repeat(E)
        j = _segment_rank(l_idx * M + dev)
        e_idx = np.tile(np.arange(E, dtype=np.int64), L)
        rows[l_idx, dev, j] = self.owner_row.reshape(-1)
        experts[l_idx, dev, j] = e_idx
        return rows, experts


def homogeneous_sharding(num_layers: int, num_experts: int, num_devices: int,
                         k_local: Optional[int] = None) -> ShardingPlan:
    """Trivial even sharding (paper §3.2): expert e of every layer owned by
    device e // (E/M); buffer rows packed layer-major."""
    L, E, M = num_layers, num_experts, num_devices
    per_dev = -(-E // M)                     # ceil
    k_local = k_local or per_dev
    owner_dev = np.zeros((L, E), np.int32)
    owner_row = np.zeros((L, E), np.int32)
    rows_per_device = L * per_dev
    next_row = np.zeros((M,), np.int32)
    for l in range(L):
        for e in range(E):
            d = min(e // per_dev, M - 1)
            owner_dev[l, e] = d
            owner_row[l, e] = next_row[d]
            next_row[d] += 1
    plan = ShardingPlan(L, E, M, rows_per_device, owner_dev, owner_row,
                        k_local=max(k_local, per_dev))
    plan.validate()
    return plan


@dataclasses.dataclass
class MaterializationPlan:
    """Post-condition P′ for every layer, in static-slot form.

    Compute slots per (layer, device) = k_local owned + m extra.
    """

    sharding: ShardingPlan
    m: int                              # extra slots per device
    impl: str                           # "ring" | "a2a" | "dense" | "none"
    # (L, M, k_local): buffer row / expert id of owned compute slots
    local_rows: np.ndarray
    local_experts: np.ndarray
    # (L, M, m): expert id materialized in each extra slot (-1 = unused)
    extra_experts: np.ndarray
    # ring impl: (L, M, m) buffer row each device SENDS in ring round j
    # (device s sends, in round j, the chunk destined for (s - j - 1) % M)
    ring_send_rows: np.ndarray
    # a2a impl: q rounds; (L, M, q_rounds) row sent by s to dst in round r is
    # a2a_send_rows[l, s, r, dst]; -1 = zero chunk.  Shape (L, M, q, M).
    a2a_send_rows: Optional[np.ndarray] = None
    q_rounds: int = 0

    # ------------------------------------------------------------------
    @property
    def k_total(self) -> int:
        return self.sharding.k_local + self.m

    def slot_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (slot_expert:(L,M,K), expert_slot:(L,M,E)).

        slot_expert: expert id in each compute slot (-1 pad).
        expert_slot[l,d,e]: local compute-slot of e on d, or -1."""
        L = self.sharding.num_layers
        M = self.sharding.num_devices
        E = self.sharding.num_experts
        slot_expert = np.concatenate([self.local_experts, self.extra_experts],
                                     axis=2).astype(np.int32)
        expert_slot = np.full((L, M, E), -1, np.int32)
        l_i, d_i, j_i = np.nonzero(slot_expert >= 0)
        expert_slot[l_i, d_i, slot_expert[l_i, d_i, j_i]] = j_i
        return slot_expert, expert_slot

    def replica_tables(self, r_max: int, slot_expert: Optional[np.ndarray]
                       = None) -> Tuple[np.ndarray, np.ndarray]:
        """(replicas:(L,E,r_max) device ids padded by repeating,
            n_replicas:(L,E)).  ``slot_expert`` skips rebuilding the slot
        table when the caller already has it (plan_tables)."""
        L, E, M = (self.sharding.num_layers, self.sharding.num_experts,
                   self.sharding.num_devices)
        if slot_expert is None:
            slot_expert, _ = self.slot_tables()
        K = slot_expert.shape[2]
        # replica list of (l, e) = devices holding e, in (d, slot) order =
        # rank within the (l, e) groups of the flat (d, slot) scan
        flat = slot_expert.reshape(L, M * K)
        valid = flat >= 0
        e_safe = np.where(valid, flat, E).astype(np.int64)      # E = pad bin
        l_idx = np.arange(L, dtype=np.int64)[:, None]
        rank = _segment_rank((l_idx * (E + 1) + e_safe).reshape(-1)) \
            .reshape(L, M * K)
        counts = np.zeros((L, E + 1), np.int64)
        np.add.at(counts, (np.broadcast_to(l_idx, e_safe.shape), e_safe), 1)
        n_rep = np.minimum(counts[:, :E], r_max).astype(np.int32)
        assert (n_rep >= 1).all(), "some expert has no replica"
        replicas = np.zeros((L, E, r_max), np.int32)
        sel = valid & (rank < r_max)
        l_i, p_i = np.nonzero(sel)
        replicas[l_i, flat[l_i, p_i], rank[l_i, p_i]] = p_i // K
        # pad by cycling existing replicas so modular indexing is safe
        j = np.arange(r_max)[None, None, :]
        idx = np.where(j < n_rep[..., None], j, j % n_rep[..., None])
        return np.take_along_axis(replicas, idx, axis=2), n_rep

    def validate(self) -> None:
        sh = self.sharding
        L, E, M = sh.num_layers, sh.num_experts, sh.num_devices
        assert self.extra_experts.shape == (L, M, self.m if self.m else 0) or self.m == 0
        for l in range(L):
            for d in range(M):
                # paper: P′ ⊇ P — owned experts always present (local slots)
                seen = set(x for x in self.local_experts[l, d] if x >= 0)
                for j in range(self.m):
                    e = self.extra_experts[l, d, j]
                    if e < 0:
                        continue
                    assert e not in seen, "duplicate materialization"
                    seen.add(e)
                    if self.impl == "ring":
                        src = (d + j + 1) % M
                        assert sh.owner_dev[l, e] == src, (
                            "ring constraint violated")
                        assert self.ring_send_rows[l, src, j] == sh.owner_row[l, e]

    def sparsity(self) -> float:
        """λ of Eq. (1): fraction of chunks moved across devices."""
        moved = int((self.extra_experts >= 0).sum())
        total = self.sharding.num_layers * self.sharding.num_experts
        return moved / max(total, 1)


def ep_materialization(sharding: ShardingPlan) -> MaterializationPlan:
    """Expert parallelism: P′ = P (no replicas) — the paper's EP baseline."""
    L, M = sharding.num_layers, sharding.num_devices
    rows, experts = sharding.owned_rows_table()
    return MaterializationPlan(
        sharding=sharding, m=0, impl="none",
        local_rows=rows, local_experts=experts,
        extra_experts=np.zeros((L, M, 0), np.int32),
        ring_send_rows=np.zeros((L, M, 0), np.int32))
