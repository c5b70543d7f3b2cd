"""Hecate scheduler: Algorithms 1 & 2, load prediction, calibration.

This package's own copy of the JAX package's ``repro/core/schedule.py``
(numpy only, no import of it): the same inputs give byte-identical tables
or the same exception.  All host-side numpy: runs between steps, emitting
the static-shape tables of ``repro_torch.core.placement`` that the train
step consumes.  The greedy of Algorithm 2 keeps the reference's known
dead end ("no free slot — k_local too tight") and Algorithm 1 its tie
handling, as they are: the port copies the reference, faults included,
and its tests hold the two to each other.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.placement import (MaterializationPlan, ShardingPlan,
                                        _segment_rank)


# ---------------------------------------------------------------------------
# Load prediction (paper §3.2: sliding-window average, w = 5)
# ---------------------------------------------------------------------------
class LoadPredictor:
    """Predicts next-iteration expert loads per MoE layer from history."""

    def __init__(self, num_layers: int, num_experts: int, window: int = 5):
        self.window = window
        self.history: list[np.ndarray] = []   # each (L, E) token counts
        self.num_layers = num_layers
        self.num_experts = num_experts

    def observe(self, loads: np.ndarray) -> None:
        loads = np.asarray(loads, np.float64)
        assert loads.shape == (self.num_layers, self.num_experts)
        self.history.append(loads)
        if len(self.history) > self.window:
            self.history.pop(0)

    def predict(self) -> np.ndarray:
        if not self.history:
            return np.ones((self.num_layers, self.num_experts))
        return np.mean(self.history, axis=0)


# ---------------------------------------------------------------------------
# Overlap degree (paper §4.2): t = T_nonMoE * bw / expert_size
# ---------------------------------------------------------------------------
def overlap_degree(t_non_moe_s: float, bw_bytes_per_s: float,
                   expert_bytes: float) -> int:
    if expert_bytes <= 0:
        return 0
    return int(t_non_moe_s * bw_bytes_per_s / expert_bytes)


# ---------------------------------------------------------------------------
# Algorithm 1 — sparse materialization
# ---------------------------------------------------------------------------
def _assign_slots_by_load(load_frac: float, tot_slots: int, remaining: int
                          ) -> int:
    """Paper line 9: replicas ∝ load share (at least 1 if selected)."""
    return max(1, min(remaining, int(round(load_frac * tot_slots))))


def sparse_materialization(sharding: ShardingPlan, loads: np.ndarray,
                           t: int, m: int, *, impl: str = "ring",
                           node_size: int = 0, q_rounds: int = 0,
                           vectorized: bool = True,
                           ) -> MaterializationPlan:
    """Algorithm 1, per layer, under the static-slot contract.

    loads: (L, E) predicted token counts.
    t: overlap degree (max hidden-comm experts); m: extra slots per device.
    impl:
      "ring":  extra slot j of device d is fed from static source
               (d + j + 1) % M — TRUE λS volume (beyond-paper optimized).
      "a2a":   q-round all_to_all; scheduler enforces ≤ q_rounds chunks per
               (src, dst) pair (paper-faithful volume upper bound).
      "dense": all experts on all devices (FSDP baseline; ignores t/m).
    node_size: devices per node for topology-aware spreading (0 = flat).
    vectorized: numpy-array greedy (the default — byte-identical to the
      reference Python loops, ≥10x faster at production shapes, measured
      with parity checks in benchmarks/planner_microbench.py).  ``False``
      runs the reference ``_alg1_*_loop`` implementations.
    """
    sh = sharding
    L, E, M = sh.num_layers, sh.num_experts, sh.num_devices
    loads = np.asarray(loads, np.float64).reshape(L, E)
    rows, local_experts = sh.owned_rows_table()

    if impl == "dense":
        m_eff = E                       # every expert everywhere
    else:
        t = min(t, E)
        m_eff = min(m, t) if t > 0 else 0
    extra = np.full((L, M, m_eff), -1, np.int32)
    ring_rows = np.zeros((L, M, m_eff), np.int32)
    q = q_rounds or max(1, -(-m_eff // max(M - 1, 1)))
    # the a2a send table only exists on a2a plans (the plan stores None
    # otherwise) — don't pay its (L, M, q, M) fill on the ring hot path
    a2a_rows = np.full((L, M, q, M), -1, np.int32) if impl == "a2a" \
        else np.full((L, M, q, 0), -1, np.int32)

    if vectorized:
        # presence mask by scatter (L·E writes, not an L·M·E compare)
        owned = np.zeros((L, M, E), bool)
        owned[np.arange(L).repeat(E), sh.owner_dev.reshape(-1),
              np.tile(np.arange(E), L)] = True
        if impl == "dense":
            # extras of d = all experts d does not own, ascending id
            not_mine = ~owned                               # (L, M, E)
            j = np.cumsum(not_mine, axis=2) - 1
            l_i, d_i, e_i = np.nonzero(not_mine)
            extra[l_i, d_i, j[l_i, d_i, e_i]] = e_i
        elif m_eff > 0:
            # `owned` doubles as the mutable presence state — it is not
            # read again after Alg 1 fills the slots
            if impl == "ring":
                _alg1_ring(sh, loads, m_eff, extra, ring_rows,
                           present=owned, local_experts=local_experts)
            else:
                for l in range(L):
                    _alg1_a2a(sh, l, loads[l], t, m_eff, q, extra,
                              a2a_rows, present=owned[l],
                              node_size=node_size)
    else:
        for l in range(L):
            f = loads[l]
            owned_on = [set(local_experts[l, d][local_experts[l, d] >= 0])
                        for d in range(M)]
            present = [set(s) for s in owned_on]
            if impl == "dense":
                for d in range(M):
                    j = 0
                    for e in range(E):
                        if e not in present[d]:
                            extra[l, d, j] = e
                            j += 1
                continue
            if m_eff == 0:
                continue
            if impl == "ring":
                _alg1_ring_loop(sh, l, f, m_eff, extra, ring_rows, present)
            else:
                _alg1_a2a_loop(sh, l, f, t, m_eff, q, extra, a2a_rows,
                               present, node_size)

    if impl == "ring":
        # dead-slot contract: a slot _alg1_ring could not fill keeps
        # extra == -1 and its default send row 0 — _materialize masks the
        # received chunk out via (extra_experts >= 0), so the only
        # requirement on the dead send is that the row read is in range.
        assert ((ring_rows >= 0) & (ring_rows < sh.rows_per_device)).all()

    plan = MaterializationPlan(
        sharding=sh, m=m_eff, impl=impl,
        local_rows=rows, local_experts=local_experts,
        extra_experts=extra, ring_send_rows=ring_rows,
        a2a_send_rows=(a2a_rows if impl == "a2a" else None),
        q_rounds=(q if impl == "a2a" else 0))
    return plan


def _alg1_ring(sh: ShardingPlan, loads: np.ndarray, m: int,
               extra: np.ndarray, ring_rows: np.ndarray,
               present: np.ndarray, local_experts: np.ndarray) -> None:
    """Vectorized ring-constrained Alg 1 over ALL layers at once.

    Slot j of device d must hold an expert owned by (d+j+1) % M; greedily
    pick the hottest eligible expert.  Within one ring round j every
    device's choice is independent (it only reads its own presence row),
    so the whole (L, M) grid resolves in one masked argmax per round —
    and because the candidates of (d, j) are exactly the experts OWNED by
    the round's source device, the argmax runs over the (L, M, k_local)
    owned-experts table, not the full (L, M, E) grid: m rounds of
    O(L·M·k_local) array work instead of L·m·M Python list scans.
    Byte-identical to ``_alg1_ring_loop`` (np.argmax picks the FIRST
    maximum; the owned table lists experts ascending, matching ``max``
    over the ascending candidate list).

    present: (L, M, E) bool, updated in place.
    local_experts: (L, M, k_local) int32 owned-expert table (-1 pad).
    """
    M = sh.num_devices
    L = sh.num_layers
    l_b = np.arange(L)[:, None, None]
    d_b = np.arange(M)[None, :, None]
    for j in range(m):
        src = (np.arange(M) + j + 1) % M                  # (M,)
        cand_e = local_experts[:, src, :]                 # (L, M, k_local)
        e_safe = np.maximum(cand_e, 0)
        ok = (cand_e >= 0) & ~present[l_b, d_b, e_safe]
        score = np.where(ok, loads[l_b, e_safe], -np.inf)
        jj = np.argmax(score, axis=2)                     # (L, M)
        has = np.take_along_axis(ok, jj[:, :, None], axis=2)[:, :, 0]
        e = np.take_along_axis(cand_e, jj[:, :, None], axis=2)[:, :, 0]
        extra[:, :, j] = np.where(has, e, -1)
        l_i, d_i = np.nonzero(has)
        ring_rows[l_i, src[d_i], j] = sh.owner_row[l_i, e[l_i, d_i]]
        present[l_i, d_i, e[l_i, d_i]] = True


def _alg1_ring_loop(sh: ShardingPlan, l: int, f: np.ndarray, m: int,
                    extra: np.ndarray, ring_rows: np.ndarray,
                    present: list) -> None:
    """Reference Python-loop ring Alg 1 (one layer) — the parity baseline
    for ``_alg1_ring`` (benchmarks/planner_microbench.py)."""
    M = sh.num_devices
    owned_by = [np.where(sh.owner_dev[l] == d)[0] for d in range(M)]
    for j in range(m):
        for d in range(M):
            src = (d + j + 1) % M
            cands = [e for e in owned_by[src] if e not in present[d]]
            if not cands:
                # src owns nothing device d lacks: the slot stays EMPTY
                # (extra == -1).  The static ring schedule still moves one
                # chunk for it (ring_rows default row 0), and _materialize
                # discards the payload via the (extra_experts >= 0) mask —
                # sparse_materialization asserts the send row stays in
                # range so that dead send is harmless.
                continue
            e = max(cands, key=lambda e: f[e])
            extra[l, d, j] = e
            ring_rows[l, src, j] = sh.owner_row[l, e]
            present[d].add(e)


def _seg_exclusive_cumsum(grouped: np.ndarray, starts: np.ndarray
                          ) -> np.ndarray:
    """Per-segment exclusive cumsum of a (rows, cols) bool matrix whose
    rows are already grouped into contiguous segments (``starts`` marks
    the first row of each).  The global exclusive cumsum minus its value
    at the segment start (forward-filled via a running max — the cumsum is
    nondecreasing along rows, so the current segment's start value always
    dominates earlier ones)."""
    cums = np.cumsum(grouped, axis=0, dtype=np.int64) - grouped
    base = np.maximum.accumulate(np.where(starts[:, None], cums, 0), axis=0)
    return cums - base


def _alg1_a2a(sh: ShardingPlan, l: int, f: np.ndarray, t: int, m: int,
              q: int, extra: np.ndarray, a2a_rows: np.ndarray,
              present: np.ndarray, node_size: int) -> None:
    """Vectorized paper-faithful Algorithm 1 (one layer) under the
    q-per-(src,dst) constraint — BATCHED over targets.

    The reference greedy walks the target list sequentially because each
    claim mutates three budget tables (device free slots, per-(src, dst)
    chunk budgets, per-device next-slot cursors).  All three are
    resolvable in closed form over the whole (target, device) grid:

    * every target's expert is distinct, so presence reads are
      independent of earlier claims — eligibility is one mask;
    * the q budget counts claims from a target's OWNER to each device,
      and all targets sharing an owner form one contiguous segment after
      a stable sort by owner — "claims so far from this src" is a
      per-segment exclusive cumsum (``_seg_exclusive_cumsum``), and an
      entry survives iff that rank < q.  m-budget rejections cannot
      perturb these ranks: device saturation is permanent, so m-rejected
      entries are only ever followed by further rejections on that
      device;
    * the m budget (and the slot cursor) is then the exclusive cumsum of
      the q-surviving entries down the original target order — an entry
      claims iff its rank < m, and that rank IS its slot index.

    One more cumsum over the claimed entries (same owner segments) yields
    the a2a send-round index.  Byte-identical to ``_alg1_a2a_loop`` —
    locked in by the randomized sweeps in tests/test_placement.py and
    benchmarks/planner_microbench.py; measured in the planner bench (the
    sequential per-target loop was the a2a/ring speedup gap the ROADMAP
    carried).

    present: (M, E) bool, updated in place.
    """
    M = sh.num_devices
    order = np.argsort(-f)
    top_t = list(order[:max(t, 0)]) if t > 0 else list(order)
    nsz = node_size or M
    d_all = np.arange(M)

    if t <= m:
        # lines 4-5: materialize top-t experts on ALL devices
        es = np.asarray(top_t, np.int64)
        memb = np.ones((len(es), M), bool)
    else:
        # lines 6-11: replicas ∝ load (sequential remaining-budget walk —
        # tiny, early-exits; the per-target device RANKING below is the
        # hot part and is batched)
        tot_slots = M * m
        counts = []
        remaining = tot_slots
        fsum = max(f[top_t].sum(), 1e-9)
        for e in top_t:
            n = _assign_slots_by_load(f[e] / fsum, tot_slots, remaining)
            remaining -= n
            counts.append((e, n))
            if remaining <= 0:
                break
        es = np.asarray([e for e, _ in counts], np.int64)
        ns = np.asarray([n for _, n in counts], np.int64)
        # node-aware: prefer nodes where e is NOT yet present, then
        # devices with more free slots — all devices still have m free
        # slots when targets are ranked (claims happen after), so the
        # free-slot key is constant and the reference's lexsort reduces
        # to a stable sort on node presence, ties → ascending device id.
        # One batched any-reduce + one argsort over the whole
        # (target, device) grid.
        n_pad = (-M) % nsz
        node_of = d_all // nsz
        pres = np.zeros((len(es), M + n_pad), bool)
        pres[:, :M] = present[:, es].T
        node_has = pres.reshape(len(es), -1, nsz).any(2)[:, node_of]
        dev_order = np.argsort(node_has, axis=-1, kind="stable")
        memb = np.zeros((len(es), M), bool)
        np.put_along_axis(memb, dev_order,
                          d_all[None, :] < ns[:, None], axis=1)

    if not len(es):
        return
    srcs = sh.owner_dev[l, es].astype(np.int64)            # (n_t,)
    elig = memb & ~present[:, es].T                        # (n_t, M)
    elig[np.arange(len(es)), srcs] = False                 # d != src
    # q budget: rank within (src, device) segments, target order
    ords = np.argsort(srcs, kind="stable")
    srcs_g = srcs[ords]
    starts = np.empty(len(es), bool)
    starts[0] = True
    starts[1:] = srcs_g[1:] != srcs_g[:-1]
    q_rank = np.empty_like(elig, dtype=np.int64)
    q_rank[ords] = _seg_exclusive_cumsum(elig[ords], starts)
    qkeep = elig & (q_rank < q)
    # m budget + slot cursor: rank among q-survivors down target order
    m_rank = np.cumsum(qkeep, axis=0, dtype=np.int64) - qkeep
    claimed = qkeep & (m_rank < m)
    # a2a send round: rank among CLAIMED within (src, device) segments
    p_rank = np.empty_like(q_rank)
    p_rank[ords] = _seg_exclusive_cumsum(claimed[ords], starts)
    ti, di = np.nonzero(claimed)
    extra[l, di, m_rank[ti, di]] = es[ti]
    a2a_rows[l, srcs[ti], p_rank[ti, di], di] = sh.owner_row[l, es[ti]]
    present[di, es[ti]] = True


def _alg1_a2a_loop(sh: ShardingPlan, l: int, f: np.ndarray, t: int, m: int,
                   q: int, extra: np.ndarray, a2a_rows: np.ndarray,
                   present: list, node_size: int) -> None:
    """Reference Python-loop a2a Alg 1 — the parity baseline for
    ``_alg1_a2a`` (benchmarks/planner_microbench.py)."""
    M = sh.num_devices
    order = np.argsort(-f)
    top_t = list(order[:max(t, 0)]) if t > 0 else list(order)
    slots_free = np.full(M, m, np.int32)
    pair_used = np.zeros((M, M), np.int32)       # chunks src -> dst
    slot_next = np.zeros(M, np.int32)
    nsz = node_size or M

    if t <= m:
        # lines 4-5: materialize top-t experts on ALL devices
        targets = [(e, [d for d in range(M)]) for e in top_t]
    else:
        # lines 6-11: replicas ∝ load
        tot_slots = int(slots_free.sum())
        targets = []
        remaining = tot_slots
        fsum = max(f[top_t].sum(), 1e-9)
        for e in top_t:
            n = _assign_slots_by_load(f[e] / fsum, tot_slots, remaining)
            remaining -= n
            targets.append((e, n))
            if remaining <= 0:
                break
        # expand counts into device choices below
        expanded = []
        for e, n in targets:
            # node-aware: prefer nodes where e is NOT yet present, then
            # devices with more free slots
            devs = sorted(
                (d for d in range(M)),
                key=lambda d: (
                    any(e in present[dd]
                        for dd in range((d // nsz) * nsz,
                                        min((d // nsz + 1) * nsz, M))),
                    -slots_free[d]))
            chosen = []
            for d in devs:
                if len(chosen) >= n:
                    break
                chosen.append(d)
            expanded.append((e, chosen))
        targets = expanded

    for e, devs in targets:
        src = sh.owner_dev[l, e]
        for d in devs:
            if (e in present[d] or slots_free[d] <= 0
                    or pair_used[src, d] >= q or src == d):
                continue
            j = slot_next[d]
            extra[l, d, j] = e
            a2a_rows[l, src, pair_used[src, d], d] = sh.owner_row[l, e]
            pair_used[src, d] += 1
            slot_next[d] += 1
            slots_free[d] -= 1
            present[d].add(e)


# ---------------------------------------------------------------------------
# Calibration (paper §4.2): re-run Alg 1 on the REAL gate decision and accept
# if the modeled latency (incl. the extra on-critical-path spAG) improves.
# ---------------------------------------------------------------------------
def calibrate(plan: MaterializationPlan, real_loads: np.ndarray,
              t: int, m: int, cost_model, *, impl: str = "ring"
              ) -> MaterializationPlan:
    cand = sparse_materialization(plan.sharding, real_loads, t, m, impl=impl)
    base_cost = cost_model(plan, real_loads, extra_on_path=False)
    cand_cost = cost_model(cand, real_loads, extra_on_path=True)
    return cand if cand_cost < base_cost else plan


# ---------------------------------------------------------------------------
# Algorithm 2 — heterogeneous sharding (cross-layer, memory balanced)
# ---------------------------------------------------------------------------
def heterogeneous_sharding(loads: np.ndarray, num_devices: int, t: int,
                           *, node_size: int = 0,
                           k_local: Optional[int] = None,
                           vectorized: bool = True,
                           device_weights: Optional[Sequence[float]] = None,
                           ) -> ShardingPlan:
    """Paper Algorithm 2.  loads: (L, E).  Returns a ShardingPlan where the
    number of owned experts per (layer, device) may vary (0..k_local) while
    total buffer rows per device stay exactly balanced.

    The greedy is inherently sequential (each placement shifts the device
    loads the next decision reads), but each DECISION — "least-loaded node
    with an eligible device, then least-loaded eligible device on it" —
    is a pure rank-and-filter over per-device arrays.  ``vectorized=True``
    (the default) resolves it with masked numpy lexsorts (byte-identical
    to the Python-sort reference, which survives as the parity baseline
    for benchmarks/planner_microbench.py); the ordering loops around it
    (hot marking, cold ordering, buffer-row assignment) are fully
    vectorized.

    device_weights: optional per-device SPEED weights (straggler
    de-weighting — the trainer's step-time probe).  A device of weight w
    accrues ``load * w_max / w`` effective load per placement, so the
    greedy charges a half-speed device double for every expert it takes:
    it receives proportionally fewer slots wherever the memory-balance
    cap leaves freedom, and where rows are exactly balanced it receives
    the COLDEST experts instead (fewer expected tokens either way).  The
    static memory contract is untouched — ``rows_per_device`` and
    ``k_local`` never scale, so compiled shapes and the per-device buffer
    stay identical.  Uniform weights multiply every load by exactly 1.0
    (w/w is exact in IEEE), making the output byte-identical to the
    unweighted call — locked in by tests/test_placement.py.  The weights
    are ADVISORY, the memory contract is not: on a tight (zero-slack)
    layout a skewed placement order can dead-end against the row or
    k_local caps, in which case the greedy silently retries unweighted —
    a straggler may keep its slots, but a reshard can never fail because
    a device slowed down."""
    loads = np.asarray(loads, np.float64)
    M = num_devices
    inv_w = None                        # effective-load multiplier per dev
    if device_weights is not None:
        w = np.asarray(device_weights, np.float64).reshape(-1)
        if w.shape != (M,):
            raise ValueError(f"device_weights shape {w.shape} != ({M},)")
        if not np.all(w > 0) or not np.all(np.isfinite(w)):
            raise ValueError("device_weights must be positive and finite")
        if np.any(w != w.max()):        # uniform -> stay on the exact path
            inv_w = (w.max() / w).tolist()
    if inv_w is not None:
        try:
            return _hetero_greedy(loads, M, t, node_size, k_local,
                                  vectorized, inv_w)
        except RuntimeError:
            pass                        # infeasible under this order
    return _hetero_greedy(loads, M, t, node_size, k_local, vectorized, None)


def _hetero_greedy(loads: np.ndarray, num_devices: int, t: int,
                   node_size: int, k_local: Optional[int],
                   vectorized: bool, inv_w) -> ShardingPlan:
    L, E = loads.shape
    M = num_devices
    rows_per_device = -(-(L * E) // M)
    k_local = k_local or min(E, 2 * max(1, -(-E // M)))
    nsz = node_size or M
    n_nodes = max(1, M // nsz)

    # line 1-2: J = top-t per layer (overlappable), J' = rest
    t = min(max(t, 0), E)
    hot = np.zeros((L, E), bool)
    if t:
        np.put_along_axis(hot, np.argsort(-loads, axis=1)[:, :t], True,
                          axis=1)

    owner_dev = np.full((L, E), -1, np.int32)
    covered = n_nodes * nsz                                # node-resident devs
    if not vectorized:                         # loop-reference state only
        slots_free = np.full(M, rows_per_device, np.int32)
        dev_load = np.zeros(M, np.float64)
        per_layer_count = np.zeros((L, M), np.int32)

    # ---- fast path: lazy min-heaps over (key, index, version) ---------
    # The loop reference re-ranks every node and device per placement
    # (O(M log M) Python sorts with tuple keys, L·E times).  The keys only
    # change for the ONE device that received the previous placement, so
    # lazy heaps give O(log) amortized selection: every key change bumps a
    # VERSION counter and pushes a fresh entry, a popped entry is valid
    # iff its version is current (stale ones are discarded — a fresh twin
    # is in the heap), and the first valid pop is the true lexicographic
    # minimum with ascending-index tie-break — exactly what the
    # reference's stable ``sort(key=(load, free))`` picks.  Node loads are
    # accumulated incrementally in Python floats; for integer token-count
    # loads (the production input — and the all-ones predictor default)
    # this is EXACT, identical to the reference's fresh slice sums.  For
    # continuous loads the two can differ in final ulps; a comparison
    # would only flip on a sub-ulp near-tie between different load
    # multisets (identical multisets sum identically on both sides), so
    # the randomized byte-parity sweep in benchmarks/planner_microbench.py
    # holds for both load families.
    if vectorized:                             # fast-path state only
        node_load = [0.0] * n_nodes
        node_free = [min((n + 1) * nsz, M) - n * nsz
                     for n in range(n_nodes)]
        node_free = [f * rows_per_device for f in node_free]
        node_ver = [0] * n_nodes
        dev_ver = [0] * M
        dev_loadf = [0.0] * M
        dev_freei = [rows_per_device] * M
        dev_heaps = [[(0.0, rows_per_device, d, 0)
                      for d in range(n * nsz, min((n + 1) * nsz, M))]
                     for n in range(n_nodes)]
        node_heap = [(node_load[n], node_free[n], n, 0)
                     for n in range(n_nodes)]
        heapq.heapify(node_heap)
        for dh_ in dev_heaps:
            heapq.heapify(dh_)
        plc_rows = [[0] * M for _ in range(L)]  # per-layer owned counts
        loads_rows = loads.tolist()             # scalar reads off numpy

    def place_fast(l):
        plc = plc_rows[l]
        node_stash, found = [], -1
        while node_heap:
            nk = heapq.heappop(node_heap)
            n = nk[2]
            if nk[3] != node_ver[n]:
                continue                      # stale — fresh twin in heap
            dh = dev_heaps[n]
            dev_stash = []
            while dh:
                dk = heapq.heappop(dh)
                d = dk[2]
                if dk[3] != dev_ver[d]:
                    continue                  # stale
                dev_stash.append(dk)          # valid — goes back either way
                if plc[d] >= k_local:
                    continue                  # capped for THIS layer only
                found = d
                break
            for dk in dev_stash:
                heapq.heappush(dh, dk)
            node_stash.append(nk)             # valid now; staled by the
            if found >= 0:                    # caller's update if chosen
                break
        for nk in node_stash:
            heapq.heappush(node_heap, nk)
        if found >= 0:
            return found
        # fallback: any device with a free slot (reachable only when M is
        # not a multiple of node_size — the orphan tail devices belong to
        # no node; same argsort call as the loop reference for parity —
        # dev_loadf accumulates in the reference's exact order)
        for d in np.argsort(np.asarray(dev_loadf)):
            if dev_freei[d] > 0 and plc_rows[l][d] < k_local:
                return int(d)
        raise RuntimeError("no free slot — k_local too tight")

    def placed_fast(l, d, w):
        """Post-placement bookkeeping: bump versions and push fresh heap
        entries for the one device (and node) whose keys changed.  Orphan
        devices (M not a multiple of node_size) belong to no node and live
        outside the heaps — the fallback scan handles them, as in the
        reference."""
        dev_loadf[d] += w
        dev_freei[d] -= 1
        dev_ver[d] += 1
        if d >= covered:
            return
        if dev_freei[d] > 0:
            heapq.heappush(dev_heaps[d // nsz],
                           (dev_loadf[d], dev_freei[d], d, dev_ver[d]))
        n = d // nsz
        node_load[n] += w
        node_free[n] -= 1
        node_ver[n] += 1
        if node_free[n] > 0:
            heapq.heappush(node_heap,
                           (node_load[n], node_free[n], n, node_ver[n]))

    def place_loop(l):
        node_load = [dev_load[n * nsz:(n + 1) * nsz].sum()
                     for n in range(n_nodes)]
        node_free = [slots_free[n * nsz:(n + 1) * nsz].sum()
                     for n in range(n_nodes)]
        cand_nodes = [n for n in range(len(node_load)) if node_free[n] > 0]
        cand_nodes.sort(key=lambda n: (node_load[n], node_free[n]))
        for n in cand_nodes:
            devs = [d for d in range(n * nsz, min((n + 1) * nsz, M))
                    if slots_free[d] > 0 and per_layer_count[l, d] < k_local]
            if not devs:
                continue
            devs.sort(key=lambda d: (dev_load[d], slots_free[d]))
            return devs[0]
        # fallback: any device with a free slot
        for d in np.argsort(dev_load):
            if slots_free[d] > 0 and per_layer_count[l, d] < k_local:
                return int(d)
        raise RuntimeError("no free slot — k_local too tight")

    def take_fast(l, e):
        d = place_fast(l)
        owner_dev[l, e] = d
        plc_rows[l][d] += 1
        w = loads_rows[l][e]
        placed_fast(l, d, w * inv_w[d] if inv_w is not None else w)

    def take_loop(l, e):
        d = place_loop(l)
        owner_dev[l, e] = d
        slots_free[d] -= 1
        dev_load[d] += loads[l, e] * (inv_w[d] if inv_w is not None else 1.0)
        per_layer_count[l, d] += 1

    take = take_fast if vectorized else take_loop

    # lines 6-14: place underloaded (non-overlappable) experts first,
    # layers ordered by their max underloaded expert load, experts desc.
    cold_load = np.where(hot, -np.inf, loads)
    layer_key = np.where(np.isfinite(cold_load).any(1),
                         cold_load.max(1, initial=-np.inf), 0.0)
    for l in np.argsort(-layer_key, kind="stable"):
        cold = np.nonzero(~hot[l])[0]
        for e in cold[np.argsort(-loads[l, cold], kind="stable")]:
            take(l, e)

    # line 16: fill remaining slots with hot (overlappable) experts —
    # they'll be replicated by Alg 1 anyway, so spread arbitrarily (we spread
    # round-robin over free slots for balance).
    for l in range(L):
        for e in np.nonzero(owner_dev[l] < 0)[0]:
            take(l, int(e))

    # assign buffer rows: the row of (l, e) is the number of PRIOR
    # layer-major allocations on the same device — a segment rank over
    # the flat owner keys
    owner_row = _segment_rank(owner_dev.reshape(-1).astype(np.int64)) \
        .astype(np.int32).reshape(L, E)
    # NOTE: k_local is the STATIC compute-slot width of the compiled step —
    # keep the caller-provided bound (uniform across re-shardings), not the
    # realized max, so re-sharding never changes compiled shapes.
    plan = ShardingPlan(L, E, M, rows_per_device, owner_dev, owner_row,
                        k_local=int(k_local))
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Re-sharding trigger (paper §5.1: every 100 iters, only when shards change)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReshardingPolicy:
    interval: int = 100
    t: int = 4
    node_size: int = 0
    # Per-device speed weights (straggler de-weighting) — refreshed by the
    # scheduler from the trainer's step-time probe before each trigger;
    # None means every device runs at full speed.
    device_weights: Optional[np.ndarray] = None

    def maybe_reshard(self, step: int, current: ShardingPlan,
                      predictor: LoadPredictor) -> Tuple[ShardingPlan, bool]:
        if step == 0 or step % self.interval != 0:
            return current, False
        new = heterogeneous_sharding(predictor.predict(),
                                     current.num_devices, self.t,
                                     node_size=self.node_size,
                                     k_local=current.k_local,
                                     device_weights=self.device_weights)
        changed = not np.array_equal(new.owner_dev, current.owner_dev)
        return (new, True) if changed else (current, False)
